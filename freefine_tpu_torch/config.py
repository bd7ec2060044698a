"""Static configuration dataclasses for the PyTorch port.

Same fields and defaults as `freefine_tpu.config` (SD-1.5 in bfloat16),
with `torch.dtype` in place of the jnp dtypes.  The configurations the port
runs are carried: SD-1.5, SDXL-base (dual text towers, added
conditioning), SD-2.1, the PixArt-α DiT backbone (with the T5 caption
tower, or SD-1.5's CLIP tower), and their miniature test configs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """SD UNet2DCondition architecture description (SD-1.5 defaults)."""

    sample_size: int = 64
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    # head count at every level, unless head_dim is set: then a level's
    # heads are block_out_channels[level] // head_dim (SDXL, SD-2.x)
    num_attention_heads: int = 8
    head_dim: Optional[int] = None
    # Linear (True) or 1x1-conv (False) transformer proj_in / proj_out
    use_linear_projection: bool = False
    cross_attention_dim: int = 768
    down_block_has_attn: Tuple[bool, ...] = (True, True, True, False)
    up_block_has_attn: Tuple[bool, ...] = (False, True, True, True)
    transformer_depth: Tuple[int, ...] = (1, 1, 1, 1)
    # SDXL added conditioning (pooled text ++ time ids) folded into the
    # timestep embedding; None disables
    addition_embed_dim: Optional[int] = None
    norm_num_groups: int = 32
    freq_shift: int = 0
    flip_sin_to_cos: bool = True
    dtype: torch.dtype = torch.bfloat16

    def heads(self, level: int) -> int:
        """Attention heads of the transformers at block level `level`."""
        if self.head_dim is None:
            return self.num_attention_heads
        return self.block_out_channels[level] // self.head_dim

    @property
    def attn_layer_layout(self) -> Tuple[int, int]:
        """(total, up_start) in depth-weighted attention-layer indices, the
        numbering `UNet2DCondition` threads as ``block_index``."""
        nb = len(self.block_out_channels)
        down = sum(
            self.transformer_depth[i] * self.layers_per_block
            for i in range(nb)
            if self.down_block_has_attn[i]
        )
        mid = self.transformer_depth[nb - 1]
        up = sum(
            self.transformer_depth[nb - 1 - i] * (self.layers_per_block + 1)
            for i in range(nb)
            if self.up_block_has_attn[i]
        )
        return down + mid + up, down + mid


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """AutoencoderKL (SD VAE) architecture description."""

    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215
    dtype: torch.dtype = torch.bfloat16


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    """CLIP ViT-L/14 text encoder (SD-1.5 conditioning model)."""

    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_length: int = 77
    # MLP activation: "quick_gelu" (OpenAI CLIP, SD-1.5) or "gelu" (exact,
    # the OpenCLIP-derived SD-2.x tower)
    activation: str = "quick_gelu"
    # hidden_states[-2] (SDXL's first tower): the last layer and the final
    # LayerNorm are not built
    penultimate: bool = False
    dtype: torch.dtype = torch.bfloat16


@dataclasses.dataclass(frozen=True)
class OpenCLIPTextConfig:
    """OpenCLIP text tower (SDXL's text_encoder_2 at `open_clip_text_bigg`)."""

    vocab_size: int = 49408
    width: int = 1024
    heads: int = 16
    layers: int = 24
    context_length: int = 77
    projection_dim: int = 1024
    dtype: torch.dtype = torch.float32


def open_clip_text_bigg(dtype: Optional[torch.dtype] = None) -> OpenCLIPTextConfig:
    """OpenCLIP ViT-bigG-14's text tower: 32 layers of width 1280."""
    return OpenCLIPTextConfig(width=1280, heads=20, layers=32, projection_dim=1280,
                              dtype=dtype or torch.float32)


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """DDIM schedule hyper-parameters (diffusers SD-1.5 DDIMScheduler)."""

    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    steps_offset: int = 1
    set_alpha_to_one: bool = False


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    """PixArt-α-class latent diffusion transformer (`models/dit.py`);
    defaults are the PixArt-XL-2 geometry (hidden 1152, depth 28, 16 heads
    of 72, patch 2 on the 64^2 latent grid: 1024 tokens)."""

    sample_size: int = 64
    patch_size: int = 2
    in_channels: int = 4
    out_channels: int = 4
    hidden_size: int = 1152
    depth: int = 28
    num_heads: int = 16
    cross_attention_dim: int = 768
    # PixArt checkpoints predict [eps; sigma] (out 2*C); the forward returns
    # the eps half, as the diffusers PixArt pipeline chunks it
    learn_sigma: bool = False
    dtype: torch.dtype = torch.bfloat16

    @property
    def attn_layer_layout(self) -> Tuple[int, int]:
        """(total, up_start): one self-attention per block, and every block
        reports place "up", so the TCA window is a fraction of the depth."""
        return self.depth, 0


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Top-level pipeline configuration."""

    # the denoiser: a UNetConfig, or a DiTConfig (the DiT backbone)
    unet: UNetConfig = dataclasses.field(default_factory=UNetConfig)
    vae: VAEConfig = dataclasses.field(default_factory=VAEConfig)
    # the text tower: a CLIPTextConfig, or a `models.t5.T5Config` (PixArt)
    text: CLIPTextConfig = dataclasses.field(default_factory=CLIPTextConfig)
    scheduler: SchedulerConfig = dataclasses.field(default_factory=SchedulerConfig)
    height: int = 512
    width: int = 512
    # SDXL's second text tower (None: one tower)
    text2: Optional[OpenCLIPTextConfig] = None

    @property
    def latent_height(self) -> int:
        return self.height // 8

    @property
    def latent_width(self) -> int:
        return self.width // 8


def tiny_pipeline_config(height: int = 64, width: int = 64) -> PipelineConfig:
    """Miniature float32 config for CPU tests: four block resolutions and
    16 transformer blocks, so layer indices 10..15 land in the same up
    blocks as SD-1.5."""
    unet = UNetConfig(
        sample_size=height // 8,
        block_out_channels=(32, 64, 128, 128),
        num_attention_heads=2,
        cross_attention_dim=32,
        norm_num_groups=8,
        dtype=torch.float32,
    )
    vae = VAEConfig(
        block_out_channels=(16, 16, 32, 32),
        layers_per_block=1,
        norm_num_groups=8,
        dtype=torch.float32,
    )
    text = CLIPTextConfig(
        vocab_size=1000,
        hidden_size=32,
        intermediate_size=64,
        num_layers=2,
        num_heads=2,
        dtype=torch.float32,
    )
    return PipelineConfig(unet=unet, vae=vae, text=text, height=height, width=width)


def sd15_pipeline_config(
    height: int = 512, width: int = 512, dtype: Optional[torch.dtype] = None
) -> PipelineConfig:
    """The production SD-1.5 configuration (bf16 by default)."""
    dtype = dtype or torch.bfloat16
    return PipelineConfig(
        unet=UNetConfig(dtype=dtype),
        vae=VAEConfig(dtype=dtype),
        text=CLIPTextConfig(dtype=dtype),
        height=height,
        width=width,
    )


def sdxl_unet_config(dtype: Optional[torch.dtype] = None) -> UNetConfig:
    """SDXL-base's UNet: 3 levels, transformer depths (1, 2, 10), heads of
    64 (5, 10, 20 per level), 2048-d context, linear projections, 2816-d
    added conditioning."""
    return UNetConfig(
        sample_size=128,
        block_out_channels=(320, 640, 1280),
        layers_per_block=2,
        head_dim=64,
        cross_attention_dim=2048,
        down_block_has_attn=(False, True, True),
        up_block_has_attn=(True, True, False),
        transformer_depth=(1, 2, 10),
        addition_embed_dim=2816,
        use_linear_projection=True,
        dtype=dtype or torch.bfloat16,
    )


def sdxl_pipeline_config(height: int = 1024, width: int = 1024,
                         dtype: Optional[torch.dtype] = None) -> PipelineConfig:
    """SDXL-base: the SDXL UNet, the SDXL VAE (scaling 0.13025), CLIP-L's
    penultimate hidden states and the OpenCLIP-bigG second tower."""
    dtype = dtype or torch.bfloat16
    return PipelineConfig(
        unet=sdxl_unet_config(dtype),
        vae=VAEConfig(scaling_factor=0.13025, dtype=dtype),
        text=CLIPTextConfig(penultimate=True, dtype=dtype),
        text2=open_clip_text_bigg(dtype),
        height=height,
        width=width,
    )


def tiny_sdxl_pipeline_config(height: int = 64, width: int = 64) -> PipelineConfig:
    """Miniature SDXL topology for CPU tests: 3 levels, depths (1, 2, 2),
    dual towers (16 + 32 = 48-d context), added conditioning."""
    unet = UNetConfig(
        sample_size=height // 8,
        block_out_channels=(32, 64, 128),
        num_attention_heads=2,
        cross_attention_dim=48,
        down_block_has_attn=(False, True, True),
        up_block_has_attn=(True, True, False),
        transformer_depth=(1, 2, 2),
        addition_embed_dim=32 + 6 * 256,
        use_linear_projection=True,
        norm_num_groups=8,
        dtype=torch.float32,
    )
    vae = VAEConfig(block_out_channels=(16, 16, 32, 32), layers_per_block=1, norm_num_groups=8,
                    scaling_factor=0.13025, dtype=torch.float32)
    text = CLIPTextConfig(vocab_size=1000, hidden_size=16, intermediate_size=32, num_layers=2,
                          num_heads=2, penultimate=True, dtype=torch.float32)
    text2 = OpenCLIPTextConfig(vocab_size=1000, width=32, heads=2, layers=2, projection_dim=32,
                               dtype=torch.float32)
    return PipelineConfig(unet=unet, vae=vae, text=text, text2=text2, height=height, width=width)


def sd21_pipeline_config(height: int = 768, width: int = 768,
                         dtype: Optional[torch.dtype] = None) -> PipelineConfig:
    """Stable Diffusion 2.1: SD-1.5's block layout with heads of 64 (5, 10,
    20, 20), linear projections, 1024-d context from a 23-layer gelu text
    tower."""
    dtype = dtype or torch.bfloat16
    return PipelineConfig(
        unet=UNetConfig(sample_size=height // 8, cross_attention_dim=1024, head_dim=64,
                        use_linear_projection=True, dtype=dtype),
        vae=VAEConfig(dtype=dtype),
        text=CLIPTextConfig(hidden_size=1024, intermediate_size=4096, num_layers=23,
                            num_heads=16, activation="gelu", dtype=dtype),
        height=height,
        width=width,
    )



def _square_only(height: int, width: int) -> None:
    if height != width:
        raise ValueError(
            "the DiT backbone is square-only (DiTConfig carries one sample_size and a "
            f"square sincos position table); got {height}x{width}"
        )


def pixart_xl2_dit_config(sample_size: int = 64,
                          dtype: Optional[torch.dtype] = None) -> DiTConfig:
    """The published PixArt-XL-2 transformer geometry
    (PixArt-alpha/PixArt-XL-2-512x512): depth 28, hidden 1152, 16 heads of
    72, patch 2, T5-XXL 4096-d captions, learned sigma (key manifest
    tests/fixtures/pixart_xl2_keys.txt)."""
    return DiTConfig(sample_size=sample_size, cross_attention_dim=4096, learn_sigma=True,
                     dtype=dtype or torch.bfloat16)


def pixart_pipeline_config(height: int = 512, width: int = 512,
                           dtype: Optional[torch.dtype] = None) -> PipelineConfig:
    """The PixArt-α-512 editing pipeline: the PixArt-XL-2 transformer, the
    SD VAE and the T5 v1.1 XXL caption tower (`weights.load_pixart` reads
    a diffusers PixArt directory)."""
    from freefine_tpu_torch.models.t5 import T5Config

    _square_only(height, width)
    dtype = dtype or torch.bfloat16
    return PipelineConfig(unet=pixart_xl2_dit_config(sample_size=height // 8, dtype=dtype),
                          vae=VAEConfig(dtype=dtype), text=T5Config(dtype=dtype),
                          height=height, width=width)


def tiny_dit_config() -> DiTConfig:
    """Miniature DiT for CPU tests: patch 1 on the tiny 8^2 latent grid
    keeps the token count at 64, the tiny mask pyramid's top level."""
    return DiTConfig(sample_size=8, patch_size=1, hidden_size=32, depth=4, num_heads=2,
                     cross_attention_dim=32, dtype=torch.float32)


def dit_pipeline_config(height: int = 512, width: int = 512,
                        dtype: Optional[torch.dtype] = None) -> PipelineConfig:
    """SD-1.5's VAE and CLIP tower with the DiT backbone (PixArt-XL's
    geometry at the CLIP 768-d context)."""
    _square_only(height, width)
    dtype = dtype or torch.bfloat16
    return PipelineConfig(unet=DiTConfig(sample_size=height // 8, dtype=dtype),
                          vae=VAEConfig(dtype=dtype), text=CLIPTextConfig(dtype=dtype),
                          height=height, width=width)


def tiny_dit_pipeline_config(height: int = 64, width: int = 64) -> PipelineConfig:
    """`tiny_pipeline_config` with the tiny DiT backbone."""
    return dataclasses.replace(tiny_pipeline_config(height, width), unet=tiny_dit_config())


def tiny_pixart_pipeline_config(height: int = 64, width: int = 64) -> PipelineConfig:
    """The PixArt layout at unit-test scale: the tiny DiT with learned
    sigma and the tiny T5 caption tower."""
    from freefine_tpu_torch.models.t5 import tiny_t5_config

    t5 = tiny_t5_config()
    return dataclasses.replace(
        tiny_pipeline_config(height, width),
        unet=dataclasses.replace(tiny_dit_config(), learn_sigma=True,
                                 cross_attention_dim=t5.d_model),
        text=t5)
