"""Static configuration dataclasses for the PyTorch port.

Same fields and defaults as `freefine_tpu.config` (SD-1.5 in bfloat16),
with `torch.dtype` in place of the jnp dtypes.  Only the configurations the
port runs are carried: SD-1.5 and the miniature test config.
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
    num_attention_heads: int = 8
    cross_attention_dim: int = 768
    down_block_has_attn: Tuple[bool, ...] = (True, True, True, False)
    up_block_has_attn: Tuple[bool, ...] = (False, True, True, True)
    transformer_depth: Tuple[int, ...] = (1, 1, 1, 1)
    norm_num_groups: int = 32
    freq_shift: int = 0
    flip_sin_to_cos: bool = True
    dtype: torch.dtype = torch.bfloat16

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
    dtype: torch.dtype = torch.bfloat16


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """DDIM schedule hyper-parameters (diffusers SD-1.5 DDIMScheduler)."""

    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    steps_offset: int = 1
    set_alpha_to_one: bool = False


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Top-level pipeline configuration."""

    unet: UNetConfig = dataclasses.field(default_factory=UNetConfig)
    vae: VAEConfig = dataclasses.field(default_factory=VAEConfig)
    text: CLIPTextConfig = dataclasses.field(default_factory=CLIPTextConfig)
    scheduler: SchedulerConfig = dataclasses.field(default_factory=SchedulerConfig)
    height: int = 512
    width: int = 512

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
