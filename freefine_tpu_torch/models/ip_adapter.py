"""IP-Adapter(-plus) image-prompt conditioning in PyTorch (mirrors
`freefine_tpu.models.ip_adapter`).

A perceiver `Resampler` compresses the CLIP vision tower's penultimate
hidden states into `num_queries` image tokens, and every cross-attention
adds `ip_scale * attn(q, k_ip, v_ip)` over those tokens with its own
to_k_ip / to_v_ip projections (`EditAttention.add_ip_layers`; the tokens
ride through the backbone as `context_image`, the strength is
`EditConfig.ip_scale`).  The attention here is plain math over 16 tokens,
as in the JAX package: no kernel.

Checkpoint layout ("ip-adapter-plus_sd15.bin"): {"image_proj": the
resampler under IP-Adapter's `resampler.py` names (`latents`,
`proj_in`, `layers.{i}.0` the attention, `layers.{i}.1.{0,1,3}` the
feed-forward, `proj_out`, `norm_out`), "ip_adapter":
{"<2*i+1>.to_{k,v}_ip.weight": ...}}, the layers indexed in diffusers'
`attn_processors` order: down blocks, then up blocks, then mid.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping

import torch
import torch.nn.functional as F
from torch import nn

from freefine_tpu_torch.models.layers import EditAttention


@dataclasses.dataclass(frozen=True)
class ResamplerConfig:
    """ip-adapter-plus_sd15 defaults."""

    dim: int = 768
    depth: int = 4
    dim_head: int = 64
    heads: int = 12
    num_queries: int = 16
    embedding_dim: int = 1280     # CLIP ViT-H hidden size
    output_dim: int = 768         # SD-1.5 cross-attention dim
    ff_mult: int = 4
    dtype: torch.dtype = torch.float32


class PerceiverAttention(nn.Module):
    """The latents attend to [image features; latents]; q and k are each
    scaled by dim_head^-0.25 (IP-Adapter's `PerceiverAttention`)."""

    def __init__(self, dim: int, dim_head: int, heads: int, dtype, device=None):
        super().__init__()
        inner = dim_head * heads
        kw = dict(bias=False, dtype=dtype, device=device)
        self.dim_head, self.heads = dim_head, heads
        self.norm1 = nn.LayerNorm(dim, device=device)
        self.norm2 = nn.LayerNorm(dim, device=device)
        self.to_q = nn.Linear(dim, inner, **kw)
        self.to_kv = nn.Linear(dim, 2 * inner, **kw)
        self.to_out = nn.Linear(inner, dim, **kw)

    def forward(self, x: torch.Tensor, latents: torch.Tensor) -> torch.Tensor:
        x, latents = _ln(self.norm1, x), _ln(self.norm2, latents)
        q = self.to_q(latents)
        k, v = self.to_kv(torch.cat([x, latents], dim=-2)).chunk(2, dim=-1)

        def split(t):
            b, s, _ = t.shape
            return t.reshape(b, s, self.heads, self.dim_head).transpose(1, 2)

        qh, kh, vh = split(q), split(k), split(v)
        scale = 1.0 / self.dim_head**0.25
        w = torch.matmul((qh * scale).float(), (kh * scale).float().transpose(-1, -2))
        out = torch.matmul(torch.softmax(w, dim=-1).to(vh.dtype), vh)
        b, h, s, d = out.shape
        return self.to_out(out.transpose(1, 2).reshape(b, s, h * d))


def _ln(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """A float32 LayerNorm (eps 1e-5), output in x's dtype."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight, norm.bias,
                        norm.eps).to(x.dtype)


class Resampler(nn.Module):
    """Perceiver resampler: CLIP penultimate tokens [B, N, embedding_dim]
    -> num_queries image tokens [B, Q, output_dim]."""

    def __init__(self, config: ResamplerConfig = ResamplerConfig(), device=None):
        super().__init__()
        c = self.config = config
        kw = dict(dtype=c.dtype, device=device)
        self.latents = nn.Parameter(
            torch.randn(1, c.num_queries, c.dim, dtype=torch.float32, device=device) / c.dim**0.5)
        self.proj_in = nn.Linear(c.embedding_dim, c.dim, **kw)
        self.proj_out = nn.Linear(c.dim, c.output_dim, **kw)
        self.norm_out = nn.LayerNorm(c.output_dim, device=device)
        self.layers = nn.ModuleList()
        for _ in range(c.depth):
            ff = nn.Sequential(nn.LayerNorm(c.dim, device=device),
                               nn.Linear(c.dim, c.dim * c.ff_mult, bias=False, **kw), nn.GELU(),
                               nn.Linear(c.dim * c.ff_mult, c.dim, bias=False, **kw))
            self.layers.append(nn.ModuleList([
                PerceiverAttention(c.dim, c.dim_head, c.heads, c.dtype, device), ff]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.config
        lat = self.latents.to(c.dtype).expand(x.shape[0], -1, -1)
        h = self.proj_in(x.to(c.dtype))
        for attn, ff in self.layers:
            lat = lat + attn(h, lat)
            f = ff[1](_ln(ff[0], lat))
            lat = lat + ff[3](F.gelu(f))
        return _ln(self.norm_out, self.proj_out(lat))


# ---------------------------------------------------------------------------
# the backbone's IP-Adapter layers
# ---------------------------------------------------------------------------


def cross_attentions(model: nn.Module) -> Dict[str, EditAttention]:
    """{module path: layer} of every cross-attention of a backbone."""
    return {name: m for name, m in model.named_modules()
            if isinstance(m, EditAttention) and m.is_cross}


@torch.no_grad()
def add_ip_adapter(pipe, seed: int = 0):
    """Attach to_k_ip / to_v_ip (image tokens of the denoiser's
    cross_attention_dim) to every cross-attention of `pipe.unet`, filled
    with the random-weight scheme (N(0, 0.02) from a seeded generator)
    until `load_ip_adapter` fills them, as the JAX package's
    `add_ip_adapter_params` initialises them freshly.  Returns the pipe."""
    width = pipe.config.unet.cross_attention_dim
    layers = cross_attentions(pipe.unet)
    dev = next(iter(layers.values())).to_q.weight.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    for layer in layers.values():
        layer.add_ip_layers(width)
        for lin in (layer.to_k_ip, layer.to_v_ip):
            lin.weight.copy_(0.02 * torch.randn(lin.weight.shape, generator=gen, device=dev))
            lin.requires_grad_(False)
    return pipe


def cross_attention_order(config) -> List[str]:
    """The UNet's cross-attention transformer blocks, as module paths, in
    diffusers' `attn_processors` order (down blocks, then up blocks, then
    mid): the order an IP-Adapter checkpoint indexes its layers in.  A UNet
    config only (no IP-Adapter checkpoint indexes the DiT's layers)."""
    from freefine_tpu_torch.config import UNetConfig

    if not isinstance(config, UNetConfig):
        raise ValueError("IP-Adapter checkpoints index a UNet's cross-attentions; "
                         f"got {type(config).__name__}")
    order = []
    n = len(config.block_out_channels)
    for i in range(n):
        if config.down_block_has_attn[i]:
            for j in range(config.layers_per_block):
                for d in range(config.transformer_depth[i]):
                    order.append(f"down_blocks.{i}.attentions.{j}.transformer_blocks.{d}")
    for i in range(n):
        if config.up_block_has_attn[i]:
            for j in range(config.layers_per_block + 1):
                for d in range(config.transformer_depth[n - 1 - i]):
                    order.append(f"up_blocks.{i}.attentions.{j}.transformer_blocks.{d}")
    for d in range(config.transformer_depth[n - 1]):
        order.append(f"mid_block.attentions.0.transformer_blocks.{d}")
    return order


@torch.no_grad()
def load_ip_adapter(pipe, state_dict: Mapping[str, torch.Tensor]):
    """Fill every cross-attention's to_k_ip / to_v_ip from an "ip_adapter"
    state dict ({"<2*i+1>.to_k_ip.weight": [dim, width], ...}; a whole
    checkpoint with an "ip_adapter" entry is taken too), layer i in
    `cross_attention_order`.  `add_ip_adapter` must have run; a missing
    or misshapen tensor raises.  Returns the pipe."""
    sd = state_dict.get("ip_adapter", state_dict)
    layers = cross_attentions(pipe.unet)
    for idx, path in enumerate(cross_attention_order(pipe.config.unet)):
        layer = layers[f"{path}.attn2"]
        for leaf in ("to_k_ip", "to_v_ip"):
            lin = getattr(layer, leaf)
            if lin is None:
                raise KeyError(f"{path}.attn2 has no {leaf}: call add_ip_adapter first")
            t = torch.as_tensor(sd[f"{2 * idx + 1}.{leaf}.weight"])
            if tuple(t.shape) != tuple(lin.weight.shape):
                raise ValueError(f"{path}.attn2.{leaf}: checkpoint {tuple(t.shape)} vs model "
                                 f"{tuple(lin.weight.shape)}")
            lin.weight.copy_(t)
    return pipe
