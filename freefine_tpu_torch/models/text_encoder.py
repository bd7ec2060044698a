"""CLIP text encoder in PyTorch (mirrors `freefine_tpu.models.text_encoder`).

Module names follow transformers' CLIPTextModel (text_model.embeddings,
text_model.encoder.layers, text_model.final_layer_norm).  The causal
self-attention is plain math with a finite -1e9 mask, as in the JAX
package: it is not one of the ported kernels.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from freefine_tpu_torch.config import CLIPTextConfig
from freefine_tpu_torch.models.layers import LayerNorm32


class CLIPAttention(nn.Module):
    def __init__(self, dim: int, heads: int, dtype, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.heads = heads
        self.q_proj = nn.Linear(dim, dim, **kw)
        self.k_proj = nn.Linear(dim, dim, **kw)
        self.v_proj = nn.Linear(dim, dim, **kw)
        self.out_proj = nn.Linear(dim, dim, **kw)

    def forward(self, x: torch.Tensor, causal_mask: torch.Tensor) -> torch.Tensor:
        b, s, e = x.shape
        d = e // self.heads

        def split(t):
            return t.reshape(b, s, self.heads, d).transpose(1, 2)

        qh, kh = split(self.q_proj(x)).float(), split(self.k_proj(x)).float()
        vh = split(self.v_proj(x))
        logits = torch.matmul(qh, kh.transpose(-1, -2)) / torch.sqrt(
            torch.tensor(float(d), dtype=torch.float32)
        )
        probs = torch.softmax(logits + causal_mask, dim=-1).to(vh.dtype)
        out = torch.matmul(probs, vh).transpose(1, 2).reshape(b, s, e)
        return self.out_proj(out)


class CLIPMLP(nn.Module):
    """fc1 -> QuickGELU (x * sigmoid(1.702 x), OpenAI CLIP) or, with
    activation "gelu", exact GELU (the SD-2.x tower) -> fc2."""

    def __init__(self, dim: int, intermediate: int, dtype, device=None,
                 activation: str = "quick_gelu"):
        super().__init__()
        if activation not in ("quick_gelu", "gelu"):
            raise ValueError(f"unknown CLIP MLP activation {activation!r}")
        self.activation = activation
        self.fc1 = nn.Linear(dim, intermediate, dtype=dtype, device=device)
        self.fc2 = nn.Linear(intermediate, dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.fc1(x)
        if self.activation == "gelu":
            return self.fc2(F.gelu(h))
        return self.fc2(h * torch.sigmoid(1.702 * h))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, device=None):
        super().__init__()
        self.self_attn = CLIPAttention(cfg.hidden_size, cfg.num_heads, cfg.dtype, device)
        self.layer_norm1 = LayerNorm32(cfg.hidden_size, device=device)
        self.mlp = CLIPMLP(cfg.hidden_size, cfg.intermediate_size, cfg.dtype, device,
                           cfg.activation)
        self.layer_norm2 = LayerNorm32(cfg.hidden_size, device=device)

    def forward(self, x, causal_mask):
        x = x + self.self_attn(self.layer_norm1(x), causal_mask)
        return x + self.mlp(self.layer_norm2(x))


def causal_mask(s: int, device) -> torch.Tensor:
    """[1, 1, s, s] float32: -1e9 above the diagonal, 0 elsewhere."""
    return torch.triu(torch.full((s, s), -1e9, dtype=torch.float32, device=device),
                      diagonal=1)[None, None]


class CLIPTextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, device=None):
        super().__init__()
        self.embeddings = nn.Module()
        self.embeddings.token_embedding = nn.Embedding(
            cfg.vocab_size, cfg.hidden_size, dtype=cfg.dtype, device=device
        )
        self.embeddings.position_embedding = nn.Embedding(
            cfg.max_length, cfg.hidden_size, dtype=cfg.dtype, device=device
        )
        self.encoder = nn.Module()
        n = cfg.num_layers - 1 if cfg.penultimate else cfg.num_layers
        self.encoder.layers = nn.ModuleList([CLIPEncoderLayer(cfg, device) for _ in range(n)])
        if not cfg.penultimate:
            self.final_layer_norm = LayerNorm32(cfg.hidden_size, device=device)

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        """Token plus position embeddings [B, S, hidden]."""
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)[None, :]
        return self.embeddings.token_embedding(input_ids) + self.embeddings.position_embedding(pos)


class CLIPTextEncoder(nn.Module):
    """[B, 77] token ids -> last hidden state [B, 77, hidden] after the
    final LayerNorm (the SD-1.5 conditioning) or, with the config's
    `penultimate` (SDXL), hidden_states[-2]: the last layer and the final
    LayerNorm are neither built nor run, as the JAX tree holds neither, and
    a checkpoint's tensors for them are ignored."""

    def __init__(self, config: CLIPTextConfig, device=None):
        super().__init__()
        self.config = config
        self.text_model = CLIPTextTransformer(config, device)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        tm = self.text_model
        x = tm.embed(input_ids)
        causal = causal_mask(input_ids.shape[1], input_ids.device)
        for layer in tm.encoder.layers:
            x = layer(x, causal)
        return x if self.config.penultimate else tm.final_layer_norm(x)
