"""T5 v1.1 text encoder in PyTorch, the PixArt caption tower (mirrors
`freefine_tpu.models.t5`).

Module names are transformers' `T5EncoderModel` (`shared`,
`encoder.block.{i}.layer.0.SelfAttention.{q,k,v,o}`, block 0's
`relative_attention_bias`, `layer.{0,1}.layer_norm`,
`layer.1.DenseReluDense.{wi_0,wi_1,wo}`, `encoder.final_layer_norm`), so a
checkpoint loads without renaming.  Architecture (feed_forward_proj
"gated-gelu"): a shared token embedding and no absolute positions; a
learned relative position bias [buckets, heads] in block 0, shared by every
block and added to the logits; pre-RMSNorm blocks of self-attention (no
biases and no 1/sqrt(d) scaling) and a gated tanh-GELU feed-forward; a
final RMSNorm.  The attention is plain math over at most a few hundred
tokens, as in the JAX package (an einsum there, no Pallas kernel).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from freefine_tpu_torch.models.layers import RMSNorm


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 4096       # t5-v1_1-xxl
    d_kv: int = 64
    num_heads: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    max_length: int = 120     # the PixArt pipeline's caption length
    dtype: torch.dtype = torch.bfloat16


def tiny_t5_config() -> T5Config:
    return T5Config(vocab_size=100, d_model=32, d_kv=8, num_heads=4, d_ff=64, num_layers=2,
                    max_length=16, dtype=torch.float32)


def _relative_position_bucket(relative_position: np.ndarray, num_buckets: int,
                              max_distance: int) -> np.ndarray:
    """Bidirectional bucket of each (key - query) offset (transformers'
    `T5Attention._relative_position_bucket`, bidirectional=True)."""
    num_buckets //= 2
    ret = (relative_position > 0).astype(np.int64) * num_buckets
    n = np.abs(relative_position)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    large = max_exact + (
        np.log(np.maximum(n, 1) / max_exact) / np.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).astype(np.int64)
    large = np.minimum(large, num_buckets - 1)
    return ret + np.where(is_small, n, large)


@functools.lru_cache(maxsize=None)
def _buckets(seq: int, num_buckets: int, max_distance: int) -> np.ndarray:
    rel = np.arange(seq)[None, :] - np.arange(seq)[:, None]  # key - query
    return _relative_position_bucket(rel, num_buckets, max_distance)


class T5SelfAttention(nn.Module):
    """q, k, v, o without bias; block 0 also holds the relative position
    bias table [buckets, heads] (float32)."""

    def __init__(self, c: T5Config, has_relative_bias: bool, device=None):
        super().__init__()
        inner = c.num_heads * c.d_kv
        kw = dict(bias=False, dtype=c.dtype, device=device)
        self.heads, self.d_kv = c.num_heads, c.d_kv
        self.q = nn.Linear(c.d_model, inner, **kw)
        self.k = nn.Linear(c.d_model, inner, **kw)
        self.v = nn.Linear(c.d_model, inner, **kw)
        self.o = nn.Linear(inner, c.d_model, **kw)
        if has_relative_bias:
            self.relative_attention_bias = nn.Embedding(
                c.relative_attention_num_buckets, c.num_heads, dtype=torch.float32,
                device=device)

    def forward(self, x: torch.Tensor, pos_bias: torch.Tensor,
                key_mask: Optional[torch.Tensor]) -> torch.Tensor:
        b, s, _ = x.shape

        def split(t):
            return t.reshape(b, s, self.heads, self.d_kv).transpose(1, 2)

        q, k, v = split(self.q(x)), split(self.k(x)), split(self.v(x))
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) + pos_bias[None]
        if key_mask is not None:
            logits = logits + (key_mask[:, None, None, :] - 1.0) * 1e9
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.matmul(probs, v).transpose(1, 2).reshape(b, s, self.heads * self.d_kv)
        return self.o(out)


class T5Block(nn.Module):
    """layer.0: RMSNorm then self-attention; layer.1: RMSNorm then the
    gated-GELU feed-forward (wi_0 through tanh-GELU, gated by wi_1, then
    wo); each added to the residual stream."""

    def __init__(self, c: T5Config, has_relative_bias: bool, device=None):
        super().__init__()
        kw = dict(bias=False, dtype=c.dtype, device=device)
        attn, ff = nn.Module(), nn.Module()
        attn.SelfAttention = T5SelfAttention(c, has_relative_bias, device)
        attn.layer_norm = RMSNorm(c.d_model, c.layer_norm_epsilon, device)
        ff.DenseReluDense = nn.Module()
        ff.DenseReluDense.wi_0 = nn.Linear(c.d_model, c.d_ff, **kw)
        ff.DenseReluDense.wi_1 = nn.Linear(c.d_model, c.d_ff, **kw)
        ff.DenseReluDense.wo = nn.Linear(c.d_ff, c.d_model, **kw)
        ff.layer_norm = RMSNorm(c.d_model, c.layer_norm_epsilon, device)
        self.layer = nn.ModuleList([attn, ff])

    def forward(self, x, pos_bias, key_mask):
        attn, ff = self.layer
        x = x + attn.SelfAttention(attn.layer_norm(x), pos_bias, key_mask)
        h = ff.layer_norm(x)
        d = ff.DenseReluDense
        h = F.gelu(d.wi_0(h), approximate="tanh") * d.wi_1(h)
        return x + d.wo(h)


class T5Encoder(nn.Module):
    """`T5EncoderModel`'s encoder: (ids [B, S], attention_mask [B, S] with
    1 = keep, or None) -> last hidden state [B, S, d_model] float32."""

    def __init__(self, config: T5Config, device=None):
        super().__init__()
        c = self.config = config
        self.shared = nn.Embedding(c.vocab_size, c.d_model, dtype=c.dtype, device=device)
        self.encoder = nn.Module()
        self.encoder.block = nn.ModuleList(
            [T5Block(c, i == 0, device) for i in range(c.num_layers)])
        self.encoder.final_layer_norm = RMSNorm(c.d_model, c.layer_norm_epsilon, device)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        c = self.config
        x = self.shared(input_ids)
        buckets = _buckets(input_ids.shape[1], c.relative_attention_num_buckets,
                           c.relative_attention_max_distance)
        table = self.encoder.block[0].layer[0].SelfAttention.relative_attention_bias.weight
        pos_bias = table[torch.as_tensor(buckets, device=table.device)].permute(2, 0, 1).float()
        key_mask = None if attention_mask is None else attention_mask.float()
        for blk in self.encoder.block:
            x = blk(x, pos_bias, key_mask)
        return self.encoder.final_layer_norm(x).float()
