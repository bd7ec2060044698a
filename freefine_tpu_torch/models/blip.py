"""BLIP and the ImageReward head in PyTorch (mirrors
`freefine_tpu.models.blip`): the IRS metric's model.

  * `BlipViT`: a pre-LN ViT-L/16 (1024 wide, 24 layers, 16 heads, LayerNorm
    eps 1e-6) with a class token;
  * `BertCrossEncoder`: BERT-base layers (LayerNorm eps 1e-12, exact GELU)
    of self-attention under the text's key mask, cross-attention to the
    image tokens (no mask) and the feed-forward;
  * `ImageReward`: the text's [CLS] feature through the MLP (1024, 128, 64,
    16, 1, ReLU between, as the JAX module has it), normalised by the
    released IR_MEAN / IR_STD;
  * `WordPieceTokenizer` (BERT's vocab.txt) and `HashWordTokenizer` (the
    deterministic stand-in), ids identical to the JAX package's.

Every attention (the ViT's and BERT's self- and cross-attention) goes
through `ops.attention.masked_sdpa`, so the `flash_sdpa` kernel runs it on
the card and its plain twin on the CPU; the BERT key mask is the text's
padding (the [CLS] key is always live, so no row is fully masked).

Module names are ImageReward-v1.0's checkpoint ones
(`blip.visual_encoder.{cls_token, pos_embed, patch_embed.proj,
blocks.N.{norm1, attn.qkv, attn.proj, norm2, mlp.fc1, mlp.fc2}, norm}`,
`blip.text_encoder.{embeddings.{word_embeddings, position_embeddings,
LayerNorm}, encoder.layer.N.{attention.self.{query, key, value},
attention.output.{dense, LayerNorm}, crossattention.*, intermediate.dense,
output.{dense, LayerNorm}}}`, `mlp.layers.{0, 2, 4, 6, 8}`), which
`weights.load_blip_image_reward` reads.
"""

from __future__ import annotations

import dataclasses
import re
from typing import List

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from freefine_tpu_torch.models.clip_image import CLIP_MEAN, CLIP_STD
from freefine_tpu_torch.models.layers import LayerNorm32
from freefine_tpu_torch.ops.attention import masked_sdpa
from freefine_tpu_torch.ops.resize import resize

# ImageReward-v1.0's released normalisation constants
IR_MEAN = 0.16717362830052426
IR_STD = 1.0333394966054072
MLP_LAYERS = ("0", "2", "4", "6", "8")


@dataclasses.dataclass(frozen=True)
class BlipConfig:
    image_size: int = 224
    patch_size: int = 16
    vision_width: int = 1024
    vision_layers: int = 24
    vision_heads: int = 16
    text_width: int = 768
    text_layers: int = 12
    text_heads: int = 12
    text_intermediate: int = 3072
    vocab_size: int = 30524  # bert-base-uncased + BLIP's special tokens
    max_text_len: int = 35
    dtype: torch.dtype = torch.float32


class _Attn(nn.Module):
    def __init__(self, dim: int, heads: int, dtype, device=None):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim, dtype=dtype, device=device)
        self.proj = nn.Linear(dim, dim, dtype=dtype, device=device)

    def forward(self, x):
        q, k, v = self.qkv(x).chunk(3, dim=-1)
        return self.proj(masked_sdpa(q, k, v, self.heads))


class _Mlp(nn.Module):
    def __init__(self, dim: int, dtype, device=None):
        super().__init__()
        self.fc1 = nn.Linear(dim, 4 * dim, dtype=dtype, device=device)
        self.fc2 = nn.Linear(4 * dim, dim, dtype=dtype, device=device)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class ViTBlock(nn.Module):
    def __init__(self, dim: int, heads: int, dtype, device=None):
        super().__init__()
        self.norm1 = LayerNorm32(dim, 1e-6, device=device)
        self.attn = _Attn(dim, heads, dtype, device)
        self.norm2 = LayerNorm32(dim, 1e-6, device=device)
        self.mlp = _Mlp(dim, dtype, device)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class BlipViT(nn.Module):
    """[B, 224, 224, 3] normalised (NHWC) -> [B, 1 + N, 1024] image tokens."""

    def __init__(self, cfg: BlipConfig, device=None):
        super().__init__()
        self.config = cfg
        g = cfg.image_size // cfg.patch_size
        w = cfg.vision_width
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(3, w, cfg.patch_size, stride=cfg.patch_size,
                                          dtype=cfg.dtype, device=device)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, w, dtype=torch.float32, device=device))
        self.pos_embed = nn.Parameter(torch.zeros(1, g * g + 1, w, dtype=torch.float32,
                                                  device=device))
        self.blocks = nn.ModuleList(ViTBlock(w, cfg.vision_heads, cfg.dtype, device)
                                    for _ in range(cfg.vision_layers))
        self.norm = LayerNorm32(w, 1e-6, device=device)

    def forward(self, x):
        cfg = self.config
        h = self.patch_embed.proj(x.to(cfg.dtype).permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
        cls = self.cls_token.to(cfg.dtype).expand(h.shape[0], -1, -1)
        h = torch.cat([cls, h], dim=1) + self.pos_embed.to(cfg.dtype)
        for blk in self.blocks:
            h = blk(h)
        return self.norm(h)


class _BertSelf(nn.Module):
    def __init__(self, width: int, kv_width: int, dtype, device=None):
        super().__init__()
        self.query = nn.Linear(width, width, dtype=dtype, device=device)
        self.key = nn.Linear(kv_width, width, dtype=dtype, device=device)
        self.value = nn.Linear(kv_width, width, dtype=dtype, device=device)


class _BertOutput(nn.Module):
    def __init__(self, cin: int, width: int, dtype, device=None):
        super().__init__()
        self.dense = nn.Linear(cin, width, dtype=dtype, device=device)
        self.LayerNorm = LayerNorm32(width, 1e-12, device=device)

    def forward(self, h, residual):
        return self.LayerNorm(residual + self.dense(h))


class _BertAttention(nn.Module):
    def __init__(self, width: int, kv_width: int, heads: int, dtype, device=None):
        super().__init__()
        self.heads = heads
        self.self = _BertSelf(width, kv_width, dtype, device)
        self.output = _BertOutput(width, width, dtype, device)

    def forward(self, x, kv, key_rows=None):
        s = self.self
        h = masked_sdpa(s.query(x), s.key(kv), s.value(kv), self.heads, key_rows)
        return self.output(h, x)


class BertLayer(nn.Module):
    """A BERT layer with cross-attention to the image (BLIP's med.py)."""

    def __init__(self, cfg: BlipConfig, device=None):
        super().__init__()
        w, dt = cfg.text_width, cfg.dtype
        self.attention = _BertAttention(w, w, cfg.text_heads, dt, device)
        self.crossattention = _BertAttention(w, cfg.vision_width, cfg.text_heads, dt, device)
        self.intermediate = nn.Module()
        self.intermediate.dense = nn.Linear(w, cfg.text_intermediate, dtype=dt, device=device)
        self.output = _BertOutput(cfg.text_intermediate, w, dt, device)

    def forward(self, x, key_rows, image_tokens):
        x = self.attention(x, x, key_rows)
        x = self.crossattention(x, image_tokens)
        return self.output(F.gelu(self.intermediate.dense(x)), x)


class BertCrossEncoder(nn.Module):
    """(ids [B, S], attention mask [B, S] 0/1, image tokens) -> [B, S, 768]."""

    def __init__(self, cfg: BlipConfig, device=None):
        super().__init__()
        w, dt = cfg.text_width, cfg.dtype
        self.embeddings = nn.Module()
        self.embeddings.word_embeddings = nn.Embedding(cfg.vocab_size, w, dtype=dt,
                                                       device=device)
        self.embeddings.position_embeddings = nn.Embedding(512, w, dtype=dt, device=device)
        self.embeddings.LayerNorm = LayerNorm32(w, 1e-12, device=device)
        self.encoder = nn.Module()
        self.encoder.layer = nn.ModuleList(BertLayer(cfg, device)
                                           for _ in range(cfg.text_layers))

    def forward(self, input_ids, attn_mask, image_tokens):
        e = self.embeddings
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)[None]
        x = e.LayerNorm(e.word_embeddings(input_ids) + e.position_embeddings(pos))
        rows = attn_mask.float()
        for layer in self.encoder.layer:
            x = layer(x, rows, image_tokens)
        return x


class ImageReward(nn.Module):
    """(images [B, 224, 224, 3] normalised, ids [B, S], mask [B, S]) ->
    [B] normalised scores (float32)."""

    def __init__(self, config: BlipConfig, device=None):
        super().__init__()
        self.config = config
        self.blip = nn.Module()
        self.blip.visual_encoder = BlipViT(config, device)
        self.blip.text_encoder = BertCrossEncoder(config, device)
        widths = (config.text_width, 1024, 128, 64, 16, 1)
        self.mlp = nn.Module()
        self.mlp.layers = nn.ModuleDict({
            name: nn.Linear(cin, cout, dtype=config.dtype, device=device)
            for name, cin, cout in zip(MLP_LAYERS, widths[:-1], widths[1:])})

    def forward(self, images, input_ids, attn_mask):
        tokens = self.blip.visual_encoder(images)
        h = self.blip.text_encoder(input_ids, attn_mask, tokens)[:, 0]
        for i, name in enumerate(MLP_LAYERS):
            h = self.mlp.layers[name](h)
            if i < len(MLP_LAYERS) - 1:
                h = F.relu(h)
        return (h[:, 0].float() - IR_MEAN) / IR_STD


def preprocess_blip(img_uint8: torch.Tensor, size: int = 224) -> torch.Tensor:
    """On-device convenience preprocess of uint8 [H, W, 3]: a square resize
    by JAX's "bicubic" (Keys' cubic, a = -0.5, antialiased when shrinking)
    and CLIP's normalisation -> [1, size, size, 3].  Not the metric's
    chain: IRS scores through `metrics.preprocess.clip_image_transform`
    (PIL's resample, a centre crop)."""
    x = img_uint8.float() / 255.0
    x = resize(x, (size, size), "cubic")
    mean = torch.tensor(CLIP_MEAN, device=x.device)
    std = torch.tensor(CLIP_STD, device=x.device)
    return ((x - mean) / std)[None]


class WordPieceTokenizer:
    """BERT WordPiece (vocab.txt): greedy longest match first."""

    def __init__(self, vocab: dict, max_len: int = 35):
        self.vocab = vocab
        self.max_len = max_len
        self.cls = vocab.get("[CLS]", 101)
        self.sep = vocab.get("[SEP]", 102)
        self.pad = vocab.get("[PAD]", 0)
        self.unk = vocab.get("[UNK]", 100)

    @classmethod
    def from_vocab_file(cls, path: str, max_len: int = 35):
        with open(path, encoding="utf-8") as f:
            vocab = {line.rstrip("\n"): i for i, line in enumerate(f)}
        return cls(vocab, max_len)

    def _wordpiece(self, word: str) -> List[int]:
        ids, start = [], 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = self.vocab[sub]
                    break
                end -= 1
            if cur is None:
                return [self.unk]
            ids.append(cur)
            start = end
        return ids

    def encode(self, text: str):
        """-> (ids [max_len] int32, mask [max_len] int32)."""
        words = re.findall(r"[a-z0-9]+|[^\sa-z0-9]", text.lower())
        ids = [self.cls]
        for w in words:
            ids.extend(self._wordpiece(w))
        ids = ids[: self.max_len - 1] + [self.sep]
        mask = [1] * len(ids) + [0] * (self.max_len - len(ids))
        ids = ids + [self.pad] * (self.max_len - len(ids))
        return np.asarray(ids, np.int32), np.asarray(mask, np.int32)


class HashWordTokenizer:
    """The deterministic stand-in when no vocab.txt is available: each
    lower-cased word's FNV-1a hash picks an id."""

    def __init__(self, vocab_size: int = 30524, max_len: int = 35):
        self.vocab_size = vocab_size
        self.max_len = max_len

    def encode(self, text: str):
        """-> (ids [max_len] int32, mask [max_len] int32)."""
        words = text.lower().split()
        ids = [101]
        for w in words:
            h = 2166136261
            for ch in w.encode():
                h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
            ids.append(103 + h % (self.vocab_size - 200))
        ids = ids[: self.max_len - 1] + [102]
        mask = [1] * len(ids) + [0] * (self.max_len - len(ids))
        ids = ids + [0] * (self.max_len - len(ids))
        return np.asarray(ids, np.int32), np.asarray(mask, np.int32)
