"""OpenCLIP text towers in PyTorch (mirror
`freefine_tpu.models.open_clip_text`): `OpenCLIPText`, the pooled tower of
HPSv2.1's ViT-H-14 (`open_clip_text_h14`), and `OpenCLIPTextHidden`, SDXL's
`text_encoder_2`.

Parameter names are transformers' `CLIPTextModelWithProjection` ones
(text_model.embeddings, text_model.encoder.layers.N.self_attn.{q,k,v}_proj,
text_model.final_layer_norm, text_projection), so a diffusers SDXL
checkpoint's `text_encoder_2/` loads as it is.  The JAX tower fuses q, k, v
into one `in_proj`; the math is the same.  Exact (erf) GELU; the causal
attention is plain math with a -1e9 mask, as in the JAX package (not one
of the ported kernels: the JAX tower's attention is plain XLA).
"""

from __future__ import annotations

import torch
from torch import nn

from freefine_tpu_torch.config import CLIPTextConfig, OpenCLIPTextConfig
from freefine_tpu_torch.models.text_encoder import CLIPTextTransformer, causal_mask


def open_clip_text_h14() -> OpenCLIPTextConfig:
    """OpenCLIP ViT-H-14's text tower (HPSv2.1): 24 layers of width 1024,
    16 heads, projection 1024."""
    return OpenCLIPTextConfig()


class OpenCLIPText(nn.Module):
    """[B, 77] ids -> [B, projection_dim] text features (unnormalised): the
    final LayerNorm's output at the EOT token, taken as argmax(input_ids)
    (the first one where several tie), through the text projection."""

    def __init__(self, config: OpenCLIPTextConfig, device=None):
        super().__init__()
        self.config = config
        self.text_model = CLIPTextTransformer(CLIPTextConfig(
            vocab_size=config.vocab_size, hidden_size=config.width,
            intermediate_size=4 * config.width, num_layers=config.layers,
            num_heads=config.heads, max_length=config.context_length, activation="gelu",
            dtype=config.dtype), device)
        self.text_projection = nn.Linear(config.width, config.projection_dim, bias=False,
                                         dtype=config.dtype, device=device)

    def _pooled(self, x: torch.Tensor, eot_pos: torch.Tensor) -> torch.Tensor:
        x = self.text_model.final_layer_norm(x)
        pooled = x[torch.arange(x.shape[0], device=x.device), eot_pos]
        return self.text_projection(pooled)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        tm = self.text_model
        x = tm.embed(input_ids)
        causal = causal_mask(input_ids.shape[1], input_ids.device)
        for layer in tm.encoder.layers:
            x = layer(x, causal)
        return self._pooled(x, input_ids.argmax(dim=-1))


class OpenCLIPTextHidden(OpenCLIPText):
    """([B, 77] ids, [B] EOT positions) -> (hidden_states[-2] [B, 77, width],
    pooled projection [B, projection_dim]).  SDXL conditions on the
    penultimate hidden states (beside the first tower's) and on the
    projection of the final LayerNorm's output at the EOT position.  The
    position is passed explicitly, so a stand-in tokenizer with a small
    vocabulary pools where the real one would."""

    def forward(self, input_ids: torch.Tensor, eot_pos: torch.Tensor):
        tm = self.text_model
        x = tm.embed(input_ids)
        causal = causal_mask(input_ids.shape[1], input_ids.device)
        *head, last = tm.encoder.layers
        for layer in head:
            x = layer(x, causal)
        return x, self._pooled(last(x, causal), eot_pos)
