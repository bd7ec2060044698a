"""OpenCLIP text tower in PyTorch, SDXL's `text_encoder_2` (mirrors
`freefine_tpu.models.open_clip_text.OpenCLIPTextHidden`).

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


class OpenCLIPTextHidden(nn.Module):
    """([B, 77] ids, [B] EOT positions) -> (hidden_states[-2] [B, 77, width],
    pooled projection [B, projection_dim]).  SDXL conditions on the
    penultimate hidden states (beside the first tower's) and on the
    projection of the final LayerNorm's output at the EOT position.  The
    position is passed explicitly, so a stand-in tokenizer with a small
    vocabulary pools where the real one would."""

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

    def forward(self, input_ids: torch.Tensor, eot_pos: torch.Tensor):
        tm = self.text_model
        x = tm.embed(input_ids)
        causal = causal_mask(input_ids.shape[1], input_ids.device)
        *head, last = tm.encoder.layers
        for layer in head:
            x = layer(x, causal)
        hidden = x
        x = tm.final_layer_norm(last(x, causal))
        pooled = x[torch.arange(x.shape[0], device=x.device), eot_pos]
        return hidden, self.text_projection(pooled)
