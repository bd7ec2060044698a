"""FreeFine on the SDXL backbone (mirrors `freefine_tpu.sdxl`): two text
towers and SDXL's added conditioning.

  * context = concat(CLIP-L hidden_states[-2] [768], OpenCLIP-bigG
    hidden_states[-2] [1280]) -> [B, 77, 2048];
  * added conditioning = concat(bigG's pooled projection [1280],
    sinusoid(time_ids) [6 * 256]) -> [B, 2816], which the UNet's
    add_embedding folds into its timestep embedding.

Every entry point (and `BatchedFreeFine`'s lanes) is `FreeFine`'s: only the
conditioning hook `_batch_text_embeddings` differs, and the loops carry
its `Cond` (context, added) through as they carry SD-1.5's context.

Documented deviation (as in the JAX package): diffusers tokenizes the
second tower's text with a tokenizer that pads with 0 (OpenCLIP's
convention) where CLIP pads with the end token; here the text is tokenized
once and the second tower's padding rewritten (`_openclip_ids`), so one BPE
vocabulary serves both towers.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from freefine_tpu_torch.conditioning import Cond
from freefine_tpu_torch.config import PipelineConfig, sdxl_pipeline_config
from freefine_tpu_torch.models.layers import timestep_embedding
from freefine_tpu_torch.models.open_clip_text import OpenCLIPTextHidden
from freefine_tpu_torch.pipeline import FreeFine

# diffusers UNet2DConditionModel addition_time_embed_dim of SDXL
TIME_ID_DIM = 256


class SDXLFreeFine(FreeFine):
    """FreeFine editing on the SDXL backbone.  params: {"unet", "vae",
    "text", "text2"} state dicts (`weights.load_sdxl` reads a diffusers
    SDXL directory into them); without them the constructor raises unless
    `init_random=True`."""

    def __init__(
        self,
        config: Optional[PipelineConfig] = None,
        params: Optional[dict] = None,
        tokenizer_path: Optional[str] = None,
        init_random: bool = False,
        seed: int = 0,
        device: Union[str, torch.device] = "cuda",
    ):
        config = config or sdxl_pipeline_config()
        if config.text2 is None:
            raise ValueError("SDXLFreeFine needs a second text tower (PipelineConfig.text2)")
        super().__init__(config=config, params=params, tokenizer_path=tokenizer_path,
                         init_random=init_random, seed=seed, device=device)

    def _build_modules(self) -> None:
        super()._build_modules()
        self.text_encoder_2 = OpenCLIPTextHidden(self.config.text2).eval()

    def components(self) -> dict:
        return {**super().components(), "text2": self.text_encoder_2}

    # -- the two towers ---------------------------------------------------------

    def _openclip_ids(self, ids: np.ndarray):
        """CLIP-padded ids [B, 77] -> (OpenCLIP-padded ids: 0 after the end
        token, end-token positions [B])."""
        eot = np.argmax(ids == self.tokenizer.eos, axis=1).astype(np.int64)
        ids2 = ids.copy()
        for row, e in zip(ids2, eot):
            row[e + 1:] = 0
        return ids2, eot

    @torch.no_grad()
    def _encode_dual(self, texts: Sequence[str]):
        """-> (context [B, 77, 2048], pooled [B, 1280]), float32."""
        ids = np.asarray(self.tokenizer.batch_encode(list(texts)))
        ids2, eot = self._openclip_ids(ids)

        def t(a):
            return torch.as_tensor(a, dtype=torch.long, device=self.device)

        h1 = self.text_encoder(t(ids))
        h2, pooled = self.text_encoder_2(t(ids2), t(eot))
        return torch.cat([h1.float(), h2.float()], dim=-1), pooled.float()

    def encode_text(self, texts: Sequence[str]) -> torch.Tensor:
        """[B, 77, 2048]: both towers' penultimate hidden states."""
        return self._encode_dual(texts)[0]

    def _added_cond(self, pooled: torch.Tensor) -> torch.Tensor:
        """pooled [B, P] -> [B, P + 6 * 256]: the time ids (orig_h, orig_w,
        crop_top, crop_left, target_h, target_w), each through the 256-d
        sinusoid (diffusers `_get_add_time_ids`), after the pooled text."""
        cfg = self.config
        tids = torch.tensor([cfg.height, cfg.width, 0, 0, cfg.height, cfg.width],
                            dtype=torch.float32, device=pooled.device)
        emb = timestep_embedding(tids, TIME_ID_DIM).reshape(1, -1)
        return torch.cat([pooled, emb.expand(pooled.shape[0], -1)], dim=-1)

    def _batch_text_embeddings(self, texts: Sequence[str]) -> Cond:
        ctx, pooled = self._encode_dual(texts)
        return Cond(ctx, self._added_cond(pooled))
