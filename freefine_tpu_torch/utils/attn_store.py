"""Attention-map store for the PyTorch port (mirrors
`freefine_tpu.utils.attn_store`): the reference's AttentionControl /
AttentionStore debug instrument.

With `EditConfig(store_attention=True)` every attention layer with at most
32 x 32 queries adds its head-averaged probability map to
`EditState.intermediates` under (module path..., "attn_probs"), one UNet
forward at a time:

    state = EditState(..., intermediates={})
    eps = pipe.unet_apply(x, t, ctx, dataclasses.replace(cfg, store_attention=True), state)
    store.update(state.intermediates)      # once per step
    maps = store.get_average_attention()   # averaged over steps

or use `FreeFine.attention_maps(...)` for a one-step probe.
"""

from __future__ import annotations

from typing import Dict, List, Mapping

import numpy as np


def classify_layer(path: tuple) -> str:
    """Module path (ending in the record's name) -> the reference's store
    key '{place}_{self|cross}'."""
    top = path[0]
    if top.startswith("down_blocks"):
        place = "down"
    elif top.startswith("mid_block") or top.startswith("mid"):
        place = "mid"
    elif top.startswith("up_blocks"):
        place = "up"
    else:
        place = top
    kind = "self" if path[-2].endswith("attn1") else "cross"
    return f"{place}_{kind}"


def _path_order(path: tuple) -> tuple:
    """Sort key of a module path: integer segments by value, so layers
    come in module order at any depth."""
    return tuple((0, int(p), "") if p.isdigit() else (1, 0, p) for p in path)


def collect_maps(intermediates: Mapping[tuple, list]) -> Dict[str, List[np.ndarray]]:
    """One forward's recorded maps -> the reference's {place_kind:
    [per-layer maps]} layout (numpy float32), in module order."""
    out: Dict[str, List[np.ndarray]] = {}
    for path in sorted((p for p in intermediates if p[-1] == "attn_probs"), key=_path_order):
        for arr in intermediates[path]:
            out.setdefault(classify_layer(path), []).append(arr.float().cpu().numpy())
    return out


class AttentionStore:
    """Step-averaging accumulator (reference AttentionStore.between_steps /
    get_average_attention)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.cur_step = 0
        self.attention_store: Dict[str, List[np.ndarray]] = {}

    def update(self, intermediates: Mapping[tuple, list]):
        """Accumulate one UNet forward's maps (one diffusion step)."""
        step = collect_maps(intermediates)
        if not self.attention_store:
            self.attention_store = step
        else:
            for key, maps in step.items():
                for i, m in enumerate(maps):
                    self.attention_store[key][i] = self.attention_store[key][i] + m
        self.cur_step += 1

    def get_average_attention(self) -> Dict[str, List[np.ndarray]]:
        return {key: [m / self.cur_step for m in maps]
                for key, maps in self.attention_store.items()}
