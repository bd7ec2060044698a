"""The denoiser's text conditioning, as the loops carry it.

SD-1.5 conditions the UNet on a context [..., L, D] (L tokens: 77 for
CLIP, 120 for PixArt's T5).  SDXL adds a vector [..., A] (the second
tower's pooled projection ++ the time ids) with the same leading axes,
which the UNet folds into its timestep embedding.
`Cond` holds both (`added` is None for SD-1.5).  The loops stack, index,
flatten and broadcast it over its leading axes, as the JAX package moves
its (context, added_cond) pytrees with `tree_map`; `FreeFine.unet_apply`
splits it at the UNet call.  `Cond.of` is the one place a bare context
tensor becomes a `Cond`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class Cond:
    ctx: torch.Tensor                      # [..., L, D]
    added: Optional[torch.Tensor] = None   # [..., A], the same leading axes

    @staticmethod
    def of(x) -> "Cond":
        """A `Cond` as it is; a tensor as a context."""
        return x if isinstance(x, Cond) else Cond(x)

    @property
    def lead(self) -> torch.Size:
        """The leading axes (the context's shape without its last two)."""
        return self.ctx.shape[:-2]

    def _map(self, fn: Callable) -> "Cond":
        """fn(leaf, trailing axes) on each leaf (context 2, added 1)."""
        return Cond(fn(self.ctx, 2), None if self.added is None else fn(self.added, 1))

    def map(self, fn: Callable) -> "Cond":
        return self._map(lambda a, _: fn(a))

    def __getitem__(self, idx) -> "Cond":
        return self.map(lambda a: a[idx])

    def expand(self, *lead: int) -> "Cond":
        """Leading axes broadcast to `lead` (new ones prepended), a view."""
        return self._map(lambda a, k: a.expand(*lead, *a.shape[a.dim() - k:]))

    def reshape(self, *lead: int) -> "Cond":
        """Leading axes reshaped to `lead` (-1 as in `torch.reshape`)."""
        return self._map(lambda a, k: a.reshape(*lead, *a.shape[a.dim() - k:]))

    @staticmethod
    def stack(conds: Sequence["Cond"], dim: int) -> "Cond":
        """`torch.stack` leaf-wise at leading axis `dim` (>= 0)."""
        added = None if conds[0].added is None else torch.stack([c.added for c in conds], dim)
        return Cond(torch.stack([c.ctx for c in conds], dim), added)

    @staticmethod
    def cat(conds: Sequence["Cond"], dim: int) -> "Cond":
        """`torch.cat` leaf-wise along leading axis `dim` (>= 0)."""
        added = None if conds[0].added is None else torch.cat([c.added for c in conds], dim)
        return Cond(torch.cat([c.ctx for c in conds], dim), added)
