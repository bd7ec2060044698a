"""Per-stage wall-clock timing (mirrors `freefine_tpu.utils.profiling`'s
`StageTimer`; its `trace` and `annotate`, which wrap `jax.profiler`, are
not ported).

    timer = StageTimer()
    with timer.stage("edit"):
        ...   # the caller decides where the device is synchronised

`BatchedFreeFine` takes a timer as `timer=` and ends each of its stages
with a device synchronise on CUDA, so a stage times its device work.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator, List


class StageTimer:
    """Accumulates wall-clock timings per named stage."""

    def __init__(self):
        self.records: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.records[name].append(time.perf_counter() - t0)

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "count": len(vals),
                "total_s": sum(vals),
                "mean_s": sum(vals) / len(vals),
                "min_s": min(vals),
                "max_s": max(vals),
            }
            for name, vals in self.records.items()
        }

    def report(self) -> str:
        return "\n".join(
            f"{name:>16}: n={s['count']:<4} mean={s['mean_s'] * 1e3:8.1f}ms "
            f"min={s['min_s'] * 1e3:8.1f}ms max={s['max_s'] * 1e3:8.1f}ms "
            f"total={s['total_s']:6.2f}s"
            for name, s in sorted(self.summary().items())
        )
