"""Per-stage wall-clock timing (mirrors `freefine_tpu.utils.profiling`'s
`StageTimer`; its `trace` and `annotate`, which wrap `jax.profiler`, are
not ported).

    timer = StageTimer()
    with timer.stage("edit"):
        ...   # the caller decides where the device is synchronised

`BatchedFreeFine` takes a timer as `timer=` and ends each of its stages
with a device synchronise on CUDA, so a stage times its device work.
`GradStepTimer` splits each differentiated step of the gradient baselines
(SelfGuidance, GeoDiffuser, DiffusionHandles, DragDiffusion) into its
forward and backward by CUDA events; `synced_stage` times a baseline's
stages on a `StageTimer`, each ended by a device synchronise.
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


@contextlib.contextmanager
def synced_stage(timer, name: str, device) -> Iterator[None]:
    """`timer.stage(name)` around the body, the device synchronised before
    the stage ends (a CUDA device's work is then inside the stage); no
    timing without a timer."""
    if timer is None:
        yield
        return
    with timer.stage(name):
        yield
        if getattr(device, "type", device) == "cuda":
            import torch

            torch.cuda.synchronize(device)


class NoStepTimer:
    """What a differentiating loop uses without a `GradStepTimer`."""

    def begin(self) -> None:
        pass

    def mark(self, name: str) -> None:
        pass

    def cancel(self) -> None:
        pass


class GradStepTimer:
    """Device time of each differentiated step of a loop, split into its
    forward and its backward: CUDA events recorded on the stream when the
    step begins, when its loss is formed ("forward") and when its gradient
    is taken ("end").  CUDA only; read after a synchronise."""

    def __init__(self):
        self.steps: List[dict] = []

    def begin(self) -> None:
        self._events = {}
        self.steps.append(self._events)
        self.mark("start")

    def mark(self, name: str) -> None:
        import torch

        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self._events[name] = ev

    def cancel(self) -> None:
        """Drop the step begun last (a step that took no gradient)."""
        self.steps.pop()

    def split_ms(self) -> List[Dict[str, float]]:
        """[{"forward", "backward", "total": ms}] per differentiated step."""
        return [dict(forward=ev["start"].elapsed_time(ev["forward"]),
                     backward=ev["forward"].elapsed_time(ev["end"]),
                     total=ev["start"].elapsed_time(ev["end"])) for ev in self.steps]
