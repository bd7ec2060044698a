"""`bench_torch.py`, the port's throughput benchmark, on the CPU at the
tiny configuration: each lane (SD-1.5's, SDXL's with `--sdxl` and the
DiT's with `--dit`) prints one JSON line with `bench.py`'s keys (and the
port's own), and the lanes that are not ported exit non-zero."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "lane")
PORT_KEYS = ("median_s_per_edit", "max_s_per_edit", "peak_memory_gib", "fused_gn", "card",
             "backbone")


def _bench(*flags):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, str(ROOT / "bench_torch.py"), *flags], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("flags,lane", [
    (("--batch", "2"), "per-case batch 2"),
    (("--batch", "2", "--shared"), "shared-source batch 2"),
    ((), "per-case batch 1"),
    (("--sdxl",), "per-case batch 1"),
    (("--dit",), "per-case batch 1"),
])
def test_tiny_cpu_lanes_print_one_json_line(flags, lane):
    out = _bench("--tiny", "--device", "cpu", "--steps", "2", "--repeats", "1", *flags)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1
    result = json.loads(lines[0])
    assert all(k in result for k in BENCH_KEYS + PORT_KEYS)
    assert result["lane"] == lane and result["unit"] == "edits/min"
    assert result["value"] > 0 and abs(result["vs_baseline"] - result["value"] / 20.0) <= 1e-3
    assert result["max_s_per_edit"] >= result["median_s_per_edit"] > 0
    assert result["card"] is None and result["peak_memory_gib"] is None
    assert result["backbone"] == ("sdxl" if "--sdxl" in flags else "dit" if "--dit" in flags
                                  else "sd15")


@pytest.mark.parametrize("flag", ["--mesh", "--sp"])
def test_unported_lanes_exit_non_zero(flag):
    out = _bench("--tiny", "--device", "cpu", flag, *(["data=1,model=1"] if flag == "--mesh"
                                                      else []))
    assert out.returncode != 0 and out.stdout == ""
    assert "ROADMAP A1" in out.stderr
