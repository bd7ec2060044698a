"""Build and load the port's CUDA kernels (plain C interface, ctypes).

Each `csrc/<name>.cu` is compiled by `nvcc` for sm_90a into its own shared
library under `build/kernels/` at the repository root (listed in
.gitignore).  The library name carries a hash of the sources and flags, so
an edited source is rebuilt and an unchanged one is loaded as it is.
`build_all()` starts one `nvcc` per source at once and waits for all of
them.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
KERNEL_SOURCES = ("flash_sdpa", "tca_flash", "flash_sdpa_bwd", "tca_flash_bwd", "group_norm")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# library -> {exported function: argument types}
_SIGNATURES = {
    "flash_sdpa": {
        "flash_sdpa_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P],
        "flash_sdpa_fwd_lse": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P],
        "flash_sdpa_smem_bytes": [_I, _I],
    },
    "tca_flash": {
        "tca_flash_fwd": [_P, _P, _P, _P, _P, _P, _P, _F, _P, _I, _I, _I, _I, _F, _I, _P],
        "tca_flash_fwd_lse": [_P, _P, _P, _P, _P, _P, _P, _F, _P, _P, _P, _I, _I, _I, _I, _F, _I,
                              _P],
    },
    "tca_flash_bwd": {
        "tca_flash_bwd_dq": [_P, _P, _P, _P, _P, _P, _P, _F, _P, _P, _P, _P, _I, _I, _I, _I, _F,
                             _I, _P],
        "tca_flash_bwd_dkv": [_P, _P, _P, _P, _P, _P, _P, _F, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                              _I, _I, _F, _I, _P],
        "tca_flash_bwd_smem_bytes": [_I, _I, _I],
    },
    "flash_sdpa_bwd": {
        "flash_sdpa_bwd_dq": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P],
        "flash_sdpa_bwd_dkv": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I,
                               _P],
        "flash_sdpa_bwd_smem_bytes": [_I, _I, _I],
    },
    "group_norm": {
        "group_norm_silu_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _I, _I, _I, _I, _I,
                                _I, _I, _P],
        "group_norm_active_clusters": [_I, _I, _I, _I, _I],
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine "
                           "with the CUDA toolkit (CUDA_HOME or PATH)")
    return found


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(_CSRC.glob("*.cuh")) + [_CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Iterable[str] = KERNEL_SOURCES) -> Dict[str, Path]:
    """Compile every named kernel whose library is missing, all `nvcc`
    processes in parallel; raise with the compiler output on failure.
    The ptxas report (registers, shared memory, spills) of each build is
    kept beside its library as `<lib>.log`."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {n: _target(n) for n in names}
    procs = {}
    for n, out in targets.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True), tmp)
    failed = []
    for n, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        targets[n].with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{n}: nvcc exited {proc.returncode}\n{log}")
        else:
            os.replace(tmp, targets[n])
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return targets


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library `name`, building it on first use."""
    if name not in _LIBS:
        path = build_all([name])[name]
        lib = ctypes.CDLL(str(path))
        for fn_name, argtypes in _SIGNATURES[name].items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.ff_error_string.argtypes = [ctypes.c_int]
        lib.ff_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return _LIBS[name]


def check(lib: ctypes.CDLL, name: str, code: int) -> None:
    """Raise if a launch returned a CUDA error."""
    if code != 0:
        msg = lib.ff_error_string(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {code} ({msg})")
