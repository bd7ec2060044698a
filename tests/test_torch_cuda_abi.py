"""The ctypes signatures of the port's kernel libraries against their C
sources, on the CPU (no compiler needed).

`cuda_build` loads each `csrc/<name>.cu` with ctypes and declares every
exported function's argument types in `_SIGNATURES`.  A declaration one
argument short, or an int where the C function takes a pointer, silently
truncates a pointer on the card, so every `extern "C" int` function of
every source is parsed here and held to its declaration: same number of
arguments, `c_void_p` for every pointer, `c_int` for every int and
`c_float` for every float.
"""

import ctypes
import re
from pathlib import Path

import pytest

from freefine_tpu_torch.ops import cuda_build

CSRC = Path(cuda_build.__file__).resolve().parents[1] / "csrc"
_EXTERN = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)', re.S)


def _ctype(arg: str):
    arg = " ".join(arg.split())
    if "*" in arg:
        return ctypes.c_void_p
    kind = arg.rsplit(" ", 1)[0].replace("const ", "")
    return {"int": ctypes.c_int, "float": ctypes.c_float}[kind]


def _exports(source: str) -> dict:
    text = (CSRC / f"{source}.cu").read_text()
    return {name: [_ctype(a) for a in args.split(",")] for name, args in _EXTERN.findall(text)}


def test_kernel_sources_are_the_cu_files():
    assert sorted(cuda_build.KERNEL_SOURCES) == sorted(p.stem for p in CSRC.glob("*.cu"))
    assert set(cuda_build._SIGNATURES) == set(cuda_build.KERNEL_SOURCES)


@pytest.mark.parametrize("source", cuda_build.KERNEL_SOURCES)
def test_signatures_match_the_c_functions(source):
    exports = _exports(source)
    declared = cuda_build._SIGNATURES[source]
    assert exports, f"no extern \"C\" int function parsed from {source}.cu"
    assert set(declared) == set(exports)
    for name, argtypes in exports.items():
        assert declared[name] == argtypes, name


def test_parser_reads_each_argument_kind():
    assert _ctype("const void* q") is ctypes.c_void_p
    assert _ctype("void *stream") is ctypes.c_void_p
    assert _ctype("int  batch") is ctypes.c_int
    assert _ctype("float scale") is ctypes.c_float
