"""The port's PNG reader and writer (`freefine_tpu_torch.utils.image_io`)
against PIL, bit for bit.

PIL writes every file in `tmp_path`: 8-bit gray, gray+alpha, RGB, RGBA and
palette (a full palette and short ones, which PIL writes at 1, 2 or 4 bits),
1-bit gray; smooth and noisy images, with and without `optimize`; and RGB
files written here with each of the five row filters, alone and mixed.  `read_png` must equal
`np.array(Image.open(p))` (mode None) and `np.array(Image.open(p).convert(m))`
for m in "RGB", "L": dtype, shape and every value.  Interlaced files, 16-bit
depths and files that are not PNGs raise; `write_png`'s files read back
equal through PIL and through `read_png`, stored and deflated.
"""

import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from freefine_tpu_torch.utils.image_io import read_png, write_png

MODES = ("L", "LA", "RGB", "RGBA", "P", "P_short", "1")


def _image(mode: str, h: int, w: int, seed: int, smooth: bool) -> Image.Image:
    rng = np.random.default_rng(seed)
    if mode == "1":
        return Image.fromarray(rng.integers(0, 2, (h, w)).astype(bool))
    if mode.startswith("P"):
        colours = 256 if mode == "P" else int(rng.integers(2, 17))
        img = Image.fromarray(rng.integers(0, colours, (h, w)).astype(np.uint8), "P")
        img.putpalette(rng.integers(0, 256, 3 * colours).astype(np.uint8).tolist())
        return img
    ch = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}[mode]
    a = rng.integers(0, 256, (h, w, ch))
    if smooth:  # gradients: PIL's filter choice turns to Sub, Up, Average, Paeth
        a = (np.cumsum(a // 32, axis=1) + np.arange(h)[:, None, None]) % 256
    a = a.astype(np.uint8)
    return Image.fromarray(a[..., 0] if ch == 1 else a, mode)


def _filters(path) -> set:
    """The row filter types of a PNG written by PIL."""
    data = open(path, "rb").read()
    pos, idat, hdr = 8, b"", None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, depth, ctype = hdr[:4]
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    row = (w * ch * depth + 7) // 8 + 1
    raw = zlib.decompress(idat)
    return {raw[r * row] for r in range(h)}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("smooth,optimize", [(False, False), (True, False), (True, True)])
def test_read_png_matches_pil(tmp_path, mode, smooth, optimize):
    for seed, (h, w) in enumerate([(1, 1), (7, 13), (33, 20), (64, 64)]):
        p = tmp_path / f"{mode}_{seed}.png"
        _image(mode, h, w, seed, smooth).save(p, optimize=optimize)
        pil = Image.open(p)
        for m in (None, "RGB", "L"):
            want = np.array(pil if m is None else pil.convert(m))
            got = read_png(str(p), m)
            assert got.dtype == want.dtype and got.shape == want.shape, (m, got.shape, want.shape)
            assert np.array_equal(got, want), (mode, m, seed)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _png_with_filters(a: np.ndarray, filters) -> bytes:
    """An 8-bit RGB PNG of `a` whose row r is written with filter
    filters[r % len(filters)], filtered byte by byte as the PNG
    specification states it."""
    h, w, _ = a.shape
    x = a.reshape(h, -1).astype(int)
    out = b""
    for r in range(h):
        f = filters[r % len(filters)]
        line = []
        for i in range(x.shape[1]):
            left = x[r, i - 3] if i >= 3 else 0
            up = x[r - 1, i] if r else 0
            ul = x[r - 1, i - 3] if r and i >= 3 else 0
            p = left + up - ul
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - ul)
            paeth = left if pa <= pb and pa <= pc else (up if pb <= pc else ul)
            pred = (0, left, up, (left + up) // 2, paeth)[f]
            line.append((x[r, i] - pred) % 256)
        out += bytes([f] + line)
    head = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", head) + _chunk(b"IDAT", zlib.compress(out))
            + _chunk(b"IEND", b""))


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4),
                                     (4, 3, 3, 1, 2)])
def test_each_row_filter_decodes_as_pil(tmp_path, filters):
    """PIL's own files use None, Sub, Up and Paeth; rows written with each
    of the five filters, alone and mixed (the Average and Paeth rows take
    the wavefront decoder), read as PIL reads them."""
    a = np.random.default_rng(len(filters)).integers(0, 256, (11, 9, 3), dtype=np.uint8)
    a[4:] = np.cumsum(a[4:], axis=1, dtype=np.uint8)
    p = tmp_path / "filtered.png"
    p.write_bytes(_png_with_filters(a, filters))
    assert _filters(p) == set(filters)
    assert np.array_equal(np.array(Image.open(p)), a)
    assert np.array_equal(read_png(str(p)), a)
    assert np.array_equal(read_png(str(p), "L"), np.array(Image.open(p).convert("L")))


def test_interlaced_16_bit_and_other_files_raise(tmp_path):
    rgb = np.random.default_rng(0).integers(0, 256, (9, 11, 3), dtype=np.uint8)
    plain = _png_with_filters(rgb, (0,))
    # IHDR's last byte: interlace method 1 (Adam7), the CRC recomputed
    head = struct.pack(">IIBBBBB", 11, 9, 8, 2, 0, 0, 1)
    interlaced = tmp_path / "interlaced.png"
    interlaced.write_bytes(plain[:8] + _chunk(b"IHDR", head) + plain[33:])
    assert Image.open(interlaced).info.get("interlace") == 1
    deep = tmp_path / "deep.png"
    Image.fromarray(np.arange(99, dtype=np.uint16).reshape(9, 11) * 600).save(deep)
    assert Image.open(deep).mode.startswith("I;16")
    jpeg = tmp_path / "photo.jpg"
    Image.fromarray(rgb).save(jpeg)
    for path, what in ((interlaced, "interlaced"), (deep, "bit depth 16"),
                       (jpeg, "not a PNG")):
        with pytest.raises(ValueError, match=what) as err:
            read_png(str(path), "RGB")
        assert str(path) in str(err.value)


@pytest.mark.parametrize("level", [0, 6])
def test_write_png_reads_back(tmp_path, level):
    rng = np.random.default_rng(level)
    for a in (rng.integers(0, 256, (17, 23, 3), dtype=np.uint8),
              rng.integers(0, 256, (5, 64), dtype=np.uint8)):
        p = tmp_path / f"w{a.ndim}.png"
        write_png(str(p), a, level=level)
        assert np.array_equal(np.array(Image.open(p)), a)
        assert np.array_equal(read_png(str(p)), a)
    with pytest.raises(ValueError):
        write_png(str(tmp_path / "bad.png"), np.zeros((4, 4, 4), np.uint8))
