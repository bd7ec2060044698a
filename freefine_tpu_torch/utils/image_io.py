"""PNG files read and written without PIL (the port's counterpart of the
`Image.open(p).convert(mode)` and `np.array(Image.open(p))` calls of the JAX
package's metrics; the card's machine has no PIL).

`read_png` decodes non-interlaced PNGs of bit depth 8 (gray, gray+alpha, RGB,
RGBA, palette) and 1, 2 or 4 (gray, palette) with the standard library's
`zlib`, undoing the five row filters (None, Sub, Up, Average, Paeth).  Its
`mode` converts as PIL's `convert` does:

  * "RGB": alpha dropped, gray replicated, palette looked up;
  * "L": gray as it is (gray+alpha's gray channel), colour by PIL's
    fixed-point luma (19595 R + 38470 G + 7471 B + 0x8000) >> 16;
  * None: the stored mode, as `np.array(Image.open(p))` gives it (L [H, W]
    uint8, 1-bit gray [H, W] bool, LA [H, W, 2], RGB, RGBA, palette
    indices [H, W]).

Interlaced files, 16-bit depths and anything that is not a PNG raise
`ValueError` naming the file.  `write_png` writes 8-bit L or RGB, stored
(level 0) or deflated.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples a pixel
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8), 2: (8,), 3: (1, 2, 4, 8), 4: (8,), 6: (8,)}
# PIL's unpackers stretch 2- and 4-bit gray over 0..255
_GRAY_SCALE = {2: 85, 4: 17, 8: 1}


def _chunks(data: bytes, path: str):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"{path}: truncated PNG chunk {kind!r}")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"{path}: bad CRC in PNG chunk {kind!r}")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{path}: PNG ends without IEND")


def _unfilter_rows(ftype: np.ndarray, x: np.ndarray, bpp: int) -> np.ndarray:
    """Rows of filters None, Sub and Up only: one vectorised step a row."""
    out = np.empty_like(x)
    prev = np.zeros(x.shape[1], np.uint8)
    for r, f in enumerate(ftype):
        line = x[r]
        if f == 0:
            cur = line
        elif f == 2:
            cur = line + prev
        else:  # Sub: a running sum over each byte of the pixel, mod 256
            cur = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        out[r] = cur
        prev = cur
    return out


def _unfilter_wavefront(ftype: np.ndarray, x: np.ndarray, bpp: int) -> np.ndarray:
    """Any filters: byte group (r, g) needs (r, g-1), (r-1, g) and
    (r-1, g-1), so the groups on one anti-diagonal r + g are independent.
    The rows are skewed (row r shifted right by r) so that each diagonal is
    one column, two zero columns and a zero row in front; positions off the
    image stay zero, which is what the filters read past an edge."""
    h, n = x.shape
    g = n // bpp
    cols = g + h - 1
    raw = np.zeros((h, cols + 2, bpp), np.int32)
    rr = np.arange(h)[:, None]
    at = rr + np.arange(g)[None, :] + 2
    raw[rr, at] = x.reshape(h, g, bpp)
    s = np.zeros((h + 1, cols + 2, bpp), np.int32)
    valid = np.zeros((h, cols + 2), bool)
    valid[rr, at] = True
    kind = ftype.astype(np.int32)[:, None]
    for c in range(2, cols + 2):
        a = s[1:, c - 1]
        b = s[:-1, c - 1]
        ul = s[:-1, c - 2]
        p = a + b - ul
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - ul)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, ul))
        pred = np.select([kind == 1, kind == 2, kind == 3, kind == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        col = (raw[:, c] + pred) & 0xFF
        col[~valid[:, c]] = 0
        s[1:, c] = col
    return s[1:][rr, at].reshape(h, n).astype(np.uint8)


def _unpack(rows: np.ndarray, width: int, depth: int, channels: int) -> np.ndarray:
    h = rows.shape[0]
    if depth == 8:
        return rows.reshape(h, width, channels)
    # 1-, 2- or 4-bit samples (one channel), the first in the high bits
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    vals = (rows[:, :, None] >> shifts) & np.uint8((1 << depth) - 1)
    return vals.reshape(h, -1)[:, :width, None]


def _luma(rgb: np.ndarray) -> np.ndarray:
    c = rgb.astype(np.uint32)
    return ((19595 * c[..., 0] + 38470 * c[..., 1] + 7471 * c[..., 2] + 0x8000) >> 16) \
        .astype(np.uint8)


def read_png(path: str, mode: Optional[str] = None) -> np.ndarray:
    """The PNG at `path` as a numpy array, converted to `mode` ("RGB", "L"
    or None for the stored mode) as PIL converts (see the module's
    docstring)."""
    if mode not in (None, "RGB", "L"):
        raise ValueError(f"read_png: mode {mode!r} is not one of None, 'RGB', 'L'")
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, palette, idat = None, None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    width, height, depth, ctype, _, _, interlace = header
    if ctype not in _CHANNELS or depth not in _DEPTHS[ctype]:
        raise ValueError(f"{path}: PNG colour type {ctype} at bit depth {depth} is not "
                         "supported (8-bit gray, gray+alpha, RGB, RGBA, palette; 1-4-bit gray "
                         "and palette)")
    if interlace:
        raise ValueError(f"{path}: interlaced PNGs are not supported")
    if ctype == 3 and palette is None:
        raise ValueError(f"{path}: palette PNG without PLTE")
    channels = _CHANNELS[ctype]
    bpp = max(1, depth * channels // 8)
    rowbytes = (width * channels * depth + 7) // 8
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{path}: corrupt PNG image data ({e})") from None
    if len(raw) < height * (rowbytes + 1):
        raise ValueError(f"{path}: PNG image data too short")
    lines = np.frombuffer(raw, np.uint8)[:height * (rowbytes + 1)].reshape(height, rowbytes + 1)
    ftype, x = lines[:, 0], lines[:, 1:]
    if ftype.max(initial=0) > 4:
        raise ValueError(f"{path}: unknown PNG row filter {int(ftype.max())}")
    if np.isin(ftype, (3, 4)).any():
        rows = _unfilter_wavefront(ftype, x, bpp)
    else:
        rows = _unfilter_rows(ftype, x, bpp)
    px = _unpack(rows, width, depth, channels)

    if ctype == 3:  # palette: PIL pads a short palette with black
        lut = np.zeros((256, 3), np.uint8)
        lut[:len(palette)] = palette[:256]
        idx = px[..., 0]
        if mode is None:
            return idx.copy()
        rgb = lut[idx]
        return rgb if mode == "RGB" else _luma(rgb)
    if ctype == 0:
        gray = px[..., 0]
        if depth == 1:
            if mode is None:
                return gray.astype(bool)
            gray = gray * np.uint8(255)
        else:
            gray = gray * np.uint8(_GRAY_SCALE[depth])
        if mode == "RGB":
            return np.repeat(gray[..., None], 3, axis=2)
        return gray.copy()
    if ctype == 4:
        if mode is None:
            return px.copy()
        gray = px[..., 0]
        return np.repeat(gray[..., None], 3, axis=2) if mode == "RGB" else gray.copy()
    # RGB, RGBA
    if mode is None:
        return px.copy()
    rgb = px[..., :3]
    return rgb.copy() if mode == "RGB" else _luma(rgb)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def write_png(path: str, img: np.ndarray, level: int = 6) -> None:
    """Write uint8 [H, W] (L) or [H, W, 3] (RGB) as an 8-bit PNG, every row
    unfiltered, deflated at zlib `level` (0: stored)."""
    a = np.asarray(img)
    if a.dtype != np.uint8 or not (a.ndim == 2 or (a.ndim == 3 and a.shape[2] == 3)):
        raise ValueError(f"write_png: needs uint8 [H, W] or [H, W, 3], got {a.dtype} "
                         f"{a.shape}")
    h, w = a.shape[:2]
    ctype = 0 if a.ndim == 2 else 2
    lines = np.zeros((h, 1 + a[0].size), np.uint8)
    lines[:, 1:] = a.reshape(h, -1)
    header = struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", header)
                + _chunk(b"IDAT", zlib.compress(lines.tobytes(), level))
                + _chunk(b"IEND", b""))
