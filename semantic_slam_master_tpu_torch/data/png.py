"""PNG reading and writing in numpy and the standard library's ``zlib``.

The port's stand-in for the PNG input/output that PIL does in the JAX
package: ``read_png`` decodes the forms TUM RGB-D uses (8-bit RGB, 8-bit
gray, 16-bit big-endian gray), non-interlaced, with any of the five row
filters, whichever encoder wrote them; anything else (palettes, alpha,
other bit depths, Adam7 interlacing) raises ``PNGError``, as does a
damaged file (bad signature, CRC or zlib stream). ``write_png`` writes
the same forms with a chosen row filter. It is also the plain version of
the native loader (``data/native_io.py``).

Cost: None, Sub and Up rows decode vectorised over the row. Average and
Paeth rows depend on the pixel to their left, so an image that holds one
is reconstructed along anti-diagonals (every pixel of one diagonal at
once, H + W steps), which is several times slower per frame.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
FILTERS = {"none": 0, "sub": 1, "up": 2, "average": 3, "paeth": 4}
# (color type, bit depth) -> channels, for the forms this module takes.
FORMS = {(0, 8): 1, (0, 16): 1, (2, 8): 3}
_COLOR_NAMES = {0: "gray", 2: "RGB", 3: "palette", 4: "gray + alpha", 6: "RGBA"}


class PNGError(IOError):
    """A file this module cannot decode: damaged, or a PNG form it does not take."""


def read_png(path: str | Path) -> np.ndarray:
    """(H, W, 3) or (H, W) uint8, or (H, W) uint16 for 16-bit gray."""
    return decode_png(Path(path).read_bytes(), name=str(path))


def _chunks(data: bytes, name: str):
    pos = 8
    while True:
        if pos + 8 > len(data):
            raise PNGError(f"{name}: truncated before IEND")
        length, ctype = struct.unpack(">I4s", data[pos : pos + 8])
        body = data[pos + 8 : pos + 8 + length]
        crc = data[pos + 8 + length : pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise PNGError(f"{name}: truncated {ctype!r} chunk")
        if zlib.crc32(ctype + body) != struct.unpack(">I", crc)[0]:
            raise PNGError(f"{name}: CRC mismatch in the {ctype.decode('latin-1')} chunk")
        pos += 12 + length
        yield ctype, body
        if ctype == b"IEND":
            return


def decode_png(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """``read_png`` of the bytes of a file."""
    if data[:8] != SIGNATURE:
        raise PNGError(f"{name}: not a PNG file (bad signature)")
    header, idat = None, []
    for ctype, body in _chunks(data, name):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype != b"IEND" and not ctype[0] & 0x20 and ctype != b"PLTE":
            raise PNGError(f"{name}: unknown critical chunk {ctype!r}")
    if header is None:
        raise PNGError(f"{name}: no IHDR chunk")
    width, height, bit_depth, color_type, compression, filter_method, interlace = header
    if interlace:
        raise PNGError(f"{name}: interlaced (Adam7) PNG files are not supported")
    channels = FORMS.get((color_type, bit_depth))
    if channels is None:
        raise PNGError(
            f"{name}: unsupported PNG form, {_COLOR_NAMES.get(color_type, color_type)} at {bit_depth} bits "
            "(this reader takes 8-bit RGB, 8-bit gray and 16-bit gray)")
    if compression or filter_method:
        raise PNGError(f"{name}: unknown compression {compression} or filter method {filter_method}")
    bpp = channels * bit_depth // 8
    stride = width * bpp
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise PNGError(f"{name}: corrupt image data ({e})") from None
    if len(raw) != height * (stride + 1):
        raise PNGError(f"{name}: image data holds {len(raw)} bytes, expected {height * (stride + 1)}")
    rows = np.frombuffer(raw, np.uint8).reshape(height, stride + 1)
    ftypes = rows[:, 0]
    if (ftypes > 4).any():
        raise PNGError(f"{name}: unknown row filter {int(ftypes.max())}")
    out = _unfilter(ftypes, rows[:, 1:], bpp)
    if bit_depth == 16:
        return out.view(">u2").reshape(height, width).astype(np.uint16)
    return out.reshape(height, width, channels) if channels == 3 else out.reshape(height, width)


def _unfilter(ftypes: np.ndarray, filt: np.ndarray, bpp: int) -> np.ndarray:
    """Reconstructed (H, stride) bytes of filtered rows."""
    H, stride = filt.shape
    if (ftypes <= 2).all():
        out = np.empty_like(filt)
        prev = np.zeros(stride, np.uint8)
        for r in range(H):
            f, row = ftypes[r], filt[r]
            if f == 2:
                row = row + prev
            elif f == 1:
                row = np.cumsum(row.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
            out[r] = prev = row
        return out
    return _unfilter_diagonals(ftypes, filt, bpp)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter_diagonals(ftypes: np.ndarray, filt: np.ndarray, bpp: int) -> np.ndarray:
    """Any mix of the five filters: each byte depends on the bytes to its
    left, above and above-left, so every pixel of one anti-diagonal
    r + x = t is reconstructed at once, for t = 0 .. H + W - 2."""
    H, stride = filt.shape
    W = stride // bpp
    raw = filt.reshape(H, W, bpp).astype(np.int32)
    rec = np.zeros((H + 1, W + 1, bpp), np.int32)  # a zero row above, a zero column left
    ft = ftypes.astype(np.int32)
    for t in range(H + W - 1):
        rs = np.arange(max(0, t - W + 1), min(H - 1, t) + 1)
        xs = t - rs
        a, b, c = rec[rs + 1, xs], rec[rs, xs + 1], rec[rs, xs]
        f = ft[rs][:, None]
        pred = np.select([f == 1, f == 2, f == 3, f == 4], [a, b, (a + b) >> 1, _paeth(a, b, c)], 0)
        rec[rs + 1, xs + 1] = (raw[rs, xs] + pred) & 255
    return rec[1:, 1:].astype(np.uint8).reshape(H, stride)


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + ctype + body + struct.pack(">I", zlib.crc32(ctype + body))


def encode_png(img: np.ndarray, filters="up", level: int = 6) -> bytes:
    """PNG bytes of (H, W) or (H, W, 3) uint8 or (H, W) uint16.

    ``filters`` names the row filter (a key of ``FILTERS`` or its code) or
    gives one per row (cycled over the rows)."""
    img = np.asarray(img)
    if img.dtype == np.uint8 and img.ndim == 2:
        color, depth, data = 0, 8, img
    elif img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3:
        color, depth, data = 2, 8, img
    elif img.dtype == np.uint16 and img.ndim == 2:
        color, depth, data = 0, 16, img.astype(">u2")
    else:
        raise ValueError(f"cannot write {img.dtype} {img.shape}: takes (H, W) or (H, W, 3) uint8, (H, W) uint16")
    H, W = img.shape[:2]
    bpp = (3 if color == 2 else 1) * depth // 8
    rows = np.ascontiguousarray(data).view(np.uint8).reshape(H, W * bpp).astype(np.int32)
    codes = [FILTERS.get(filters, filters)] if isinstance(filters, (str, int)) else [
        FILTERS.get(f, f) for f in filters]
    ftypes = np.resize(np.asarray(codes, np.int32), H)[:, None]
    up = np.zeros_like(rows)
    up[1:] = rows[:-1]
    left = np.zeros_like(rows)
    left[:, bpp:] = rows[:, :-bpp]
    upleft = np.zeros_like(rows)
    upleft[:, bpp:] = up[:, :-bpp]
    pred = np.select([ftypes == 1, ftypes == 2, ftypes == 3, ftypes == 4],
                     [left, up, (left + up) >> 1, _paeth(left, up, upleft)], 0)
    body = np.concatenate([ftypes, (rows - pred) & 255], axis=1).astype(np.uint8)
    ihdr = struct.pack(">IIBBBBB", W, H, depth, color, 0, 0, 0)
    return SIGNATURE + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", zlib.compress(body.tobytes(), level)) + _chunk(
        b"IEND", b"")


def write_png(path: str | Path, img: np.ndarray, filters="up", level: int = 6) -> None:
    """Write ``encode_png(img, filters, level)`` to ``path``."""
    Path(path).write_bytes(encode_png(img, filters, level))
