"""The port's PNG reader and writer (``data/png.py``) against PIL, exact:
every form TUM uses (8-bit RGB, 8-bit gray, 16-bit gray) under each of
the five row filters and a mix of them, files PIL wrote (its adaptive
filters), the writer's round trip, and a clear error on an interlaced, a
palette, an RGBA and a damaged file."""

import io
import zlib

import numpy as np
import pytest
from PIL import Image

from semantic_slam_master_tpu_torch.data import png

FORMS = {
    "rgb8": lambda rng: rng.integers(0, 256, size=(37, 53, 3), dtype=np.uint8),
    "gray8": lambda rng: rng.integers(0, 256, size=(37, 53), dtype=np.uint8),
    "gray16": lambda rng: rng.integers(0, 65536, size=(37, 53), dtype=np.uint16),
}
FILTERS = ["none", "sub", "up", "average", "paeth", ("paeth", "none", "average", "sub", "up")]


def _smooth(form, rng):
    """A smooth image, on which adaptive encoders pick every filter."""
    y, x = np.mgrid[0:37, 0:53]
    base = (3 * x + 5 * y + rng.integers(0, 4, size=(37, 53)))
    if form == "rgb8":
        return np.stack([base, 2 * base, 255 - base], -1).astype(np.uint8)
    if form == "gray8":
        return base.astype(np.uint8)
    return (base * 97).astype(np.uint16)


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("filters", FILTERS, ids=str)
def test_reader_matches_pil_for_each_filter(form, filters):
    rng = np.random.default_rng(0)
    for img in (FORMS[form](rng), _smooth(form, rng)):
        data = png.encode_png(img, filters)
        ref = np.asarray(Image.open(io.BytesIO(data)))
        got = png.decode_png(data)
        assert got.dtype == img.dtype and got.shape == img.shape
        np.testing.assert_array_equal(ref, img)
        np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("form", sorted(FORMS))
def test_reader_reads_files_pil_wrote(form, tmp_path):
    rng = np.random.default_rng(1)
    for k, img in enumerate((FORMS[form](rng), _smooth(form, rng))):
        path = tmp_path / f"{form}_{k}.png"
        Image.fromarray(img).save(path)
        got = png.read_png(path)
        assert got.dtype == img.dtype
        np.testing.assert_array_equal(got, np.asarray(Image.open(path)))


def test_writer_round_trip(tmp_path):
    rng = np.random.default_rng(2)
    for form, make in FORMS.items():
        img = make(rng)
        path = tmp_path / f"{form}.png"
        png.write_png(path, img, filters=("up", "sub"))
        np.testing.assert_array_equal(png.read_png(path), img)
        assert Image.open(path).size == (img.shape[1], img.shape[0])
    with pytest.raises(ValueError):
        png.encode_png(np.zeros((4, 4), np.float32))


def _pil_bytes(img, **kw):
    buf = io.BytesIO()
    img.save(buf, format="PNG", **kw)
    return buf.getvalue()


def test_interlaced_file_raises():
    rng = np.random.default_rng(3)
    data = bytearray(png.encode_png(rng.integers(0, 256, size=(8, 8, 3), dtype=np.uint8)))
    # IHDR body starts at byte 16; its last byte is the interlace method.
    data[16 + 12] = 1
    body = bytes(data[12:16 + 13])
    data[29:33] = zlib.crc32(body).to_bytes(4, "big")
    with pytest.raises(png.PNGError, match="interlaced"):
        png.decode_png(bytes(data))


@pytest.mark.parametrize("mode", ["P", "RGBA", "1"])
def test_unsupported_forms_raise(mode):
    img = Image.fromarray(np.random.default_rng(4).integers(0, 256, size=(8, 8, 3), dtype=np.uint8)).convert(mode)
    with pytest.raises(png.PNGError, match="unsupported PNG form"):
        png.decode_png(_pil_bytes(img))


def test_corrupt_files_raise(tmp_path):
    good = png.encode_png(np.random.default_rng(5).integers(0, 256, size=(16, 16), dtype=np.uint8))
    flipped = bytearray(good)
    flipped[40] ^= 0xFF  # inside the IDAT data: the chunk's CRC no longer holds
    for bad, match in ((bytes(flipped), "CRC"), (good[:50], "truncated"), (b"not a png", "signature")):
        path = tmp_path / "bad.png"
        path.write_bytes(bad)
        with pytest.raises(png.PNGError, match=match):
            png.read_png(path)
    # A damaged zlib stream under a valid CRC.
    idat = png._chunk(b"IDAT", b"\x78\x9c garbage")
    with pytest.raises(png.PNGError, match="corrupt image data"):
        png.decode_png(good[:33] + idat + png._chunk(b"IEND", b""))
    assert issubclass(png.PNGError, IOError)
