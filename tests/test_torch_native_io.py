"""The port's native loader bindings (``data/native_io.py``, the repo's
``native/semslam_io.cpp`` built into the port's ``_build/``) against the
JAX package's ``native_io.load_batch``, and the plain decoder against the
native one: all bit for bit (compared as uint32 bit patterns). Also an
``IOError`` naming the bad frame, rgb-only batches, and the fall-back to
the plain decoder, named by ``decoder()``, when the library does not build."""

import numpy as np
import pytest
from PIL import Image

from semantic_slam_master_tpu.data import native_io as jnative_io
from semantic_slam_master_tpu_torch.data import native_io, png

H, W = 48, 64


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """TUM-like PNGs: RGB8 and 16-bit depth written by PIL, and by the port's
    writer an 8-bit gray colour frame and an 8-bit depth frame."""
    root = tmp_path_factory.mktemp("pngs")
    rng = np.random.default_rng(0)
    rgb_paths, depth_paths = [], []
    for i in range(5):
        rp, dp = root / f"rgb_{i}.png", root / f"depth_{i}.png"
        if i == 4:
            png.write_png(rp, rng.integers(0, 256, size=(H, W), dtype=np.uint8), "paeth")
            png.write_png(dp, rng.integers(0, 256, size=(H, W), dtype=np.uint8), "average")
        else:
            Image.fromarray(rng.integers(0, 256, size=(H, W, 3), dtype=np.uint8)).save(rp)
            Image.fromarray(rng.integers(0, 65536, size=(H, W), dtype=np.uint16)).save(dp)
        rgb_paths.append(rp)
        depth_paths.append(dp)
    return rgb_paths, depth_paths


def test_native_loader_builds_into_the_port():
    assert native_io.available(), native_io.decoder()
    d = native_io.decoder()
    assert d["name"] == "native" and d["build_error"] is None
    assert "semantic_slam_master_tpu_torch/_build" in d["library"]


def test_png_info(frames):
    rgb_paths, depth_paths = frames
    assert native_io.png_info(rgb_paths[0]) == jnative_io.png_info(rgb_paths[0]) == (W, H, 3, 8)
    assert native_io.png_info(depth_paths[0]) == (W, H, 1, 16)


@pytest.mark.parametrize("depth_scale", [5000.0, 1000.0])
def test_load_batch_matches_jax_native_bit_for_bit(frames, depth_scale):
    rgb_paths, depth_paths = frames
    got = native_io.load_batch(rgb_paths, depth_paths, width=W, height=H, depth_scale=depth_scale)
    ref = jnative_io.load_batch(rgb_paths, depth_paths, width=W, height=H, depth_scale=depth_scale)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == np.float32
        np.testing.assert_array_equal(_bits(g), _bits(r))


@pytest.mark.parametrize("depth_scale", [5000.0, 1000.0])
def test_plain_decoder_matches_native_bit_for_bit(frames, depth_scale):
    rgb_paths, depth_paths = frames
    native = native_io.load_batch(rgb_paths, depth_paths, width=W, height=H, depth_scale=depth_scale)
    plain = native_io.load_batch_plain(rgb_paths, depth_paths, width=W, height=H, depth_scale=depth_scale)
    for n, p in zip(native, plain):
        np.testing.assert_array_equal(_bits(p), _bits(n))
    # The loader multiplies by float32 reciprocals; dividing differs by an
    # ulp on some values, which is why the two paths are kept apart.
    divided = np.asarray(Image.open(rgb_paths[0]), np.float32) / 255.0
    assert (divided != native[0][0]).any()


def test_rgb_only_batches(frames):
    rgb_paths, _ = frames
    for load in (native_io.load_batch, native_io.load_batch_plain):
        rgb, depth = load(rgb_paths, None, width=W, height=H)
        assert depth is None and rgb.shape == (5, H, W, 3)
    ref, _ = jnative_io.load_batch(rgb_paths, None, width=W, height=H)
    np.testing.assert_array_equal(_bits(native_io.load_batch(rgb_paths, None, width=W, height=H)[0]), _bits(ref))


def test_bad_files_raise_ioerror(frames, tmp_path):
    rgb_paths, depth_paths = frames
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"\x89PNG\r\n\x1a\n truncated")
    for load in (native_io.load_batch, native_io.load_batch_plain):
        with pytest.raises(IOError, match="bad.png"):
            load(rgb_paths[:2] + [bad], depth_paths[:3], width=W, height=H)
        with pytest.raises(IOError):  # a frame of another size
            load(rgb_paths[:1], depth_paths[:1], width=W + 1, height=H)
    with pytest.raises(IOError):
        native_io.png_info(bad)


def test_falls_back_to_the_plain_decoder_when_the_build_fails(frames, monkeypatch):
    rgb_paths, depth_paths = frames
    native = native_io.load_batch(rgb_paths, depth_paths, width=W, height=H)

    def no_compiler():
        raise RuntimeError("no C++ compiler (g++) on PATH")

    monkeypatch.setattr(native_io, "_state", {})
    monkeypatch.setattr(native_io, "LIB_PATH", native_io.BUILD_DIR / "missing" / "libsemslam_io.so")
    monkeypatch.setattr(native_io, "build", no_compiler)
    assert native_io.decoder() == {"name": "plain", "library": None,
                                   "build_error": "no C++ compiler (g++) on PATH"}
    plain = native_io.load_batch(rgb_paths, depth_paths, width=W, height=H)
    for n, p in zip(native, plain):
        np.testing.assert_array_equal(_bits(p), _bits(n))
