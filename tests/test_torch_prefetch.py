"""The port's prefetch (``data/prefetch.py``) against the JAX package's on
the CPU: items in order, a producer's error raised in the consumer, and
``frame_chunks``' chunks, padded tail and ``count`` equal to JAX's bit for
bit. On the CPU the transfer is the identity: the chunks' tensors share
the decoded arrays' memory. (The pinned copies to the card are checked on
the card by chip_smoke.py.)"""

import numpy as np
import pytest
import torch
from PIL import Image

from semantic_slam_master_tpu.data import prefetch as jprefetch
from semantic_slam_master_tpu_torch.data import prefetch


def test_prefetch_preserves_order_and_values():
    batches = [{"x": np.full((4,), i, np.float32)} for i in range(7)]
    out = list(prefetch.prefetch(iter(batches), buffer_size=2))
    ref = list(jprefetch.prefetch(iter(batches), buffer_size=2))
    assert len(out) == len(ref) == 7
    for i, (b, r) in enumerate(zip(out, ref)):
        np.testing.assert_array_equal(b["x"], np.asarray(r["x"]))
        assert b["x"][0] == i


def test_prefetch_applies_transfer_in_order():
    out = list(prefetch.prefetch(iter(range(9)), buffer_size=3, transfer=lambda x: x * x))
    assert out == [i * i for i in range(9)]


def test_prefetch_propagates_errors():
    def gen():
        yield {"x": np.zeros(2)}
        raise ValueError("decode failed")

    it = prefetch.prefetch(gen(), buffer_size=1)
    next(it)
    with pytest.raises(ValueError, match="decode failed"):
        list(it)


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    root = tmp_path_factory.mktemp("chunks")
    rng = np.random.default_rng(0)
    rgb_paths, depth_paths = [], []
    for i in range(5):
        rp, dp = root / f"r{i}.png", root / f"d{i}.png"
        Image.fromarray(rng.integers(0, 256, size=(24, 32, 3), dtype=np.uint8)).save(rp)
        Image.fromarray(rng.integers(100, 20000, size=(24, 32), dtype=np.uint16)).save(dp)
        rgb_paths.append(rp)
        depth_paths.append(dp)
    return rgb_paths, depth_paths


@pytest.mark.parametrize("chunk,to_gray", [(2, True), (3, False), (5, True), (8, True)])
def test_frame_chunks_match_jax(frames, chunk, to_gray):
    rgb_paths, depth_paths = frames
    kw = dict(chunk=chunk, width=32, height=24, to_gray=to_gray)
    got = list(prefetch.frame_chunks(rgb_paths, depth_paths, device="cpu", **kw))
    ref = list(jprefetch.frame_chunks(rgb_paths, depth_paths, **kw))
    assert len(got) == len(ref) == -(-5 // chunk)
    for g, r in zip(got, ref):
        assert g.keys() == r.keys()
        assert int(g["count"]) == int(r["count"]) and g["count"].dtype == np.int32
        for k in g:
            if k == "count":
                continue
            assert isinstance(g[k], torch.Tensor) and g[k].device.type == "cpu"
            np.testing.assert_array_equal(g[k].numpy().view(np.uint32), np.asarray(r[k]).view(np.uint32))
    tail = got[-1]["gray" if to_gray else "rgb"]
    for i in range(int(got[-1]["count"]), chunk):  # the padded frames repeat the last real one
        assert torch.equal(tail[i], tail[int(got[-1]["count"]) - 1])


def test_cpu_transfer_is_the_identity():
    arr = np.arange(6, dtype=np.float32)
    t = prefetch.PinnedTransfer("cpu", 3)
    out = t({"a": arr, "count": np.int32(2)})
    assert out["count"] == 2 and "_event" not in out
    arr[0] = 42.0
    assert out["a"][0] == 42.0  # shares the host array's memory
    assert t.pinned_copies == 0
