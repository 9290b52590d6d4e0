"""The 4-point early test of the port's FAST-9 kernel, stated in plain
PyTorch (``fast_candidates_plain``): a pixel it rejects has a response of
exactly 0, so the kernel may skip its 16-point chain and stay bit-exact.
Checked on the CPU against the plain response on noise, smooth texture
and rendered frames of the synthetic world (every pyramid level)."""

import numpy as np
import pytest
import torch

from semantic_slam_master_tpu_torch.cli.run_slam_cli import render_all
from semantic_slam_master_tpu_torch.data import synthetic
from semantic_slam_master_tpu_torch.ops.kernels import fast_score as kfast
from semantic_slam_master_tpu_torch.slam import tracking


def _images():
    rng = np.random.default_rng(0)
    noise = torch.from_numpy(rng.uniform(0, 1, (2, 61, 83)).astype(np.float32))
    coarse = torch.from_numpy(rng.uniform(0, 1, (2, 1, 9, 12)).astype(np.float32))
    smooth = torch.nn.functional.interpolate(coarse, size=(64, 96), mode="bilinear")[:, 0].contiguous()
    _, gray, _, _ = render_all(synthetic.make_sequence(num_frames=2, scale=0.5))
    levels = tracking.build_pyramid(torch.from_numpy(gray), 4)
    return {"noise": [noise], "smooth": [smooth], "rendered": levels, "tiny": [noise[:1, :7, :5]]}


IMAGES = _images()


@pytest.mark.parametrize("threshold", [0.05, 0.08, 0.0])
@pytest.mark.parametrize("kind", sorted(IMAGES))
def test_rejected_pixels_score_zero(kind, threshold):
    for img in IMAGES[kind]:
        score = kfast.fast_score_plain(img, threshold)
        cand = kfast.fast_candidates_plain(img, threshold)
        assert cand.shape == img.shape and cand.dtype == torch.bool
        assert torch.equal(score[~cand], torch.zeros_like(score[~cand]))
        assert bool(cand[score > 0].all())


def test_early_test_rejects_most_of_a_rendered_frame():
    cand = kfast.fast_candidates_plain(IMAGES["rendered"][0], 0.05)
    assert 0.0 < float(cand.float().mean()) < 0.5
