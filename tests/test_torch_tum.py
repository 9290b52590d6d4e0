"""The port's TUM input (``data/tum.py``, ``core/camera.py``'s
``camera_for_sequence``) against the JAX package on the CPU, on a
miniature TUM directory like tests/test_tum_dataset.py's (timestamp-named
PNGs written by PIL, ground truth at twice the frame rate, here with
non-trivial quaternions). Everything is exact (``assert_array_equal``,
floats compared as bit patterns): file lists, timestamps, ground-truth
poses (rotations rounded in float32 as JAX rounds them), ``frame``,
``load_all_gray_depth``, ``pair`` with and without an augmentation seed,
``batch_pairs``, the resize and augmentation helpers, and a directory
written by ``write_tum_sequence`` read back by both packages; and the
port's ``read_tum_trajectory`` (``evaluate``'s ground-truth reader)
rounding its rotations as JAX's does."""

import numpy as np
import pytest
from PIL import Image

from semantic_slam_master_tpu.core import camera as jcamera
from semantic_slam_master_tpu.data import tum as jtum
from semantic_slam_master_tpu_torch.core import camera as pcamera
from semantic_slam_master_tpu.data import trajectory_io as jtrajectory_io
from semantic_slam_master_tpu_torch.data import synthetic, trajectory_io, tum

N = 6


def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    if a.dtype.kind == "f":
        a, b = a.view(f"u{a.itemsize}"), b.view(f"u{b.itemsize}")
    np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def tum_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("tum") / "rgbd_dataset_freiburg1_fake"
    (root / "rgb").mkdir(parents=True)
    (root / "depth").mkdir()
    rng = np.random.default_rng(0)
    for i in range(N):
        ts = 1305031102.0 + i * 0.033
        Image.fromarray(rng.integers(0, 256, size=(48, 64, 3), dtype=np.uint8)).save(root / "rgb" / f"{ts:.6f}.png")
        Image.fromarray(rng.integers(1000, 20000, size=(48, 64), dtype=np.uint16)).save(
            root / "depth" / f"{ts:.6f}.png")
    with open(root / "groundtruth.txt", "w") as f:
        f.write("# ground truth trajectory\n")
        for i in range(N * 2):
            q = rng.normal(size=4)
            q /= np.linalg.norm(q)
            f.write(f"{1305031101.99 + i * 0.0165:.6f} {0.01 * i:.4f} {rng.normal():.4f} 1.5 "
                    + " ".join(f"{v:.7f}" for v in q) + "\n")
    return root


def _pair_of_sequences(tum_dir, **kw):
    jaug = jtum.AugmentationConfig() if kw.pop("augment", False) else None
    paug = tum.AugmentationConfig() if jaug else None
    j = jtum.TUMSequence(tum_dir, camera=jcamera.TUM_FR1._replace(width=64, height=48), augmentation=jaug, **kw)
    p = tum.TUMSequence(tum_dir, camera=pcamera.TUM_FR1._replace(width=64, height=48), augmentation=paug, **kw)
    return j, p


def test_files_timestamps_and_poses_exact(tum_dir):
    j, p = _pair_of_sequences(tum_dir)
    assert p.rgb_files == j.rgb_files and p.depth_files == j.depth_files
    assert p.num_frames() == j.num_frames() == N and len(p) == len(j) == N - 1
    _equal(p.timestamps, j.timestamps)
    _equal(p.poses, j.poses)
    jt, jp = jtum.load_groundtruth_file(tum_dir / "groundtruth.txt")
    pt, pp = tum.load_groundtruth_file(tum_dir / "groundtruth.txt")
    _equal(pt, jt)
    _equal(pp, jp)


def test_quaternion_rounding_is_jax_f32():
    from semantic_slam_master_tpu.core import lie as jlie
    import jax.numpy as jnp

    rng = np.random.default_rng(1)
    for scale in (1.0, 1e-3, 7.0):  # unit and non-unit quaternions
        q = np.round(rng.normal(size=(5000, 4)) * scale, 7)
        _equal(trajectory_io.quat_to_matrix_f32(q), np.asarray(jlie.quat_to_matrix(jnp.asarray(q))))


def test_trajectory_reader_rotations_match_jax(tmp_path):
    """``evaluate`` reads a TUM sequence's groundtruth.txt with
    ``read_tum_trajectory``: its rotations must round as JAX's do (torch's
    float32 ``quat_to_matrix`` differed in the last bit on ~11% of the
    entries)."""
    rng = np.random.default_rng(2)
    q = rng.normal(size=(300, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    path = tmp_path / "groundtruth.txt"
    path.write_text("# timestamp tx ty tz qx qy qz qw\n" + "".join(
        f"{i / 30:.6f} {rng.normal():.6f} 0.1 0.2 " + " ".join(f"{v:.7f}" for v in q[i]) + "\n" for i in range(300)))
    for got, ref in zip(trajectory_io.read_tum_trajectory(path), jtrajectory_io.read_tum_trajectory(path)):
        _equal(got, ref)


def test_max_frames_and_missing_directories(tum_dir, tmp_path):
    j, p = _pair_of_sequences(tum_dir, max_frames=4)
    assert p.num_frames() == j.num_frames() == 4
    _equal(p.timestamps, j.timestamps)
    _equal(p.poses, j.poses)
    with pytest.raises(FileNotFoundError):
        tum.TUMSequence(tmp_path, "rgbd_dataset_freiburg1_absent")


def test_frame_and_batch_decode_exact(tum_dir):
    j, p = _pair_of_sequences(tum_dir)
    for i in (0, 3):
        jf, pf = j.frame(i), p.frame(i)
        assert jf.keys() == pf.keys()
        for k in jf:
            _equal(pf[k], jf[k])
    for a, b in zip(p.load_all_gray_depth(), j.load_all_gray_depth()):
        _equal(a, b)


@pytest.mark.parametrize("seed", [None, 0, 1, 5, 123, 2024])
def test_pair_exact(tum_dir, seed):
    j, p = _pair_of_sequences(tum_dir, input_size=32, augment=True)
    jp, pp = j.pair(1, seed=seed), p.pair(1, seed=seed)
    assert jp.keys() == pp.keys()
    for k in jp:
        _equal(pp[k], jp[k])


def test_batch_pairs_exact(tum_dir):
    j, p = _pair_of_sequences(tum_dir, input_size=24, frame_spacing=2, augment=True)
    jb = jtum.batch_pairs([j.pair(i, seed=7 + i) for i in range(3)])
    pb = tum.batch_pairs([p.pair(i, seed=7 + i) for i in range(3)])
    assert jb.keys() == pb.keys()
    for k in jb:
        _equal(pb[k], jb[k])


def test_helpers_exact():
    rng = np.random.default_rng(3)
    img = rng.uniform(size=(30, 41, 3)).astype(np.float32)
    depth = rng.uniform(size=(30, 41)).astype(np.float32)
    for shape in ((16, 16), (45, 20), (30, 41)):
        _equal(tum.resize_bilinear(img, *shape), jtum.resize_bilinear(img, *shape))
        _equal(tum.resize_bilinear(depth, *shape), jtum.resize_bilinear(depth, *shape))
        _equal(tum.resize_nearest(depth, *shape), jtum.resize_nearest(depth, *shape))
    _equal(tum.imagenet_normalize(img), jtum.imagenet_normalize(img))
    for seed in range(12):  # some seeds take the blur branch, some the hue rotation
        for cfg in ({}, {"hue": 0.0}, {"gaussian_blur": 1.0}, {"enabled": False}):
            _equal(tum.apply_augmentation(img, seed, tum.AugmentationConfig(**cfg)),
                   jtum.apply_augmentation(img, seed, jtum.AugmentationConfig(**cfg)))


@pytest.mark.parametrize("name", ["rgbd_dataset_freiburg1_desk", "rgbd_dataset_freiburg2_xyz",
                                  "rgbd_dataset_freiburg3_walking_static", "rgbd_dataset_freiburg2_synthetic"])
def test_camera_for_sequence(name):
    assert tuple(pcamera.camera_for_sequence(name)) == tuple(jcamera.camera_for_sequence(name))
    assert pcamera.CAMERAS.keys() == jcamera.CAMERAS.keys()


def test_unknown_camera():
    with pytest.raises(ValueError):
        pcamera.camera_for_sequence("kitti_00")
    assert tum._camera_or_default("kitti_00") == pcamera.TUM_FR1


def test_written_sequence_reads_back_in_both_packages(tmp_path):
    """``write_tum_sequence`` of the synthetic world (fr2 intrinsics):
    both packages read the same frames, timestamps and poses; the PNGs
    hold the frames quantised (RGB to 1/255, depth to 1/5000 m) and the
    ground truth the poses to float32 rounding."""
    seq = synthetic.make_sequence(num_frames=3, scale=1.0)
    name = "rgbd_dataset_freiburg2_synthetic"
    tum.write_tum_sequence(seq, tmp_path, name, filters=("none", "sub", "up"))
    j, p = jtum.TUMSequence(tmp_path, name), tum.TUMSequence(tmp_path, name)
    assert tuple(p.cam) == tuple(jcamera.TUM_FR2) == tuple(seq.cam)
    _equal(p.timestamps, j.timestamps)
    _equal(p.poses, j.poses)
    np.testing.assert_allclose(p.poses, seq.poses_wc, atol=1e-6)
    for a, b in zip(p.load_all_gray_depth(), j.load_all_gray_depth()):
        _equal(a, b)
    f = p.frame(2)
    np.testing.assert_allclose(f["rgb"], seq.frame(2)["rgb"], atol=0.5 / 255 + 1e-6)
    np.testing.assert_allclose(f["depth"], seq.frame(2)["depth"], atol=0.5 / 5000 + 1e-6)
    rows = (tmp_path / name / "associations.txt").read_text().split("\n")
    assert rows[0] == "0.0 rgb/0.000000.png 0.0 depth/0.000000.png" and len(rows) == 4
