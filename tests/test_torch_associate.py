"""The port's TUM association (``data/associate.py``,
``cli/associate_cli.py``) against the JAX package: the parsed listings,
the associated rows and the written file exact, and ``associate -o``'s
file and its printed rows byte-equal to the JAX CLI's; and the port's
dispatcher lists ``run-tests`` and ``associate``."""

import numpy as np
import pytest

from semantic_slam_master_tpu.cli import associate_cli as jassociate_cli
from semantic_slam_master_tpu.data import associate as jassociate
from semantic_slam_master_tpu_torch.cli import associate_cli
from semantic_slam_master_tpu_torch.data import associate


@pytest.fixture(scope="module")
def listings(tmp_path_factory):
    """rgb.txt at 30 Hz and depth.txt at a jittered, offset rate with
    dropped frames, comments and blank lines, as TUM's files have them."""
    root = tmp_path_factory.mktemp("assoc")
    rng = np.random.default_rng(0)
    t_rgb = 1305031102.175304 + np.arange(40) / 30.0
    t_depth = np.sort(1305031102.160 + np.arange(45) / 30.0 + rng.uniform(-0.012, 0.012, 45))
    t_depth = np.delete(t_depth, [3, 4, 17, 30])
    for name, ts, folder in (("rgb.txt", t_rgb, "rgb"), ("depth.txt", t_depth, "depth")):
        lines = ["# color images", "# file: 'rgbd_dataset_freiburg1_xyz.bag'", "# timestamp filename", ""]
        lines += [f"{t:.6f} {folder}/{t:.6f}.png" for t in ts]
        (root / name).write_text("\n".join(lines) + "\n\n")
    return root


def test_read_stamped_file_list(listings):
    for name in ("rgb.txt", "depth.txt"):
        got = associate.read_stamped_file_list(listings / name)
        assert got == jassociate.read_stamped_file_list(listings / name) and len(got) > 30


@pytest.mark.parametrize("max_difference", [0.02, 0.005, 0.1])
def test_associate_file_lists(listings, max_difference):
    rgb = associate.read_stamped_file_list(listings / "rgb.txt")
    depth = associate.read_stamped_file_list(listings / "depth.txt")
    got = associate.associate_file_lists(rgb, depth, max_difference)
    assert got == jassociate.associate_file_lists(rgb, depth, max_difference)
    assert 0 < len(got) <= len(rgb)


def test_write_associations(listings, tmp_path):
    rgb = associate.read_stamped_file_list(listings / "rgb.txt")
    depth = associate.read_stamped_file_list(listings / "depth.txt")
    rows = associate.associate_file_lists(rgb, depth)
    associate.write_associations(rows, tmp_path / "port.txt")
    jassociate.write_associations(rows, tmp_path / "jax.txt")
    assert (tmp_path / "port.txt").read_bytes() == (tmp_path / "jax.txt").read_bytes()


def test_cli_output_file_and_stdout_match_jax(listings, tmp_path, capsys):
    argv = [str(listings / "rgb.txt"), str(listings / "depth.txt"), "--max_difference", "0.015"]
    assert associate_cli.main(argv + ["-o", str(tmp_path / "port.txt")]) == 0
    assert jassociate_cli.main(argv + ["-o", str(tmp_path / "jax.txt")]) == 0
    assert (tmp_path / "port.txt").read_bytes() == (tmp_path / "jax.txt").read_bytes()
    capsys.readouterr()
    assert associate_cli.main(argv) == 0
    port_out = capsys.readouterr()
    assert jassociate_cli.main(argv) == 0
    jax_out = capsys.readouterr()
    assert port_out.out == jax_out.out and port_out.err == jax_out.err
    assert port_out.out.count("\n") == (tmp_path / "port.txt").read_text().count("\n") > 0


def test_dispatcher_lists_the_new_commands(capsys):
    from semantic_slam_master_tpu_torch import __main__ as dispatcher

    assert dispatcher.main([]) == 0
    listed = [line.split()[0] for line in capsys.readouterr().out.splitlines()[2:] if line.strip()]
    assert listed == ["run-slam", "evaluate", "run-tests", "associate", "train", "train-segmenter",
                      "check-setup", "download-tum", "visualize", "bench"]
