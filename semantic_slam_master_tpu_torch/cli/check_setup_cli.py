"""Environment and dataset checks (port of ``check-setup``): the Python
packages the port needs, a CUDA card visible to PyTorch, the port's own
imports, and the completeness (rgb, depth, groundtruth) of each reference
TUM sequence under ``--data-root``. Prints PASS and exits 0 when the
packages, the card and the imports are there, else FAIL and 1; missing
data is reported, not failed (the synthetic world needs none).
"""

from __future__ import annotations

import argparse
import importlib
from pathlib import Path

REQUIRED_PACKAGES = ("torch", "numpy", "yaml")
REFERENCE_SEQUENCES = (
    "rgbd_dataset_freiburg1_desk",
    "rgbd_dataset_freiburg1_plant",
    "rgbd_dataset_freiburg1_room",
    "rgbd_dataset_freiburg3_long_office_household",
    "rgbd_dataset_freiburg3_walking_static",
    "rgbd_dataset_freiburg3_walking_xyz",
)


def check_sequence_dir(seq_dir: Path) -> dict:
    """Which parts of a TUM sequence directory are present."""
    rgb = seq_dir / "rgb"
    depth = seq_dir / "depth"
    gt = seq_dir / "groundtruth.txt"
    status = {
        "exists": seq_dir.exists(),
        "rgb": rgb.exists() and any(rgb.glob("*.png")),
        "depth": depth.exists() and any(depth.glob("*.png")),
        "groundtruth": gt.exists(),
    }
    status["complete"] = all(status.values())
    return status


def main(argv=None):
    parser = argparse.ArgumentParser(prog="check-setup", description=__doc__)
    parser.add_argument("--data-root", default="data/tum_rgbd")
    args = parser.parse_args(argv)

    ok = True
    print("== packages ==")
    for pkg in REQUIRED_PACKAGES:
        try:
            importlib.import_module(pkg)
            print(f"  [ok] {pkg}")
        except ImportError as e:
            print(f"  [MISSING] {pkg}: {e}")
            ok = False

    print("== accelerator ==")
    try:
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("torch.cuda.is_available() is False")
        names = [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
        print(f"  [ok] torch {torch.__version__} cuda {torch.version.cuda} devices={names}")
    except Exception as e:  # any failure to reach a card is a FAIL line, not a crash
        print(f"  [FAIL] cuda devices: {e}")
        ok = False

    print("== framework ==")
    try:
        from .. import core, data, eval as eval_mod, losses, models, ops, slam  # noqa: F401

        print("  [ok] semantic_slam_master_tpu_torch imports")
    except Exception as e:  # report the broken import and go on to the dataset
        print(f"  [FAIL] package import: {e}")
        ok = False

    print("== dataset ==")
    root = Path(args.data_root)
    if not root.exists():
        print(f"  [absent] {root} — TUM data not downloaded "
              "(synthetic world available for tests/benchmarks)")
    else:
        for seq in REFERENCE_SEQUENCES:
            st = check_sequence_dir(root / seq)
            mark = "ok" if st["complete"] else ("partial" if st["exists"] else "absent")
            print(f"  [{mark}] {seq}")

    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
