"""TUM RGB-D downloader (port of ``download-tum``): fetches and extracts
the reference sequences (and fr2/desk) under ``--data-root``, then checks
that rgb, depth and groundtruth are there; ``--verify-only`` checks
without fetching. Needs network access; where there is none, use
``check-setup`` on data already in place, or the synthetic world.
"""

from __future__ import annotations

import argparse
import sys
import tarfile
import urllib.request
from pathlib import Path

BASE_URL = "https://cvg.cit.tum.de/rgbd/dataset"

SEQUENCES = {
    # name -> subdirectory on the TUM server
    "rgbd_dataset_freiburg1_desk": "freiburg1",
    "rgbd_dataset_freiburg1_plant": "freiburg1",
    "rgbd_dataset_freiburg1_room": "freiburg1",
    "rgbd_dataset_freiburg2_desk": "freiburg2",  # north-star benchmark seq
    "rgbd_dataset_freiburg3_long_office_household": "freiburg3",
    "rgbd_dataset_freiburg3_walking_static": "freiburg3",
    "rgbd_dataset_freiburg3_walking_xyz": "freiburg3",
}


def download_sequence(name: str, group: str, root: Path) -> bool:
    """Fetch and extract ``name`` under ``root`` unless it is already
    there; False when the fetch fails."""
    url = f"{BASE_URL}/{group}/{name}.tgz"
    dest = root / f"{name}.tgz"
    seq_dir = root / name
    if seq_dir.exists():
        print(f"[skip] {name} already extracted")
        return True
    root.mkdir(parents=True, exist_ok=True)
    print(f"[download] {url}")
    try:
        urllib.request.urlretrieve(url, dest)
    except Exception as e:  # a failed fetch fails this sequence; the others go on
        print(f"[FAIL] {name}: {e}", file=sys.stderr)
        return False
    print(f"[extract] {dest}")
    with tarfile.open(dest) as tar:
        tar.extractall(root, filter="data")  # no member may land outside root
    dest.unlink()
    return True


def main(argv=None):
    parser = argparse.ArgumentParser(prog="download-tum", description=__doc__)
    parser.add_argument("--data-root", default="data/tum_rgbd")
    parser.add_argument("--sequences", nargs="*", default=None)
    parser.add_argument("--verify-only", action="store_true")
    args = parser.parse_args(argv)

    from .check_setup_cli import check_sequence_dir

    root = Path(args.data_root)
    wanted = args.sequences or list(SEQUENCES)
    ok = True
    for name in wanted:
        if name not in SEQUENCES:
            print(f"[unknown] {name}", file=sys.stderr)
            ok = False
            continue
        if not args.verify_only:
            ok &= download_sequence(name, SEQUENCES[name], root)
        st = check_sequence_dir(root / name)
        print(f"[{'complete' if st['complete'] else 'incomplete'}] {name}")
        ok &= st["complete"] or args.verify_only
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
