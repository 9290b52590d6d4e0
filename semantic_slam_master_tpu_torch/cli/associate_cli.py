"""RGB/depth timestamp association of two TUM listings (port of
``associate``): prints or writes ``rgb_time rgb_file depth_time depth_file``
rows."""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    parser = argparse.ArgumentParser(prog="associate", description=__doc__)
    parser.add_argument("rgb_file")
    parser.add_argument("depth_file")
    parser.add_argument("--max_difference", type=float, default=0.02)
    parser.add_argument("--output", "-o", default=None)
    args = parser.parse_args(argv)

    from ..data import associate

    rgb_list = associate.read_stamped_file_list(args.rgb_file)
    depth_list = associate.read_stamped_file_list(args.depth_file)
    print(f"{len(rgb_list)} rgb, {len(depth_list)} depth entries", file=sys.stderr)
    assoc = associate.associate_file_lists(rgb_list, depth_list, args.max_difference)
    print(f"{len(assoc)} associations", file=sys.stderr)
    if args.output:
        associate.write_associations(assoc, args.output)
        print(f"written to {args.output}", file=sys.stderr)
    else:
        for row in assoc:
            print(" ".join(str(v) for v in row))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
