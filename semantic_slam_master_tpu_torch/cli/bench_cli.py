"""Per-stage performance report (port of ``bench``).

Per-stage latency of one frontend on a batch of synthetic frames (FAST /
ORB / matching, or the learned frontend's stages), and the fps they add
up to, from the acceptance suite's ``run_performance_test``: CUDA events
on the card. The JSON names the device and, on the card, the
``nvidia-smi`` name and power limit the times were taken at.

``--frontend learned`` runs a seeded ``LearnedFrontend`` at its defaults
(ViT-S/16) on the frames resized to 448x448, as the JAX CLI does; its
weights are drawn by PyTorch, not JAX's numbers.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

from ..core.device import resolve_device

LEARNED_SIZE = 448


def card_name(device: torch.device) -> str | None:
    """``nvidia-smi``'s "name, power.limit" of the card, None off the card."""
    if device.type != "cuda":
        return None
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.splitlines()
    return out[torch.cuda.current_device() if device.index is None else device.index].strip()


def main(argv=None):
    parser = argparse.ArgumentParser(prog="bench", description=__doc__)
    parser.add_argument("--frontend", choices=("orb", "learned"), default="orb")
    parser.add_argument("--width", type=int, default=640)
    parser.add_argument("--height", type=int, default=480)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--num-keypoints", type=int, default=1000)
    parser.add_argument("--output", default=None)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)

    from ..core.camera import TUM_FR2
    from ..data import synthetic
    from ..eval import frontend_tests

    device = resolve_device(args.device)
    cam = TUM_FR2.scaled(args.width / 640, args.height / 480)
    timestamps, poses = synthetic.orbit_trajectory(args.batch)
    seq = synthetic.SyntheticSequence(cam=cam, timestamps=timestamps, poses_wc=poses)
    if args.frontend == "orb":
        adapter = frontend_tests.orb_adapter(num_keypoints=args.num_keypoints, device=device)
    else:
        from ..data.tum import resize_bilinear
        from ..models.frontend import LearnedFrontend

        model = LearnedFrontend(generator=torch.Generator().manual_seed(0)).to(device).eval()
        adapter = frontend_tests.learned_adapter(model, device=device)
        frames = seq

        class Resized:
            cam = frames.cam.scaled(LEARNED_SIZE / frames.cam.width, LEARNED_SIZE / frames.cam.height)

            def __len__(self):
                return len(frames)

            def frame(self, i):
                f = frames.frame(i)
                return {**f, "rgb": resize_bilinear(f["rgb"], LEARNED_SIZE, LEARNED_SIZE)}

        seq = Resized()

    result = frontend_tests.run_performance_test(seq, adapter, batch=args.batch)
    result["device"] = f"{device} ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else str(device)
    result["card"] = card_name(device)
    print(json.dumps(result, indent=2, default=float))
    if args.output:
        with open(args.output, "w") as f:
            json.dump(result, f, indent=2, default=float)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
