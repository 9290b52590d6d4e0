"""The numbers that decide ``correct``: what the timed path produced,
against the plain reference's output for the same frames.

Each number is a gap (0 when the two agree) with a limit of its own in
the configuration file (``limits``); a run is correct when every number
is at or below its limit. Which numbers a cell compares follows from its
configuration's frontend and its traffic's drive:

- ``feature_mismatch`` (ORB): the share of keypoint slots whose validity,
  position (beyond 1e-3 px) or descriptor bits differ from the
  reference's;
- ``weight_map_mismatch`` (segmenter): the share of weight-map pixels
  whose class weight differs from the reference's;
- ``keypoint_miss`` (learned): the share of valid keypoints with no valid
  reference keypoint within 1 px in the same frame;
- ``descriptor_gap`` (learned): the mean of 1 - cosine between the
  descriptors of keypoints that lie within 0.1 px of a reference keypoint;
- ``pose_gap_m`` (drives that track): the largest distance between a
  pose's position and the reference's, over every frame of every pass;
- ``ate_m`` (drives that track): the largest absolute trajectory error of
  a pass against the world's ground truth. It rests on nothing the port
  made, so it witnesses the trajectory where ``pose_gap_m``, which runs
  the reference loop over the port's own features, cannot; its limit is
  the one the repo holds these paths to.
"""

from __future__ import annotations

import numpy as np
import torch

SAME_XY_PX = 1e-3
NEAR_PX = 1.0
SAME_KEYPOINT_PX = 0.1


def feature_mismatch(feats, ref) -> float:
    valid, rvalid = feats.valid.bool(), ref.valid.bool().to(feats.valid.device)
    xy_gap = (feats.xy - ref.xy.to(feats.xy.device)).abs().amax(-1)
    desc_differs = (feats.desc != ref.desc.to(feats.desc.device)).any(-1)
    bad = (valid != rvalid) | (valid & ((xy_gap > SAME_XY_PX) | desc_differs))
    return float(bad.float().mean())


def weight_map_mismatch(wm, ref) -> float:
    return float((wm != ref.to(wm.device)).float().mean())


def _nearest(feats, ref):
    """Per valid keypoint (flattened over frames): distance to the nearest
    valid reference keypoint of its frame, and that keypoint's descriptor."""
    dists, rdesc, desc = [], [], []
    for f in range(feats.xy.shape[0]):
        v = feats.valid[f].bool()
        rv = ref.valid[f].bool().to(v.device)
        xy, rxy = feats.xy[f][v], ref.xy[f].to(v.device)[rv]
        if len(xy) == 0:
            continue
        if len(rxy) == 0:
            dists.append(torch.full((len(xy),), float("inf"), device=v.device))
            rdesc.append(torch.zeros_like(feats.desc[f][v]).float())
            desc.append(feats.desc[f][v].float())
            continue
        d = torch.cdist(xy.double(), rxy.double())
        dmin, idx = d.min(dim=1)
        dists.append(dmin)
        rdesc.append(ref.desc[f].to(v.device)[rv][idx].float())
        desc.append(feats.desc[f][v].float())
    if not dists:
        return None, None, None
    return torch.cat(dists), torch.cat(desc), torch.cat(rdesc)


def keypoint_gaps(feats, ref) -> dict:
    d, desc, rdesc = _nearest(feats, ref)
    if d is None:
        return {"keypoint_miss": 1.0, "descriptor_gap": 1.0}
    same = d <= SAME_KEYPOINT_PX
    cos = torch.nn.functional.cosine_similarity(desc[same].double(), rdesc[same].double(), dim=-1)
    return {
        "keypoint_miss": float((d > NEAR_PX).double().mean()),
        "descriptor_gap": float((1.0 - cos).mean()) if len(cos) else 1.0,
    }


def pose_gap(poses: np.ndarray, ref: np.ndarray) -> float:
    """Largest distance (m) between the positions of two (F, 4, 4)
    trajectories; inf where a pose is not finite."""
    gap = np.linalg.norm(poses[:, :3, 3].astype(np.float64) - ref[:, :3, 3].astype(np.float64), axis=-1)
    return float(np.max(np.where(np.isfinite(gap), gap, np.inf)))


def numbers(config: dict, out: dict, ref: dict) -> dict:
    """Every number the cell compares, by name. ``out`` holds the timed
    path's ``weight_map`` and ``features`` of the sampled pass, the
    ``poses`` of every pass (a list; empty for a drive that stops at the
    features) and the world's ground-truth poses, ``truth``."""
    nums = {}
    if out.get("weight_map") is not None:
        nums["weight_map_mismatch"] = weight_map_mismatch(out["weight_map"], ref["weight_map"])
    if config["frontend"] == "learned":
        nums.update(keypoint_gaps(out["features"], ref["features"]))
    else:
        nums["feature_mismatch"] = feature_mismatch(out["features"], ref["features"])
    if out.get("poses"):
        nums["pose_gap_m"] = max(pose_gap(p, ref["poses"]) for p in out["poses"])
        nums["ate_m"] = max(ate_rmse(p, out["truth"]) for p in out["poses"])
    return nums


def failed_passes(config: dict, out: dict, ref: dict) -> int:
    """Passes whose trajectory lies beyond the pose or the ATE limit."""
    lims = config["limits"]
    if not out.get("poses"):
        return 0
    return sum(pose_gap(p, ref["poses"]) > lims["pose_gap_m"] or ate_rmse(p, out["truth"]) > lims["ate_m"]
               for p in out["poses"])


def judge(config: dict, nums: dict) -> tuple[bool, dict]:
    """(correct, {name: [value, limit]}): every number at or below its
    limit; a number without a limit, or NaN, fails."""
    limits = config["limits"]
    table = {k: [v, limits.get(k)] for k, v in nums.items()}
    ok = all(lim is not None and v == v and v <= lim for v, lim in table.values())
    return ok, table


def ate_rmse(est: np.ndarray, gt: np.ndarray) -> float:
    """Absolute trajectory error (m, RMSE of positions) after the rigid
    (Horn/Umeyama, no scale) alignment of ``est`` onto ``gt``."""
    a, b = est[:, :3, 3].astype(np.float64), gt[:, :3, 3].astype(np.float64)
    if not np.all(np.isfinite(a)):
        return float("inf")
    ma, mb = a.mean(0), b.mean(0)
    u, _, vt = np.linalg.svd((b - mb).T @ (a - ma))
    s = np.diag([1.0, 1.0, np.sign(np.linalg.det(u @ vt))])
    r = u @ s @ vt
    aligned = (r @ (a - ma).T).T + mb
    return float(np.sqrt(np.mean(np.sum((aligned - b) ** 2, axis=1))))
