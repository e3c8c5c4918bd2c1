"""How ``correct`` is decided: the port's answers of a run against the plain
reference (``reference.py``, ``detector.py``), number by number, each beside
its limit (``limits/<workload>.json``). Every number passes at or under its
limit.

- ``failed_share`` (tracking; the configuration's delivery guarantee,
  limit 0): frames handed in during the window whose pose did not come
  back OK by its end, over those handed in;
- ``ate_m`` (tracking): per sequence the RMSE of the camera centres over
  the window's frames after a rigid alignment to the ground truth; the
  worst sequence;
- ``rpe_m`` (tracking): per sequence the RMS translation error of the
  motion over :data:`RPE_FRAMES` frames (1 s of the stream), from each
  frame of the window that has one that many frames later, against the
  ground truth's; the worst sequence;
- ``det_gap`` (front end: the detector and its hand kernels): on
  :data:`N_DET` frames of the window drawn from the seed, every camera of
  every sequence at every pyramid level, the share of segments that the
  program's detector and the reference detector, run on the same images,
  do not both find within 1 px at both ends;
- ``ba_gap`` (local BA): over :data:`N_BA` local-BA windows solved in the
  window (drawn from the seed), the Huber cost of the program's answer
  against that of the reference's own solve of the same window from the
  same start, pooled relative to the latter. ``ba_pose_m``, the largest
  distance between the two solves' camera centres, is read beside it but
  has no limit: sound runs and the control overlap on it.

``control=True`` puts the reference in the program's place, computed in
bfloat16: the ground truth's poses, the reference detector and the
reference's own solves of the windows.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np
import torch

from portbench import detector as det
from portbench import reference as ref

N_BA = 6  # local-BA windows compared per run
N_DET = 3  # frames whose detections are compared per run
RPE_FRAMES = 20  # frames between the two poses of a relative-pose error (1 s of the stream)


def _sample(n: int, k: int, rng) -> List[int]:
    return sorted(rng.choice(n, size=min(n, k), replace=False).tolist()) if n else []


def _det_pairs(records: Dict, images: Callable, picks, device, control: bool) -> list:
    """(program, reference) (endpoints, valid) of each image of each picked
    frame, each camera and pyramid level: the program's side is what its
    detector returned (nothing where its calls of that frame are not one
    per camera and level), or with ``control`` the reference in bfloat16."""
    pairs = []
    for j in picks:
        cams = images(j)  # (lefts, rights), each (n_seq, H, W) uint8
        refs = [det.detect_levels(c, device, torch.float32) for c in cams]
        sides = [det.detect_levels(c, device, torch.bfloat16) for c in cams] if control else None
        for k, shape in enumerate(det.level_shapes(*cams[0].shape[-2:])):
            calls = [c for c in records[j] if tuple(c[0][-2:]) == shape]
            for c, ref_cam in enumerate(refs):
                r = ref_cam[k]
                for b in range(r.valid.shape[0]):
                    rb = (r.endpoints[b].to(torch.float64).cpu().numpy(), r.valid[b].cpu().numpy())
                    if control:
                        p = (sides[c][k].endpoints[b].to(torch.float64).cpu().numpy(), sides[c][k].valid[b].cpu().numpy())
                    elif len(calls) == len(refs):
                        p = (calls[c][1][b].to(torch.float64).cpu().numpy(), calls[c][2][b].cpu().numpy())
                    else:
                        p = (np.zeros((0, 2, 2)), np.zeros(0))
                    pairs.append((p, rb))
    return pairs


def numbers(run: Dict, streams, seed: int, lm: dict, device="cpu", control: bool = False) -> Dict[str, float]:
    """The compared numbers of a finished run. ``run`` holds ``frames`` (per
    sequence: {j: (T_cw, ok)} for the frames handed in during the window),
    ``attempted``, ``ba`` ([(window arrays, result)]), ``det`` ({j:
    [(input shape, endpoints, valid)]}) and ``images`` (j -> (lefts,
    rights) uint8 as handed in)."""
    rng = np.random.default_rng([int(seed) % (1 << 63), 0x5EED])
    lo = torch.bfloat16 if control else torch.float64
    out = {}
    resolved_ok = sum(1 for seq in run["frames"] for _, ok in seq.values() if ok)
    out["failed_share"] = 0.0 if control else 1.0 - resolved_ok / max(run["attempted"], 1)

    ates, rpes = [], []
    for s, seq in enumerate(run["frames"]):
        js = sorted(seq)
        if len(js) < 3:
            ates.append(np.inf)
            rpes.append(np.inf)
            continue
        gts = np.stack([streams[s].gt(j) for j in js])
        gt = ref.world_gt(gts, streams[s].gt(0))
        est = ref.world_gt(gts, streams[s].gt(0), lo) if control else np.stack([seq[j][0] for j in js])
        ates.append(ref.ate(est, gt))
        at = {j: i for i, j in enumerate(js)}
        a = np.array([i for i, j in enumerate(js) if j + RPE_FRAMES in at], dtype=np.int64)
        b = np.array([at[js[i] + RPE_FRAMES] for i in a], dtype=np.int64)
        rpes.append(ref.rpe(est[a], est[b], gt[a], gt[b]))
    out["ate_m"] = max(ates) if ates else np.inf
    out["rpe_m"] = max(rpes) if rpes else np.inf

    keys = sorted(run["det"])
    picks = [keys[i] for i in _sample(len(keys), N_DET, rng)]
    pairs = _det_pairs(run["det"], run["images"], picks, device, control)
    out["det_gap"] = det.det_gap(pairs) if pairs else np.inf

    picks = _sample(len(run["ba"]), N_BA, rng)
    windows = [ref.BAWindow.of(run["ba"][i][0]) for i in picks]
    answers = [None if control else (np.asarray(run["ba"][i][1]["poses"]), np.asarray(run["ba"][i][1]["lines"])) for i in picks]
    if windows:
        out.update(ref.ba_compare(windows, answers, streams[0].rig, lm, device, lo))
    else:
        out.update(ba_gap=np.inf, ba_pose_m=np.inf)
    return out


def judge(values: Dict[str, float], limits: Dict[str, float]):
    """(correct, {name: {"value", "limit"}}): correct when every number is at
    or under its limit and every limit has its number."""
    checks = {k: {"value": float(values.get(k, np.inf)), "limit": float(v)} for k, v in limits.items()}
    ok = all(np.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
