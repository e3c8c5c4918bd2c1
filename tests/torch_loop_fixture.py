"""The loop fixtures of the JAX package's tests, built without JAX.

``pose_graph_fields`` is tests/test_posegraph.py's drifted circle as a
padded pose-graph problem (SE(3), or Sim(3) with scale drift).

``drifted_loop`` makes the port's SlamMap that ``_build_drifted_loop``
makes in the JAX package (keyframes around tpuslam_torch's
``make_loop_scene`` circle, keyframe k drifted by exp(k xi), landmarks of
keyframes 0-2 at their true positions and the last keyframe's duplicates
at drifted ones), so the card tests, which run where JAX is not installed,
can close the same loop. With ``fuse`` keyframes 1 and 2's landmarks of the
segments keyframe 0 sees are fused into keyframe 0's (the multi-view map
of tests/test_torch_loop_closing.py). tests/test_torch_loop_closing.py holds
it to the JAX fixture.
"""

from __future__ import annotations

import numpy as np
import torch

from tpuslam_torch import Intrinsics
from tpuslam_torch.frontend.frame import FrameFeatures
from tpuslam_torch.geometry.se3 import se3_exp
from tpuslam_torch.io.synthetic import make_loop_scene, observe_frame
from tpuslam_torch.slammap.map import SlamMap

CAM = Intrinsics(fx=458.0, fy=457.0, cx=320.0, cy=240.0, width=640, height=480, baseline=0.11)
DRIFT_XI = (0.02, 0.01, -0.015, 0.002, 0.003, -0.002)


def frame_features(scene, frame: int, capacity: int = 256, desc_seed: int = 1234):
    """The JAX package's ``synthetic_frame_features(scene, frame,
    with_depth=True)``: projected ground-truth segments with identity-stable
    descriptors. Returns (numpy FrameFeatures, visible segment ids)."""
    obs = observe_frame(scene, frame)
    S = scene.segments.shape[0]
    drs = np.random.RandomState(desc_seed)
    all_bits = drs.randint(0, 2**32, size=(S, 8), dtype=np.uint64).astype(np.uint32)
    all_desc = drs.standard_normal((S, 72)).astype(np.float32)
    vis = np.nonzero(obs.seg_visible)[0][:capacity]
    n, K = len(vis), capacity
    f = dict(
        endpoints=np.zeros((K, 2, 2), np.float32), valid=np.zeros(K, np.float32), angle=np.zeros(K, np.float32),
        length=np.zeros(K, np.float32), midpoint=np.zeros((K, 2), np.float32), response=np.zeros(K, np.float32),
        level=np.zeros(K, np.int32), sigma=np.ones(K, np.float32), desc=np.zeros((K, 72), np.float32),
        desc_bits=np.zeros((K, 8), np.uint32), depth=np.zeros((K, 2), np.float32), has_depth=np.zeros(K, np.float32),
    )
    f["endpoints"][:n] = obs.seg_uv[vis]
    f["valid"][:n] = 1.0
    d = f["endpoints"][:n, 1] - f["endpoints"][:n, 0]
    f["angle"][:n] = np.arctan2(d[:, 1], d[:, 0])
    f["length"][:n] = np.linalg.norm(d, axis=-1)
    f["midpoint"][:n] = f["endpoints"][:n].mean(axis=1)
    f["response"][:n] = f["length"][:n]
    f["desc"][:n] = all_desc[vis]
    f["desc_bits"][:n] = all_bits[vis]
    T = scene.poses[frame]
    seg_c = scene.segments @ T[:3, :3].T + T[:3, 3]
    f["depth"][:n] = seg_c[vis][:, :, 2]
    f["has_depth"][:n] = np.all(f["depth"][:n] > 0.1, axis=-1).astype(np.float32)
    return FrameFeatures(**f), vis


def drifted_loop(n_kf: int = 10, fuse: bool = False):
    """(scene, SlamMap, keyframe kids, true poses) of the drifted loop."""
    scene = make_loop_scene(np.random.default_rng(5), n_segments=280, n_frames=n_kf, radius=6.0, room=10.0, cam=CAM)
    smap = SlamMap()
    drift_step = se3_exp(torch.tensor(DRIFT_XI, dtype=torch.float32)).numpy()
    cum = np.eye(4, dtype=np.float32)
    kfs = []
    for f in range(n_kf):
        feats, vis = frame_features(scene, f)
        kf = smap.new_keyframe(f, f * 0.1, (cum @ scene.poses[f]).astype(np.float32), feats)
        kfs.append((kf, vis))
        cum = (drift_step @ cum).astype(np.float32)
    st = smap.lines

    def bind(kf, vis, pose):
        T_true = scene.poses[kf.frame_idx]
        Twc = np.linalg.inv(pose)
        for slot in range(int(kf.features.valid.sum())):
            ep_cam = scene.segments[vis[slot]] @ T_true[:3, :3].T + T_true[:3, 3]
            ep_w = ep_cam @ Twc[:3, :3].T + Twc[:3, 3]
            plk = np.concatenate([np.cross(ep_w[0], ep_w[1]), ep_w[1] - ep_w[0]])
            lid = st.allocate(plk.astype(np.float32), ep_w.astype(np.float32), kf.features.desc_bits[slot], kf.kid)
            st.add_observation(lid, kf, slot)

    for kf, vis in kfs[:3]:
        bind(kf, vis, scene.poses[kf.frame_idx])
    bind(kfs[-1][0], kfs[-1][1], kfs[-1][0].T_cw)
    for kf, _ in kfs:
        kf.parent = kf.kid - 1 if kf.kid > 0 else None
        if kf.parent is not None:
            smap.keyframes[kf.parent].children.add(kf.kid)
    if fuse:
        kf0, vis0 = kfs[0]
        seg_of = {int(seg): int(kf0.line_ids[s]) for s, seg in enumerate(vis0[: int(kf0.features.valid.sum())])}
        for kf, vis in kfs[1:3]:
            for slot, seg in enumerate(vis[: int(kf.features.valid.sum())]):
                lid = int(kf.line_ids[slot])
                if int(seg) in seg_of and lid >= 0 and lid != seg_of[int(seg)]:
                    st.replace(lid, seg_of[int(seg)], smap.keyframes)
    return scene, smap, [kf.kid for kf, _ in kfs], [scene.poses[f] for f in range(n_kf)]


def circle_poses(n: int, radius: float = 3.0) -> np.ndarray:
    """tests/test_posegraph.py's ``_circle_poses``: T_cw of n cameras on a
    circle looking inward."""
    poses = []
    for i in range(n):
        a = 2 * np.pi * i / n
        c = np.array([radius * np.cos(a), 0.0, radius * np.sin(a)])
        z = -c / np.linalg.norm(c)
        x = np.cross([0, 1, 0], z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        T_wc = np.eye(4)
        T_wc[:3, :3] = np.stack([x, y, z], axis=1)
        T_wc[:3, 3] = c
        poses.append(np.linalg.inv(T_wc).astype(np.float32))
    return np.stack(poses)


GRAPH_N, GRAPH_P, GRAPH_E = 12, 16, 64  # cameras; poses and edges padded as the loop closer pads them


def pose_graph_fields(kind: str, pad: bool = True):
    """The drifted circle: odometry edges with a constant drift per step
    (for "sim3" the drift also grows the scale by 3% per step) and one loop
    edge at the true relative pose, weight 5. Returns (the problem's numpy
    fields in PoseGraphProblem order, the number of real edges)."""
    N = GRAPH_N
    gt = circle_poses(N).astype(np.float64)
    drift = se3_exp(torch.tensor([0.01, 0.004, -0.008, 0.002, 0.004, -0.002], dtype=torch.float32)).numpy().astype(np.float64)
    if kind == "sim3":
        drift[:3, :3] *= 1.03
    est = [gt[0]]
    for i in range(1, N):
        est.append(drift @ (gt[i] @ np.linalg.inv(gt[i - 1])) @ est[-1])
    est = np.stack(est).astype(np.float32)
    e_i = list(range(1, N)) + [N - 1]
    e_j = list(range(N - 1)) + [0]
    meas = [est[i] @ np.linalg.inv(est[i - 1]) for i in range(1, N)] + [gt[N - 1] @ np.linalg.inv(gt[0])]
    w = [1.0] * (N - 1) + [5.0]
    P, E = (GRAPH_P, GRAPH_E) if pad else (N, len(e_i))
    poses = np.tile(np.eye(4, dtype=np.float32), (P, 1, 1))
    poses[:N] = est
    free = np.zeros(P, np.float32)
    free[1:N] = 1.0
    ei = np.zeros(E, np.int32)
    ej = np.zeros(E, np.int32)
    ei[: len(e_i)] = e_i
    ej[: len(e_j)] = e_j
    em = np.tile(np.eye(4, dtype=np.float32), (E, 1, 1))
    em[: len(meas)] = np.stack(meas).astype(np.float32)
    ev = np.zeros(E, np.float32)
    ev[: len(e_i)] = 1.0
    ew = np.ones(E, np.float32)
    ew[: len(w)] = w
    return (poses, free, ei, ej, em, ev, ew), len(e_i)
