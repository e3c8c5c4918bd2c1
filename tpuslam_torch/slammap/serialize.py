"""Map checkpoint/resume: save a SlamMap to one file and load it back.

Counterpart of ``tpuslam.slammap.serialize``, in its file format key for
key: one compressed npz of numpy arrays (keyframe poses, line and corner
features with their uint32 descriptor words, the landmark stores) with the
graph structure (keyframes, covisibility, observations, free lists) as an
embedded JSON string ``meta``. A map written by either package loads in
the other. The keyframes hold numpy copies already, so no tensor enters
the file.
"""

from __future__ import annotations

import json

import numpy as np

from tpuslam_torch.frontend.frame import FrameFeatures
from tpuslam_torch.kernels.fast import PointFeatures
from tpuslam_torch.slammap.map import KeyFrame, MapLineStore, SlamMap
from tpuslam_torch.slammap.points import MapPointStore

_FEATURE_FIELDS = list(FrameFeatures._fields)
_POINT_FIELDS = list(PointFeatures._fields)


def save_map(slam_map: SlamMap, path: str):
    arrays = {}
    meta = {"keyframes": [], "next_kid": slam_map._next_kid, "covis": {}}
    for kid, kf in slam_map.keyframes.items():
        meta["keyframes"].append(
            dict(
                kid=kid,
                frame_idx=kf.frame_idx,
                timestamp=kf.timestamp,
                parent=kf.parent,
                children=sorted(kf.children),
                loop_edges=sorted(kf.loop_edges),
            )
        )
        arrays[f"kf{kid}_T"] = kf.T_cw
        arrays[f"kf{kid}_line_ids"] = kf.line_ids
        for name in _FEATURE_FIELDS:
            arrays[f"kf{kid}_f_{name}"] = np.asarray(getattr(kf.features, name))
        if kf.point_ids is not None:
            arrays[f"kf{kid}_point_ids"] = kf.point_ids
            for name in _POINT_FIELDS:
                arrays[f"kf{kid}_p_{name}"] = np.asarray(getattr(kf.point_features, name))
    meta["covis"] = {str(k): v for k, v in slam_map.covis.items()}

    st = slam_map.lines
    arrays["lines_plucker"] = st.plucker
    arrays["lines_endpoints"] = st.endpoints
    arrays["lines_alive"] = st.alive
    arrays["lines_desc"] = st.desc_bits
    arrays["lines_n_obs"] = st.n_obs
    arrays["lines_first_kf"] = st.first_kf
    meta["lines_obs"] = {str(k): v for k, v in st.obs.items()}
    meta["lines_next"] = st._next
    meta["lines_free"] = st._free

    pt = slam_map.points
    if len(pt.obs) or pt._next:
        arrays["points_xyz"] = pt.xyz
        arrays["points_alive"] = pt.alive
        arrays["points_desc"] = pt.desc_bits
        arrays["points_n_obs"] = pt.n_obs
        arrays["points_first_kf"] = pt.first_kf
        meta["points_obs"] = {str(k): v for k, v in pt.obs.items()}
        meta["points_next"] = pt._next
        meta["points_free"] = pt._free

    np.savez_compressed(path, meta=json.dumps(meta), **arrays)


def load_map(path: str) -> SlamMap:
    data = np.load(path, allow_pickle=False)
    meta = json.loads(str(data["meta"]))
    m = SlamMap(native=False)  # the python graph, as the JAX loader builds it
    m._next_kid = meta["next_kid"]
    for e in meta["keyframes"]:
        kid = e["kid"]
        feats = FrameFeatures(*[data[f"kf{kid}_f_{name}"] for name in _FEATURE_FIELDS])
        kf = KeyFrame(
            kid=kid,
            frame_idx=e["frame_idx"],
            timestamp=e["timestamp"],
            T_cw=data[f"kf{kid}_T"],
            features=feats,
            line_ids=data[f"kf{kid}_line_ids"],
            parent=e["parent"],
            children=set(e["children"]),
            loop_edges=set(e["loop_edges"]),
        )
        if f"kf{kid}_point_ids" in data:
            kf.point_ids = data[f"kf{kid}_point_ids"]
            kf.point_features = PointFeatures(*[data[f"kf{kid}_p_{name}"] for name in _POINT_FIELDS])
        m.keyframes[kid] = kf
    m.covis = {int(k): {int(kk): vv for kk, vv in v.items()} for k, v in meta["covis"].items()}

    st = m.lines
    n = data["lines_plucker"].shape[0]
    if n > st.capacity:
        st = MapLineStore(capacity=n)
        m.lines = st
    st.plucker[:n] = data["lines_plucker"]
    st.endpoints[:n] = data["lines_endpoints"]
    st.alive[:n] = data["lines_alive"]
    st.desc_bits[:n] = data["lines_desc"]
    st.n_obs[:n] = data["lines_n_obs"]
    st.first_kf[:n] = data["lines_first_kf"]
    st.obs = {int(k): {int(kk): int(vv) for kk, vv in v.items()} for k, v in meta["lines_obs"].items()}
    st._next = meta["lines_next"]
    st._free = list(meta["lines_free"])

    if "points_xyz" in data:
        pt = m.points
        n = data["points_xyz"].shape[0]
        if n > pt.capacity:
            pt = MapPointStore(capacity=n)
            m.points = pt
        pt.xyz[:n] = data["points_xyz"]
        pt.alive[:n] = data["points_alive"]
        pt.desc_bits[:n] = data["points_desc"]
        pt.n_obs[:n] = data["points_n_obs"]
        pt.first_kf[:n] = data["points_first_kf"]
        pt.obs = {int(k): {int(kk): int(vv) for kk, vv in v.items()} for k, v in meta["points_obs"].items()}
        pt._next = meta["points_next"]
        pt._free = list(meta["points_free"])
    return m
