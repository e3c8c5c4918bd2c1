"""Carry the JAX package's state into this one, as numpy arrays and dicts.

Tests use these helpers to hand identical inputs to both packages. Each takes
NamedTuples, mappings, numpy arrays, or any object whose arrays ``np.asarray``
can read, and returns this package's types; nothing here imports JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from tpuslam_torch.backend.global_ba import GlobalBAConfig
from tpuslam_torch.backend.lm import BAProblem
from tpuslam_torch.backend.loop_closing import LoopConfig
from tpuslam_torch.backend.mapping import MapperConfig
from tpuslam_torch.backend.pose_graph import PoseGraphProblem, Sim3GraphProblem
from tpuslam_torch.frontend.frame import FrameFeatures, FrontendParams
from tpuslam_torch.frontend.initializer import MonoInitParams
from tpuslam_torch.frontend.points import PointFrontendParams
from tpuslam_torch.frontend.tracking import TrackerConfig
from tpuslam_torch.geometry.camera import Intrinsics
from tpuslam_torch.kernels.align_direct import DirectAlignParams
from tpuslam_torch.kernels.fast import PointFeatures
from tpuslam_torch.kernels.stereo_direct import DirectPointStereoParams, DirectStereoParams
from tpuslam_torch.slammap.map import (
    KeyFrame,
    SlamMap,
    features_to_device,
    features_to_numpy,
    point_features_to_device,
    point_features_to_numpy,
)


def _as_mapping(value) -> Mapping[str, Any]:
    return value._asdict() if hasattr(value, "_asdict") else value


def _ported_fields(value, ours, cls_name) -> dict:
    """The fields of ``value`` (a NamedTuple, dataclass or mapping) that
    ``ours`` names. A field ``ours`` lacks belongs to a path this package does
    not run: it is dropped when it holds its class's default and refused
    otherwise (a mapping has no defaults, so its extra keys are refused)."""
    if dataclasses.is_dataclass(value):
        d = {f.name: getattr(value, f.name) for f in dataclasses.fields(value)}
        fresh = type(value)()
        defaults = {name: getattr(fresh, name) for name in d}
    else:
        d = dict(_as_mapping(value))
        defaults = getattr(type(value), "_field_defaults", {})
    refused = sorted(k for k, v in d.items() if k not in ours and (k not in defaults or v != defaults[k]))
    if refused:
        raise ValueError(f"{cls_name} has no fields {refused}: their paths are not ported")
    return {k: v for k, v in d.items() if k in ours}


def params_from(cls, value):
    """Build the NamedTuple ``cls`` from a NamedTuple or mapping with the same
    field names, recursing into fields whose default is itself a NamedTuple.
    Fields ``cls`` does not have are dropped when ``value``'s class holds
    them at their defaults, and refused otherwise."""
    out = {}
    for name, v in _ported_fields(value, cls._fields, cls.__name__).items():
        default = cls._field_defaults.get(name)
        if v is not None and hasattr(default, "_fields"):
            v = params_from(type(default), v)
        out[name] = v
    return cls(**out)


def frontend_params_from(value) -> FrontendParams:
    """FrontendParams from the JAX package's: its LSD, LBD and radtan
    ``dist`` settings, and the camera ``cam`` (set with distortion) as this
    package's Intrinsics."""
    fe = params_from(FrontendParams, value)
    return fe if fe.cam is None else fe._replace(cam=Intrinsics(*fe.cam))


def features_from(value, device="cpu") -> FrameFeatures:
    """FrameFeatures (tensors on ``device``) from a mapping or NamedTuple of
    arrays with FrameFeatures' field names; uint32 descriptor words become
    int64 words."""
    d = _as_mapping(value)
    return features_to_device(FrameFeatures(**{name: np.asarray(d[name]) for name in FrameFeatures._fields}), device)


def point_features_from(value, device="cpu") -> PointFeatures:
    """PointFeatures (tensors on ``device``) from a mapping or NamedTuple of
    arrays with PointFeatures' field names; uint32 descriptor words become
    int64 words."""
    d = _as_mapping(value)
    return point_features_to_device(PointFeatures(**{name: np.asarray(d[name]) for name in PointFeatures._fields}), device)


_BA_INDEX_FIELDS = ("l_pose", "l_line", "p_pose", "p_point")


def ba_problem_from(value, device="cpu") -> BAProblem:
    """BAProblem (tensors on ``device``) from one with BAProblem's field
    names; the observation index fields stay int32, the rest float32."""
    d = _as_mapping(value)
    out = {}
    for name in BAProblem._fields:
        a = np.asarray(d[name])
        a = a.astype(np.int32 if name in _BA_INDEX_FIELDS else np.float32)
        out[name] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return BAProblem(**out)


def mapper_config_from(value) -> MapperConfig:
    """MapperConfig from a MapperConfig-like dataclass (the JAX package's):
    every field carries over, the mono triangulation fields
    (``triangulate_neighbors``, ``tri_*``) and the deferred fusion's
    (``fuse_defer``, ``fuse_apply_delay_s``) included."""
    ours = MapperConfig()
    out = {}
    for name, v in _ported_fields(value, {f.name for f in dataclasses.fields(MapperConfig)}, "MapperConfig").items():
        default = getattr(ours, name)
        out[name] = params_from(type(default), v) if hasattr(default, "_fields") else v
    return MapperConfig(**out)


def mono_init_params_from(value) -> MonoInitParams:
    """MonoInitParams from the JAX package's (its MatchParams included)."""
    return params_from(MonoInitParams, value)


def init_result_from(result, device="cpu"):
    """A ``MonoInitializer.try_initialize`` result of the JAX package (None
    or its 9-tuple) as this package's: the reference frame's features as
    tensors on ``device``, the rest as numpy (T_10, Pluecker lines and
    endpoints float32, ok bool, slots int64)."""
    if result is None:
        return None
    ref, t0, idx0, T10, Lw, ep3d, ok, slots0, slots1 = result
    return (
        features_from(ref, device),
        float(t0),
        int(idx0),
        np.asarray(T10, np.float32),
        np.asarray(Lw, np.float32),
        np.asarray(ep3d, np.float32),
        np.asarray(ok, bool),
        np.asarray(slots0, np.int64),
        np.asarray(slots1, np.int64),
    )


def global_ba_config_from(value) -> GlobalBAConfig:
    """GlobalBAConfig from the JAX package's (its LMConfig included)."""
    return params_from(GlobalBAConfig, value)


def loop_config_from(value) -> LoopConfig:
    """LoopConfig from a LoopConfig-like dataclass (the JAX package's): its
    MatchParams, PoseGraphConfig and, when set, GlobalBAConfig become this
    package's types."""
    ours = LoopConfig()
    out = {}
    for name, v in _ported_fields(value, {f.name for f in dataclasses.fields(LoopConfig)}, "LoopConfig").items():
        default = getattr(ours, name)
        if name == "gba_cfg":
            v = None if v is None else global_ba_config_from(v)
        elif hasattr(default, "_fields"):
            v = params_from(type(default), v)
        out[name] = v
    return LoopConfig(**out)


def _graph_problem_from(cls, value, device):
    d = _as_mapping(value)
    out = {}
    for name in cls._fields:
        a = np.asarray(d[name])
        a = a.astype(np.int32 if name in ("e_i", "e_j") else np.float32)
        out[name] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return cls(**out)


def pose_graph_problem_from(value, device="cpu") -> PoseGraphProblem:
    """PoseGraphProblem (tensors on ``device``) from one with its field
    names; the edge ends stay int32, the rest float32."""
    return _graph_problem_from(PoseGraphProblem, value, device)


def sim3_graph_problem_from(value, device="cpu") -> Sim3GraphProblem:
    """Sim3GraphProblem (tensors on ``device``) from one with its field
    names; the edge ends stay int32, the rest float32."""
    return _graph_problem_from(Sim3GraphProblem, value, device)


# TrackerConfig fields whose default is None and whose value is a NamedTuple
_TRACKER_PARAMS = {
    "direct_stereo": DirectStereoParams,
    "semidirect": DirectAlignParams,
    "points": PointFrontendParams,
    "direct_points": DirectPointStereoParams,
}


def tracker_config_from(value) -> TrackerConfig:
    """TrackerConfig from a TrackerConfig-like dataclass (the JAX package's):
    the front end (radtan ``dist`` and ``cam`` included), stereo, search and
    pose settings, the pipelined fields (``pipelined``, ``fused``,
    ``fuse_lag``, ``chunk``), ``direct_stereo``, ``semidirect`` and the
    hybrid-point fields (``points``, ``point_local_capacity``,
    ``direct_points``) become this package's types."""
    ours = TrackerConfig()
    out = {}
    for name, v in _ported_fields(value, {f.name for f in dataclasses.fields(TrackerConfig)}, "TrackerConfig").items():
        default = getattr(ours, name)
        if name in _TRACKER_PARAMS:
            v = None if v is None else params_from(_TRACKER_PARAMS[name], v)
        elif name == "frontend":
            v = frontend_params_from(v)
        elif hasattr(default, "_fields"):
            v = params_from(type(default), v)
        out[name] = v
    return TrackerConfig(**out)


def tensor_from(value, device="cpu", dtype=None) -> torch.Tensor:
    """A tensor on ``device`` from any array ``np.asarray`` reads (its dtype
    kept unless ``dtype`` is given)."""
    t = torch.from_numpy(np.array(value))  # a writable copy
    return t.to(device=device, dtype=dtype) if dtype is not None else t.to(device)


def local_map_from(value, device="cpu") -> dict:
    """The tracker's local-map arrays from a mapping with the JAX tracker's
    keys: plucker (NL, 6), ep3d (NL, 2, 3) and valid (NL,) as float32, the
    uint32 descriptor words ``bits`` (NL, W) as int64."""
    d = _as_mapping(value)
    return dict(
        plucker=tensor_from(d["plucker"], device, torch.float32),
        ep3d=tensor_from(d["ep3d"], device, torch.float32),
        bits=tensor_from(np.asarray(d["bits"]).astype(np.uint32).astype(np.int64), device),
        valid=tensor_from(d["valid"], device, torch.float32),
    )


def point_local_from(value, device="cpu") -> dict:
    """The tracker's local point-map arrays from a mapping with the JAX
    tracker's keys: xyz (NP, 3) and valid (NP,) as float32, the uint32
    descriptor words ``bits`` (NP, W) as int64."""
    d = _as_mapping(value)
    return dict(
        xyz=tensor_from(d["xyz"], device, torch.float32),
        bits=tensor_from(np.asarray(d["bits"]).astype(np.uint32).astype(np.int64), device),
        valid=tensor_from(d["valid"], device, torch.float32),
    )


def chunk_inputs_from(frames, T_last, T_prevlast, local, device="cpu"):
    """The inputs of one semi-direct chunk (``frontend.pipeline``): the
    (C + 1, H, W) frame stack (u8 kept as u8), the pose chain (T_last,
    T_prevlast) as float32 (4, 4) and the local-map arrays. Returns
    (frames, T_last, T_prevlast, local) on ``device``."""
    return (
        tensor_from(frames, device),
        tensor_from(T_last, device, torch.float32),
        tensor_from(T_prevlast, device, torch.float32),
        local_map_from(local, device),
    )


def _store_state(st, *arrays) -> dict:
    """A landmark store's arrays, observation dicts and free list."""
    out = {name: np.array(getattr(st, name)) for name in arrays}
    out.update(
        alive=np.array(st.alive),
        desc_bits=np.asarray(st.desc_bits).astype(np.uint32),
        n_obs=np.array(st.n_obs),
        first_kf=np.array(st.first_kf),
        obs={int(l): {int(k): int(s) for k, s in o.items()} for l, o in st.obs.items()},
        next=int(st._next),
        free=[int(x) for x in st._free],
    )
    return out


def _restore_store(st, state: Mapping, *arrays) -> None:
    for name in (*arrays, "alive", "desc_bits", "n_obs", "first_kf"):
        getattr(st, name)[:] = state[name]
    st.obs = {l: dict(o) for l, o in state["obs"].items()}
    st._next = state["next"]
    st._free = list(state["free"])


def map_state(m) -> dict:
    """Numpy/dict snapshot (copies: later edits of the map leave it as it
    was) of a SlamMap of either package: the line and
    point stores (free lists in order), the keyframes (poses, line and
    corner features, observations, spanning tree, loop edges) and the
    covisibility graph."""
    lines = _store_state(m.lines, "plucker", "endpoints")
    points = _store_state(m.points, "xyz")
    keyframes = []
    for kid in sorted(m.keyframes):
        kf = m.keyframes[kid]
        keyframes.append(
            dict(
                kid=int(kf.kid),
                frame_idx=int(kf.frame_idx),
                timestamp=float(kf.timestamp),
                T_cw=np.array(kf.T_cw, np.float32),
                features={k: np.asarray(v) for k, v in _as_mapping(kf.features).items()},
                line_ids=np.array(kf.line_ids, np.int32),
                point_features=None
                if kf.point_features is None
                else {k: np.asarray(v) for k, v in _as_mapping(kf.point_features).items()},
                point_ids=None if kf.point_ids is None else np.array(kf.point_ids, np.int32),
                is_bad=bool(kf.is_bad),
                parent=kf.parent,
                children=sorted(int(c) for c in kf.children),
                loop_edges=sorted(int(c) for c in kf.loop_edges),
            )
        )
    covis = {int(a): {int(b): int(w) for b, w in row.items()} for a, row in m.covis.items()}
    return dict(
        lines=lines, points=points, keyframes=keyframes, covis=covis, next_kid=int(m._next_kid), generation=int(m.generation)
    )


def slam_map_from(state: Mapping) -> SlamMap:
    """This package's SlamMap from a :func:`map_state` snapshot, on the
    python covisibility graph (no native mirror: the stores are restored
    array by array, as a loaded map is)."""
    ls, ps = state["lines"], state["points"]
    m = SlamMap(line_capacity=len(ls["alive"]), point_capacity=len(ps["alive"]), native=False)
    _restore_store(m.lines, ls, "plucker", "endpoints")
    _restore_store(m.points, ps, "xyz")
    for k in state["keyframes"]:
        feats = features_to_numpy(FrameFeatures(**{n: np.asarray(k["features"][n]) for n in FrameFeatures._fields}))
        pf = k["point_features"]
        if pf is not None:
            pf = point_features_to_numpy(PointFeatures(**{n: np.asarray(pf[n]) for n in PointFeatures._fields}))
        m.keyframes[k["kid"]] = KeyFrame(
            kid=k["kid"],
            frame_idx=k["frame_idx"],
            timestamp=k["timestamp"],
            T_cw=np.asarray(k["T_cw"], np.float32).copy(),
            features=feats,
            line_ids=np.asarray(k["line_ids"], np.int32).copy(),
            is_bad=k["is_bad"],
            parent=k["parent"],
            children=set(k["children"]),
            loop_edges=set(k["loop_edges"]),
            point_features=pf,
            point_ids=None if k["point_ids"] is None else np.asarray(k["point_ids"], np.int32).copy(),
        )
    m.covis = {a: dict(row) for a, row in state["covis"].items()}
    m._next_kid = state["next_kid"]
    m.generation = state["generation"]
    return m
