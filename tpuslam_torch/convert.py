"""Carry the JAX package's state into this one, as numpy arrays and dicts.

Tests use these helpers to hand identical inputs to both packages. Each takes
NamedTuples, mappings, numpy arrays, or any object whose arrays ``np.asarray``
can read, and returns this package's types; nothing here imports JAX.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from tpuslam_torch.frontend.frame import FrameFeatures
from tpuslam_torch.slammap.map import KeyFrame, SlamMap, features_to_numpy


def _as_mapping(value) -> Mapping[str, Any]:
    return value._asdict() if hasattr(value, "_asdict") else value


def params_from(cls, value):
    """Build the NamedTuple ``cls`` from a NamedTuple or mapping with the same
    field names, recursing into fields whose default is itself a NamedTuple.
    Fields ``cls`` does not have are refused."""
    d = dict(_as_mapping(value))
    unknown = set(d) - set(cls._fields)
    if unknown:
        raise ValueError(f"{cls.__name__} has no fields {sorted(unknown)}")
    out = {}
    for name, v in d.items():
        default = cls._field_defaults.get(name)
        if v is not None and hasattr(default, "_fields"):
            v = params_from(type(default), v)
        out[name] = v
    return cls(**out)


def features_from(value, device="cpu") -> FrameFeatures:
    """FrameFeatures (tensors on ``device``) from a mapping or NamedTuple of
    arrays with FrameFeatures' field names; uint32 descriptor words become
    int64 words."""
    d = _as_mapping(value)
    out = {}
    for name in FrameFeatures._fields:
        a = np.asarray(d[name])
        if name == "desc_bits":
            a = a.astype(np.uint32).astype(np.int64)
        elif name == "level":
            a = a.astype(np.int32)
        else:
            a = a.astype(np.float32)
        out[name] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return FrameFeatures(**out)


def map_state(m) -> dict:
    """Numpy/dict snapshot of a SlamMap of either package: the line store,
    the keyframes (poses, features, observations, spanning tree) and the
    covisibility graph."""
    st = m.lines
    lines = dict(
        plucker=np.asarray(st.plucker),
        endpoints=np.asarray(st.endpoints),
        alive=np.asarray(st.alive),
        desc_bits=np.asarray(st.desc_bits).astype(np.uint32),
        n_obs=np.asarray(st.n_obs),
        first_kf=np.asarray(st.first_kf),
        obs={int(l): {int(k): int(s) for k, s in o.items()} for l, o in st.obs.items()},
        next=int(st._next),
        free=[int(x) for x in st._free],
    )
    keyframes = []
    for kid in sorted(m.keyframes):
        kf = m.keyframes[kid]
        keyframes.append(
            dict(
                kid=int(kf.kid),
                frame_idx=int(kf.frame_idx),
                timestamp=float(kf.timestamp),
                T_cw=np.asarray(kf.T_cw, np.float32),
                features={k: np.asarray(v) for k, v in _as_mapping(kf.features).items()},
                line_ids=np.asarray(kf.line_ids, np.int32),
                parent=kf.parent,
                children=sorted(int(c) for c in kf.children),
            )
        )
    covis = {int(a): {int(b): int(w) for b, w in row.items()} for a, row in m.covis.items()}
    return dict(lines=lines, keyframes=keyframes, covis=covis, next_kid=int(m._next_kid))


def slam_map_from(state: Mapping) -> SlamMap:
    """This package's SlamMap from a :func:`map_state` snapshot."""
    ls = state["lines"]
    m = SlamMap(line_capacity=len(ls["alive"]))
    st = m.lines
    st.plucker[:] = ls["plucker"]
    st.endpoints[:] = ls["endpoints"]
    st.alive[:] = ls["alive"]
    st.desc_bits[:] = ls["desc_bits"]
    st.n_obs[:] = ls["n_obs"]
    st.first_kf[:] = ls["first_kf"]
    st.obs = {l: dict(o) for l, o in ls["obs"].items()}
    st._next = ls["next"]
    st._free = list(ls["free"])
    for k in state["keyframes"]:
        feats = features_to_numpy(FrameFeatures(**{n: np.asarray(k["features"][n]) for n in FrameFeatures._fields}))
        m.keyframes[k["kid"]] = KeyFrame(
            kid=k["kid"],
            frame_idx=k["frame_idx"],
            timestamp=k["timestamp"],
            T_cw=np.asarray(k["T_cw"], np.float32).copy(),
            features=feats,
            line_ids=np.asarray(k["line_ids"], np.int32).copy(),
            parent=k["parent"],
            children=set(k["children"]),
        )
    m.covis = {a: dict(row) for a, row in state["covis"].items()}
    m._next_kid = state["next_kid"]
    return m
