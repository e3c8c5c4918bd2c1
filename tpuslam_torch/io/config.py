"""Settings files: reference-style flat YAML -> frozen dataclasses.

Counterpart of ``tpuslam.io.config``: the same ``Camera.*`` and
``LineExtractor.*`` keys (cv::FileStorage style, as the reference's
per-dataset settings files write them), mapped onto this package's
``Intrinsics``, ``FrontendParams`` and ``TrackerConfig``.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Dict, Optional

from tpuslam_torch.frontend.frame import FrontendParams
from tpuslam_torch.frontend.tracking import TrackerConfig
from tpuslam_torch.geometry.camera import Distortion, Intrinsics
from tpuslam_torch.kernels.lsd import LSDParams


def _parse_scalar(v: str) -> Any:
    v = v.strip().strip('"')
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            continue
    return v


def load_yaml_settings(path: str) -> Dict[str, Any]:
    """Minimal flat `Key.Sub: value` YAML reader (cv::FileStorage style).

    Handles the `%YAML` directive, comments, and flat scalar keys — the
    entire schema this system class uses. No external yaml dependency.
    """
    out: Dict[str, Any] = {}
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line or line.startswith("%") or line == "---":
                continue
            m = re.match(r"([\w.]+)\s*:\s*(.+)", line)
            if m:
                out[m.group(1)] = _parse_scalar(m.group(2))
    return out


@dataclass(frozen=True)
class Settings:
    cam: Intrinsics
    fps: float = 30.0
    tracker: TrackerConfig = None  # type: ignore[assignment]
    raw: Dict[str, Any] = None  # type: ignore[assignment]


def settings_from_dict(d: Dict[str, Any]) -> Settings:
    cam = Intrinsics(
        fx=float(d.get("Camera.fx", 500.0)),
        fy=float(d.get("Camera.fy", 500.0)),
        cx=float(d.get("Camera.cx", 320.0)),
        cy=float(d.get("Camera.cy", 240.0)),
        width=int(d.get("Camera.width", 640)),
        height=int(d.get("Camera.height", 480)),
        # reference convention: Camera.bf = fx * baseline
        baseline=float(d.get("Camera.bf", 0.0)) / max(float(d.get("Camera.fx", 500.0)), 1e-9),
    )
    lsd = LSDParams(
        min_length=float(d.get("LineExtractor.minLineLength", 15.0)),
        min_support=int(d.get("LineExtractor.minSupport", 20)),
    )
    # Reference YAMLs use scaleFactor > 1 (per-level downscale divisor, e.g.
    # 1.2); FrontendParams.scale is the < 1 multiplier. Accept both.
    s = float(d.get("LineExtractor.scaleFactor", 0.8))
    if s <= 0:
        raise ValueError(f"LineExtractor.scaleFactor must be positive, got {s}")
    dist = Distortion(
        k1=float(d.get("Camera.k1", 0.0)),
        k2=float(d.get("Camera.k2", 0.0)),
        p1=float(d.get("Camera.p1", 0.0)),
        p2=float(d.get("Camera.p2", 0.0)),
    )
    fe = FrontendParams(
        max_lines=int(d.get("LineExtractor.nFeatures", 256)),
        n_levels=int(d.get("LineExtractor.nLevels", 2)),
        scale=1.0 / s if s > 1.0 else s,
        lsd=lsd,
        dist=dist,
        cam=None if dist.is_zero else cam,
    )
    tracker = TrackerConfig(frontend=fe)
    return Settings(cam=cam, fps=float(d.get("Camera.fps", 30.0)), tracker=tracker, raw=d)


def load_settings(path: Optional[str] = None, **overrides) -> Settings:
    d = load_yaml_settings(path) if path else {}
    d.update(overrides)
    return settings_from_dict(d)
