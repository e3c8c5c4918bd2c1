"""Settings files: tpuslam_torch.io.config against tpuslam.io.config on the
same YAML files (tests/test_io.py's, a distorted one, and the scaleFactor
rules), and System(settings) built from them."""

import numpy as np
import pytest

from tpuslam.io.config import load_settings as j_load_settings
from tpuslam_torch.convert import tracker_config_from
from tpuslam_torch.geometry.camera import Intrinsics
from tpuslam_torch.io.config import Settings, load_settings, load_yaml_settings, settings_from_dict
from tpuslam_torch.system import System

# tests/test_io.py's test_yaml_roundtrip settings
EUROC_YAML = """%YAML:1.0
---
# reference-style settings
Camera.fx: 458.654
Camera.fy: 457.296
Camera.cx: 367.215
Camera.cy: 248.375
Camera.width: 752
Camera.height: 480
Camera.bf: 47.90639384423901
Camera.fps: 20.0
LineExtractor.nFeatures: 300
LineExtractor.nLevels: 2
LineExtractor.scaleFactor: 0.8
"""
# TUM fr1's radtan coefficients, a reference scale divisor and detector keys
DISTORTED_YAML = """%YAML:1.0
Camera.fx: 517.306408
Camera.fy: 516.469215
Camera.cx: 318.643040
Camera.cy: 255.313989
Camera.k1: 0.262383   # radial
Camera.k2: -0.953104
Camera.p1: -0.005358
Camera.p2: 0.002628
Camera.fps: 30
LineExtractor.scaleFactor: 1.2
LineExtractor.minLineLength: 12.5
LineExtractor.minSupport: 16
"""
CASES = {
    "euroc": EUROC_YAML,
    "defaults": "",  # tests/test_io.py's test_defaults: no key at all
    "distorted": DISTORTED_YAML,
    "scale_divisor": "Camera.bf: 50.0\nLineExtractor.scaleFactor: 1.2\n",
}


def _both(tmp_path, text):
    p = tmp_path / "settings.yaml"
    p.write_text(text)
    return load_settings(str(p)), j_load_settings(str(p)), str(p)


@pytest.mark.parametrize("case", list(CASES))
def test_settings_match_jax(tmp_path, case):
    """The same camera (exactly), fps and raw keys, and a TrackerConfig equal
    to the JAX one carried over by convert.tracker_config_from."""
    s, js, path = _both(tmp_path, CASES[case])
    assert isinstance(s, Settings) and isinstance(s.cam, Intrinsics)
    assert tuple(s.cam) == tuple(js.cam)
    assert [type(v) for v in s.cam] == [type(v) for v in js.cam]
    assert s.fps == js.fps and s.raw == js.raw == load_yaml_settings(path)
    assert s.tracker == tracker_config_from(js.tracker)
    fe = s.tracker.frontend
    assert (fe.cam is None) == fe.dist.is_zero == (case != "distorted")
    if case == "scale_divisor":
        assert fe.scale == pytest.approx(1 / 1.2) and s.cam.baseline == pytest.approx(0.1)


def test_yaml_values(tmp_path):
    """tests/test_io.py's assertions, on this package's settings."""
    s, _, _ = _both(tmp_path, EUROC_YAML)
    assert abs(s.cam.fx - 458.654) < 1e-6
    assert s.cam.width == 752
    assert abs(s.cam.baseline - 47.90639384423901 / 458.654) < 1e-9
    assert s.tracker.frontend.max_lines == 300
    assert s.fps == 20.0
    assert settings_from_dict({}).cam.baseline == 0.0
    # overrides beat the file, as in the JAX package
    o = load_settings(str(tmp_path / "settings.yaml"), **{"Camera.width": 640})
    assert o.cam.width == 640 and o.raw["Camera.width"] == 640


@pytest.mark.parametrize("scale", [0, -1.5])
def test_nonpositive_scale_raises(tmp_path, scale):
    """scaleFactor <= 0 raises ValueError in both packages."""
    p = tmp_path / "settings.yaml"
    p.write_text(f"LineExtractor.scaleFactor: {scale}\n")
    with pytest.raises(ValueError, match="scaleFactor"):
        load_settings(str(p))
    with pytest.raises(ValueError, match="scaleFactor"):
        j_load_settings(str(p))


@pytest.mark.parametrize("case", ["euroc", "distorted"])
def test_system_takes_settings(tmp_path, case):
    """System(settings) takes the settings' camera and tracker config; an
    explicit tracker_cfg wins; Intrinsics still work."""
    s, _, _ = _both(tmp_path, CASES[case])
    sys_ = System(s, loop_closing=False, device="cpu")
    assert sys_.cam == s.cam and sys_.tracker.cam == s.cam
    assert sys_.tracker.cfg == s.tracker and sys_.mapper.cam == s.cam
    from tpuslam_torch.frontend.tracking import TrackerConfig

    mine = TrackerConfig(max_frames_between_kf=4)
    assert System(s, mapping=False, loop_closing=False, tracker_cfg=mine, device="cpu").tracker.cfg is mine
    assert System(s.cam, mapping=False, loop_closing=False, device="cpu").tracker.cfg == TrackerConfig()
    sys_.shutdown()
