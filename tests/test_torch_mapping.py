"""tpuslam_torch's local mapping against tpuslam's on the same map: window
assembly, the BA write-back, and one whole keyframe event of the mapper.

The map comes from the JAX System (stereo, mapping on) driven by exact
synthetic features, and is carried across with ``convert``. The JAX map's
native graph mirror is switched off: it orders covisibility ties its own
way, and this package follows the JAX map's python dicts."""

import copy

import numpy as np
import pytest
import torch

from torch_parity import np_of
from tpuslam.backend import local_ba as jlba
from tpuslam.backend.mapping import MapperConfig as JMapperConfig
from tpuslam.frontend.tracking import TrackerConfig as JTrackerConfig
from tpuslam.geometry import Intrinsics as JIntrinsics
from tpuslam.io.synthetic import make_wireframe_scene, synthetic_frame_features
from tpuslam.system import System as JSystem
from tpuslam_torch import Intrinsics
from tpuslam_torch.backend import local_ba as tlba
from tpuslam_torch.backend.residuals import line_residuals
from tpuslam_torch.backend.mapping import LocalMapper
from tpuslam_torch.convert import map_state, mapper_config_from, params_from, slam_map_from
from tpuslam_torch.geometry import project_points, se3_apply

J_CAM = JIntrinsics(fx=458.0, fy=457.0, cx=320.0, cy=240.0, width=640, height=480, baseline=0.11)
T_CAM = Intrinsics(*J_CAM)
N_FRAMES = 24


@pytest.fixture(scope="module")
def jax_run():
    """24 frames of the JAX System, a keyframe every 3 frames; the map and
    the mapper's state are recorded before and after every keyframe event."""
    events = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TPUSLAM_NATIVE_MAP", "0")
        rng = np.random.default_rng(0)
        scene = make_wireframe_scene(rng, n_segments=140, n_frames=N_FRAMES, cam=J_CAM, motion_scale=0.02)
        js = JSystem(J_CAM, sensor="stereo", loop_closing=False, tracker_cfg=JTrackerConfig(max_frames_between_kf=3))
        process = js.mapper.process

        def recorded(kf):
            before = copy.deepcopy((map_state(js.map), dict(js.mapper._recent), js.mapper._kf_count))
            process(kf)
            events.append(dict(kid=kf.kid, before=before, after=copy.deepcopy(map_state(js.map)), last_ba=js.mapper.last_ba))

        js.mapper.process = recorded
        for f in range(N_FRAMES):
            feats, _ = synthetic_frame_features(scene, f, noise_px=0.3, rng=rng, with_depth=True)
            js.tracker.frame_idx = f
            js.trajectory.append(js.tracker._track(feats, f * 0.05, stereo=True))
    return js, events


def _assert_maps_equal(a, b):
    for k in ("plucker", "endpoints", "alive", "desc_bits", "n_obs", "first_kf"):
        np.testing.assert_array_equal(a["lines"][k], b["lines"][k], err_msg=k)
    for k in ("obs", "next", "free"):
        assert a["lines"][k] == b["lines"][k], k
    assert len(a["keyframes"]) == len(b["keyframes"])
    for ka, kb in zip(a["keyframes"], b["keyframes"]):
        for k in ("kid", "is_bad", "parent", "children"):
            assert ka[k] == kb[k], k
        np.testing.assert_array_equal(ka["T_cw"], kb["T_cw"])
        np.testing.assert_array_equal(ka["line_ids"], kb["line_ids"])
    assert a["covis"] == b["covis"] and a["next_kid"] == b["next_kid"]


def test_assemble_and_apply_match_jax(jax_run):
    """The window problem is equal field by field (index fields int32), so
    is its context; one result written back through both packages' apply
    leaves equal maps (the chi2 prune included)."""
    js, _ = jax_run
    center = max(js.map.keyframes)
    cfg = jlba.LocalBAConfig()
    tmap = slam_map_from(map_state(js.map))
    jprob, jctx = jlba.assemble_problem(js.map, center, J_CAM, cfg)
    tprob, tctx = tlba.assemble_problem(tmap, center, T_CAM, tlba.LocalBAConfig(), device="cpu")
    assert len(jctx["window"]) >= 3
    for name in jprob._fields:
        a, b = np.asarray(getattr(jprob, name)), np_of(getattr(tprob, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert jctx.keys() == tctx.keys()
    for k in jctx:
        np.testing.assert_array_equal(np.asarray(jctx[k]), np.asarray(tctx[k]), err_msg=k)

    res = jlba.solve_in_process(jprob, J_CAM, cfg)
    res["inl_l"] = res["inl_l"].copy()
    res["inl_l"][: len(res["inl_l"]) // 8] = 0.0  # force a prune of real rows
    jstats = jlba.apply_result(js.map, cfg, jctx, copy.deepcopy(res))
    tstats = tlba.apply_result(tmap, tlba.LocalBAConfig(), tctx, copy.deepcopy(res))
    assert tuple(jstats) == tuple(tstats) and tstats.n_pruned > 0
    _assert_maps_equal(map_state(tmap), map_state(js.map))


def test_bucket_ladder_matches_jax():
    cfg = tlba.LocalBAConfig()
    lists = (cfg.pose_buckets, cfg.line_buckets, cfg.obs_buckets)
    assert tlba.bucket_ladder(*lists) == jlba.bucket_ladder(*lists)
    for ns in [(3, 100, 400), (9, 100, 400), (8, 129, 100), (30, 5000, 1), (24, 1024, 4096)]:
        assert tlba.ladder_bucket(ns, *lists) == jlba.ladder_bucket(ns, *lists)
    assert [tlba._bucket(n, cfg.line_buckets) for n in (1, 128, 129, 9999)] == [
        jlba._bucket(n, cfg.line_buckets) for n in (1, 128, 129, 9999)
    ]


def test_ba_configs_carry_ported_fields_only():
    """The JAX LocalBAConfig's point buckets belong to hybrid points, which
    are not ported: at their defaults they are dropped, otherwise refused,
    directly and inside a MapperConfig."""
    jcfg = jlba.LocalBAConfig(window_size=7)
    assert set(jcfg._fields) - set(tlba.LocalBAConfig._fields) == {"point_buckets", "p_obs_buckets"}
    cfg = params_from(tlba.LocalBAConfig, jcfg)
    assert isinstance(cfg.lm, type(tlba.LocalBAConfig().lm))
    assert all(getattr(cfg, k) == getattr(jcfg, k) for k in cfg._fields if k != "lm")
    assert tuple(cfg.lm) == tuple(jcfg.lm)
    assert mapper_config_from(JMapperConfig(ba=jcfg)).ba == cfg
    for bad in (jlba.LocalBAConfig(point_buckets=(64,)), jlba.LocalBAConfig(p_obs_buckets=(256,))):
        with pytest.raises(ValueError, match="not ported"):
            params_from(tlba.LocalBAConfig, bad)
        with pytest.raises(ValueError, match="not ported"):
            mapper_config_from(JMapperConfig(ba=bad))


@pytest.mark.parametrize("kid", [3, 6, 7])
def test_mapper_event_matches_jax(jax_run, kid):
    """A keyframe event of the run, replayed by this package's mapper from
    the map the JAX mapper started from: the same landmarks culled and fused,
    the same observations pruned and keyframes culled, and BA poses and lines
    within float32 LM agreement. Event 3 prunes an observation and culls
    landmarks; events 6 and 7 cull a keyframe."""
    js, events = jax_run
    ev = next(e for e in events if e["kid"] == kid)
    before, recent, kf_count = ev["before"]
    tmap = slam_map_from(before)
    mapper = LocalMapper(tmap, T_CAM, mapper_config_from(js.mapper.cfg), device="cpu")
    mapper._recent, mapper._kf_count = dict(recent), kf_count
    mapper.process(tmap.keyframes[kid])
    got, want = map_state(tmap), ev["after"]
    assert before["lines"]["obs"] != want["lines"]["obs"]  # the event changes the map
    assert got["lines"]["obs"] == want["lines"]["obs"]  # fusion, culling, prune
    np.testing.assert_array_equal(got["lines"]["alive"], want["lines"]["alive"])
    assert got["lines"]["free"] == want["lines"]["free"]
    assert [k["kid"] for k in got["keyframes"]] == [k["kid"] for k in want["keyframes"]]
    assert (len(want["keyframes"]) < len(before["keyframes"])) == (kid in (6, 7))
    assert got["covis"] == want["covis"]
    for a, b in zip(got["keyframes"], want["keyframes"]):
        assert (a["parent"], a["children"]) == (b["parent"], b["children"])
        np.testing.assert_array_equal(a["line_ids"], b["line_ids"])
        np.testing.assert_allclose(a["T_cw"], b["T_cw"], atol=2e-4)  # float32 LM, 8 iterations
    # lines seen from 3+ keyframes are fixed by the data; lines seen from 1-2
    # nearby ones only up to their depth along the viewing rays (which rides
    # on damping and float32 rounding), so every line is also held in the
    # images that observe it: the JAX line's endpoints lie on this package's
    # image line within 1 px
    n_obs, alive = want["lines"]["n_obs"], want["lines"]["alive"]
    firm = alive & (n_obs >= 3)
    assert firm.sum() > 50
    np.testing.assert_allclose(got["lines"]["endpoints"][firm], want["lines"]["endpoints"][firm], atol=1e-2)
    poses = {k["kid"]: k["T_cw"] for k in want["keyframes"]}
    rows = [(l, k) for l in np.nonzero(alive)[0] for k in want["lines"]["obs"][int(l)]]
    T = torch.from_numpy(np.stack([poses[k] for _, k in rows]))
    ep = torch.from_numpy(np.stack([want["lines"]["endpoints"][l] for l, _ in rows]))
    X = se3_apply(T[:, None], ep)
    front = (X[..., 2] > 0.1).all(dim=-1)  # endpoints in front of that camera
    assert front.float().mean() > 0.95
    L = torch.from_numpy(np.stack([got["lines"]["plucker"][l] for l, _ in rows]))
    r = line_residuals(T[front], L[front], project_points(T_CAM, X[front]), T_CAM)
    assert r.abs().max() < 1.0
    stats, jstats = mapper.last_ba, ev["last_ba"]
    assert stats[:4] == jstats[:4] and stats.n_pruned == jstats.n_pruned
    np.testing.assert_allclose(stats.cost, jstats.cost, rtol=1e-3)
