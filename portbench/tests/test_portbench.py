"""CPU tests of the benchmark (portbench): its data found by name, the
stream generator, the frozen renderer, the JAX check, the result line, the
comparison and its faults. A card test runs one cell through run.py.

    python -m pytest portbench/tests -q -p xdist -n 4
"""

from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

HERE = Path(__file__).resolve().parent
REPO = HERE.parent.parent
sys.path.insert(0, str(REPO))

from portbench import correct, detector, harness, reference, stream  # noqa: E402

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _small(tmp_path_factory, sequences: int):
    dst = tmp_path_factory.mktemp("bench") / "portbench"
    subprocess.run([sys.executable, str(HERE / "cpu_cell.py"), "--make", str(dst), str(sequences)], check=True, cwd=REPO)
    return dst


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """A copy of the benchmark cut to one sequence and 4 warm-up frames
    (cpu_cell.small_bench); its rig, traffic and limits are the cell's."""
    return _small(tmp_path_factory, 1)


@pytest.fixture(scope="module")
def small2(tmp_path_factory):
    """The same with two sequences, for a fault that leaves half out."""
    return _small(tmp_path_factory, 2)


def run_small(bench: Path, workload: str, *extra, seconds: float = 8.0):
    p = subprocess.run(
        [sys.executable, str(HERE / "cpu_cell.py"), str(bench), workload, str(seconds), *extra],
        capture_output=True, text=True, cwd=REPO, timeout=900,
    )
    assert p.returncode == 0, p.stderr[-4000:]
    lines = p.stdout.strip().splitlines()
    return json.loads(lines[-2]), json.loads(lines[-1])


def test_benchmark_json_keys_names_and_units():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert isinstance(SPEC["run_seconds"], int) and 10 <= SPEC["run_seconds"] <= 51
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("portbench/") and all(NAME.match(k) for k in c["reduced"])
    ends = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in ends
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert m["moves"] in ends and m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert set(m["workloads"]) <= {w["name"] for w in SPEC["workloads"]}


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_cell_found_by_name(workload):
    cell = harness.Cell(SPEC, workload, REPO)
    assert callable(cell.builder.build)
    assert {"lap_frames", "step_m", "step_deg", "segments", "scene_seed", "noise", "rate_hz"} <= set(cell.traffic)
    assert set(cell.limits) == {"failed_share", "ate_m", "rpe_m", "det_gap", "ba_gap"}
    for m, reader in cell.readers(cell.end_to_end + cell.per_layer).values():
        assert callable(reader.read), m["name"]
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "device_ms_per_frame"}
    assert cell.per_layer


@pytest.mark.parametrize("L", [200, 160])
def test_periodic_path_closes_with_continuous_velocity(L):
    traffic = json.loads((HERE.parent / "traffic" / "mh01_lap200.json").read_text())
    step = traffic["step_m"]
    poses = stream.periodic_path(L, step, traffic["step_deg"])
    cyc = np.linalg.inv(np.concatenate([poses, poses[:2]]))  # T_wc, the wrap included
    steps = np.stack([np.linalg.inv(a) @ b for a, b in zip(cyc, cyc[1:])])  # motion between frames
    trans = np.linalg.norm(steps[:, :3, 3], axis=1)
    rot = np.degrees(np.arccos(np.clip((np.trace(steps[:, :3, :3], axis1=1, axis2=2) - 1) / 2, -1, 1)))
    assert abs(trans[:L].mean() - step) < 0.02 * step
    assert abs(rot[:L].mean() - traffic["step_deg"]) < 0.1 * traffic["step_deg"]
    # the velocity is continuous: no step differs from the one before by more than a small share of a step
    assert np.max(np.abs(np.diff(steps[:, :3, 3], axis=0))) < 0.1 * trans.mean()
    assert np.max(np.abs(np.diff(steps[:, :3, :3], axis=0))) < 0.1 * np.radians(rot.mean())


def test_frozen_renderer_equals_the_ports():
    from tpuslam_torch.geometry.camera import Intrinsics
    from tpuslam_torch.io.synthetic import make_wireframe_scene, render_wireframe_image

    rig = stream.Rig(458.0, 457.0, 320.0, 240.0, 640, 480, 0.11)
    scene = make_wireframe_scene(np.random.default_rng(0), n_segments=140, n_frames=2, cam=Intrinsics(*rig[:7]))
    seg = stream.scene_segments(0, 140)
    assert np.array_equal(seg, scene.segments)
    poses = stream.periodic_path(120, 0.0085, 0.13)
    for f in (0, 37, 119):
        ours = stream.render(seg, poses[f], rig)
        theirs = render_wireframe_image(scene._replace(poses=poses.astype(np.float32)), f, noise=0.0)
        assert np.array_equal(ours, theirs)


def test_forbidden_modules_compared_by_whole_top_level_name(monkeypatch):
    for name in ("tpuslam_torch", "tpuslam_torch.system", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert harness.loaded_forbidden() == []
    for name in ("jax.numpy", "tpuslam", "flax.linen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert harness.loaded_forbidden() == ["flax", "jax", "tpuslam"]


LM = {"max_iters": 8, "lam0": 1e-4, "lam_up": 4.0, "lam_down": 0.5, "huber_line": 2.0, "min_lam": 1e-8, "max_lam": 1e4}


def _window(seed: int = 1):
    """A local-BA window over the bench scene: 6 keyframes on the path, the
    first fixed, the visible segments as lines, endpoints with 0.5 px noise,
    the start perturbed."""
    rng = np.random.default_rng(seed)
    rig = stream.Rig(458.0, 457.0, 320.0, 240.0, 640, 480, 0.11)
    seg = stream.scene_segments(0, 60).astype(np.float64)
    path = stream.periodic_path(400, 0.0085, 0.13)
    frames = [0, 20, 40, 60, 80, 100]
    A, B = seg[:, 0], seg[:, 1]
    v = B - A
    s = np.linalg.norm(v, axis=1, keepdims=True)
    lines = np.concatenate([np.cross(A, B) / s, v / s], axis=1)
    rows = []
    for pi, f in enumerate(frames):
        uv, vis = stream.project(seg, path[f], rig)
        rows += [(pi, li, uv[li] + rng.normal(size=(2, 2)) * 0.5) for li in np.nonzero(vis)[0]]
    poses = path[frames].copy()
    poses[1:, :3, 3] += rng.normal(size=(len(frames) - 1, 3)) * 0.005
    O = len(rows)
    w = reference.BAWindow(
        poses, (np.arange(len(frames)) > 0).astype(np.float32), lines + rng.normal(size=lines.shape) * 0.003,
        np.ones(len(lines)), np.array([r[0] for r in rows]), np.array([r[1] for r in rows]),
        np.stack([r[2] for r in rows]), np.ones(O), np.ones(O),
    )
    return w, rig


def test_ba_compare_reads_0_for_the_reference_and_apart_for_the_start_and_for_bfloat16():
    w, rig = _window()
    solved = reference.ba_solve(w, rig, LM)
    assert reference.ba_compare([w], [solved], rig, LM) == {"ba_gap": 0.0, "ba_pose_m": 0.0}
    f32 = reference.ba_compare([w], [None], rig, LM, dtype=torch.float32)
    assert f32["ba_gap"] < 1e-4 and f32["ba_pose_m"] < 1e-3
    start = reference.ba_compare([w], [(w.poses, w.lines)], rig, LM)  # a solve that returned its start
    assert start["ba_gap"] > 0.5 and start["ba_pose_m"] > 1e-3
    bf16 = reference.ba_compare([w], [None], rig, LM, dtype=torch.bfloat16)  # the control
    assert bf16["ba_gap"] > 0.05 and bf16["ba_pose_m"] > 1e-3


def test_ba_cost_is_the_programs_cost():
    """The reference's Huber cost equals the one the port's LM reports."""
    from tpuslam_torch.backend.lm import BAProblem, LMConfig, run_lm
    from tpuslam_torch.geometry.camera import Intrinsics

    w, rig = _window()
    t = lambda a, d=torch.float32: torch.as_tensor(np.asarray(a)).to(d)  # noqa: E731
    prob = BAProblem(
        poses=t(w.poses), pose_free=t(w.pose_free), lines=t(w.lines), line_valid=t(w.line_valid),
        points=torch.zeros((1, 3)), point_valid=torch.zeros(1), l_pose=t(w.l_pose, torch.int32),
        l_line=t(w.l_line, torch.int32), l_endpoints=t(w.l_endpoints), l_valid=t(w.l_valid), l_sigma=t(w.l_sigma),
        p_pose=torch.zeros(1, dtype=torch.int32), p_point=torch.zeros(1, dtype=torch.int32), p_uv=torch.zeros((1, 2)),
        p_valid=torch.zeros(1), p_sigma=torch.ones(1),
    )
    state = run_lm(prob, Intrinsics(*rig[:7]), LMConfig(max_iters=8))
    ours = reference.ba_cost(w, rig, state.poses.numpy(), state.lines.numpy(), 2.0)
    assert ours == pytest.approx(float(state.cost), rel=1e-4)
    assert reference.ba_compare([w], [(state.poses.numpy(), state.lines.numpy())], rig, LM)["ba_gap"] < 1e-3


def test_rpe_reads_0_for_the_truth_and_the_motion_for_a_stuck_pose():
    poses = stream.periodic_path(200, 0.0221, 0.63)
    a, b = np.arange(0, 150), np.arange(10, 160)
    assert reference.rpe(poses[a], poses[b], poses[a], poses[b]) < 1e-12
    G = np.eye(4)
    G[:3, 3] = (1.0, -2.0, 0.5)  # the system's world is another frame: no change
    moved = poses @ G
    assert reference.rpe(moved[a], moved[b], poses[a], poses[b]) < 1e-9
    stuck = np.repeat(np.eye(4)[None], 200, axis=0)
    chord = np.linalg.norm(reference.centres(poses[b]) - reference.centres(poses[a]), axis=1)
    assert reference.rpe(stuck[a], stuck[b], poses[a], poses[b]) == pytest.approx(np.sqrt(np.mean(chord**2)), rel=1e-9)


def _noisy_pair(rig, f: int = 5):
    seqs = stream.streams(json.loads((HERE.parent / "traffic" / "mh01_lap200.json").read_text()), rig, 2)
    imgs = np.stack([stream.render(s.segments, s.poses[f], rig) for s in seqs]).astype(np.float64)
    noise = np.random.default_rng(0).normal(size=imgs.shape)
    return np.clip(np.round(imgs + noise), 0, 255).astype(np.uint8)


def test_reference_detector_equals_the_ports_and_bfloat16_departs():
    """The frozen detector finds the port's segments on the cell's images
    (its plain twins on the CPU); in bfloat16 it does not."""
    from tpuslam_torch.frontend import frame
    from tpuslam_torch.kernels.image import build_pyramid

    rig = stream.Rig.of(json.loads((HERE.parent / "configs" / "euroc_x8.json").read_text())["rig"])
    imgs = _noisy_pair(rig)
    ours32 = detector.detect_levels(imgs, "cpu", torch.float32)
    ours16 = detector.detect_levels(imgs, "cpu", torch.bfloat16)
    theirs = [frame.detect_lines(lv, detector.K, frame.LSDParams()) for lv in
              build_pyramid(torch.from_numpy(imgs).to(torch.float32) / 255.0, detector.N_LEVELS, detector.LEVEL_SCALE)]
    assert [tuple(t.valid.shape[-1:]) for t in theirs] == [(detector.K,)] * detector.N_LEVELS
    side = lambda d, b: (d.endpoints[b].to(torch.float64).numpy(), d.valid[b].to(torch.float64).numpy())  # noqa: E731
    pairs = [(side(t, b), side(o, b)) for t, o in zip(theirs, ours32) for b in range(2)]
    assert sum(int(v.sum()) for _, (_, v) in pairs) > 200
    assert detector.det_gap(pairs) == 0.0
    assert detector.det_gap([(side(o16, b), side(o, b)) for o16, o in zip(ours16, ours32) for b in range(2)]) > 0.5


def test_distorted_render_draws_the_distorted_curve():
    """Each segment's dark pixels lie along its image through the radtan
    model, and the curve's points are dark."""
    rig = stream.Rig.of(json.loads((HERE.parent / "configs" / "euroc_x8.json").read_text())["rig"])
    seg = np.array([[[-1.5, -0.9, 4.0], [1.6, -1.0, 4.4]]], np.float32)  # across the top of the view: bent by k1
    img = stream.render(seg, np.eye(4), rig)
    t = np.linspace(0, 1, 2001)[:, None]
    P = seg[0, 0] + t * (seg[0, 1] - seg[0, 0])
    curve = rig.distort(P[:, 0] / P[:, 2], P[:, 1] / P[:, 2])
    ys, xs = np.nonzero(img < 120)
    d = np.min(np.hypot(xs[:, None] - curve[None, :, 0], ys[:, None] - curve[None, :, 1]), axis=1)
    assert len(xs) > 500 and d.max() < 1.6
    on = np.round(curve).astype(int)
    assert np.mean(img[on[:, 1], on[:, 0]] < 120) > 0.99
    straight = 0.5 * (curve[0] + curve[-1])
    assert np.hypot(*(curve[1000] - straight)) > 5.0  # bent, not straight


def test_judge_holds_every_number_to_its_limit():
    limits = {"failed_share": 0.0, "ate_m": 0.1, "ba_gap": 0.01}
    assert correct.judge({"failed_share": 0.0, "ate_m": 0.05, "ba_gap": 0.001}, limits)[0]
    assert not correct.judge({"failed_share": 0.01, "ate_m": 0.05, "ba_gap": 0.001}, limits)[0]
    assert not correct.judge({"failed_share": 0.0, "ate_m": 0.05}, limits)[0]
    assert not correct.judge({"failed_share": 0.0, "ate_m": float("nan"), "ba_gap": 0.001}, limits)[0]


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_cell_runs_on_the_cpu_and_prints_the_result_line(small, workload):
    out, forbidden = run_small(small, workload, seconds=240.0)  # over 20 frames: rpe_m has pairs
    assert forbidden == []
    assert out["correct"] is True, out["checks"]
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert out["attempted"] > 0 and 0 <= out["failed"] <= out["attempted"]
    cell = harness.Cell(SPEC, workload, REPO)
    assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end if m["source"] == "host_clock"}  # no trace off the card
    for v in out["metrics"].values():
        assert math.isfinite(v["value"]) and v["value"] > 0
    assert set(out["checks"]) == set(cell.limits)
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(out["device"])


@pytest.mark.parametrize("workload,fault,number", [
    ("euroc_x8.lap", "unchanged", "rpe_m"),
    ("euroc_x8.lap", "altered", "ate_m"),
    ("euroc_x8.lap", "ba_unchanged", "ba_gap"),
    ("euroc_x8.lap", "half_batch", "failed_share"),
    ("euroc_x8.lap", "det_altered", "det_gap"),
])
def test_a_fault_in_the_timed_path_makes_correct_false(request, workload, fault, number):
    """Each fault the cell can have, planted under a CPU run of it at the
    cell's own rig, traffic and limits (one card: no exchange between cards
    to leave out)."""
    bench = request.getfixturevalue("small2" if fault == "half_batch" else "small")
    out, _ = run_small(bench, workload, "--fault", fault, seconds=240.0 if number == "rpe_m" else 100.0)
    assert out["correct"] is False
    c = out["checks"][number]
    assert c["value"] > c["limit"], out["checks"]


def test_a_cell_from_new_files_alone(small, tmp_path):
    """A throwaway cell: a configuration, a traffic mix, a limits file and a
    metric of its own, added as new files and entries only."""
    import shutil

    bench = tmp_path / "portbench"
    shutil.copytree(small, bench)
    spec = json.loads((bench / "spec.json").read_text())
    cfg = json.loads((bench / "configs" / "euroc_x8.json").read_text())
    cfg["name"] = "tiny_stereo"
    (bench / "configs" / "tiny_stereo.json").write_text(json.dumps(cfg))
    (bench / "configs" / "tiny_stereo.py").write_text((bench / "configs" / "euroc_x8.py").read_text())
    traffic = json.loads((bench / "traffic" / "mh01_lap200.json").read_text())
    traffic.update(lap_frames=30, scene_seed=5)
    (bench / "traffic" / "lap30.json").write_text(json.dumps(traffic))
    (bench / "limits" / "tiny.lap.json").write_text((bench / "limits" / "euroc_x8.lap.json").read_text())
    (bench / "metrics" / "frames_handed_in.py").write_text("def read(rec):\n    return rec['attempted']\n")
    spec["configs"].append({"name": "tiny_stereo", "source": "test", "file": "configs/tiny_stereo.json", "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "tiny.lap", "config": "tiny_stereo", "traffic": "lap30", "chips": 1, "why": "test"})
    spec["end_to_end"].append({"name": "frames_handed_in", "unit": "frames", "better": "higher", "bound": 0.05,
                               "source": "host_clock", "workloads": ["tiny.lap"]})
    (bench / "spec.json").write_text(json.dumps(spec))
    out, _ = run_small(bench, "tiny.lap", seconds=4.0)
    assert out["metrics"]["frames_handed_in"]["value"] == out["attempted"] > 0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the cells run on the card only")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"] if w["chips"] == 1])
def test_cell_on_the_card(card, workload):
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", workload, "--seed", str(2**31 + 3), "--seconds", "5", "--trace", "0"],
        capture_output=True, text=True, cwd=REPO, timeout=1200,
    )
    assert p.returncode == 0, p.stderr[-4000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["device"]["platform"] == "gpu" and out["metrics"]["device_ms_per_frame"]["value"] > 0
