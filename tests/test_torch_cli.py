"""The command line: tpuslam_torch.cli against tpuslam.cli on one synthetic
QVGA dataset written once (by this package's writer; both CLIs read the
same .npy frames). The JAX CLI runs with cv2 hidden, keyframes finished at
once and its native map mirror off (torch_parity.JaxAsOnTheCard), and this
package's run with its mirror off too (torch_parity.python_graph), each
with its defaults: synchronous descriptor stereo, mapping and loop closing.

Run as a script, it prints chip_smoke.py's phase-21 references (the JAX
CLI's ATE on the 40 VGA frames chip_smoke writes; ~10 min on a CPU):

    python tests/test_torch_cli.py default fast
"""

import contextlib
import io
import json
import os
import runpy
import sys

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import pytest

from torch_parity import QVGA, JaxAsOnTheCard, python_graph
from tpuslam_torch import cli
from tpuslam_torch.convert import map_state
from tpuslam_torch.io.datasets import load_synthetic, write_synthetic_dataset
from tpuslam_torch.slammap.serialize import load_map

N_FRAMES = 8  # keyframes at frames 0 and 7: the first local BA runs at frame 7's event
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _main(fn, argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(argv)
    return out.getvalue()


def _summary(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


def _log_poses(path):
    rows = [json.loads(line) for line in open(path)]
    return {r["frame"]: np.asarray(r["pose"]).reshape(4, 4) for r in rows if "frame" in r}, rows


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both CLIs' `run` on the dataset, each with --out, --log and, for this
    package, --save-map."""
    from tpuslam import cli as jcli

    d = tmp_path_factory.mktemp("cli")
    root = str(d / "ds")
    write_synthetic_dataset(root, n_frames=N_FRAMES, seed=0, cam=QVGA, n_segments=140, motion_scale=0.02)
    paths = {k: str(d / k) for k in ("t_traj.txt", "j_traj.txt", "t_log.jsonl", "j_log.jsonl", "map.npz")}
    with python_graph():
        t = _summary(_main(cli.main, [
            "run", "--device", "cpu", "--dataset", "synthetic", "--root", root, "--out", paths["t_traj.txt"],
            "--log", paths["t_log.jsonl"], "--save-map", paths["map.npz"],
        ]))
    with JaxAsOnTheCard():
        j = _summary(_main(jcli.main, [
            "--platform", "cpu", "run", "--dataset", "synthetic", "--root", root, "--out", paths["j_traj.txt"],
            "--log", paths["j_log.jsonl"],
        ]))
    return root, paths, t, j


def test_run_matches_jax_cli(runs):
    """The same summary keys, frame and keyframe counts; the poses of the
    frames tracked before the first local BA reaches tracking within 2e-3
    of the JAX CLI's (as tests/test_torch_slam.py holds them); the ATE
    within the JAX CLI's x 1.05 + 0.01 m; every frame OK."""
    _, paths, t, j = runs
    assert sorted(t) == sorted(j) == sorted(
        ["frames", "fps", "wall_s", "keyframes", "lines", "loops", "timing", "ate_rmse", "ate_n"]
    )
    assert t["frames"] == j["frames"] == N_FRAMES and t["ate_n"] == j["ate_n"] == N_FRAMES
    assert t["keyframes"] == j["keyframes"] >= 2
    tp, trows = _log_poses(paths["t_log.jsonl"])
    jp, jrows = _log_poses(paths["j_log.jsonl"])
    assert sorted(tp) == sorted(jp) == list(range(N_FRAMES))
    assert all(r["state"] == "OK" for r in trows if "frame" in r)
    kf = [r["frame"] for r in jrows if r.get("kf")]
    assert [r["frame"] for r in trows if r.get("kf")] == kf
    first_ba = kf[1]  # keyframe 1's event runs the first local BA
    for f in range(first_ba + 1):
        np.testing.assert_allclose(tp[f], jp[f], atol=2e-3, err_msg=f"frame {f}")
    assert t["ate_rmse"] <= j["ate_rmse"] * 1.05 + 0.01
    assert "timing" in trows[-1] and "track" in t["timing"]


def test_eval_matches_jax_cli(runs):
    """`eval` prints the same JSON from both CLIs (within 1e-9), equal to
    the run's own ATE."""
    from tpuslam import cli as jcli

    root, paths, t, _ = runs
    for scale in ([], ["--scale"]):
        argv = ["eval", "--est", paths["t_traj.txt"], "--gt", os.path.join(root, "groundtruth.txt"), *scale]
        mine, theirs = _summary(_main(cli.main, argv)), _summary(_main(jcli.main, argv))
        assert sorted(mine) == sorted(theirs)
        for k in mine:
            assert mine[k] == pytest.approx(theirs[k], abs=1e-9), k
    assert _summary(_main(cli.main, argv[:-1]))["rmse"] == pytest.approx(t["ate_rmse"], abs=1e-6)


def test_saved_map_loads_in_jax(runs):
    """--save-map writes a file the JAX load_map reads to the state this
    package's load_map reads, with the run's keyframes and lines."""
    from tpuslam.slammap.serialize import load_map as j_load_map

    _, paths, t, _ = runs
    mine, theirs = load_map(paths["map.npz"]), j_load_map(paths["map.npz"])
    assert len(mine.keyframes) == len(theirs.keyframes) == t["keyframes"]
    assert len(theirs.lines.live_ids()) == t["lines"]
    a, b = map_state(mine), map_state(theirs)
    assert a["covis"] == b["covis"] and a["lines"]["obs"] == b["lines"]["obs"]
    for ka, kb in zip(a["keyframes"], b["keyframes"]):
        assert ka["T_cw"].tobytes() == kb["T_cw"].tobytes() and ka["line_ids"].tobytes() == kb["line_ids"].tobytes()


def test_profile_writes_a_trace(runs, tmp_path):
    """--profile writes a torch.profiler Chrome trace that carries the
    program's spans (the first frame's: tracking, the mapper's poll, the
    initial keyframe's local mapping and its stages)."""
    root, _, _, _ = runs
    prof = str(tmp_path / "prof")
    argv = ["run", "--device", "cpu", "--dataset", "synthetic", "--root", root, "--max-frames", "1", "--no-loop", "--profile", prof]
    assert _summary(_main(cli.main, argv))["frames"] == 1
    trace = json.load(open(os.path.join(prof, "trace.json")))
    assert len(trace["traceEvents"]) > 100
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"track", "tick", "local_mapping", "mp.cull", "mp.ba"} <= names


def test_device_and_bench(runs, monkeypatch):
    """--device defaults to cuda with no fallback (it raises without a
    card), for run and bench; `bench --device cpu` at QVGA (2 timed frames
    after 6) prints the bench's JSON lines, the last with its three
    metrics."""
    import torch

    root, _, _, _ = runs
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            _main(cli.main, ["run", "--dataset", "synthetic", "--root", root])
        with pytest.raises(RuntimeError, match="cuda"):
            _main(cli.main, ["bench"])
    for k in [k for k in os.environ if k.startswith("TPUSLAM_BENCH_")]:
        monkeypatch.delenv(k)
    monkeypatch.setenv("TPUSLAM_BENCH_CAM", "qvga")
    monkeypatch.setenv("TPUSLAM_BENCH_DEVFEED", "0")
    lines = _main(cli.main, ["bench", "--device", "cpu", "--frames", "2", "--warmup", "6"]).strip().splitlines()
    rows = [json.loads(line) for line in lines]
    assert len(rows) == 2 and rows[0]["frames"] == rows[1]["frames"] == 2
    last = rows[-1]
    assert last["device"] == "cpu" and last["fps_wall"] > 0 and last["ate_rmse"] < 0.05 and "local_ba_ms" in last
    assert last["tracked_ok"] == 8 and last["native_map"] is True


def test_make_synthetic(tmp_path):
    root = str(tmp_path / "syn")
    assert "wrote synthetic dataset" in _main(cli.main, ["make-synthetic", "--root", root, "--frames", "2", "--segments", "20", "--mono"])
    seq = load_synthetic(root)
    assert len(seq) == 2 and seq.cam.baseline == 0.0 and seq.items[0].right is None


EXAMPLES = {
    "mono_tum": [["/data/rgbd_dataset_freiburg3"], ["/data/tum", "out.txt"]],
    "stereo_euroc": [["/data/MH_01"], ["/data/MH_01", "e.txt"]],
    "stereo_kitti": [["/data/kitti"], ["/data/kitti", "05"], ["/data/kitti", "07", "k.txt"]],
}


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_examples_build_the_jax_argv(name, monkeypatch):
    """Each examples/torch_*.py hands tpuslam_torch.cli.main the argv its JAX
    twin hands tpuslam.cli.main."""
    import tpuslam.cli as jcli

    got = {}
    monkeypatch.setattr(cli, "main", lambda argv=None: got.__setitem__("torch", argv))
    monkeypatch.setattr(jcli, "main", lambda argv=None: got.__setitem__("jax", argv))
    for args in EXAMPLES[name]:
        got.clear()
        for prefix in ("", "torch_"):
            path = os.path.join(REPO, "examples", f"{prefix}{name}.py")
            monkeypatch.setattr(sys, "argv", [path, *args])
            runpy.run_path(path, run_name="__main__")
        assert got["torch"] == got["jax"] and got["torch"][0] == "run", (name, args)


if __name__ == "__main__":
    # chip_smoke.py's phase-21 references (JAX_CLI_ATE_M, JAX_CLI_FAST_ATE_M):
    # the JAX CLI's run, with its defaults or --fast, on the 40 VGA frames
    # chip_smoke writes with this package's make-synthetic, on the CPU with
    # cv2 hidden, TPUSLAM_KF_DEFER_MS=0 and TPUSLAM_NATIVE_MAP=0:
    #     python tests/test_torch_cli.py default fast
    import tempfile

    import jax

    jax.config.update("jax_platforms", "cpu")
    from chip_smoke import write_cli_dataset
    from tpuslam import cli as jcli

    for which in sys.argv[1:]:
        with tempfile.TemporaryDirectory() as d:
            root, log = os.path.join(d, "ds"), os.path.join(d, "log.jsonl")
            write_cli_dataset(root)
            argv = ["run", "--dataset", "synthetic", "--root", root, "--log", log] + (["--fast"] if "fast" in which else [])
            with JaxAsOnTheCard():
                s = _summary(_main(jcli.main, ["--platform", "cpu", *argv]))
            kfs = [r["frame"] for r in map(json.loads, open(log)) if r.get("kf")]
        name = {"default": "JAX_CLI_ATE_M", "fast": "JAX_CLI_FAST_ATE_M"}[which]
        print(f"{which}: {s['frames']} frames, keyframes at frames {kfs}, {s['lines']} lines, {s['loops']} loops", flush=True)
        print(f"{name} = {s['ate_rmse']!r}", flush=True)
