#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tpuslam_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each a hard check (the script stops with a non-zero exit on the
first failure and catches nothing):

1. device: torch/CUDA versions and the card's name and power limit; no
   CUDA device is a failure (the script never falls back to the CPU);
2. build: compile the hand-written CUDA kernels from tpuslam_torch/csrc;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the slice's two image shapes (480x640 and the 384x512 pyramid level):
   blur within 1e-5 on [0, 1] images, gradients within 1e-3 on the 0..255
   scale, connected-component propagation exactly equal; blur and CCL also
   bit-equal to their baseline forms (their first forms: two launches;
   one launch per round).
   Device time per call: CUDA events around 100 back-to-back calls queued
   behind a spin kernel (so no host gap enters), the baseline forms in turns
   with the kernels (old, new, new, old); the blur's yardstick is one
   F.conv2d with the 7x7 outer product of the taps over a plane padded
   once; each kernel's bound from its shape (bytes at 3.35 TB/s,
   operations at 67 T/s). Gradients, unchanged since its first form, has
   no baseline form: its baseline time is its own;
4. the tracking slice: System(cam, sensor="stereo", mapping=False,
   loop_closing=False, device="cuda") over 40 rendered VGA stereo frames.
   Every frame after initialisation must track OK, at least 2 keyframes,
   ATE no worse than the JAX package's on the same frames + 0.01 m, and
   each kernel's call count equal to frames x its per-frame count, with
   one device launch per call for blur and gradients and ceil(64 / k) for
   CCL;
5. the mapping slice: the same with mapping=True (local mapping and local
   BA at every keyframe, on the card). The same checks against the JAX
   package's mapping ATE, plus a local BA at every keyframe event after the
   first; tracking ms on keyframe and other frames, local-BA ms per keyframe
   and the (P, L, OL) rung of each solve;
6. BA on the card: the last keyframe's window solved twice on the card must
   come out bit-identical, and agree with the CPU solve (poses within 1e-3,
   whitened residuals within 0.5 px, cost within 1%);
7. relocalization: the tracker forced LOST and fed frame 20 again must come
   back OK through the keyframe database, its camera centre within 5 cm of
   frame 20's, its kernel launches one frame's worth.

Output: a {"kernels": [...]} JSON line (calls and launches per call from
the mapping slice; times, bounds and errors at 480x640 from phase 3),
the card line, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

N_FRAMES = 40
# ATE RMSE (m) of the JAX package (tpuslam.system.System, same arguments,
# default TrackerConfig) on the 40 frames `make_frames` renders, run on the
# CPU through JAX's XLA:CPU backend; see PERF.md ("the slice's reference").
JAX_ATE_M = 0.007307378698761408
# the same for tpuslam.system.System(..., mapping=True, loop_closing=False)
# on the same 40 frames (XLA:CPU, in-process BA; 4 keyframes, identical with
# and without the JAX map's native graph mirror); see PERF.md
JAX_MAPPING_ATE_M = 0.009802508959604729
ATE_MARGIN_M = 0.01
RELOC_FRAME = 20
# kernel calls per stereo frame on the slice (two cameras): blur 3 per
# camera (prefilter at 2 levels + pyramid), gradients 4 (detector + LBD at
# 2 levels), propagation 2 (one per level)
PER_FRAME = {"blur": 6, "gradients": 8, "ccl": 4}
KERNELS = {
    "blur": ("tpuslam_torch/csrc/image.cu", "tpuslam/kernels/pallas_image.py:148"),
    "gradients": ("tpuslam_torch/csrc/image.cu", "tpuslam/kernels/pallas_image.py:86"),
    "ccl": ("tpuslam_torch/csrc/ccl.cu", "tpuslam/kernels/pallas_ccl.py:121"),
}
TOL = {"blur": 1e-5, "gradients": 1e-3, "ccl": 0}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def make_frames(n_frames: int = N_FRAMES):
    """VGA stereo camera, the bench's scene (tpuslam/bench.py) and its
    rendered (left, right) uint8 frames, all from seed 0."""
    import numpy as np

    from tpuslam_torch import Intrinsics
    from tpuslam_torch.io.synthetic import make_wireframe_scene, render_wireframe_image

    cam = Intrinsics(fx=458.0, fy=457.0, cx=320.0, cy=240.0, width=640, height=480, baseline=0.11)
    rng = np.random.default_rng(0)
    scene = make_wireframe_scene(rng, n_segments=140, n_frames=n_frames, cam=cam, motion_scale=0.02)
    Tb = np.eye(4, dtype=np.float32)
    Tb[0, 3] = -cam.baseline
    scene_r = scene._replace(poses=np.stack([Tb @ T for T in scene.poses]))
    frames = [
        (render_wireframe_image(scene, f, noise=1.0, rng=rng), render_wireframe_image(scene_r, f, noise=1.0, rng=rng))
        for f in range(n_frames)
    ]
    return cam, scene, frames


def ate_of(trajectory, scene) -> float:
    import numpy as np

    from tpuslam_torch.eval.ate import absolute_trajectory_error

    est = np.stack([np.linalg.inv(r.T_cw)[:3, 3] for r in trajectory])
    gt = np.stack([np.linalg.inv(T)[:3, 3] for T in scene.poses[: len(trajectory)]])
    return absolute_trajectory_error(est, gt).rmse


REPS = 100  # back-to-back calls per device timing
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 memory rate
PEAK_OPS_PER_S = 67e12  # H100 SXM float32 peak outside the tensor cores


def device_us(fn, reps: int = REPS) -> float:
    """Device time per call (us): CUDA events around `reps` back-to-back
    calls, after 3 warm-up calls. The calls are enqueued behind a spin
    kernel (torch.cuda._sleep), so the host is ahead of the card and they run
    without host gaps; the start event must still be pending once the host
    has enqueued them all (else the run is repeated with fewer calls or a
    longer spin)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    spin = 20_000_000  # clock cycles, ~10 ms
    for _ in range(6):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        ahead = not a.query()
        b.synchronize()
        if ahead:
            return a.elapsed_time(b) * 1e3 / reps
        # the card's queue of pending launches is finite: a host that blocks
        # on it never gets ahead, so fewer calls first, then a longer spin
        if reps > 10:
            reps //= 2
        else:
            spin *= 4
    fail("device timing: the host never got ahead of the card")


def host_paced_ms(fn, reps: int) -> float:
    """ms per call from CUDA events around `reps` back-to-back calls after 3
    warm-up calls, with no spin ahead: for the plain versions, whose many
    small launches outrun the host's enqueue (their time is what a run
    pays)."""
    import torch

    for _ in range(3):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def bound_us(name: str, H: int, W: int, ntaps: int, rounds: int, compat_bits: int):
    """(least time in us, "bytes" or "operations") of one call at (H, W):
    each input read once and each output written once, at 3.35 TB/s, and
    the operations these inputs need at 67 T/s. CCL's work depends on the
    data: a min and a max per compat bit set, per round (`compat_bits` is
    the number of bits set on the plane)."""
    px = H * W
    nbytes, ops = {
        "blur": (8 * px, 4 * ntaps * px),  # 1 plane in, 1 out; a multiply and an add per tap and pass
        "gradients": (20 * px, 10 * px),  # 1 in, 4 out; differences, halvings, squares, sum, sqrt, atan2
        "ccl": (20 * px, 2 * rounds * compat_bits),  # 3 int32 in, 2 out
    }[name]
    tb, to = nbytes / PEAK_BYTES_PER_S, ops / PEAK_OPS_PER_S
    return max(tb, to) * 1e6, ("bytes" if tb >= to else "operations")


def in_turns(old, new):
    """Device us of two forms of one function, timed old, new, new, old;
    returns (new, old), each the mean of its two turns."""
    o1, n1, n2, o2 = device_us(old[0], old[1]), device_us(new[0], new[1]), device_us(new[0], new[1]), device_us(old[0], old[1])
    return (n1 + n2) / 2, (o1 + o2) / 2


def kernel_phase(frames, card):
    """Each kernel against its plain version (and the redesigned ones bit
    for bit against their baseline forms) at 480x640 and 384x512, with device
    times. Returns {name: fields of the kernels line at 480x640}."""
    import torch
    import torch.nn.functional as F

    from tpuslam_torch.kernels import image, lsd

    left = torch.from_numpy(frames[0][0]).cuda().float() / 255.0
    level1 = image.build_pyramid(left, 2, 0.8)[1].contiguous()  # 384x512
    params = lsd.LSDParams()
    R = params.ccl_rounds
    sigma = params.prefilter_sigma
    ntaps = image._blur_taps(sigma).numel()
    res = {}
    for img in (left, level1):
        H, W = img.shape
        g = img * 255.0
        _, _, _, _, lab0, mx0, cb = lsd.ccl_inputs(img, params)
        n_bits = int(sum(((cb >> d) & 1).sum() for d in range(8)))
        print(f"ccl planes {(H, W)}: {int((cb != 0).sum())} pixels with compat bits, {n_bits} bits", flush=True)
        taps = image._blur_taps(sigma).cuda()
        r = taps.numel() // 2
        padded = F.pad(img[None, None], (r, r, r, r), mode="replicate")
        taps2d = torch.outer(taps, taps)[None, None]
        cases = {
            # name: (kernel, plain, baseline form (reps), library call, reps of the kernel)
            "blur": (lambda: image.gaussian_blur(img, sigma), lambda: image.gaussian_blur_torch(img, sigma),
                     (lambda: image._blur_two_pass_cuda(img, sigma), REPS), lambda: F.conv2d(padded, taps2d), REPS),
            # unchanged since its first form: no baseline form
            "gradients": (lambda: image.image_gradients(g), lambda: image.image_gradients_torch(g), None, None, REPS),
            "ccl": (lambda: lsd.ccl_propagate(lab0, mx0, cb, R), lambda: lsd._ccl_torch(lab0, mx0, cb, R),
                    (lambda: lsd._ccl_per_round_cuda(lab0, mx0, cb, R), 10), None, REPS),
        }
        for name, (kern, plain, baseline, lib, reps) in cases.items():
            outs_k, outs_p = (x if isinstance(x, tuple) else (x,) for x in (kern(), plain()))
            torch.cuda.synchronize()
            err = max(float((a.double() - b.double()).abs().max()) for a, b in zip(outs_k, outs_p))
            if baseline:
                outs_o = baseline[0]()
                same_old = all(torch.equal(a, b) for a, b in zip(outs_k, outs_o if isinstance(outs_o, tuple) else (outs_o,)))
                old_txt = f"bit-equal to the baseline form: {same_old}"
            else:
                same_old, old_txt = True, "unchanged (no baseline form)"
            ok = err <= TOL[name] and same_old
            print(f"kernel {name:9s} {(H, W)}: max_abs_err={err:.3g} (tol {TOL[name]}), {old_txt} {'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                fail(f"{name} kernel disagrees with its plain version or its baseline form at {(H, W)}")
            if baseline:
                dev_us, old_us = in_turns(baseline, (kern, reps))
            else:
                dev_us = old_us = device_us(kern, reps)
            plain_ms = host_paced_ms(plain, 10 if name == "ccl" else REPS)
            lib_ms = device_us(lib) / 1e3 if lib else None
            b_us, b_by = bound_us(name, H, W, ntaps, R, n_bits)
            lib_txt = f"{lib_ms * 1e3:.3f} us" if lib else "none"
            old_txt = f"baseline form {old_us:.3f} us" if baseline else "no baseline form"
            print(
                f"kernel {name:9s} {(H, W)}: device {dev_us:.3f} us/call, {old_txt}, bound {b_us:.3f} us "
                f"({b_by}, {b_us / dev_us:.1%} of it), plain {plain_ms:.4f} ms (host-paced), library {lib_txt} on {card}",
                flush=True,
            )
            prev = res.get(name)
            if prev is None:  # the first shape, 480x640, fills the kernels line
                res[name] = dict(
                    shape=f"{H}x{W}", max_abs_err=err, device_us=dev_us, ms=dev_us / 1e3, plain_ms=plain_ms,
                    bound_us=b_us, bound_ms=b_us / 1e3, bound_by=b_by, library_ms=lib_ms, baseline_device_us=old_us,
                )
            else:
                prev["max_abs_err"] = max(prev["max_abs_err"], err)
    return res


def reset_launches() -> None:
    from tpuslam_torch.kernels import image, lsd

    for d in (image.LAUNCHES, lsd.LAUNCHES, image.KERNEL_LAUNCHES, lsd.KERNEL_LAUNCHES):
        for k in d:
            d[k] = 0


def read_launches():
    """(kernel calls, device launches of those calls), by kernel."""
    from tpuslam_torch.kernels import image, lsd

    return {**image.LAUNCHES, **lsd.LAUNCHES}, {**image.KERNEL_LAUNCHES, **lsd.KERNEL_LAUNCHES}


def launches_per_call() -> dict:
    """Device launches each kernel call must make: one for blur and
    gradients, ceil(R / k) for CCL."""
    from tpuslam_torch.kernels import lsd

    return {"blur": 1, "gradients": 1, "ccl": -(-lsd.LSDParams().ccl_rounds // lsd.CCL_TILE[2])}


def check_launches(tag: str, launches, n_frames: int) -> None:
    calls, device = launches
    want_lpc = launches_per_call()
    for name, per in PER_FRAME.items():
        want = per * n_frames
        print(
            f"{tag}: {name} calls {calls[name]} (expected {want}), device launches {device[name]} "
            f"(expected {want * want_lpc[name]})",
            flush=True,
        )
        if calls[name] != want:
            fail(f"{tag}: {name}: {calls[name]} calls, expected {want}")
        if device[name] != want * want_lpc[name]:
            fail(f"{tag}: {name}: {device[name]} device launches, expected {want_lpc[name]} per call")


def run_slice(tag, cam, scene, frames, card, mapping: bool, jax_ate: float):
    """System(..., mapping=mapping, device="cuda") over the frames, with the
    launch counts set to 0 just before and read just after."""
    import torch

    from tpuslam_torch.system import System

    sys_ = System(cam, sensor="stereo", mapping=mapping, loop_closing=False, device="cuda")
    reset_launches()
    frame_s = []
    for f, (il, ir) in enumerate(frames):
        t = time.perf_counter()
        sys_.track_stereo(il, ir, f * 0.05)
        torch.cuda.synchronize()
        frame_s.append(time.perf_counter() - t)
    launches = read_launches()
    sys_.shutdown()

    states = [r.state.name for r in sys_.trajectory]
    n_kf = len(sys_.map.keyframes)
    ate = ate_of(sys_.trajectory, scene)
    print(f"{tag}: states {states}", flush=True)
    print(f"{tag}: keyframes {n_kf}, map lines {len(sys_.map.lines.live_ids())}, ATE {ate:.5f} m", flush=True)
    if any(s != "OK" for s in states):
        fail(f"{tag}: a frame did not track OK")
    if n_kf < 2:
        fail(f"{tag}: only {n_kf} keyframes")
    bound = jax_ate + ATE_MARGIN_M
    print(f"{tag}: ATE bound {bound:.5f} m (JAX package {jax_ate} m + {ATE_MARGIN_M} m)", flush=True)
    if not ate <= bound:
        fail(f"{tag}: ATE {ate} m above {bound} m")
    check_launches(tag, launches, len(frames))
    med = statistics.median(frame_s[1:])
    mean = sum(frame_s[1:]) / len(frame_s[1:])
    print(
        f"{tag}: first frame {frame_s[0] * 1e3:.1f} ms; frames 1-{len(frames) - 1}: median {med * 1e3:.2f} ms, "
        f"mean {mean * 1e3:.2f} ms/frame = {1.0 / mean:.2f} frames/s on {card}",
        flush=True,
    )
    if not mapping:
        return sys_, launches

    def med_ms(xs):  # seconds -> "x.xx ms"
        return f"{statistics.median(xs) * 1e3:.2f} ms" if xs else "not measured (no sample)"

    kf = [dt for r, dt in zip(sys_.trajectory[1:], frame_s[1:]) if r.made_keyframe]
    other = [dt for r, dt in zip(sys_.trajectory[1:], frame_s[1:]) if not r.made_keyframe]
    print(
        f"{tag}: frames 1-{len(frames) - 1}: keyframe frames {len(kf)}, median {med_ms(kf)}; "
        f"other frames {len(other)}, median {med_ms(other)} on {card}",
        flush=True,
    )
    mapper = sys_.mapper
    n_events = sum(r.made_keyframe for r in sys_.trajectory)
    n_solves = sum(len(v) for v in mapper.solve_ms_by_rung.values())
    print(f"{tag}: keyframe events {n_events}, local BA solves {n_solves}, last {mapper.last_ba}", flush=True)
    if n_solves != n_events - 1 or mapper.last_ba is None:
        fail(f"{tag}: {n_solves} local BA solves for {n_events} keyframe events (one per event after the first)")
    ba = sys_.timer.times.get("mp.ba", [])
    lm_ms = sys_.timer.times.get("local_mapping", [])
    print(
        f"{tag}: local BA (mp.ba, ends in the solve's read back) median {med_ms(ba)} per keyframe over "
        f"{len(ba)} steady events; local mapping median {med_ms(lm_ms)} on {card}",
        flush=True,
    )
    for rung, ms in mapper.solve_ms_by_rung.items():
        print(f"{tag}: solve rung (P, L, OL) = {rung}: {', '.join(f'{x:.2f}' for x in ms)} ms on {card}", flush=True)
    return sys_, launches


def ba_phase(sys_, cam, card) -> None:
    """The last keyframe's window, solved twice on the card and once on the
    CPU."""
    import numpy as np
    import torch

    from tpuslam_torch.backend.lm import _whitened_residuals, run_lm
    from tpuslam_torch.backend.local_ba import assemble_problem

    center = max(sys_.map.keyframes)
    cfg = sys_.mapper.cfg.ba
    prob, _ = assemble_problem(sys_.map, center, cam, cfg, device="cuda")
    solves = []
    for _ in range(2):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        st = run_lm(prob, cam, cfg.lm)
        b.record()
        b.synchronize()
        solves.append(([x.cpu().numpy() for x in st], a.elapsed_time(b)))
    (s1, ms1), (s2, ms2) = solves
    same = all(np.array_equal(x, y) for x, y in zip(s1, s2))
    rung = (prob.poses.shape[0], prob.lines.shape[0], prob.l_pose.shape[0])
    print(f"ba: keyframe {center}, rung {rung}, two solves on the card bit-identical: {same} ({ms1:.2f} / {ms2:.2f} ms) on {card}", flush=True)
    if not same:
        fail("ba: two solves of one problem on the card differ")
    cprob, _ = assemble_problem(sys_.map, center, cam, cfg, device="cpu")
    cs = run_lm(cprob, cam, cfg.lm)
    gs = [torch.from_numpy(x) for x in s1]
    dpose = float((cs.poses - gs[0]).abs().max())
    rc = _whitened_residuals(cs.poses, cs.lines, cs.points, cprob, cam)[0]
    rg = _whitened_residuals(gs[0], gs[1], gs[2], cprob, cam)[0]
    valid = cprob.l_valid > 0
    dres = float((rc - rg)[valid].abs().max())
    dcost = abs(float(cs.cost) - float(gs[4])) / max(float(cs.cost), 1e-9)
    print(f"ba: card vs CPU: poses {dpose:.3g} (tol 1e-3), whitened residuals {dres:.3g} px (tol 0.5), cost rel {dcost:.3g} (tol 0.01)", flush=True)
    if not (dpose <= 1e-3 and dres <= 0.5 and dcost <= 0.01):
        fail("ba: the card's solve disagrees with the CPU's")


def reloc_phase(sys_, scene, frames) -> None:
    """Force LOST and feed frame RELOC_FRAME again as a new frame."""
    import numpy as np
    import torch

    from tpuslam_torch.frontend.tracking import TrackingState

    sys_.tracker.state = TrackingState.LOST
    reset_launches()
    il, ir = frames[RELOC_FRAME]
    t = time.perf_counter()
    sys_.track_stereo(il, ir, len(frames) * 0.05)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    launches = read_launches()
    r = sys_.trajectory[-1]

    def centre(T):
        return np.linalg.inv(np.asarray(T, np.float64))[:3, 3]

    # ground truth in the system's world, which is the first camera's frame
    gt = centre(scene.poses[RELOC_FRAME] @ np.linalg.inv(scene.poses[0]))
    err = float(np.linalg.norm(centre(r.T_cw) - gt))
    tracked = float(np.linalg.norm(centre(sys_.trajectory[RELOC_FRAME].T_cw) - gt))
    n = sys_.tracker.n_relocalizations
    print(
        f"reloc: state {r.state.name}, relocalizations {n}, centre error {err:.4f} m vs frame {RELOC_FRAME}'s ground "
        f"truth (tracked there: {tracked:.4f} m), {dt * 1e3:.1f} ms",
        flush=True,
    )
    if r.state != TrackingState.OK or n != 1 or not err < 0.05:
        fail("reloc: the LOST tracker did not relocalize within 5 cm")
    check_launches("reloc", launches, 1)


def main() -> int:
    import torch

    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script runs on a CUDA device only")
    card = card_line()
    print(f"card: {card}", flush=True)

    import tpuslam_torch

    if os.path.dirname(os.path.abspath(tpuslam_torch.__file__)) != os.path.join(REPO, "tpuslam_torch"):
        fail(f"tpuslam_torch imported from {tpuslam_torch.__file__}, not from this checkout")
    from tpuslam_torch.kernels import cuda_lib

    t0 = time.perf_counter()
    path = cuda_lib.build()
    cuda_lib.library()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {os.path.relpath(path, REPO)}", flush=True)
    for line in path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"ptxas: {line.strip()}", flush=True)

    cam, scene, frames = make_frames()
    kres = kernel_phase(frames, card)

    run_slice("slice", cam, scene, frames, card, mapping=False, jax_ate=JAX_ATE_M)
    sys_, launches = run_slice("mapping", cam, scene, frames, card, mapping=True, jax_ate=JAX_MAPPING_ATE_M)
    ba_phase(sys_, cam, card)
    reloc_phase(sys_, scene, frames)

    calls, device = launches  # the mapping slice's run
    kernels = [
        dict(
            name=name,
            route="cuda",
            source=KERNELS[name][0],
            replaces=KERNELS[name][1],
            launches=calls[name],
            launches_per_call=device[name] // calls[name],  # exact: check_launches held it
            **kres[name],
        )
        for name in PER_FRAME
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(
        json.dumps(
            {"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}
        ),
        flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
