#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tpuslam_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each a hard check (the script stops with a non-zero exit on the
first failure and catches nothing):

1. device: torch/CUDA versions and the card's name and power limit; no
   CUDA device is a failure (the script never falls back to the CPU);
2. build: compile the hand-written CUDA kernels from tpuslam_torch/csrc;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the slice's two image shapes (480x640 and the 384x512 pyramid level) and
   the bench path's (240x320 and its 192x256 level): blur within 1e-5 on
   [0, 1] images, the LBD gradients form (gx, gy of the image times 255)
   within 1e-3 on the 0..255 scale, connected-component propagation exactly
   equal; the detector's fused front (lsd_front: prefilter, gradients,
   support, compat plane, label seeds) with mag within 1e-3 and its integer
   planes equal except where a threshold decides by less than 1e-3 (counted
   and printed; any other difference fails). Each kernel is also held bit
   for bit to its baseline form, the form it replaced: blur to two launches,
   gradients to `img * 255` then the four-plane kernel, lsd_front to that
   chain behind the blur kernel plus the eager compat loop (162 launches),
   CCL to one launch per round. The blur also at BRIEF's sigma 2 (radius
   6) on the image times 255 at 480x640 and 240x320 (FAST's shape on the
   bench path), within 255e-5. The detector's three fixed-order sum
   kernels, on the inputs of a detect_lines call at 480x640, 240x320 and
   192x256 (the member share printed): component_moments (the 7 moments
   of the 256 components from the label, magnitude and support planes),
   component_extents (t_min, t_max and the normal moment) and
   segment_moments (the merge's 7 columns over 256 segments, one block)
   against their plain versions within 1e-5 relative (t_min and t_max
   bit-equal), bit-equal over two calls, timed in turns with the forms
   they replaced (the eager chain around the two-launch kernel; for the
   merge that kernel alone), that kernel also alone on the stacked
   columns; their yardstick is index_add_ on the stacked columns under
   torch.use_deterministic_algorithms(True).
   Device time per call: CUDA events around 100 back-to-back calls queued
   behind a spin kernel (so no host gap enters), the baseline forms in turns
   with the kernels (old, new, new, old); the blur's yardstick is one
   F.conv2d with the outer product of the taps (7x7, 13x13 for BRIEF's)
   over a plane padded once; each kernel's bound from its shape and this
   run's data (bytes at 3.35 TB/s, operations at 67 T/s). Device launches
   per call of each form, counted by torch.profiler over one call: 1 for
   lsd_front, gradients and each sum kernel (and the sums' wrapper count).
   Every trace of the script is read from its raw records; the first with
   100 or more kernel launches is also read through key_averages, and the
   two reads must agree;
4. the tracking slice: System(cam, sensor="stereo", mapping=False,
   loop_closing=False, device="cuda") over 40 rendered VGA stereo frames.
   Every frame after initialisation must track OK, at least 2 keyframes,
   ATE no worse than the JAX package's on the same frames + 0.01 m, and
   each kernel's call count equal to frames x its per-frame count, with
   one device launch per call for blur, gradients and lsd_front and
   ceil(64 / k) for CCL; then, on a fresh System, 3 steady frames under
   torch.profiler: device busy ms and device launches per frame;
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
   frame 20's, its kernel launches one frame's worth;
8. the bench path: System(..., mapping=True, loop_closing=False) with the
   JAX package's bench configuration (`tpuslam_torch.system.bench_configs`:
   pipelined semi-direct chunks of 6, direct stereo, host-halved frames,
   the two-rung local-BA ladder) over the same 40 frames. One trajectory
   entry per frame, every frame OK, ATE no worse than the JAX package's for
   this configuration + 0.01 m, keyframes only from anchors (or frames the
   synchronous path tracked), each kernel's calls equal to its count per
   left-image extraction (blur 1, gradients 2, lsd_front 2, CCL 2 and
   each of the three sum kernels 2) times
   the anchors and synchronous extractions; tracking frames/s over the
   steady frames (after the first chunk) including the final flush,
   local-BA ms per keyframe with each solve's rung; then, on a fresh
   System, the host synchronizations of the chunk program alone (must be 0)
   and of one steady chunk's calls (dispatch + resolve; target 1),
   torch.profiler device busy ms and launches of one steady chunk's calls,
   and of the anchor's step and one follower's step run alone; then the
   same configuration run again over the same frames: the same keyframes
   and bit-equal poses (the card runs repeat);
9. the hybrid bench path: the same with bench_configs(points=True) (FAST
   corners and BRIEF beside the lines, corner depths by direct stereo, the
   joint pose LM, point templates on the followers, point landmarks and
   their BA) over the same 40 frames with the scene's points drawn as dots:
   every frame OK, ATE no worse than the JAX package's hybrid ATE + 0.01 m,
   kernel calls per extraction (blur 2: the pyramid's and BRIEF's), live
   and multi-observation point counts, frames/s; host syncs of its chunk
   program (must be 0) and the device busy ms and launches of its anchor
   and one follower;
   then the loop phase: System(cam) with its defaults (stereo, mapping,
   loop closing) over benchmarks/ladder.py's stereo_loop scene with a
   48-frame dwell (148 QVGA frames): a closure, the keyframe-map ATE
   lower after the last closure, the final one within the JAX package's
   x 1.05 + 0.01 m, the closures' problems solved again bit-equal; the
   System runs the loop warm-up at start (warm_loop_programs, the card's
   default), whose seconds are printed beside the first closure's ms and
   its essential graph's;
10. mono: System(cam, sensor="mono") with its defaults (mapping, loop
   closing on the Sim(3) branch) and benchmarks/ladder.py's mono tracker
   settings over its mono_sequence scene at VGA (fx 458, 60 segments, 120
   points drawn as dots, 30 frames), hybrid and lines only: initialized no
   later than the JAX package's first OK frame + 2, every later frame OK,
   3+ keyframes, the kernel calls per frame (one full-resolution left
   extraction: blur 1, 2 in hybrid, gradients 2, lsd_front 2, CCL 2, each
   sum kernel 2), in hybrid 10+ points seen from two keyframes and the
   Sim(3) ATE within the JAX package's x 1.05 + 0.01 m, lines only the
   median Sim(3) ATE over 11 RANSAC draws (10 of them in child processes,
   5 at a time) within the JAX package's median over its 11 x 1.05 + 0.01
   m (lines-only mono is chaotic in the draws);
   the hybrid run again (the same keyframes, bit-equal poses); ms per frame (keyframe
   frames apart), mp.triangulate ms per keyframe event, the initializer's
   ms and the host syncs of one attempt, the device busy ms and launches of
   one steady frame;
11. the mono loop: the same System with hybrid points over the ladder's
   mono_loop (140 QVGA frames, dwell 20): OK frames within 2 of the JAX
   package's, a closure through the Sim(3) branch, the final keyframe-map
   Sim(3) ATE within the JAX package's x 1.05 + 0.01 m; each closure's
   scale and stage times;
12-17. the pipelined forms over the 40 VGA frames, each through
   System(..., mapping=True, loop_closing=False) with the JAX bench's other
   switches (`bench_configs`): 12 full-detection chunks of 6
   (semidirect=False), 13 the single-frame direct program (chunk=1), run
   twice (the same keyframes, bit-equal poses), 14 the single-frame
   descriptor program (both cameras detected), 15 the semi-direct chunks
   resized on the card (hostscale=False: the blur kernel at sigma 0.5,
   radius 2, then the resize's two products), 16 the single-frame hybrid
   program over make_frames(draw_points=True); 17 the classic pipeline
   (TrackerConfig(pipelined=True, fused=False)) without mapping, bit-equal
   to phase 4 before phase 4's first fallback, and with mapping. Each: one
   trajectory entry per frame, every frame OK, the ATE within the JAX
   package's x 1.05 + 0.01 m, the kernel calls per image extraction
   (programs and synchronous path), frames/s from frame 1 through the
   flush, and on a fresh System one steady frame's or chunk's host syncs,
   device busy ms and launches;
18. pipelined lines-only mono (the classic pipeline) over the mono
   sequence, the first RANSAC draws: every frame after initialization OK
   and through the pipeline, the kernel calls per frame, states, poses and
   keyframes bit-equal to phase 10's synchronous lines-only run up to its
   first fallback (phase 10 holds the ATE by its median over 11 draws);
19. radtan: the bench scene through TUM fr1's distortion (a numpy
   inverse-map bilinear remap): extract_features on the card, its
   undistortion within 1e-3 px of the CPU's on the same detections, its
   segments against the CPU port's (95% within 0.5 px), the median
   endpoint-to-true-line distance below 2 px, the padding finite; then 20
   frames of the synchronous descriptor-stereo tracker within the JAX
   bound;
20. BASELINE config #5: 8 VGA stereo sequences with their own
   calibrations (`make_multi_frames`) through
   tpuslam_torch.parallel.multi_seq.MultiTracker with a LocalMapper each:
   (a) every batched kernel (blur, LBD gradients, front, CCL, the three
   sums) on the 8 images at 480x640 and 384x512 bit-equal per image to the
   single-image calls and within its tolerance of the plain version, one
   call's launches the single call's (the wrapper's count), device us in
   turns with 8 single calls, bound, plain and library times; the batched
   extraction bit-equal to 8 single extractions; (b) the main path, the
   launch counts set to 0 just before its 20 frames and read just after:
   only batched kernels, their calls per batched frame, one batched
   tracking dispatch per steady frame, every later frame OK, each
   sequence's ATE within the JAX MultiTracker's x 1.05 + 0.01 m; (c)
   batched_ba of 8 toy problems at (16, 256, 1024) against 8 single run_lm
   solves (float64: within 1e-8; float32: converged, costs within 1e-5,
   poses within 5e-3), their ms, device busy ms and launches; (d) host ms,
   device busy ms and launches per sequence-frame at N = 1, 2 and 8
   (tracking alone), and the host syncs of one steady batched frame; (e)
   the split over split_mesh() (every card that divides 8, or two shards
   on cuda:0), one process per shard: part (b)'s checks read from the
   shards' counters (each shard's batched calls on its own card over its
   own N/k images, none in this process), batched_ba over the mesh equal
   to the unsplit call, and the split's host ms per batched frame,
   sequence-frames/s with mappers and without, device busy ms and
   launches per card and each process's start-up seconds beside one
   card's.
21. the host surface: a 40-frame VGA stereo dataset written by the CLI's
   make-synthetic (seed 0, 140 segments) and a settings YAML with its
   Camera.* keys (load_settings' camera equal to the dataset's); the CLI's
   `run` with its defaults (synchronous descriptor stereo, mapping, loop
   closing; --out, --save-map, --log) with the launch counts set to 0 just
   before and read just after: every frame after the first OK, the ATE
   within the JAX CLI's + 0.01 m, each kernel's calls frames x its
   per-frame count; `run --fast` within the JAX CLI's x 1.05 + 0.01 m;
   `eval` of the run's trajectory equal to its ATE (1e-6), its RPE (delta
   1); System(settings, loop_closing=False).load_map of the saved file (the
   saved live lines, a database row per keyframe) relocalizing a LOST frame
   20 within 5 cm; each run's frames/s and the phase's wall time.
22. the bench (tpuslam_torch.bench), with the native map mirror on (phases
   4-21 run with TPUSLAM_NATIVE_MAP=0, as their JAX references were taken):
   `cli bench --frames 100 --warmup 6` in process (106 VGA frames, lines
   only), then run_benchmark(100, 6) over image-noise seeds 0-4, lines only
   and with hybrid points (TPUSLAM_BENCH_POINTS=1, the scene's points drawn
   as dots), each with the launch counts set to 0 just before and read just
   after: a JSON line per stage, the last naming the card and its power limit,
   every frame OK in frame order, the mirror in use, each kernel's calls its
   count per extraction times the detector's runs (chunk anchors, anchors
   dispatched again at the flush, synchronous frames, device-feed
   programs; the device feed runs in the CLI run and the hybrid seed-0
   run); fps_wall, fps_median, track_ms_median, fps_device_feed,
   local_ba_ms and its rungs', pretouch_s, wire_mbps and the keyframe
   frames printed. The CLI run and the hybrid seed-0 run run alone in this
   process and give the rates; the other nine seed runs run seven at a time,
   each in a process of its own with the same checks (a run's result does
   not depend on its timing), in one pool with phase 23's five. Each row's median ATE over the seeds within
   the JAX package's median x 1.05 + 0.01 m; then run_ba_benchmark: each rung's
   ms per solve and launches per solve, its initial cost equal to the
   CPU's (1e-5) and the card's and the CPU's final cost at the float32
   floor (at most 1e-8 of the initial cost).
   Phases 1-22 run with TPUSLAM_BA_SUBPROCESS=0 and TPUSLAM_BENCH_FUSEDEFER=0:
   local and global BA in this process, fusion at the keyframe (their JAX
   references and bit-equal repeats belong to that path).
23. the asynchronous back end, the configuration the JAX bench runs on its
   chip (TPUSLAM_BA_SUBPROCESS=1, TPUSLAM_BENCH_FUSEDEFER=1): a solver
   process (backend/ba_worker.py) on the card, its start-up time, and the
   bench's larger toy rung solved there twice against solve_in_process on
   the card (every array and the cost within 1e-5); the bench with the
   solver process and deferred fusion: the CLI run and the hybrid run of
   seed 0 alone in this process, each printed beside phase 22's
   synchronous run on the same frames (fps_wall, fps_median, the longest
   call that ran a keyframe event, local_ba_ms), then lines only over
   noise seeds 0-4 in processes of their own (in phase 22's pool), the median ATE within phase
   22's bound; every run with solves submitted and none failed, abandoned
   or stale; the loop configuration (phase 9's System(cam)) with its
   solver process, each local-BA answer written back one frame after its
   submit (a fixed schedule, as the JAX package's reference ran): the
   noiseless run in this process and noise seeds 1-4 in processes of
   their own, each with a closure, every global-BA round through the
   solver in float64, no local-BA solve assembled before a closure
   written back after it, and each closure's keyframe-map ATE printed;
   their median final keyframe-map ATE within phase 9's bound and the
   JAX package's median x 1.05 + 0.01 m; then one steady chunk's calls of the bench
   configuration under torch.profiler with the solver idle and with two
   toy solves at (24, 1024, 4096) in flight: the tracking chunk's device
   busy ms and wall ms.

Output: a {"kernels": [...]} JSON line (calls per path and launches per
call from the mono phase's hybrid run, the main path; times, bounds,
errors and profiled launches per call at 480x640 from phase 3, device us
at every shape timed; "blur.resize", the blur kernel at the resize's
sigma, with its calls from phase 15; "<name>.batch", each kernel's batched
form, from phase 20; "cli" in launches_by_path from phase 21, "bench100"
(the CLI run) and "bench100_hybrid" (seed 0) from phase 22,
"bench100_async", "bench100_async_hybrid" and "loop_solver" from phase 23), the script's
own wall time, the card line, and as the last line
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
# the same for the bench configuration (tpuslam.system.System(...,
# mapping=True, loop_closing=False, tracker_cfg / mapper_cfg of
# tests/test_torch_semidirect.py's jax_bench_config, which equal
# bench_configs here) on the same 40 frames, XLA:CPU, with cv2 hidden (so
# host_prescale takes its numpy form, the one this port has), keyframes
# finished at the next event (TPUSLAM_KF_DEFER_MS=0) and the native map
# mirror off (TPUSLAM_NATIVE_MAP=0): `python tests/test_torch_semidirect.py`
# prints it (keyframes at frames 0, 13, 19)
JAX_BENCH_ATE_M = 0.0336553673054669
# the same for the hybrid bench configuration (the above with
# tcfg.points = PointFrontendParams(), as tpuslam/bench.py sets it under
# TPUSLAM_BENCH_POINTS=1) on the 40 frames `make_frames(draw_points=True)`
# renders, XLA:CPU, cv2 hidden, TPUSLAM_KF_DEFER_MS=0, TPUSLAM_NATIVE_MAP=0:
# `python tests/test_torch_hybrid.py` prints it (keyframes at frames 0, 1, 7,
# 13, 19, 25, 31)
JAX_HYBRID_BENCH_ATE_M = 0.03508363848096205
ATE_MARGIN_M = 0.01
# the loop sequence (`make_loop_frames`: benchmarks/ladder.py's stereo_loop
# scene with a 48-frame dwell) through tpuslam.system.System(cam,
# sensor="stereo", mapping=True, loop_closing=True, tracker_cfg=LOOP_TRACKER
# there), XLA:CPU, cv2 hidden, TPUSLAM_KF_DEFER_MS=0, TPUSLAM_NATIVE_MAP=0,
# TPUSLAM_WARM_LOOP=0, TPUSLAM_BA_SUBPROCESS=0: `python
# tests/test_torch_loop_closing.py` prints them (148 frames OK, 51 keyframes,
# loops closed at keyframes 45, 47 and 49; the first took the keyframe-map ATE
# from 0.9037 to 0.7933 m). With a 16-frame dwell (the ladder's) the JAX
# package closes no loop on these frames.
JAX_LOOP_OK_FRAMES = 148
JAX_LOOP_KF_ATE_M = 0.680995491968856  # rigid ATE of the keyframe map at the end
LOOP_KF_ATE_FACTOR = 1.05  # the final keyframe-map ATE bound: JAX x 1.05 + ATE_MARGIN_M
# phase 23's loop with the solver process answers each local-BA request at
# the first tick LOOP_SOLVER_LAG frames after its submit (waiting there for
# the solver if need be), the schedule on which tests/torch_loop_lockstep.py's
# ScheduledSolver runs the JAX package: on the solver's own timing the run
# is a race between the solve and the host, and one build's runs ended
# anywhere in 0.21962-0.86288 m on one H100; on the schedule a run repeats
# bit for bit. Runs on the noiseless frames and on LOOP_SOLVER_SEEDS' noisy
# ones (noisy_loop_frames), each seed in a process of its own; their median
# final keyframe-map ATE is held to phase 9's bound and to the JAX
# package's median on the same frames and schedule x 1.05 + 0.01 m, which
# `python tests/test_torch_loop_closing.py --solver --lag 1 [--noise K]`
# prints (noiseless, then seeds 1-4; XLA:CPU; 8, 2, 8, 8 and 3 closures,
# 61, 52, 57, 63 and 56 keyframes, 148 OK frames each).
LOOP_SOLVER_LAG = 1
LOOP_SOLVER_SEEDS = (1, 2, 3, 4)
JAX_LOOP_LAG1_KF_ATES_M = (
    1.6076972517527426, 0.5015179755256753, 0.30195258709150974, 0.3385028205710072, 1.856106722685037,
)
LOOP_SOLVER_CHILD_S = 600  # the most seconds a seed run may take
# the mono sequence (`make_mono_frames`: benchmarks/ladder.py's mono_sequence
# scene at VGA, 30 frames) through tpuslam.system.System(cam, sensor="mono",
# tracker_cfg=MONO_TRACKER there, mapping and loop closing on), XLA:CPU, cv2
# hidden, TPUSLAM_KF_DEFER_MS=0, TPUSLAM_NATIVE_MAP=0, TPUSLAM_WARM_LOOP=0,
# TPUSLAM_BA_SUBPROCESS=0: `python tests/test_torch_mono.py mono` prints them
# (hybrid: first OK frame 4, 26 OK frames, keyframes at frames 4, 8, ..., 28;
# lines only: first OK frame 5, 25 OK frames, keyframes at 5, 9, ..., 29).
# ATE: Sim(3)-aligned RMSE over the OK frames.
JAX_MONO_HYBRID_FIRST_OK = 4
JAX_MONO_HYBRID_ATE_M = 0.02929071390771116
JAX_MONO_LINES_FIRST_OK = 5
JAX_MONO_LINES_ATE_M = 0.22372437381713334
# Lines only, the Sim(3) ATE is chaotic in the RANSAC draws (in the JAX
# package too: the scale of a lines-only mono map drifts), so that run is held
# by the median over MONO_DRAWS runs: the JAX package's with PRNGKey(frame_idx
# + 1000 k), k = 0..10 (k = 0 is the run above; `python
# tests/test_torch_mono.py draws 1 11` prints the others), the port's with
# its generator seeded frame_idx + 1000 k on the card (k = 0: the default)
JAX_MONO_LINES_DRAW_ATES_M = (
    0.22372437381713334, 0.090788042155714, 0.42738820079879375, 0.16759669018952306, 0.1412654692079062,
    0.1531556027260977, 0.2867959017854134, 0.2774904866119114, 0.27804777105496004, 0.3138127518700231,
    0.1760691221047711,
)
MONO_DRAWS = len(JAX_MONO_LINES_DRAW_ATES_M)
MONO_ATE_FACTOR = 1.05  # mono ATE bounds: JAX x 1.05 + ATE_MARGIN_M
# the mono loop (`make_mono_loop_frames`: benchmarks/ladder.py's mono_loop,
# with the ladder's 20-frame dwell, 140 QVGA frames) through the same System
# with hybrid points, the same settings: `python tests/test_torch_mono.py
# loop` prints them (138 frames OK, 37 keyframes, loops closed at keyframes
# 30, 32, 34 and 36 through the Sim(3) branch; the final keyframe map's
# Sim(3) ATE is that after the last closure)
JAX_MONO_LOOP_OK_FRAMES = 138
JAX_MONO_LOOP_KF_ATE_M = 1.554863693170919
# The pipelined forms (phases 12-17) on the same frames, tpuslam.system.System
# with mapping on and loop closing off, XLA:CPU, cv2 hidden,
# TPUSLAM_KF_DEFER_MS=0, TPUSLAM_NATIVE_MAP=0: `python
# tests/test_torch_pipelined.py fullchunk frame hybrid descriptor hostscale
# classic` prints them, under the JAX bench's switches (bench_configs here):
# semidirect=False (full-detection chunks of 6; keyframes at frames 0, 8-17,
# 37), chunk=1 (the single-frame program; 0, 8, 9, 10, 30), chunk=1 with points
# over make_frames(draw_points=True) (0-7, 9-12, 32), chunk=1 with descriptor
# stereo (0, 8, 9, 10, 13, 14, 15, 35), hostscale=False (semi-direct chunks
# resized on the device; 0, 13, 19, 25); the classic pipeline
# (TrackerConfig(pipelined=True, fused=False), mapping on; 0, 8, 17, 37: the
# JAX package's synchronous mapping run's ATE to the last digit, as its
# classic run without mapping gives JAX_ATE_M). Bound: JAX x 1.05 + 0.01 m.
JAX_FULLCHUNK_ATE_M = 0.029031030910803432
JAX_FRAME_ATE_M = 0.013331763301453577
JAX_HYBRID_FRAME_ATE_M = 0.0512740825023997
JAX_DESCRIPTOR_FRAME_ATE_M = 0.028262284993123426
JAX_HOSTSCALE_ATE_M = 0.015130935636825193
JAX_CLASSIC_MAPPING_ATE_M = 0.009802508959604729
PIPELINED_ATE_FACTOR = 1.05
# the synchronous descriptor-stereo tracker (mapping off) over
# `make_radtan_frames()`, the JAX package's undistortion patched to leave the
# padding slots alone (it undistorts them to NaN there, which poisons
# descriptor stereo: ROADMAP.md section 3): `python
# tests/test_torch_extract_variants.py` prints it (keyframes at frames 0, 5,
# 9; its frame-0 left extraction's median endpoint-to-true-line distance
# 1.92865 px)
JAX_RADTAN_ATE_M = 0.011594484670728142
# BASELINE config #5 (phase 20): per-sequence ATE of the JAX MultiTracker
# (tpuslam.parallel.multi_seq, the default TrackerConfig, a LocalMapper per
# sequence) over `make_multi_frames()` (8 VGA stereo sequences, 20 frames,
# per-sequence calibrations), XLA:CPU, cv2 hidden, TPUSLAM_KF_DEFER_MS=0,
# TPUSLAM_NATIVE_MAP=0: `python tests/test_torch_parallel.py` prints them
# (every frame OK; keyframes per sequence at frames [0, 6, 7, 12, 18], [0, 7,
# 12], [0], [0, 10], [0, 7], [0], [0], [0]). Bound: JAX x 1.05 + 0.01 m per
# sequence.
JAX_MULTI_ATE_M = (
    0.025014201498682432, 0.020736853320132545, 0.007569044372442805, 0.011306460205816975,
    0.015105178520964208, 0.009269905592480133, 0.008823428466979828, 0.009899952828617309,
)
RADTAN_LINE_ERR_PX = 2.0  # the median endpoint-to-true-line bound
# phase 21, the host surface: the CLI's `run` on the dataset `make-synthetic`
# writes with these arguments (VGA stereo, fx 458, baseline 0.11 m, motion
# 0.03, image noise 1, .npy frames). The JAX CLI's ATE on the same files, run on
# the CPU (XLA:CPU) with cv2 hidden, TPUSLAM_KF_DEFER_MS=0 and
# TPUSLAM_NATIVE_MAP=0: `python tests/test_torch_cli.py default fast` prints
# them (the CLI's defaults: synchronous descriptor stereo, mapping, loop
# closing; keyframes at frames 0, 4, 10, 16, 33; --fast: semi-direct chunks of
# 6 on host-halved frames, direct stereo, the default mapper; keyframes at
# frames 0, 7, 13, 19, 25)
CLI_FRAMES, CLI_SEGMENTS, CLI_SEED = 40, 140, 0
JAX_CLI_ATE_M = 0.01557428979140405
JAX_CLI_FAST_ATE_M = 0.04356155547790103
CLI_FAST_ATE_FACTOR = 1.05  # --fast is a pipelined form: JAX x 1.05 + ATE_MARGIN_M
# phase 22, the bench: run_benchmark(100, 6) renders the bench's 106 VGA
# frames (make_frames(106) for lines only, make_frames(106, draw_points=True)
# with hybrid points; with noise_seed k their image noise from seed k). The
# JAX System in the bench configuration (lines only or hybrid points) on the
# same frames, XLA:CPU, cv2 hidden, TPUSLAM_KF_DEFER_MS=0 and, unlike the
# constants above, the JAX map's native mirror on (the JAX bench's default,
# and the port's in this phase): `python tests/test_torch_bench.py lines`
# prints JAX_BENCH100_ATE_M (keyframes at frames 0, 13, 19, 43, 67, 91) and
# `... lines seeds 0 5` / `... hybrid seeds 0 5` the seeds' ATEs. A single
# run is inside both packages' chaos there (the JAX package's ATE spreads
# over the five seeds by more than ATE_MARGIN_M), so each row is held by its
# median over seeds 0-4: JAX median x 1.05 + 0.01 m
BENCH100_FRAMES, BENCH100_WARMUP = 100, 6
BENCH100_SEEDS = range(5)
JAX_BENCH100_ATE_M = 0.02134548378221491
JAX_BENCH100_SEED_ATES_M = (
    0.022601111670697838, 0.0249310796125024, 0.04719287287527833, 0.024404004414758824, 0.02705449171901201,
)
# (hybrid, the default noise stream: 0.05387035123901514 m, `python
# tests/test_torch_bench.py hybrid`)
JAX_HYBRID_BENCH100_SEED_ATES_M = (
    0.03298659928069139, 0.03697441411411868, 0.03405683614820747, 0.04427447610599114, 0.05176447325293941,
)
BENCH100_ATE_FACTOR = 1.05
# phase 22's seed runs at once, each in a process of its own, and the most
# seconds one may take
BENCH100_SLOTS, BENCH100_CHILD_S = 7, 600
# benchmarks/ladder.py's mono tracker settings
MONO_TRACKER = dict(min_init_lines=8, min_track_matches=6, min_track_inliers=6, max_frames_between_kf=4)
RELOC_FRAME = 20
# kernel calls per stereo frame on the slice (two cameras, two levels each):
# the pyramid's blur per camera; per camera and level the LBD gradients, the
# detector's front (its prefilter blur inside), the propagation and three
# sums (the components' moments, their extents and normal moment, the
# merge's 7 columns)
PER_FRAME = {
    "blur": 2, "gradients": 4, "lsd_front": 4, "ccl": 4, "component_moments": 4, "component_extents": 4, "segment_moments": 4,
}
KERNELS = {
    "blur": ("tpuslam_torch/csrc/image.cu", "tpuslam/kernels/pallas_image.py:148"),
    "gradients": ("tpuslam_torch/csrc/image.cu", "tpuslam/kernels/pallas_image.py:86"),
    "lsd_front": ("tpuslam_torch/csrc/lsd_front.cu", "tpuslam/kernels/pallas_image.py:86"),
    "ccl": ("tpuslam_torch/csrc/ccl.cu", "tpuslam/kernels/pallas_ccl.py:121"),
    # no Pallas kernel: XLA fuses these sums into its reductions (detect_lines'
    # `red`, its t_min / t_max / sn2, merge_collinear's segment_sum)
    "component_moments": ("tpuslam_torch/csrc/moments.cu", "tpuslam/kernels/lsd.py:219"),
    "component_extents": ("tpuslam_torch/csrc/moments.cu", "tpuslam/kernels/lsd.py:247"),
    "segment_moments": ("tpuslam_torch/csrc/moments.cu", "tpuslam/kernels/lsd.py:344"),
}
# blur_brief: the 1e-5 of [0, 1] images on BRIEF's 0..255 input; the sums:
# relative (t_min and t_max exact)
TOL = {
    "blur": 1e-5, "blur_brief": 255e-5, "blur_resize": 1e-5, "gradients": 1e-3, "lsd_front": 1e-3, "ccl": 0,
    "component_moments": 1e-5, "component_extents": 1e-5, "segment_moments": 1e-5,
}
# the bench path: chunks of 6; kernel calls of one left-image extraction at
# half resolution (an anchor, or a frame on the synchronous path): the
# pyramid's blur; per level the LBD gradients, the front and the propagation
BENCH_C = 6
PER_EXTRACTION = {
    "blur": 1, "gradients": 2, "lsd_front": 2, "ccl": 2, "component_moments": 2, "component_extents": 2, "segment_moments": 2,
}
# the hybrid bench path adds BRIEF's smoothing blur (sigma 2, radius 6) per extraction
PER_EXTRACTION_HYBRID = {**PER_EXTRACTION, "blur": 2}
PROFILE_WARM, PROFILE_FRAMES = 10, 3  # frames before the profiled ones, profiled frames


def fail(msg: str) -> None:
    """Stop with exit code 1, the reason on standard output and on standard
    error (whose tail a caller that keeps only that still shows)."""
    print(f"FAIL: {msg}", flush=True)
    print(f"chip_smoke.py FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def make_frames(n_frames: int = N_FRAMES, draw_points: bool = False, noise_seed=None):
    """VGA stereo camera, the bench's scene (tpuslam/bench.py) and its
    rendered (left, right) uint8 frames, all from seed 0; with
    ``draw_points`` the scene's 3D points are drawn as dots (the hybrid
    front end's corners; the same scene, lines and seed); with
    ``noise_seed`` the same scene and trajectory with the image noise drawn
    from that seed instead."""
    import numpy as np

    from tpuslam_torch import Intrinsics
    from tpuslam_torch.io.synthetic import make_wireframe_scene, render_wireframe_image

    cam = Intrinsics(fx=458.0, fy=457.0, cx=320.0, cy=240.0, width=640, height=480, baseline=0.11)
    rng = np.random.default_rng(0)
    scene = make_wireframe_scene(rng, n_segments=140, n_frames=n_frames, cam=cam, motion_scale=0.02)
    Tb = np.eye(4, dtype=np.float32)
    Tb[0, 3] = -cam.baseline
    scene_r = scene._replace(poses=np.stack([Tb @ T for T in scene.poses]))
    if noise_seed is not None:
        rng = np.random.default_rng(noise_seed)
    frames = [
        (
            render_wireframe_image(scene, f, noise=1.0, rng=rng, draw_points=draw_points),
            render_wireframe_image(scene_r, f, noise=1.0, rng=rng, draw_points=draw_points),
        )
        for f in range(n_frames)
    ]
    return cam, scene, frames


# BASELINE config #5 (phase 20): N sequences tracked concurrently, each
# with its own calibration (tests/test_parallel.py's, extended to 8) and
# scene seed
MULTI_SEQ, MULTI_FRAMES = 8, 20


def multi_cams(n: int = MULTI_SEQ):
    """n VGA stereo calibrations: fx, fy, cx, cy and the baseline moved per
    sequence as tests/test_parallel.py moves them."""
    from tpuslam_torch import Intrinsics

    return [
        Intrinsics(
            fx=458.0 + 14.0 * s, fy=457.0 - 11.0 * s, cx=320.0 + 6.0 * s, cy=240.0 - 5.0 * s, width=640, height=480,
            baseline=0.11 + 0.015 * s,
        )
        for s in range(n)
    ]


def make_multi_frames(n_seq: int = MULTI_SEQ, n_frames: int = MULTI_FRAMES):
    """(cams, scenes, frames): n_seq VGA stereo sequences, sequence s the
    bench scene's generator at seed 100 + s under its own calibration
    (multi_cams), frames[s][f] its rendered (left, right) uint8 pair."""
    import numpy as np

    from tpuslam_torch.io.synthetic import make_wireframe_scene, render_wireframe_image

    cams, scenes, frames = multi_cams(n_seq), [], []
    for s, cam in enumerate(cams):
        rng = np.random.default_rng(100 + s)
        scene = make_wireframe_scene(rng, n_segments=140, n_frames=n_frames, cam=cam, motion_scale=0.02)
        Tb = np.eye(4, dtype=np.float32)
        Tb[0, 3] = -cam.baseline
        scene_r = scene._replace(poses=np.stack([Tb @ T for T in scene.poses]))
        scenes.append(scene)
        frames.append([
            (render_wireframe_image(scene, f, noise=1.0, rng=rng), render_wireframe_image(scene_r, f, noise=1.0, rng=rng))
            for f in range(n_frames)
        ])
    return cams, scenes, frames


LOOP_FRAMES, LOOP_DWELL = 100, 48  # the circle's frames, then its first LOOP_DWELL frames again


def make_loop_frames(n_frames: int = LOOP_FRAMES, dwell: int = LOOP_DWELL):
    """The loop sequence of benchmarks/ladder.py's stereo_loop (the repo's
    analog of BASELINE config #4, KITTI 00 with loop closure): QVGA at fx
    200 and baseline 0.1 m, ``make_loop_scene(rng(7), 260 segments,
    n_frames, radius 5, room 14)``, its first ``dwell`` poses appended as the
    revisit, and (left, right) uint8 frames rendered with noise 1 and
    ``draw_points`` (the scene has no points), all from seed 7."""
    import numpy as np

    from tpuslam_torch import Intrinsics
    from tpuslam_torch.io.synthetic import make_loop_scene, render_wireframe_image

    cam = Intrinsics(fx=200.0, fy=200.0, cx=160.0, cy=120.0, width=320, height=240, baseline=0.1)
    rng = np.random.default_rng(7)
    scene = make_loop_scene(rng, n_segments=260, n_frames=n_frames, radius=5.0, room=14.0, cam=cam)
    scene = scene._replace(poses=np.concatenate([scene.poses, scene.poses[:dwell]]))
    Tb = np.eye(4, dtype=np.float32)
    Tb[0, 3] = -cam.baseline
    scene_r = scene._replace(poses=np.stack([Tb @ T for T in scene.poses]))
    frames = [
        (
            render_wireframe_image(scene, f, noise=1.0, rng=rng, draw_points=True),
            render_wireframe_image(scene_r, f, noise=1.0, rng=rng, draw_points=True),
        )
        for f in range(n_frames + dwell)
    ]
    return cam, scene, frames


MONO_FRAMES = 30


def make_mono_frames(n_frames: int = MONO_FRAMES):
    """The monocular sequence of benchmarks/ladder.py's mono_sequence (BASELINE
    config #2's analog) at VGA: fx 458 / fy 457, no baseline,
    ``make_mono_scene(rng(11), 60 segments, 120 points, step 0.06)`` and its
    uint8 frames rendered with noise 1 and the points drawn as dots, all from
    seed 11."""
    import numpy as np

    from tpuslam_torch import Intrinsics
    from tpuslam_torch.io.synthetic import make_mono_scene, render_wireframe_image

    cam = Intrinsics(fx=458.0, fy=457.0, cx=320.0, cy=240.0, width=640, height=480)
    rng = np.random.default_rng(11)
    scene = make_mono_scene(rng, n_frames, cam=cam)
    frames = [render_wireframe_image(scene, f, noise=1.0, rng=rng, draw_points=True) for f in range(n_frames)]
    return cam, scene, frames


MONO_LOOP_FRAMES, MONO_LOOP_DWELL = 120, 20  # the circle's frames, then its first MONO_LOOP_DWELL frames again


def make_mono_loop_frames(n_frames: int = MONO_LOOP_FRAMES, dwell: int = MONO_LOOP_DWELL):
    """The monocular loop of benchmarks/ladder.py's mono_loop: QVGA at fx
    200, ``make_mono_loop_scene(rng(7), n_frames, dwell)`` and its uint8
    frames rendered with noise 1 and ``draw_points`` (the scene has no
    points), all from seed 7."""
    import numpy as np

    from tpuslam_torch import Intrinsics
    from tpuslam_torch.io.synthetic import make_mono_loop_scene, render_wireframe_image

    cam = Intrinsics(fx=200.0, fy=200.0, cx=160.0, cy=120.0, width=320, height=240, baseline=0.1)
    rng = np.random.default_rng(7)
    scene = make_mono_loop_scene(rng, n_frames, dwell, cam=cam)
    frames = [render_wireframe_image(scene, f, noise=1.0, rng=rng, draw_points=True) for f in range(n_frames + dwell)]
    return cam, scene, frames


# TUM fr1's radial-tangential coefficients (tests/test_distortion.py's), on
# the bench camera
RADTAN = dict(k1=0.2624, k2=-0.9531, p1=-0.0054, p2=0.0026)
RADTAN_FRAMES = 20


def undistort_np(cam, dist, uv, iters: int = 8):
    """(..., 2) distorted pixels -> ideal pinhole pixels, float64: the radtan
    model's fixed-point inversion (8 iterations, the radial factor floored at
    1e-6), as the packages' undistort_pixels computes it."""
    import numpy as np

    uv = np.asarray(uv, np.float64)
    xd, yd = (uv[..., 0] - cam.cx) / cam.fx, (uv[..., 1] - cam.cy) / cam.fy
    x, y = xd, yd
    with np.errstate(over="ignore", invalid="ignore"):  # diverges beyond the largest distorted radius
        for _ in range(iters):
            r2 = x * x + y * y
            radial = 1.0 + dist["k1"] * r2 + dist["k2"] * r2 * r2
            dx = 2.0 * dist["p1"] * x * y + dist["p2"] * (r2 + 2.0 * x * x)
            dy = dist["p1"] * (r2 + 2.0 * y * y) + 2.0 * dist["p2"] * x * y
            x = (xd - dx) / np.maximum(radial, 1e-6)
            y = (yd - dy) / np.maximum(radial, 1e-6)
        return np.stack([cam.fx * x + cam.cx, cam.fy * y + cam.cy], axis=-1)


def distort_image(img, cam, dist, border: float = 200.0):
    """A pinhole render -> the image the radtan camera sees: an inverse-map
    bilinear remap (each distorted pixel samples the ideal image at its
    undistorted position; outside it, the background ``border``), rounded to
    uint8."""
    import numpy as np

    H, W = img.shape
    uu, vv = np.meshgrid(np.arange(W, dtype=np.float64), np.arange(H, dtype=np.float64))
    src = undistort_np(cam, dist, np.stack([uu, vv], -1))
    # where the fixed point does not converge (beyond the model's largest
    # distorted radius, at the corners) the sample falls outside
    x = np.clip(np.nan_to_num(src[..., 0], nan=-2.0), -2.0, W + 1.0)
    y = np.clip(np.nan_to_num(src[..., 1], nan=-2.0), -2.0, H + 1.0)
    x0, y0 = np.floor(x), np.floor(y)
    fx_, fy_ = x - x0, y - y0
    a = np.asarray(img, np.float64)

    def tap(yi, xi):
        inside = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        v = a[np.clip(yi, 0, H - 1).astype(np.int64), np.clip(xi, 0, W - 1).astype(np.int64)]
        return np.where(inside, v, border)

    out = (
        tap(y0, x0) * (1 - fx_) * (1 - fy_) + tap(y0, x0 + 1) * fx_ * (1 - fy_)
        + tap(y0 + 1, x0) * (1 - fx_) * fy_ + tap(y0 + 1, x0 + 1) * fx_ * fy_
    )
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


def line_errors(endpoints, valid, gt_uv, near_px: float = 10.0):
    """For each valid detected segment, the larger distance (px) of its two
    endpoints to the line of a true segment (ideal pinhole pixels), the
    smallest over the true segments that pass within ``near_px`` of its
    midpoint (inf where none does): tests/test_distortion.py's measure, with
    the true segment found by proximity (among the bench scene's 140
    segments the nearest midpoint is often another segment's)."""
    import numpy as np

    ep = np.asarray(endpoints, np.float64)[np.asarray(valid) > 0.5]
    a, b = np.asarray(gt_uv[:, 0], np.float64), np.asarray(gt_uv[:, 1], np.float64)
    ab = b - a
    n = np.stack([-ab[:, 1], ab[:, 0]], -1) / (np.linalg.norm(ab, axis=-1, keepdims=True) + 1e-9)
    mid = ep.mean(axis=1)
    t = np.clip(np.einsum("sgk,gk->sg", mid[:, None] - a[None], ab) / (np.einsum("gk,gk->g", ab, ab) + 1e-12), 0.0, 1.0)
    near = np.linalg.norm(mid[:, None] - (a[None] + t[..., None] * ab[None]), axis=-1) <= near_px
    d0 = np.abs(np.einsum("sgk,gk->sg", ep[:, None, 0] - a[None], n))
    d1 = np.abs(np.einsum("sgk,gk->sg", ep[:, None, 1] - a[None], n))
    return np.where(near, np.maximum(d0, d1), np.inf).min(axis=1)


def make_radtan_frames(n_frames: int = RADTAN_FRAMES):
    """The bench scene and camera (`make_frames`, seed 0) seen through TUM
    fr1's radtan distortion: (cam, RADTAN, scene, distorted (left, right)
    uint8 frames). Both cameras share the coefficients; the undistorted
    features are rectified."""
    cam, scene, frames = make_frames(n_frames)
    return cam, RADTAN, scene, [tuple(distort_image(x, cam, RADTAN) for x in pair) for pair in frames]


def ate_of(trajectory, scene) -> float:
    import numpy as np

    from tpuslam_torch.eval.ate import absolute_trajectory_error

    est = np.stack([np.linalg.inv(r.T_cw)[:3, 3] for r in trajectory])
    gt = np.stack([np.linalg.inv(T)[:3, 3] for T in scene.poses[: len(trajectory)]])
    return absolute_trajectory_error(est, gt).rmse


REPS = 100  # back-to-back calls per device timing
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 memory rate
PEAK_OPS_PER_S = 67e12  # H100 SXM float32 peak outside the tensor cores


def device_us(fn, reps: int = REPS):
    """Device time per call (us): CUDA events around `reps` back-to-back
    calls, after 3 warm-up calls. The calls are enqueued behind a spin
    kernel (torch.cuda._sleep), so the host is ahead of the card and they run
    without host gaps; the start event must still be pending once the host
    has enqueued them all (else the run is repeated with fewer calls or a
    longer spin). A call that waits for the card can never be ahead: that
    fails."""
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


def bound_us(name: str, H: int, W: int, ntaps: int, rounds: int, compat_bits: int, n_support: int):
    """(least time in us, "bytes" or "operations") of one call at (H, W):
    each input read once and each output written once, at 3.35 TB/s, and
    the operations these inputs need at 67 T/s. Data-dependent work is
    counted for this run's planes: CCL's a min and a max per compat bit set
    (`compat_bits` on the plane), per round; the front's compat test (two
    products and a sum for the dot, two products for the threshold, a
    compare) per direction of a supported pixel (`n_support`)."""
    px = H * W
    nbytes, ops = {
        "blur": (8 * px, 4 * ntaps * px),  # 1 plane in, 1 out; a multiply and an add per tap and pass
        "gradients": (12 * px, 8 * px),  # 1 in, gx and gy out; 4 scalings, 2 differences, 2 halvings
        # 1 f32 in; mag, support (1 B), labels0, maxlab0, compat out. Blur,
        # scale, differences, halvings, squares, sum, sqrt and the support
        # compare per pixel, then the compat tests
        "lsd_front": (21 * px, (4 * ntaps + 10) * px + 6 * 8 * n_support),
        "ccl": (20 * px, 2 * rounds * compat_bits),  # 3 int32 in, 2 out
    }[name]
    tb, to = nbytes / PEAK_BYTES_PER_S, ops / PEAK_OPS_PER_S
    return max(tb, to) * 1e6, ("bytes" if tb >= to else "operations")


def sums_bound_us(name: str, N: int, K: int, V: int):
    """(least time in us, "bytes" or "operations") of one call of a sum
    kernel. component_moments: the label, magnitude and support planes (9 B
    per pixel) and K int64 roots read, (7, K) written; component_extents the
    same plus cx, cy, ev (16 B per component) read and (3, K) written;
    segment_moments: V float32 columns and an int32 slot per item read, (V,
    K) written. Operations: a compare per pixel and a few per item, far
    below the bytes."""
    nbytes = {
        "component_moments": 9 * N + 8 * K + 28 * K,
        "component_extents": 9 * N + 8 * K + 16 * K + 12 * K,
        "segment_moments": 4 * N * (V + 1) + 4 * V * K,
    }[name]
    ops = N * V if name == "segment_moments" else N
    tb, to = nbytes / PEAK_BYTES_PER_S, ops / PEAK_OPS_PER_S
    return max(tb, to) * 1e6, ("bytes" if tb >= to else "operations")


def in_turns(old, new):
    """Device us of two forms of one function, timed old, new, new, old;
    returns (new, old), each the mean of its two turns."""
    o1, n1, n2, o2 = device_us(old[0], old[1]), device_us(new[0], new[1]), device_us(new[0], new[1]), device_us(old[0], old[1])
    return (n1 + n2) / 2, (o1 + o2) / 2


# torch.cuda._sleep's kernel, which `profiled` launches PROFILE_MARKERS times
# first in each trace
PROFILE_MARKER = "spin_kernel"
PROFILE_MARKERS = 4
# the runtime calls that launch one kernel each
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchCooperativeKernel")


def trace_records(prof):
    """({kernel or copy name: [records, us]}, host kernel launch calls) of a
    torch.profiler run, without `profiled`'s marker kernels, read from its
    raw Kineto records (key_averages first builds an event object for
    every record and a tree of them, which takes seconds for one traced
    chunk)."""
    from torch.autograd import DeviceType

    dev, n_calls = {}, 0
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if PROFILE_MARKER not in name:
                rec = dev.setdefault(name, [0, 0.0])
                rec[0] += 1
                rec[1] += (e.end_ns() - e.start_ns()) / 1e3
        elif name.startswith(LAUNCH_CALLS):
            n_calls += 1
    return dev, n_calls - PROFILE_MARKERS


def device_events(prof):
    """(device busy us, kernel launches, memcpy/memset events, launch calls)
    of a torch.profiler run, without `profiled`'s marker kernels: the first
    three from its device-side records (host ops repeat their kernels'
    time), the last from the host's kernel launch calls, which the device
    records should match one for one."""
    dev, n_calls = trace_records(prof)
    n_copies = sum(n for name, (n, _) in dev.items() if name.startswith(("Memcpy", "Memset")))
    return sum(us for _, us in dev.values()), sum(n for n, _ in dev.values()) - n_copies, n_copies, n_calls


def check_trace_records(prof) -> None:
    """device_events' numbers from the raw records against the same read
    through key_averages (the form it replaced) on one trace: the counts
    equal, the busy us within 1e-6 relative; both reads timed."""
    from torch.autograd import DeviceType

    t = time.perf_counter()
    raw = device_events(prof)
    t_raw = time.perf_counter() - t
    t = time.perf_counter()
    avg = prof.key_averages()
    dev = [e for e in avg if e.device_type == DeviceType.CUDA and PROFILE_MARKER not in e.key]
    n_copies = sum(e.count for e in dev if e.key.startswith(("Memcpy", "Memset")))
    n_calls = sum(e.count for e in avg if e.device_type == DeviceType.CPU and e.key.startswith(LAUNCH_CALLS))
    ref = (sum(e.self_device_time_total for e in dev), sum(e.count for e in dev) - n_copies, n_copies, n_calls - PROFILE_MARKERS)
    t_avg = time.perf_counter() - t
    print(f"torch.profiler: the first trace read from its raw records {raw} in {t_raw * 1e3:.1f} ms, through key_averages "
          f"{ref} in {t_avg * 1e3:.1f} ms", flush=True)
    if raw[1:] != ref[1:] or not abs(raw[0] - ref[0]) <= 1e-6 * max(ref[0], 1.0):
        fail("torch.profiler: the raw records and key_averages disagree")


# traces taken; traces taken again; kernel launches whose device record the
# returned traces lack; whether a trace was read both ways (check_trace_records)
TRACES = {"taken": 0, "again": 0, "records_lost": 0, "checked": False}


def profiled(run, tries: int = 6, whole: bool = True):
    """(profile, (device busy us, kernel launches, memcpy/memset events)) of
    run() under torch.profiler (CPU and CUDA activity). On the card a trace
    can lose a device record, most often its first whatever its kernel
    (PERF.md section 7), so each trace starts with PROFILE_MARKERS marker
    kernels, left out of the counts. A trace is taken again, up to `tries`
    times (a `run` that tracks frames tracks the next ones), when it holds
    no device work, or, with `whole`, fewer kernel records than kernel
    launch calls; it fails when none is left. TRACES counts what was lost."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for t in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILE_MARKERS):
                torch.cuda._sleep(1000)
            run()
            torch.cuda.synchronize()
        *events, n_calls = device_events(prof)
        if not TRACES["checked"] and n_calls >= 100:
            TRACES["checked"] = True
            check_trace_records(prof)
        TRACES["taken"] += 1
        if events[0] > 0 and (events[1] >= n_calls or not whole):
            TRACES["records_lost"] += max(0, n_calls - events[1])
            return prof, tuple(events)
        TRACES["again"] += t + 1 < tries
        print(f"torch.profiler: trace {t + 1} of {tries} holds {events[1]} device records of {n_calls} kernel launches", flush=True)
    fail("torch.profiler lost device records in every trace")


def profiled_launches(fn, whole: bool = True) -> int:
    """Device kernel launches of one call of fn, counted by torch.profiler
    (with `whole` from a trace that lost no device record)."""
    fn()
    return profiled(fn, whole=whole)[1][1]


def kernel_phase(frames, card):
    """Each kernel against its plain version and bit for bit against its
    baseline form at 480x640, 384x512 and 240x320, with device times and
    launches per call. Returns {name: fields of the kernels line at
    480x640}."""
    import torch
    import torch.nn.functional as F

    from tpuslam_torch.kernels import image, lsd
    from tpuslam_torch.kernels.fast import FASTParams

    left = torch.from_numpy(frames[0][0]).cuda().float() / 255.0
    level1 = image.build_pyramid(left, 2, 0.8)[1].contiguous()  # 384x512
    half = image.resize_linear(left, (240, 320)).contiguous()
    half1 = image.build_pyramid(half, 2, 0.8)[1].contiguous()  # 192x256, the bench path's level 1
    params = lsd.LSDParams()
    R = params.ccl_rounds
    sigma = params.prefilter_sigma
    ntaps = image._blur_taps(sigma).numel()
    bsig = FASTParams().blur_sigma  # BRIEF's smoothing: radius 6, on the image times 255
    bntaps = image._blur_taps(bsig).numel()
    want_lpc = launches_per_call()
    res = {}
    for img in (left, level1, half, half1):
        H, W = img.shape
        _, sup, lab0, mx0, cb = lsd.ccl_inputs(img, params)
        n_bits = int(sum(((cb >> d) & 1).sum() for d in range(8)))
        n_support = int(sup.sum())
        print(
            f"front planes {(H, W)}: {n_support} supported pixels, {int((cb != 0).sum())} with compat bits, {n_bits} bits",
            flush=True,
        )
        taps = image._blur_taps(sigma).cuda()
        r = taps.numel() // 2
        padded = F.pad(img[None, None], (r, r, r, r), mode="replicate")
        taps2d = torch.outer(taps, taps)[None, None]
        cases = {
            # name: (kernel, plain, baseline form (reps), library call, reps of the kernel)
            "blur": (lambda: image.gaussian_blur(img, sigma), lambda: image.gaussian_blur_torch(img, sigma),
                     (lambda: image._blur_two_pass_cuda(img, sigma), REPS), lambda: F.conv2d(padded, taps2d), REPS),
            "gradients": (lambda: image.gradients_xy(img, 255.0), lambda: image.gradients_xy_torch(img, 255.0),
                          (lambda: image._gradients_cuda(img * 255.0)[:2], REPS), None, REPS),
            # 162 launches a call: 5 calls fit the card's queue of pending launches
            "lsd_front": (lambda: lsd.ccl_inputs(img, params), lambda: lsd.ccl_inputs_torch(img, params),
                          (lambda: lsd._ccl_inputs_chain_cuda(img, params), 5), None, REPS),
            "ccl": (lambda: lsd.ccl_propagate(lab0, mx0, cb, R), lambda: lsd._ccl_torch(lab0, mx0, cb, R),
                    (lambda: lsd._ccl_per_round_cuda(lab0, mx0, cb, R), 10), None, REPS),
        }
        if img is left:  # the in-program resize's prefilter (sigma 0.5, radius 2) on the full-resolution frame
            rsig = 0.5 * (1.0 / 0.5 - 1.0)
            rtaps = image._blur_taps(rsig).cuda()
            rr = rtaps.numel() // 2
            rpadded = F.pad(img[None, None], (rr, rr, rr, rr), mode="replicate")
            rtaps2d = torch.outer(rtaps, rtaps)[None, None]
            cases["blur_resize"] = (lambda: image.gaussian_blur(img, rsig), lambda: image.gaussian_blur_torch(img, rsig),
                                    (lambda: image._blur_two_pass_cuda(img, rsig), REPS), lambda: F.conv2d(rpadded, rtaps2d), REPS)
        if img is left or img is half:  # FAST runs on the bench path's 240x320 left image
            bimg = (img * 255.0).contiguous()
            btaps = image._blur_taps(bsig).cuda()
            br = btaps.numel() // 2
            bpadded = F.pad(bimg[None, None], (br, br, br, br), mode="replicate")
            btaps2d = torch.outer(btaps, btaps)[None, None]
            cases["blur_brief"] = (lambda: image.gaussian_blur(bimg, bsig), lambda: image.gaussian_blur_torch(bimg, bsig),
                                   (lambda: image._blur_two_pass_cuda(bimg, bsig), REPS), lambda: F.conv2d(bpadded, btaps2d), REPS)
        for name, (kern, plain, baseline, lib, reps) in cases.items():
            outs_k, outs_p, outs_o = (x if isinstance(x, tuple) else (x,) for x in (kern(), plain(), baseline[0]()))
            torch.cuda.synchronize()
            n_near = None
            if name == "lsd_front":
                gx, gy, _, _ = image.image_gradients_torch(image.gaussian_blur_torch(img, sigma) * 255.0)
                err, n_near, n_other = lsd.front_disagreements(outs_k, outs_p, gx, gy, params, TOL[name])
                within = err <= TOL[name] and n_other == 0
                plain_txt = f"; integer planes differ at {n_near} pixels where a threshold decides by < 1e-3, {n_other} elsewhere"
            else:
                err = max(float((a.double() - b.double()).abs().max()) for a, b in zip(outs_k, outs_p))
                within, plain_txt = err <= TOL[name], ""
            same_old = len(outs_k) == len(outs_o) and all(torch.equal(a, b) for a, b in zip(outs_k, outs_o))
            ok = within and same_old
            print(
                f"kernel {name:9s} {(H, W)}: max_abs_err={err:.3g} (tol {TOL[name]}){plain_txt}, "
                f"bit-equal to the baseline form: {same_old} {'ok' if ok else 'FAIL'}",
                flush=True,
            )
            if not ok:
                fail(f"{name} kernel disagrees with its plain version or its baseline form at {(H, W)}")
            lpc, old_lpc = profiled_launches(kern), profiled_launches(baseline[0], whole=False)
            print(f"kernel {name:9s} {(H, W)}: device launches per call (torch.profiler) {lpc}, baseline form {old_lpc}", flush=True)
            if name in ("gradients", "lsd_front") and lpc != want_lpc[name]:
                fail(f"{name}: {lpc} device launches per call, expected {want_lpc[name]}")
            dev_us, old_us = in_turns(baseline, (kern, reps))
            plain_ms = host_paced_ms(plain, 10 if name in ("ccl", "lsd_front") else REPS)
            lib_ms = device_us(lib) / 1e3 if lib else None
            if name == "blur_brief":
                b_us, b_by = bound_us("blur", H, W, bntaps, R, n_bits, n_support)
            elif name == "blur_resize":
                b_us, b_by = bound_us("blur", H, W, rtaps.numel(), R, n_bits, n_support)
            else:
                b_us, b_by = bound_us(name, H, W, ntaps, R, n_bits, n_support)
            lib_txt = f"{lib_ms * 1e3:.3f} us" if lib else "none"
            print(
                f"kernel {name:9s} {(H, W)}: device {dev_us:.3f} us/call, baseline form {old_us:.3f} us, bound {b_us:.3f} us "
                f"({b_by}, {b_us / dev_us:.1%} of it), plain {plain_ms:.4f} ms (host-paced), library {lib_txt} on {card}",
                flush=True,
            )
            prev = res.get(name)
            by_shape = f"{H}x{W}"
            if prev is None:  # the first shape, 480x640, fills the kernels line
                res[name] = dict(
                    shape=f"{H}x{W}", max_abs_err=err, device_us=dev_us, ms=dev_us / 1e3, plain_ms=plain_ms,
                    bound_us=b_us, bound_ms=b_us / 1e3, bound_by=b_by, library_ms=lib_ms, baseline_device_us=old_us,
                    profiled_launches_per_call=lpc, baseline_launches_per_call=old_lpc,
                    device_us_by_shape={by_shape: dev_us}, bound_us_by_shape={by_shape: b_us},
                )
                if n_near is not None:
                    res[name]["near_threshold_px"] = n_near
            else:
                prev["max_abs_err"] = max(prev["max_abs_err"], err)
                prev["device_us_by_shape"][by_shape] = dev_us
                prev["bound_us_by_shape"][by_shape] = b_us
    # BRIEF's blur is the blur kernel's second instance on the main path
    res["blur"]["brief"] = dict(sigma=bsig, radius=bntaps // 2, **res.pop("blur_brief"))
    # the in-program resize's prefilter: the blur kernel's third instance, its own entry of the kernels line
    res["blur.resize"] = dict(sigma=0.5, radius=2, **res.pop("blur_resize"))
    res.update(sums_phase((left, half, half1), card))
    return res


def detector_sum_inputs(img):
    """{entry: args} of the three sums one detect_lines call makes on
    ``img``: component_moments (labels, mag, support, roots),
    component_extents (the same and cx, cy, ev), segment_moments (the
    merge's 7 columns over the segments, their group labels, S)."""
    from tpuslam_torch.kernels import lsd

    seen, real = {}, {name: getattr(lsd, name) for name in lsd.SUMS}

    def grab(name):
        def call(*args):
            if name in seen:
                fail(f"{name}: detect_lines called it twice")
            seen[name] = args
            return real[name](*args)

        return call

    for name in lsd.SUMS:
        setattr(lsd, name, grab(name))
    try:
        lsd.detect_lines(img, 256)
    finally:
        for name in lsd.SUMS:
            setattr(lsd, name, real[name])
    if set(seen) != set(lsd.SUMS):
        fail(f"sums: detect_lines called {sorted(seen)}, expected {sorted(lsd.SUMS)}")
    return seen


def _sum_errors(name, got, ref):
    """(max abs error, max relative error of the sums, t_min / t_max
    bit-equal (None for the other kernels), merge bit-equal)."""
    import torch

    g, r = got.cpu().double(), ref.double()
    sums = slice(2, 3) if name == "component_extents" else slice(None)
    err = float((g[sums] - r[sums]).abs().max())
    rel = float(((g[sums] - r[sums]).abs() / r[sums].abs().clamp(min=1e-30)).max())
    bits = lambda t: t.contiguous().view(torch.int32)  # noqa: E731
    exact = torch.equal(bits(got[:2].cpu()), bits(ref[:2])) if name == "component_extents" else None
    return err, rel, exact, torch.equal(bits(got.cpu()), bits(ref))


def sums_phase(images, card) -> dict:
    """The three sum kernels on the detector's own inputs at each image's
    shape: the member share; each kernel against its plain version (sums
    within 1e-5 relative, t_min / t_max bit-equal), bit-equal over two
    calls, one launch per call (the wrapper's count and torch.profiler's),
    device us in turns with the form it replaced (what detect_lines ran on
    the card before: the eager chain around the two-launch kernel; the
    merge's: that kernel alone), that kernel alone on the stacked columns,
    and the deterministic index_add_ yardstick on those columns. Returns
    {name: kernels-line fields}, the first shape filling the top level."""
    import torch

    from tpuslam_torch.kernels import lsd

    plain = {"component_moments": lsd.component_moments_torch, "component_extents": lsd.component_extents_torch,
             "segment_moments": lsd.segment_moments_torch}
    replaced = {"component_moments": lsd._component_moments_replaced_cuda,
                "component_extents": lsd._component_extents_replaced_cuda, "segment_moments": lsd._moments_two_launch_cuda}
    chains = {"component_moments": lsd._component_moments_chain, "component_extents": lsd._component_extents_chain}
    res = {}
    per_extraction = {}  # shape -> (new us, replaced us) of its three sums
    for img in images:
        H, W = img.shape
        inputs = detector_sum_inputs(img)
        labels, _, support, roots = inputs["component_moments"]
        members = int(torch.isin(labels, roots).sum())
        n_support = int(support.sum())
        print(
            f"sums {(H, W)}: members of the {roots.numel()} components {members} of {labels.numel()} pixels "
            f"({members / labels.numel():.2%}); supported pixels {n_support} ({n_support / labels.numel():.2%})",
            flush=True,
        )
        removed = 0
        for name, args in inputs.items():
            tag = f"kernel {name:17s} {(H, W)}"
            kern = lambda: getattr(lsd, name)(*args)  # noqa: E731
            old = lambda: replaced[name](*args)  # noqa: E731
            a, b = kern(), kern()
            ref = plain[name](*(x.cpu() if isinstance(x, torch.Tensor) else x for x in args))
            err, rel, exact, same_plain = _sum_errors(name, a, ref)
            same = torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))
            ok = same and rel <= TOL[name] and exact is not False
            ext_txt = f", t_min / t_max bit-equal: {exact}" if exact is not None else ""
            print(
                f"{tag}: max_abs_err={err:.3g}, relative {rel:.3g} (tol {TOL[name]}){ext_txt}, bit-equal to the plain "
                f"version: {same_plain}, two calls bit-equal: {same} {'ok' if ok else 'FAIL'}",
                flush=True,
            )
            if not ok:
                fail(f"{name} kernel disagrees with its plain version or between two calls at {(H, W)}")
            before = lsd.KERNEL_LAUNCHES[name]
            kern()
            lpc = lsd.KERNEL_LAUNCHES[name] - before
            profiler_lpc, old_lpc = profiled_launches(kern), profiled_launches(old, whole=False)
            print(f"{tag}: launches per call {lpc} (wrapper's count), {profiler_lpc} (torch.profiler); the replaced form "
                  f"{old_lpc} (torch.profiler)", flush=True)
            if lpc != 1 or profiler_lpc != 1:
                fail(f"{name}: {lpc} (wrapper) and {profiler_lpc} (torch.profiler) device launches per call, expected 1")
            removed += old_lpc - profiler_lpc
            # the stacked columns and slots the replaced form summed
            if name in chains:
                stacked = []
                chains[name](*args, sums=lambda v, sl, S: stacked.append((v, sl, S)) or lsd._moments_two_launch_cuda(v, sl, S))
                vals, slot, S = stacked[0]
            else:
                vals, slot, S = args
            V, N = vals.shape
            valsT, slot64 = vals.t().contiguous(), slot.long()

            def library():  # one PyTorch call in its deterministic mode, on the stacked columns
                torch.use_deterministic_algorithms(True)
                try:
                    return torch.zeros((S, V), dtype=torch.float32, device=vals.device).index_add_(0, slot64, valsT)
                finally:
                    torch.use_deterministic_algorithms(False)

            dev_us, old_us = in_turns((old, REPS), (kern, REPS))
            old_kernel_us = device_us(lambda: lsd._moments_two_launch_cuda(vals, slot, S))
            lib_us = device_us(library)
            plain_ms = host_paced_ms(lambda: plain[name](*args), 10)
            K = roots.numel() if name != "segment_moments" else S
            b_us, b_by = sums_bound_us(name, N if name == "segment_moments" else labels.numel(), K, V)
            print(
                f"{tag}: device {dev_us:.3f} us/call, replaced form {old_us:.3f} us (its two-launch kernel alone on the "
                f"{V} stacked columns {old_kernel_us:.3f} us), bound {b_us:.3f} us ({b_by}, {b_us / dev_us:.1%} of it); "
                f"deterministic index_add_ {lib_us:.3f} us; plain {plain_ms:.4f} ms (host-paced) on {card}",
                flush=True,
            )
            new_sum, old_sum = per_extraction.get((H, W), (0.0, 0.0))
            per_extraction[(H, W)] = (new_sum + dev_us, old_sum + old_us)
            key = f"{H}x{W}"
            r = res.get(name)
            if r is None:
                r = res[name] = dict(
                    shape=key, max_abs_err=err, max_rel_err=rel, device_us=dev_us, ms=dev_us / 1e3, plain_ms=plain_ms,
                    bound_us=b_us, bound_ms=b_us / 1e3, bound_by=b_by, library_ms=lib_us / 1e3, baseline_device_us=old_us,
                    profiled_launches_per_call=profiler_lpc, baseline_launches_per_call=old_lpc,
                    device_us_by_shape={}, bound_us_by_shape={}, library_us_by_shape={}, baseline_us_by_shape={},
                    replaced_kernel_us_by_shape={}, member_share_by_shape={},
                )
            r["max_abs_err"] = max(r["max_abs_err"], err)
            r["max_rel_err"] = max(r["max_rel_err"], rel)
            r["device_us_by_shape"][key] = dev_us
            r["bound_us_by_shape"][key] = b_us
            r["library_us_by_shape"][key] = lib_us
            r["baseline_us_by_shape"][key] = old_us
            r["replaced_kernel_us_by_shape"][key] = old_kernel_us
            r["member_share_by_shape"][key] = members / labels.numel()
        print(f"sums {(H, W)}: device launches per detector level cut by {removed} (replaced forms' profiled launches less "
              f"the kernels')", flush=True)
    levels = [(240, 320), (192, 256)]  # one extraction of the bench path
    if all(lv in per_extraction for lv in levels):
        new_us = sum(per_extraction[lv][0] for lv in levels)
        old_us = sum(per_extraction[lv][1] for lv in levels)
        print(f"sums: one bench extraction's six calls (240x320 and 192x256) {new_us:.3f} us of device time, the replaced "
              f"forms {old_us:.3f} us, in turns on {card}", flush=True)
    return res


def profile_phase(cam, frames, card) -> None:
    """A fresh tracking System over PROFILE_WARM frames, then PROFILE_FRAMES
    steady frames under torch.profiler: device busy ms and device launches
    per frame, and the largest device items."""
    import torch

    from tpuslam_torch.system import System

    sys_ = System(cam, sensor="stereo", mapping=False, loop_closing=False, device="cuda")
    for f in range(PROFILE_WARM):
        sys_.track_stereo(*frames[f], f * 0.05)
    n = PROFILE_FRAMES
    todo = iter(range(PROFILE_WARM, len(frames)))  # a trace that is taken again tracks the next frames
    walls = []

    def run():
        t = time.perf_counter()
        for _ in range(n):
            f = next(todo)
            sys_.track_stereo(*frames[f], f * 0.05)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)

    prof, (busy_us, n_kernels, n_copies) = profiled(run, whole=False)
    sys_.shutdown()
    wall, first = walls[-1], PROFILE_WARM + n * (len(walls) - 1)
    states = [r.state.name for r in sys_.trajectory[first:]]
    print(
        f"profile: frames {first}-{first + n - 1} {states}: device busy {busy_us / 1e3 / n:.3f} ms/frame, "
        f"{n_kernels / n:.1f} kernel launches and {n_copies / n:.1f} memcpy/memset per frame, "
        f"{wall * 1e3 / n:.2f} ms/frame under the profiler (device idle {1 - busy_us / 1e6 / wall:.1%}) on {card}",
        flush=True,
    )
    for name, (count, us) in sorted(trace_records(prof)[0].items(), key=lambda kv: -kv[1][1])[:10]:
        print(f"profile: {us / 1e3 / n:8.3f} ms/frame {count / n:7.1f} calls/frame  {name[:90]}", flush=True)


def reset_launches() -> None:
    from tpuslam_torch.kernels import cuda_lib

    cuda_lib.reset_kernel_counts()


def read_launches():
    """(kernel calls, device launches of those calls), by kernel."""
    from tpuslam_torch.kernels import cuda_lib

    counts = cuda_lib.kernel_counts()
    return counts["calls"], counts["launches"]


def launches_per_call() -> dict:
    """Device launches each kernel call must make: one for blur, gradients,
    lsd_front and the three sums, ceil(R / k) for CCL."""
    from tpuslam_torch.kernels import lsd

    ccl = -(-lsd.LSDParams().ccl_rounds // lsd.CCL_TILE[2])
    return {"blur": 1, "gradients": 1, "lsd_front": 1, "ccl": ccl, **dict.fromkeys(lsd.SUMS, 1)}


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


def bench_system(cam, points: bool = False):
    from tpuslam_torch.system import System, bench_configs

    tcfg, mcfg = bench_configs(BENCH_C, points=points)
    return System(cam, sensor="stereo", mapping=True, loop_closing=False, tracker_cfg=tcfg, mapper_cfg=mcfg, device="cuda")


def bench_phase(cam, scene, frames, card, points: bool = False):
    """The bench configuration (its hybrid variant with ``points``) over the
    frames, with the launch counts set to 0 just before and read just
    after. Returns (launches, trajectory)."""
    import torch

    tag = "bench hybrid" if points else "bench"
    per_extraction = PER_EXTRACTION_HYBRID if points else PER_EXTRACTION
    jax_ate = JAX_HYBRID_BENCH_ATE_M if points else JAX_BENCH_ATE_M
    sys_ = bench_system(cam, points)
    sys_.timer.warmup = 0  # keep every keyframe event's stage times
    steady = BENCH_C + 1  # frames 1..C fill the first chunk, dispatched by frame C's call
    reset_launches()
    call_s = []
    t0 = time.perf_counter()
    for f, (il, ir) in enumerate(frames):
        if f == steady:
            torch.cuda.synchronize()
            t_steady = time.perf_counter()
        t = time.perf_counter()
        sys_.track_stereo(il, ir, f * 0.05)
        call_s.append(time.perf_counter() - t)
    sys_.shutdown()  # the final flush: the last chunk, padded
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    launches = read_launches()

    tr = sys_.tracker
    traj = sys_.trajectory
    states = [r.state.name for r in traj]
    kfs = [r.frame_idx for r in traj if r.made_keyframe]
    print(
        f"{tag}: anchors {tr.anchor_frames}, dispatched again at the flush {tr.flush_frames}, synchronous frames "
        f"{tr.sync_frames}, keyframes at frames {kfs}", flush=True,
    )
    print(f"{tag}: states {states}", flush=True)
    if [r.frame_idx for r in traj] != list(range(len(frames))):
        fail(f"{tag}: trajectory frames {[r.frame_idx for r in traj]}, expected one entry per frame in order")
    if any(st != "OK" for st in states):
        fail(f"{tag}: a frame did not track OK")
    allowed = set(tr.anchor_frames) | set(tr.sync_frames)
    if not set(kfs) <= allowed:
        fail(f"{tag}: keyframes at frames {sorted(set(kfs) - allowed)}, neither anchors nor synchronous frames")
    ate = ate_of(traj, scene)
    bound = jax_ate + ATE_MARGIN_M
    print(f"{tag}: ATE {ate:.5f} m, bound {bound:.5f} m (JAX package {jax_ate} m + {ATE_MARGIN_M} m)", flush=True)
    if not ate <= bound:
        fail(f"{tag}: ATE {ate} m above {bound} m")

    calls, device = launches
    want_lpc = launches_per_call()
    # an anchor dispatched again at the final flush (ROADMAP.md section 3,
    # fault 3.3) extracts again
    n_anchor = len(tr.anchor_frames) + len(tr.flush_frames)
    n_ext = n_anchor + tr.n_sync_extractions
    for name, per in per_extraction.items():
        want = per * n_ext
        print(
            f"{tag}: {name} calls {calls[name]} (expected {per} x {n_ext} extractions = {want}: {n_anchor} anchors "
            f"({len(tr.flush_frames)} again at the flush), {tr.n_sync_extractions} synchronous), "
            f"{calls[name] / n_anchor:.2f} per anchor, device launches {device[name]}",
            flush=True,
        )
        if calls[name] != want or calls[name] == 0:
            fail(f"{tag}: {name}: {calls[name]} calls, expected {want}")
        if device[name] != want * want_lpc[name]:
            fail(f"{tag}: {name}: {device[name]} device launches, expected {want_lpc[name]} per call")

    n_steady = len(frames) - steady
    wall = t_end - t_steady
    chunk_calls = [dt for f, dt in enumerate(call_s[steady:], steady) if (f - 1) % BENCH_C == BENCH_C - 1]
    other_calls = [dt for f, dt in enumerate(call_s[steady:], steady) if (f - 1) % BENCH_C != BENCH_C - 1]
    print(
        f"{tag}: frames {steady}-{len(frames) - 1} and the final flush: {wall * 1e3:.1f} ms for {n_steady} frames = "
        f"{n_steady / wall:.2f} frames/s ({wall * 1e3 / n_steady:.2f} ms/frame); calls that dispatch a chunk and resolve the "
        f"previous one median {statistics.median(chunk_calls) * 1e3:.2f} ms, buffering calls median "
        f"{statistics.median(other_calls) * 1e3:.3f} ms; whole run {(t_end - t0):.2f} s on {card}",
        flush=True,
    )
    ba = sys_.timer.times.get("mp.ba", [])
    lm_ms = sys_.timer.times.get("local_mapping", [])
    print(
        f"{tag}: keyframe events {len(kfs)}, local BA (mp.ba) per keyframe event {', '.join(f'{x * 1e3:.2f}' for x in ba)} ms "
        f"(median after the first {statistics.median(ba[1:]) * 1e3 if len(ba) > 1 else float('nan'):.2f} ms), local mapping "
        f"{', '.join(f'{x * 1e3:.2f}' for x in lm_ms)} ms on {card}",
        flush=True,
    )
    n_solves = sum(len(v) for v in sys_.mapper.solve_ms_by_rung.values())
    if n_solves != len(kfs) - 1:
        fail(f"{tag}: {n_solves} local BA solves for {len(kfs)} keyframe events (one per event after the first)")
    for rung, ms in sys_.mapper.solve_ms_by_rung.items():
        print(f"{tag}: solve rung (P, L, OL) = {rung}: {', '.join(f'{x:.2f}' for x in ms)} ms on {card}", flush=True)
    if points:
        pts = sys_.map_points()
        n_multi = int((pts["n_obs"] >= 2).sum())
        print(f"{tag}: live point landmarks {len(pts['ids'])}, seen from 2+ keyframes {n_multi}, live lines {len(sys_.map.lines.live_ids())}", flush=True)
        if n_multi == 0:
            fail(f"{tag}: no point landmark seen from two keyframes")
    return launches, traj


def count_syncs(run) -> list:
    """Host synchronizations with the card inside run(), as
    torch.cuda.set_sync_debug_mode("warn") reports them (each blocking read
    back or blocking copy warns once): the innermost line of tpuslam_torch
    (or of this script) on the Python stack of each."""
    import traceback
    import warnings

    import torch

    sites = []

    def show(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" in str(message):  # not the mode's own notice
            ours = [fr for fr in traceback.extract_stack()[:-1] if fr.filename.startswith(REPO)]
            fr = ours[-1] if ours else None
            sites.append(f"{os.path.relpath(fr.filename, REPO)}:{fr.lineno}" if fr else f"{filename}:{lineno}")

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sites


def bench_profile_phase(cam, frames, card, points: bool = False) -> None:
    """A fresh bench System (its hybrid variant with ``points``): host syncs
    of the chunk program alone and of one steady chunk's calls;
    torch.profiler over one steady chunk's calls, the anchor's step and one
    follower's step."""
    import numpy as np
    import torch

    from tpuslam_torch.frontend import pipeline
    from tpuslam_torch.frontend.frame import host_prescale
    from tpuslam_torch.kernels.align_direct import anchor_point_templates_body, anchor_templates_body

    tag = "bench hybrid" if points else "bench"
    sys_ = bench_system(cam, points)
    tr = sys_.tracker
    C = BENCH_C
    f = 0

    def feed(n):
        nonlocal f
        for _ in range(n):
            sys_.track_stereo(*frames[f], f * 0.05)
            f += 1

    feed(1 + 2 * C)  # the initialization and two chunks
    torch.cuda.synchronize()

    # one steady chunk's calls: C - 1 buffering calls, then the dispatch of
    # this chunk and the resolve of the previous one
    n0 = len(sys_.trajectory)
    syncs = count_syncs(lambda: feed(C))
    resolved = sys_.trajectory[n0:]
    print(
        f"{tag} syncs: frames {f - C}-{f - 1}: {len(syncs)} host synchronizations at {syncs} (target 1, the resolve's read of "
        f"the previous chunk's rows); the resolve completed frames {[r.frame_idx for r in resolved]}, keyframes among them "
        f"{[r.frame_idx for r in resolved if r.made_keyframe]} (a keyframe reads its features and runs the mapper)",
        flush=True,
    )
    if len(resolved) != C or (not any(r.made_keyframe for r in resolved) and len(syncs) != 1):
        fail(f"{tag}: a steady chunk without a keyframe must resolve C frames with one host read")
    n0 = len(sys_.trajectory)
    walls = []

    def run_chunk():
        t = time.perf_counter()
        feed(C)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)

    _, (busy_us, n_kernels, n_copies) = profiled(run_chunk, tries=3, whole=False)  # 19 + 3 x 6 frames of 40
    resolved = sys_.trajectory[n0:]
    print(
        f"{tag} profile: frames {f - C}-{f - 1} (dispatch of their chunk, resolve of frames "
        f"{[r.frame_idx for r in resolved]}, keyframes {[r.frame_idx for r in resolved if r.made_keyframe]}): device busy "
        f"{busy_us / 1e3:.3f} ms, {n_kernels} kernel launches and {n_copies} memcpy/memset per chunk, "
        f"{walls[-1] * 1e3:.2f} ms under the profiler (device idle {1 - busy_us / 1e6 / walls[-1]:.1%}) on {card}",
        flush=True,
    )

    # the chunk program alone, on the next frames' stack and the tracker's chain and local maps
    c = tr.cfg
    g0 = min(f, len(frames) - C)  # a retaken trace tracked further frames
    half = [[host_prescale(x, c.frontend) for x in frames[g]] for g in range(g0, g0 + C)]
    stack = torch.from_numpy(np.stack([half[0][0], half[0][1]] + [p[0] for p in half[1:]])).cuda()
    local = tr._local_map_arrays()
    plocal = tr._point_local_arrays() if points else None
    T_l, T_p = tr._dev_chain if tr._dev_chain is not None else (tr._pose_tensor(tr.T_cw),) * 2
    sd, ap = tr._direct_lines(), tr._align_params()
    stages = (c.search_coarse, c.search_fine, c.pose_opt, c.min_track_inliers)

    def whole():
        if points:
            pipeline.fused_stereo_semidirect_hybrid(
                stack, T_l, T_p, local, plocal, tr._fxb, cam, c.frontend, *stages, sd, tr._direct_points(), c.points, ap
            )
        else:
            pipeline.fused_stereo_semidirect(stack, T_l, T_p, local, tr._fxb, cam, c.frontend, *stages, sd, ap)

    whole()
    torch.cuda.synchronize()
    n_sync = count_syncs(whole)
    torch.cuda.synchronize()
    print(f"{tag} syncs: the chunk program alone (anchor + {C - 1} followers): {len(n_sync)} host synchronizations {n_sync}", flush=True)
    if n_sync:
        fail(f"{tag}: the chunk program synchronizes with the host at {n_sync}")
    f32 = stack.to(torch.float32) / 255.0
    A = ap.align_cap

    def anchor():
        if points:
            out = pipeline._fused_frame_hybrid_body(
                f32[:2], T_l, T_p, local, plocal, tr._fxb, cam, c.frontend, sd, tr._direct_points(), c.points, *stages
            )
            T_acc, T_prev = out[9], out[10]
            tm_p = anchor_point_templates_body(f32[0], T_acc, plocal["xyz"][: ap.point_cap], plocal["valid"][: ap.point_cap], cam, ap)
        else:
            out = pipeline._fused_frame_direct_body(
                f32[:2], T_l, T_p, local["plucker"], local["ep3d"], local["bits"], local["valid"], tr._fxb, cam, c.frontend,
                sd, *stages,
            )
            T_acc, T_prev, tm_p = out[6], out[7], None
        return T_acc, T_prev, anchor_templates_body(f32[0], T_acc, local["ep3d"][:A], local["valid"][:A], cam, ap), tm_p

    T_acc, T_prev, tm, tm_p = anchor()

    def follower():
        pipeline._follower_step(f32[2], T_acc, T_prev, local["plucker"][:A], tm, cam, ap, c.min_track_inliers, tm_p=tm_p)

    stages_run = [("whole chunk program", whole), ("anchor step (full frame + templates)", anchor), ("one follower step", follower)]
    if points:  # the hybrid stages a later hand kernel could take, alone
        from tpuslam_torch.kernels.align_direct import _search_point_templates
        from tpuslam_torch.kernels.fast import detect_corners
        from tpuslam_torch.kernels.stereo_direct import direct_point_disparity_body

        fp = detect_corners(f32[0], c.points.max_points, c.points.fast)
        sdp = tr._direct_points()
        stages_run += [
            ("FAST + BRIEF (detect_corners)", lambda: detect_corners(f32[0], c.points.max_points, c.points.fast)),
            ("corner stereo (direct_point_disparity_body)", lambda: direct_point_disparity_body(f32[0], f32[1], fp.uv / c.frontend.base_scale, fp.valid, sdp)),
            ("point templates (anchor_point_templates_body)", lambda: anchor_point_templates_body(f32[0], T_acc, plocal["xyz"][: ap.point_cap], plocal["valid"][: ap.point_cap], cam, ap)),
            ("point template search (_search_point_templates, one round)", lambda: _search_point_templates(f32[2] * 255.0, T_acc, tm_p, cam, ap)),
        ]
    for name, run in stages_run:
        run()
        walls = []

        def timed():
            t = time.perf_counter()
            run()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)

        _, (busy_us, n_kernels, n_copies) = profiled(timed, whole=False)
        print(
            f"{tag} profile: {name}: device busy {busy_us / 1e3:.3f} ms, {n_kernels} kernel launches, {n_copies} memcpy/memset, "
            f"{walls[-1] * 1e3:.2f} ms under the profiler on {card}",
            flush=True,
        )
    sys_.shutdown()


def repeat_phase(cam, frames, traj) -> None:
    """The lines-only bench configuration run again over the same frames:
    the same keyframes and bit-equal poses as the first run ``traj``."""
    import numpy as np

    sys_ = bench_system(cam)
    for f, (il, ir) in enumerate(frames):
        sys_.track_stereo(il, ir, f * 0.05)
    sys_.shutdown()
    kfs = [[r.frame_idx for r in t if r.made_keyframe] for t in (traj, sys_.trajectory)]
    same = [r.frame_idx for r in sys_.trajectory] == [r.frame_idx for r in traj] and all(
        np.array_equal(a.T_cw, b.T_cw) for a, b in zip(traj, sys_.trajectory)
    )
    first = next((a.frame_idx for a, b in zip(traj, sys_.trajectory) if not np.array_equal(a.T_cw, b.T_cw)), None)
    print(f"bench repeat: keyframes {kfs[0]} then {kfs[1]}; poses bit-equal: {same} (first differing frame {first})", flush=True)
    if kfs[0] != kfs[1] or not same:
        fail("bench: a second run of the bench path differs from the first")



def loop_system(cam):
    """benchmarks/ladder.py's stereo_loop configuration: the synchronous
    hybrid tracker with direct stereo, local mapping and loop closing."""
    from tpuslam_torch.frontend.points import PointFrontendParams
    from tpuslam_torch.frontend.tracking import TrackerConfig
    from tpuslam_torch.kernels.stereo_direct import DirectStereoParams
    from tpuslam_torch.system import System

    cfg = TrackerConfig(
        min_init_lines=8, min_track_matches=6, min_track_inliers=6, max_frames_between_kf=4,
        points=PointFrontendParams(), direct_stereo=DirectStereoParams(max_disp=64.0),
    )
    return System(cam, sensor="stereo", mapping=True, loop_closing=True, tracker_cfg=cfg, device="cuda")


def kf_map_ate(slam_map, scene, with_scale: bool = False) -> float:
    """ATE RMSE (m) of the keyframes' camera centres, rigid or, with
    ``with_scale``, Sim(3)-aligned (mono: the scale is free)."""
    import numpy as np

    from tpuslam_torch.eval.ate import absolute_trajectory_error

    kfs = [slam_map.keyframes[k] for k in sorted(slam_map.keyframes)]
    est = np.stack([np.linalg.inv(k.T_cw)[:3, 3] for k in kfs])
    gt = np.stack([np.linalg.inv(scene.poses[k.frame_idx])[:3, 3] for k in kfs])
    return float(absolute_trajectory_error(est, gt, with_scale=with_scale).rmse)


def first_closure_run(card) -> None:
    """Phase 9's loop configuration in this process up to its first closure:
    prints the warm-up's seconds (System.warm_loop_s, None when
    TPUSLAM_WARM_LOOP=0) and the first closure's ms with its essential
    graph's ms."""
    import torch

    cam, scene, frames = make_loop_frames()
    t = time.perf_counter()
    sys_ = loop_system(cam)
    start_s = time.perf_counter() - t
    sys_.timer.warmup = 0  # keep every keyframe event's stage times
    lc = sys_.loop_closer
    for f, (il, ir) in enumerate(frames):
        sys_.track_stereo(il, ir, f * 0.05)
        if lc.closed_loops:
            break
    torch.cuda.synchronize()
    ev, dt = next((ev, dt) for ev, dt in zip(lc.timings, sys_.timer.times["loop_closing"]) if ev["closed"])
    print(f"first closure (TPUSLAM_WARM_LOOP={os.environ.get('TPUSLAM_WARM_LOOP', 'default')}): System start {start_s:.2f} s, "
          f"warm-up {sys_.warm_loop_s}; closure at keyframe {ev['kid']} (frame {f}) {dt * 1e3:.2f} ms, essential graph "
          f"{ev['essential_graph_ms']:.2f} ms, compute_se3 {ev['compute_se3_ms']:.2f} ms on {card}", flush=True)
    sys_.shutdown()


def warm_loop_turns() -> int:
    """The first closure of phase 9's loop configuration without and with
    the loop warm-up, each in a fresh process (the set-up it moves is paid
    once per process), in turns (off, on, on, off):

        python3 -c "import sys, chip_smoke; sys.exit(chip_smoke.warm_loop_turns())"
    """
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script runs on a CUDA device only")
    card = card_line()
    from tpuslam_torch.kernels import cuda_lib

    cuda_lib.library()
    for warm in ("0", "1", "1", "0"):
        env = {**os.environ, "TPUSLAM_WARM_LOOP": warm, "TPUSLAM_NATIVE_MAP": "0", **SYNC_ENV}
        code = (f"import chip_smoke; chip_smoke.first_closure_run({card!r})")
        res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, timeout=600, check=False)
        if res.returncode:
            fail(f"first closure run with TPUSLAM_WARM_LOOP={warm} exited {res.returncode}")
    print(card, flush=True)
    return 0


def loop_phase(card):
    """The loop sequence through System(cam) with loop closing, the launch
    counts set to 0 just before and read just after; each closure's
    keyframe-map ATE before and after it and its stage times; then every
    essential-graph and global-BA problem a closure solved, solved again on
    the card (bit-equal), and one global-BA solve under torch.profiler.
    Returns the launches."""
    import numpy as np
    import torch

    from tpuslam_torch.backend.global_ba import GlobalBAConfig
    from tpuslam_torch.backend.lm import run_lm
    from tpuslam_torch.backend.pose_graph import optimize_pose_graph, optimize_pose_graph_sim3

    cam, scene, frames = make_loop_frames()
    sys_ = loop_system(cam)
    sys_.timer.warmup = 0  # keep every keyframe event's stage times
    lc = sys_.loop_closer
    closures = []
    inner = lc._close

    def close(kf, cand, ev=None):
        pre = kf_map_ate(sys_.map, scene)
        ok = inner(kf, cand, ev)
        if ok:
            closures.append((kf.kid, kf.frame_idx, cand, pre, kf_map_ate(sys_.map, scene)))
        return ok

    lc._close = close
    reset_launches()
    frame_s = []
    for f, (il, ir) in enumerate(frames):
        t = time.perf_counter()
        sys_.track_stereo(il, ir, f * 0.05)
        torch.cuda.synchronize()
        frame_s.append(time.perf_counter() - t)
    launches = read_launches()
    sys_.shutdown()

    traj = sys_.trajectory
    ok = [r for r in traj if r.state.name == "OK"]
    frame_ate = ate_of(ok, scene._replace(poses=scene.poses[[r.frame_idx for r in ok]]))
    final = kf_map_ate(sys_.map, scene)
    bound = JAX_LOOP_KF_ATE_M * LOOP_KF_ATE_FACTOR + ATE_MARGIN_M
    print(
        f"loop: {len(frames)} frames, OK {len(ok)} (JAX package {JAX_LOOP_OK_FRAMES}), keyframes {len(sys_.map.keyframes)}, "
        f"loops closed {lc.closed_loops}, gba_skipped {lc.gba_skipped}; frame ATE {frame_ate:.5f} m, final keyframe-map ATE "
        f"{final:.5f} m, bound {bound:.5f} m (JAX package {JAX_LOOP_KF_ATE_M} m x {LOOP_KF_ATE_FACTOR} + {ATE_MARGIN_M} m)",
        flush=True,
    )
    for kid, frame, cand, pre, post in closures:
        print(f"loop: closure of keyframe {kid} (frame {frame}) to keyframe {cand}: keyframe-map ATE {pre:.5f} -> {post:.5f} m", flush=True)
    kf_s = [dt for r, dt in zip(traj[1:], frame_s[1:]) if r.made_keyframe]
    other_s = [dt for r, dt in zip(traj[1:], frame_s[1:]) if not r.made_keyframe]
    print(
        f"loop: frames 1-{len(frames) - 1}: median {statistics.median(frame_s[1:]) * 1e3:.2f} ms/frame; keyframe frames "
        f"{len(kf_s)} median {statistics.median(kf_s) * 1e3:.2f} ms, other frames median {statistics.median(other_s) * 1e3:.2f} ms "
        f"on {card}",
        flush=True,
    )
    lc_s = sys_.timer.times.get("loop_closing", [])
    if len(lc_s) != len(lc.timings):
        fail(f"loop: {len(lc_s)} loop-closing times for {len(lc.timings)} keyframe events")
    quiet = [dt for ev, dt in zip(lc.timings, lc_s) if not ev["closed"]]
    print(
        f"loop: keyframe events {len(lc.timings)}; without a closure {len(quiet)}: loop closing median "
        f"{statistics.median(quiet) * 1e3:.2f} ms (detection median "
        f"{statistics.median([ev['detect_ms'] for ev in lc.timings if not ev['closed']]):.2f} ms), failed closure attempts "
        f"{sum(1 for ev in lc.timings if 'compute_se3_ms' in ev and not ev['closed'])}; local mapping median "
        f"{statistics.median(sys_.timer.times['local_mapping']) * 1e3:.2f} ms on {card}",
        flush=True,
    )
    for rung, ms in sys_.mapper.solve_ms_by_rung.items():
        print(f"loop: local BA solve rung (P, L, OL) = {rung}: {len(ms)} solves, median {statistics.median(ms):.2f} ms on {card}", flush=True)
    done = [(ev, dt) for ev, dt in zip(lc.timings, lc_s) if ev["closed"]]
    for (ev, dt), rec in zip(done, lc.closures):
        gba = rec.get("gba", {})
        solves = ", ".join(f"{ms:.2f}" for _, _, ms in gba.get("solves", []))
        print(
            f"loop: closure at keyframe {ev['kid']}: {dt * 1e3:.2f} ms = detect {ev['detect_ms']:.2f} + compute_se3 (RANSAC and "
            f"the refinement) {ev['compute_se3_ms']:.2f} + essential graph {ev['essential_graph_ms']:.2f} (P, E, padded to "
            f"{ev['graph_size']}) + correction {ev['correction_ms']:.2f} + global BA {ev.get('global_ba_ms', float('nan')):.2f} ms "
            f"(rung (P, L, OL) {gba.get('rung')}, points (M, OP) {gba.get('point_rung')}, solves {solves} ms) on {card}",
            flush=True,
        )
    if not closures:
        fail("loop: no loop was closed")
    first_ev, first_s = done[0]
    print(f"loop: warm-up at System start (warm_loop_programs, TPUSLAM_WARM_LOOP={os.environ.get('TPUSLAM_WARM_LOOP', 'default')}): "
          f"{sys_.warm_loop_s}; first closure (keyframe {first_ev['kid']}) {first_s * 1e3:.2f} ms, essential graph "
          f"{first_ev['essential_graph_ms']:.2f} ms on {card}", flush=True)
    if sys_.warm_loop_s is None:
        fail("loop: the System on the card did not run the loop warm-up")
    # the last closure, as benchmarks/ladder.py's stereo_loop records it
    kid, _, _, pre, post = closures[-1]
    if not post < pre:
        fail(f"loop: the closure at keyframe {kid} took the keyframe-map ATE from {pre} to {post} m, not below")
    if not final <= bound:
        fail(f"loop: final keyframe-map ATE {final} m above {bound} m")
    if len(ok) < JAX_LOOP_OK_FRAMES - 2:
        fail(f"loop: {len(ok)} OK frames, fewer than the JAX package's {JAX_LOOP_OK_FRAMES} - 2")

    gcfg = lc.cfg.gba_cfg or GlobalBAConfig()
    same = []
    for rec in lc.closures:
        prob, out = rec["pg"]
        again = (optimize_pose_graph_sim3 if lc.mono else optimize_pose_graph)(prob, lc.cfg.pg)[0]
        same.append(("essential graph", rec["kid"], torch.equal(again, out)))
        for i, (p, st, _) in enumerate(rec.get("gba", {}).get("solves", [])):
            st2 = run_lm(p, cam, gcfg.lm)
            same.append((f"global BA solve {i + 1}", rec["kid"], all(torch.equal(a, b) for a, b in zip(st, st2))))
    print(f"loop: the closures' problems solved again on the card: {same}", flush=True)
    if not all(x for _, _, x in same):
        fail("loop: a closure's problem solved again on the card gives another result")
    prob, _ = lc.closures[-1]["pg"]
    graph = optimize_pose_graph_sim3 if lc.mono else optimize_pose_graph
    _, (busy_us, n_kernels, n_copies) = profiled(lambda: graph(prob, lc.cfg.pg), whole=False)
    print(
        f"loop: one essential-graph solve ({tuple(prob.poses.shape[:1]) + tuple(prob.e_i.shape)} poses and edges padded, "
        f"{lc.cfg.pg.max_iters} iterations) under torch.profiler: device busy {busy_us / 1e3:.3f} ms, {n_kernels} kernel "
        f"launches, {n_copies} memcpy/memset on {card}",
        flush=True,
    )
    solves = lc.closures[-1].get("gba", {}).get("solves", [])
    if solves:
        p = solves[0][0]
        _, (busy_us, n_kernels, n_copies) = profiled(lambda: run_lm(p, cam, gcfg.lm), whole=False)
        print(
            f"loop: one global BA solve (rung {lc.closures[-1]['gba']['rung']}, {gcfg.lm.max_iters} LM iterations) under "
            f"torch.profiler: device busy {busy_us / 1e3:.3f} ms, {n_kernels} kernel launches, {n_copies} memcpy/memset on {card}",
            flush=True,
        )
    calls, device = launches
    want_lpc = launches_per_call()
    n_frames = len(frames)
    for name in PER_FRAME:
        print(f"loop: {name} calls {calls[name]} ({calls[name] / n_frames:.2f} per frame), device launches {device[name]}", flush=True)
        if calls[name] == 0:
            fail(f"loop: {name} was not launched on the loop path")
        if device[name] != calls[name] * want_lpc[name]:
            fail(f"loop: {name}: {device[name]} device launches for {calls[name]} calls, expected {want_lpc[name]} per call")
    return launches


def mono_system(cam, points: bool, pipelined: bool = False):
    """System(cam, sensor="mono") with its defaults (mapping and loop closing
    on) and benchmarks/ladder.py's mono tracker settings, hybrid or lines
    only, pipelined (the classic pipeline, lines only) or not."""
    from tpuslam_torch.frontend.points import PointFrontendParams
    from tpuslam_torch.frontend.tracking import TrackerConfig
    from tpuslam_torch.system import System

    cfg = TrackerConfig(**MONO_TRACKER, points=PointFrontendParams() if points else None, pipelined=pipelined)
    return System(cam, sensor="mono", tracker_cfg=cfg, device="cuda")


def sim3_ate(trajectory, scene) -> float:
    """Sim(3)-aligned ATE RMSE (m) of the OK frames' camera centres (mono:
    the scale is free)."""
    import numpy as np

    from tpuslam_torch.eval.ate import absolute_trajectory_error

    ok = [r for r in trajectory if r.state.name == "OK"]
    est = np.stack([np.linalg.inv(r.T_cw)[:3, 3] for r in ok])
    gt = np.stack([np.linalg.inv(scene.poses[r.frame_idx])[:3, 3] for r in ok])
    return float(absolute_trajectory_error(est, gt, with_scale=True).rmse)


def check_mono_launches(tag: str, launches, per_extraction: dict, n_extractions: int) -> None:
    calls, device = launches
    want_lpc = launches_per_call()
    for name, per in per_extraction.items():
        want = per * n_extractions
        print(f"{tag}: {name} calls {calls[name]} (expected {want}), device launches {device[name]}", flush=True)
        if calls[name] != want:
            fail(f"{tag}: {name}: {calls[name]} calls, expected {per} per frame")
        if device[name] != calls[name] * want_lpc[name]:
            fail(f"{tag}: {name}: {device[name]} device launches for {calls[name]} calls, expected {want_lpc[name]} per call")


def seeded_draws(k: int):
    """The initializer's RANSAC draws from a generator on the card seeded
    with frame_idx + 1000 k (k = 0: the draws it makes by default)."""
    import torch

    def draw(frame_idx, n_rows, n_hypotheses):
        g = torch.Generator(device="cuda")
        g.manual_seed(frame_idx + 1000 * k)
        rows = torch.ones(n_rows, device="cuda")
        return torch.multinomial(rows, n_hypotheses * 8, replacement=True, generator=g).reshape(n_hypotheses, 8)

    return draw


def mono_run(cam, frames, points: bool, sampler=None, pipelined: bool = False):
    """One mono System over the frames, the launch counts set to 0 just
    before and read just after; each frame and each of the initializer's
    attempts timed. Returns (system, launches)."""
    import torch

    from tpuslam_torch.frontend.initializer import MonoInitializer

    sys_ = mono_system(cam, points, pipelined)
    sys_.timer.warmup = 0  # keep every keyframe event's stage times
    init = sys_.tracker.mono_init = MonoInitializer(cam, sampler=sampler)
    attempts = []
    inner = init.try_initialize

    def timed(*a, **k):
        t = time.perf_counter()
        out = inner(*a, **k)
        torch.cuda.synchronize()
        attempts.append((time.perf_counter() - t, out is not None))
        return out

    init.try_initialize = timed
    reset_launches()
    frame_s = []
    for f, img in enumerate(frames):
        t = time.perf_counter()
        sys_.track_monocular(img, f * 0.05)
        torch.cuda.synchronize()
        frame_s.append(time.perf_counter() - t)
    launches = read_launches()
    sys_.shutdown()
    sys_.frame_s, sys_.init_attempts = frame_s, attempts
    return sys_, launches


MONO_DRAW_SLOTS = 5  # phase 10's lines-only draws run in child processes, this many at a time


def mono_draw_child() -> int:
    """One of phase 10's lines-only RANSAC draws in a process of its own:
    sys.argv[1] is the draw k (seeded_draws); the loop warm-up is off there
    (the mono sequence closes no loop, and in a fresh process its set-up
    costs seconds). Prints the Sim(3) ATE (infinite when the System never
    initialized) as the last line."""
    k = int(sys.argv[1])
    os.environ["TPUSLAM_WARM_LOOP"] = "0"
    cam, scene, frames = make_mono_frames()
    other, _ = mono_run(cam, frames, False, sampler=seeded_draws(k))
    st = [r.state.name for r in other.trajectory]
    print(json.dumps({"ate": sim3_ate(other.trajectory, scene) if "OK" in st else float("inf")}), flush=True)
    return 0


def mono_draws(ks) -> list:
    """The Sim(3) ATEs of phase 10's lines-only draws ``ks``, each in a
    process of its own (mono_draw_child), MONO_DRAW_SLOTS at a time on the
    one card: the synchronous mono System's result does not depend on its
    timing. A child that fails fails the phase."""
    ks = list(ks)
    done = run_children("mono_draw_child", [str(k) for k in ks], MONO_DRAW_SLOTS, BENCH100_CHILD_S)
    ates = []
    for k, proc in zip(ks, done):
        if proc.returncode != 0:
            print(proc.stdout[-2000:], proc.stderr[-4000:], flush=True)
            fail(f"mono lines draw {k}: its process ended with code {proc.returncode}")
        ates.append(float(json.loads(proc.stdout.strip().splitlines()[-1])["ate"]))
    return ates


def run_children(entry: str, args, slots: int, timeout_s: float) -> list:
    """``python -c "import chip_smoke; chip_smoke.<entry>()" arg`` for each of
    ``args``, ``slots`` at a time; their CompletedProcess (text) in order. A
    child past ``timeout_s`` is killed and reported with code -9."""
    from concurrent.futures import ThreadPoolExecutor

    code = f"import sys, chip_smoke; sys.exit(chip_smoke.{entry}())"

    def run(arg):
        try:
            return subprocess.run([sys.executable, "-c", code, arg], cwd=REPO, capture_output=True, text=True, timeout=timeout_s)
        except subprocess.TimeoutExpired as e:  # subprocess.run has killed the child
            out = e.stdout.decode() if isinstance(e.stdout, bytes) else e.stdout or ""
            return subprocess.CompletedProcess(e.cmd, -9, out, f"stopped after {timeout_s} s")

    with ThreadPoolExecutor(slots) as pool:
        return list(pool.map(run, args))


def mono_phase(card):
    """Phase 10: the mono sequence at VGA through System(cam, sensor="mono"),
    hybrid and lines only, and the hybrid run again (bit-equal). Returns the
    launches of the hybrid run and of the lines-only run, and the lines-only
    System of the first draws."""
    import numpy as np
    import torch

    from tpuslam_torch.frontend.frame import extract_features
    from tpuslam_torch.frontend.initializer import MonoInitializer
    from tpuslam_torch.frontend.points import PointFrontendParams, extract_points

    cam, scene, frames = make_mono_frames()
    out = {}
    for points, jax_first, jax_ate in (
        (True, JAX_MONO_HYBRID_FIRST_OK, JAX_MONO_HYBRID_ATE_M),
        (False, JAX_MONO_LINES_FIRST_OK, JAX_MONO_LINES_ATE_M),
    ):
        tag = "mono hybrid" if points else "mono lines"
        sys_, launches = mono_run(cam, frames, points)
        traj = sys_.trajectory
        states = [r.state.name for r in traj]
        kfs = [r.frame_idx for r in traj if r.made_keyframe]
        first = states.index("OK") if "OK" in states else len(states)
        ate = sim3_ate(traj, scene) if first < len(states) else float("inf")
        bound = jax_ate * MONO_ATE_FACTOR + ATE_MARGIN_M
        pst = sys_.map.points
        live = pst.live_ids()
        n_multi = int((pst.n_obs[live] >= 2).sum())
        print(f"{tag}: states {states}", flush=True)
        print(
            f"{tag}: first OK frame {first} (JAX package {jax_first}), keyframes {kfs}, live lines "
            f"{len(sys_.map.lines.live_ids())}, live points {len(live)}, seen from 2+ keyframes {n_multi}; Sim(3) ATE {ate:.5f} m "
            f"(JAX package {jax_ate} m)",
            flush=True,
        )
        if first > jax_first + 2:
            fail(f"{tag}: initialized at frame {first}, later than the JAX package's {jax_first} + 2")
        if any(st != "OK" for st in states[first:]):
            fail(f"{tag}: a frame after initialization did not track OK")
        if len(sys_.map.keyframes) < 3:
            fail(f"{tag}: only {len(sys_.map.keyframes)} keyframes")
        if not points:
            # the median over MONO_DRAWS draws (k = 0 is this run)
            ates = [ate] + mono_draws(range(1, MONO_DRAWS))
            ate, jax_ate = statistics.median(ates), statistics.median(JAX_MONO_LINES_DRAW_ATES_M)
            bound = jax_ate * MONO_ATE_FACTOR + ATE_MARGIN_M
            print(
                f"{tag}: Sim(3) ATE over {MONO_DRAWS} RANSAC draws {', '.join(f'{a:.5f}' for a in ates)} m: median {ate:.5f} m, "
                f"bound {bound:.5f} m (the JAX package's median {jax_ate} m x {MONO_ATE_FACTOR} + {ATE_MARGIN_M} m)",
                flush=True,
            )
        else:
            print(f"{tag}: Sim(3) ATE bound {bound:.5f} m (JAX package {jax_ate} m x {MONO_ATE_FACTOR} + {ATE_MARGIN_M} m)", flush=True)
        if not ate <= bound:
            fail(f"{tag}: Sim(3) ATE {ate} m above {bound} m")
        if points and n_multi < 10:
            fail(f"{tag}: {n_multi} point landmarks seen from two keyframes, fewer than 10")
        check_mono_launches(tag, launches, PER_EXTRACTION_HYBRID if points else PER_EXTRACTION, len(frames))
        frame_s = sys_.frame_s
        kf_s = [dt for r, dt in zip(traj, frame_s) if r.made_keyframe and r.frame_idx > first]
        other_s = [dt for r, dt in zip(traj, frame_s) if not r.made_keyframe and r.frame_idx > first]
        tri = sys_.timer.times.get("mp.triangulate", [])
        init_s = [dt for dt, ok in sys_.init_attempts if ok]
        print(
            f"{tag}: frames after initialization: median {statistics.median(frame_s[first + 1:]) * 1e3:.2f} ms/frame; keyframe "
            f"frames {len(kf_s)} median {statistics.median(kf_s) * 1e3:.2f} ms, other frames median "
            f"{statistics.median(other_s) * 1e3:.2f} ms; mp.triangulate median {statistics.median(tri) * 1e3:.2f} ms per keyframe "
            f"event ({len(tri)} events); the initializer's successful attempt {init_s[0] * 1e3:.2f} ms, its "
            f"{len(sys_.init_attempts) - 1} earlier attempts {sum(dt for dt, _ in sys_.init_attempts[:-1]) * 1e3:.2f} ms in all; "
            f"local mapping median {statistics.median(sys_.timer.times['local_mapping']) * 1e3:.2f} ms, loop closing median "
            f"{statistics.median(sys_.timer.times['loop_closing']) * 1e3:.2f} ms on {card}",
            flush=True,
        )
        out[points] = (sys_, launches)

    # the hybrid run again: the card repeats it (the RANSAC draws from a seeded generator)
    hyb = out[True][0]
    again, _ = mono_run(cam, frames, True)
    kfs = [[r.frame_idx for r in t if r.made_keyframe] for t in (hyb.trajectory, again.trajectory)]
    same = len(hyb.trajectory) == len(again.trajectory) and all(
        np.array_equal(a.T_cw, b.T_cw) for a, b in zip(hyb.trajectory, again.trajectory)
    )
    print(f"mono hybrid repeat: keyframes {kfs[0]} then {kfs[1]}; poses bit-equal: {same}", flush=True)
    if kfs[0] != kfs[1] or not same:
        fail("mono: a second hybrid run differs from the first")

    # the host syncs of one initialization attempt (the one that succeeded in the hybrid run)
    first = [r.state.name for r in hyb.trajectory].index("OK")
    init = MonoInitializer(cam)
    pp = PointFrontendParams()

    def features(f):
        img = torch.from_numpy(frames[f]).cuda().to(torch.float32) / 255.0
        return extract_features(img), extract_points(img, pp)

    f0, p0 = features(0)
    fk, pk = features(first)
    init.try_initialize(f0, 0.0, 0, aux=p0)
    torch.cuda.synchronize()
    result = []

    def attempt():
        t = time.perf_counter()
        result.append(init.try_initialize(fk, first * 0.05, first, aux=pk))
        torch.cuda.synchronize()
        result.append(time.perf_counter() - t)

    sites = count_syncs(attempt)
    print(
        f"mono: one initialization attempt (frame 0 with frame {first}, initialized: {result[0] is not None}, the solvers "
        f"warm): {result[1] * 1e3:.2f} ms, {len(sites)} host syncs at {sorted(set(sites))} on {card}",
        flush=True,
    )

    # one steady frame of a fresh hybrid System under torch.profiler
    sys_ = mono_system(cam, True)
    for f in range(first + 3):
        sys_.track_monocular(frames[f], f * 0.05)
    todo = iter(range(first + 3, len(frames)))
    walls = []

    def run():
        f = next(todo)
        t = time.perf_counter()
        sys_.track_monocular(frames[f], f * 0.05)
        torch.cuda.synchronize()
        walls.append((f, time.perf_counter() - t))

    _, (busy_us, n_kernels, n_copies) = profiled(run, whole=False)
    f, wall = walls[-1]
    r = sys_.trajectory[f]
    print(
        f"mono hybrid profile: frame {f} ({r.state.name}, keyframe {r.made_keyframe}): device busy {busy_us / 1e3:.3f} ms, "
        f"{n_kernels} kernel launches, {n_copies} memcpy/memset, {wall * 1e3:.2f} ms under the profiler (device idle "
        f"{1 - busy_us / 1e6 / wall:.1%}) on {card}",
        flush=True,
    )
    sys_.shutdown()
    return out[True][1], out[False][1], out[False][0]


def mono_loop_phase(card):
    """Phase 11: the mono loop through System(cam, sensor="mono") with hybrid
    points and loop closing on its Sim(3) branch, the launch counts set to 0
    just before and read just after. Returns the launches."""
    import torch

    cam, scene, frames = make_mono_loop_frames()
    sys_ = mono_system(cam, True)
    sys_.timer.warmup = 0
    lc = sys_.loop_closer
    if not lc.mono:
        fail("mono loop: the loop closer is not on its Sim(3) branch")
    closures = []
    inner = lc._close

    def close(kf, cand, ev=None):
        pre = kf_map_ate(sys_.map, scene, with_scale=True)
        ok = inner(kf, cand, ev)
        if ok:
            closures.append((kf.kid, kf.frame_idx, cand, pre, kf_map_ate(sys_.map, scene, with_scale=True)))
        return ok

    lc._close = close
    reset_launches()
    frame_s = []
    for f, img in enumerate(frames):
        t = time.perf_counter()
        sys_.track_monocular(img, f * 0.05)
        torch.cuda.synchronize()
        frame_s.append(time.perf_counter() - t)
    launches = read_launches()
    sys_.shutdown()

    traj = sys_.trajectory
    ok = [r for r in traj if r.state.name == "OK"]
    final = kf_map_ate(sys_.map, scene, with_scale=True)
    bound = JAX_MONO_LOOP_KF_ATE_M * MONO_ATE_FACTOR + ATE_MARGIN_M
    print(
        f"mono loop: {len(frames)} frames, OK {len(ok)} (JAX package {JAX_MONO_LOOP_OK_FRAMES}), keyframes "
        f"{len(sys_.map.keyframes)}, loops closed {lc.closed_loops}, gba_skipped {lc.gba_skipped}; frame Sim(3) ATE "
        f"{sim3_ate(traj, scene):.5f} m, final keyframe-map Sim(3) ATE {final:.5f} m, bound {bound:.5f} m (JAX package "
        f"{JAX_MONO_LOOP_KF_ATE_M} m x {MONO_ATE_FACTOR} + {ATE_MARGIN_M} m)",
        flush=True,
    )
    print(f"mono loop: frames 1-{len(frames) - 1}: median {statistics.median(frame_s[1:]) * 1e3:.2f} ms/frame on {card}", flush=True)
    done = [ev for ev in lc.timings if ev["closed"]]
    for (kid, frame, cand, pre, post), ev in zip(closures, done):
        print(
            f"mono loop: closure of keyframe {kid} (frame {frame}) to keyframe {cand}: scale s {ev['scale']:.4f}, keyframe-map "
            f"Sim(3) ATE {pre:.5f} -> {post:.5f} m; detect {ev['detect_ms']:.2f} + compute_sim3 {ev['compute_se3_ms']:.2f} + "
            f"essential graph {ev['essential_graph_ms']:.2f} + correction {ev['correction_ms']:.2f} + global BA "
            f"{ev.get('global_ba_ms', float('nan')):.2f} ms on {card}",
            flush=True,
        )
    for ev in lc.timings:
        if "scale" in ev and not ev["closed"]:
            print(f"mono loop: closure attempt at keyframe {ev['kid']} not taken (scale s {ev['scale']:.4f})", flush=True)
    if len(ok) < JAX_MONO_LOOP_OK_FRAMES - 2:
        fail(f"mono loop: {len(ok)} OK frames, fewer than the JAX package's {JAX_MONO_LOOP_OK_FRAMES} - 2")
    if not closures:
        fail("mono loop: no loop was closed through the Sim(3) branch")
    if not final <= bound:
        fail(f"mono loop: final keyframe-map Sim(3) ATE {final} m above {bound} m")
    calls, device = launches
    want_lpc = launches_per_call()
    for name in PER_FRAME:
        print(f"mono loop: {name} calls {calls[name]} ({calls[name] / len(frames):.2f} per frame), device launches {device[name]}", flush=True)
        if calls[name] == 0:
            fail(f"mono loop: {name} was not launched")
        if device[name] != calls[name] * want_lpc[name]:
            fail(f"mono loop: {name}: {device[name]} device launches for {calls[name]} calls, expected {want_lpc[name]} per call")
    return launches


# ---- the pipelined forms and the front end's other branches (phases 12-19) ----


def form_system(cam, tcfg, mcfg=None, mapping: bool = True, sensor: str = "stereo"):
    from tpuslam_torch.system import System

    return System(cam, sensor=sensor, mapping=mapping, loop_closing=False, tracker_cfg=tcfg, mapper_cfg=mcfg, device="cuda")


def feed_frames(sys_, frames, lo: int, hi: int):
    for f in range(lo, hi):
        if sys_.sensor == "mono":
            sys_.track_monocular(frames[f], f * 0.05)
        else:
            sys_.track_stereo(*frames[f], f * 0.05)


def form_run(sys_, frames):
    """The frames through the System, then its flush, with the launch counts
    set to 0 just before and read just after. Returns (launches, seconds per
    call, seconds from frame 1 through the flush)."""
    import torch

    reset_launches()
    call_s = []
    t1 = None
    for f in range(len(frames)):
        if f == 1:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
        t = time.perf_counter()
        feed_frames(sys_, frames, f, f + 1)
        call_s.append(time.perf_counter() - t)
    sys_.shutdown()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    return read_launches(), call_s, wall


def check_form_launches(tag, launches, per_extraction: dict, n_images: int) -> None:
    """Each kernel's calls equal to its count per image extraction times the
    images extracted (in the programs and on the synchronous path), each
    call its launches; none left out."""
    calls, device = launches
    want_lpc = launches_per_call()
    for name, per in per_extraction.items():
        want = per * n_images
        print(f"{tag}: {name} calls {calls[name]} (expected {per} x {n_images} image extractions), device launches {device[name]}", flush=True)
        if calls[name] != want or calls[name] == 0:
            fail(f"{tag}: {name}: {calls[name]} calls, expected {want}")
        if device[name] != want * want_lpc[name]:
            fail(f"{tag}: {name}: {device[name]} device launches, expected {want_lpc[name]} per call")


def form_profile(tag, make_system, frames, card, warm: int, per: int, unit: str) -> dict:
    """A fresh System fed ``warm`` frames; the host syncs of the next ``per``
    calls (one steady frame or chunk) and torch.profiler over the ``per``
    calls after them: device busy ms and kernel launches per frame. The
    frames each window resolved, and their keyframes (a keyframe runs the
    mapper), are printed."""
    import torch

    sys_ = make_system()
    feed_frames(sys_, frames, 0, warm)
    torch.cuda.synchronize()
    f = warm

    def window(run):
        n0 = len(sys_.trajectory)
        out = run()
        done = sys_.trajectory[n0:]
        return out, [r.frame_idx for r in done], [r.frame_idx for r in done if r.made_keyframe]

    syncs, sync_frames, sync_kfs = window(lambda: count_syncs(lambda: feed_frames(sys_, frames, f, f + per)))
    f += per
    walls = []

    def run():
        nonlocal f
        if f + per > len(frames):
            fail(f"{tag} profile: out of frames")
        t = time.perf_counter()
        feed_frames(sys_, frames, f, f + per)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        f += per

    (_, (busy_us, n_kernels, n_copies)), prof_frames, prof_kfs = window(lambda: profiled(run, tries=3, whole=False))
    sys_.shutdown()
    out = dict(syncs_per_frame=len(syncs) / per, busy_ms_per_frame=busy_us / 1e3 / per, launches_per_frame=n_kernels / per)
    print(
        f"{tag} profile: one steady {unit} ({per} frame{'s' if per > 1 else ''}, resolving frames {sync_frames}, keyframes "
        f"{sync_kfs}): {len(syncs)} host syncs at {sorted(set(syncs))} ({out['syncs_per_frame']:.2f} per frame); the next "
        f"(resolving frames {prof_frames}, keyframes {prof_kfs}): device busy {busy_us / 1e3:.3f} ms, {n_kernels} kernel "
        f"launches, {n_copies} memcpy/memset ({out['busy_ms_per_frame']:.3f} ms and {out['launches_per_frame']:.0f} launches per "
        f"frame), {walls[-1] * 1e3:.2f} ms under the profiler (device idle {1 - busy_us / 1e6 / walls[-1]:.1%}) on {card}",
        flush=True,
    )
    return out


def report_rate(tag, call_s, wall, n_frames, card) -> None:
    n = n_frames - 1
    print(
        f"{tag}: frames 1-{n_frames - 1} and the flush: {wall * 1e3:.1f} ms = {n / wall:.2f} frames/s "
        f"({wall * 1e3 / n:.2f} ms/frame); calls median {statistics.median(call_s[1:]) * 1e3:.2f} ms, max "
        f"{max(call_s[1:]) * 1e3:.2f} ms on {card}",
        flush=True,
    )


def stereo_form_phase(tag, cam, scene, frames, card, tcfg, mcfg, jax_ate, per_extraction, program_cams: int,
                      sync_cams: int, per: int, unit: str, mapping: bool = True, warm: int = 20):
    """One pipelined stereo form over the frames (the launch counts around
    the run): one trajectory entry per frame in order, every frame OK, the
    ATE within the JAX package's x 1.05 + 0.01 m, the kernel calls per image
    extraction; frames/s, and one steady frame's or chunk's host syncs,
    device busy ms and launches. Returns (system, launches)."""
    sys_ = form_system(cam, tcfg, mcfg, mapping=mapping)
    launches, call_s, wall = form_run(sys_, frames)
    tr, traj = sys_.tracker, sys_.trajectory
    states = [r.state.name for r in traj]
    kfs = [r.frame_idx for r in traj if r.made_keyframe]
    ate = ate_of(traj, scene)
    bound = jax_ate * PIPELINED_ATE_FACTOR + ATE_MARGIN_M
    print(
        f"{tag}: program frames {tr.anchor_frames} (again at the flush {tr.flush_frames}), synchronous frames "
        f"{tr.sync_frames}, lagged frames {tr.lagged_frames}, "
        f"fallbacks {tr.fallback_frames}; keyframes at frames {kfs}; states {states}",
        flush=True,
    )
    print(
        f"{tag}: ATE {ate:.5f} m, bound {bound:.5f} m (JAX package {jax_ate} m x {PIPELINED_ATE_FACTOR} + {ATE_MARGIN_M} m) "
        f"on {card}",
        flush=True,
    )
    if [r.frame_idx for r in traj] != list(range(len(frames))):
        fail(f"{tag}: trajectory frames {[r.frame_idx for r in traj]}, expected one entry per frame in order")
    if any(st != "OK" for st in states):
        fail(f"{tag}: a frame did not track OK")
    if not ate <= bound:
        fail(f"{tag}: ATE {ate} m above {bound} m")
    n_images = (len(tr.anchor_frames) + len(tr.flush_frames)) * program_cams + tr.n_sync_extractions * sync_cams
    check_form_launches(tag, launches, per_extraction, n_images)
    report_rate(tag, call_s, wall, len(frames), card)
    sys_.profile = form_profile(tag, lambda: form_system(cam, tcfg, mcfg, mapping=mapping), frames, card, warm, per, unit)
    sys_.n_images = n_images
    return sys_, launches


def same_run(tag, a, b) -> None:
    import numpy as np

    kfs = [[r.frame_idx for r in t if r.made_keyframe] for t in (a, b)]
    same = [r.frame_idx for r in a] == [r.frame_idx for r in b] and all(np.array_equal(x.T_cw, y.T_cw) for x, y in zip(a, b))
    print(f"{tag} repeat: keyframes {kfs[0]} then {kfs[1]}; poses bit-equal: {same}", flush=True)
    if kfs[0] != kfs[1] or not same:
        fail(f"{tag}: a second run differs from the first")


def pipelined_phases(card, cam, scene, frames, slice_sys):
    """Phases 12-17: the JAX bench's other switches and the classic
    pipeline over the bench frames. Returns {tag: (launches, system)}."""
    import numpy as np

    from tpuslam_torch.frontend.tracking import TrackerConfig
    from tpuslam_torch.system import bench_configs

    out = {}
    per_hostscale = {**PER_EXTRACTION, "blur": 2}  # the resize's prefilter and the pyramid's blur
    for tag, switches, jax_ate, per_ext, cams, per, unit, warm in (
        # a chunk's calls: frames 25-30 dispatch the chunk of 25-30 and resolve 19-24
        ("fullchunk", dict(semidirect=False), JAX_FULLCHUNK_ATE_M, PER_EXTRACTION, (1, 1), BENCH_C, "chunk", 25),
        ("frame", dict(chunk=1), JAX_FRAME_ATE_M, PER_EXTRACTION, (1, 1), 1, "frame", 20),
        ("descriptor frame", dict(chunk=1, direct=False), JAX_DESCRIPTOR_FRAME_ATE_M, PER_EXTRACTION, (2, 2), 1, "frame", 20),
        ("hostscale", dict(hostscale=False), JAX_HOSTSCALE_ATE_M, per_hostscale, (1, 1), BENCH_C, "chunk", 25),
    ):
        tcfg, mcfg = bench_configs(**switches)
        sys_, launches = stereo_form_phase(tag, cam, scene, frames, card, tcfg, mcfg, jax_ate, per_ext, *cams, per, unit, warm=warm)
        out[tag] = (launches, sys_)
        if tag == "frame":  # the single-frame direct program again: the card repeats it
            again = form_system(cam, tcfg, mcfg)
            feed_frames(again, frames, 0, len(frames))
            again.shutdown()
            same_run(tag, sys_.trajectory, again.trajectory)
    _, dot_scene_, dot_frames = make_frames(draw_points=True)
    tcfg, mcfg = bench_configs(chunk=1, points=True)
    sys_, launches = stereo_form_phase(
        "hybrid frame", cam, dot_scene_, dot_frames, card, tcfg, mcfg, JAX_HYBRID_FRAME_ATE_M, PER_EXTRACTION_HYBRID, 1, 1, 1, "frame"
    )
    out["hybrid frame"] = (launches, sys_)

    # the classic pipeline: without mapping bit-equal to the synchronous
    # slice up to the slice's first fallback (where it goes LOST instead)
    classic = TrackerConfig(pipelined=True, fused=False)
    sys_, launches = stereo_form_phase(
        "classic", cam, scene, frames, card, classic, None, JAX_ATE_M, PER_EXTRACTION, 0, 2, 1, "frame", mapping=False
    )
    first = min(slice_sys.tracker.fallback_frames, default=len(frames))
    a, b = slice_sys.trajectory[:first], sys_.trajectory[:first]
    same = all(np.array_equal(x.T_cw, y.T_cw) and x.made_keyframe == y.made_keyframe for x, y in zip(a, b))
    print(
        f"classic: the slice's first fallback at frame {first if first < len(frames) else 'none'}; poses and keyframes of frames "
        f"0-{first - 1} bit-equal to the slice's: {same}; lagged frames {len(sys_.tracker.lagged_frames)}",
        flush=True,
    )
    if not same or len(a) != first:
        fail("classic: the classic pipeline without mapping differs from the synchronous slice before a fallback")
    out["classic"] = (launches, sys_)
    sys_, launches = stereo_form_phase(
        "classic mapping", cam, scene, frames, card, classic, None, JAX_CLASSIC_MAPPING_ATE_M, PER_EXTRACTION, 0, 2, 1, "frame"
    )
    out["classic mapping"] = (launches, sys_)
    return out


def pipelined_mono_phase(card, sync_sys):
    """Phase 18: pipelined lines-only mono (the classic pipeline) over the
    mono sequence with the first RANSAC draws: every frame after
    initialization OK and through the pipeline, the kernel calls per frame,
    and its poses and keyframes bit-equal to phase 10's synchronous
    lines-only run (``sync_sys``, the same draws) up to that run's first
    fallback: the classic pipeline computes what the synchronous path
    computes until then, and phase 10 holds the Sim(3) ATE by its median
    over the draws. Returns the launches."""
    import numpy as np

    cam, scene, frames = make_mono_frames()
    tag = "pipelined mono lines"
    sys_, launches = mono_run(cam, frames, False, pipelined=True)
    traj = sys_.trajectory
    states = [r.state.name for r in traj]
    first = states.index("OK") if "OK" in states else len(states)
    tr = sys_.tracker
    ate = sim3_ate(traj, scene) if first < len(states) else float("inf")
    print(
        f"{tag}: states {states}; keyframes {[r.frame_idx for r in traj if r.made_keyframe]}; lagged frames "
        f"{tr.lagged_frames}; Sim(3) ATE {ate:.5f} m (phase 10's synchronous run: {sim3_ate(sync_sys.trajectory, scene):.5f} m)",
        flush=True,
    )
    if [r.frame_idx for r in traj] != list(range(len(frames))):
        fail(f"{tag}: trajectory frames {[r.frame_idx for r in traj]}, expected one entry per frame in order")
    if first == len(states) or any(st != "OK" for st in states[first:]):
        fail(f"{tag}: not every frame after initialization tracked OK")
    if tr.lagged_frames != list(range(first + 1, len(frames))):
        fail(f"{tag}: the frames after initialization did not all go through the classic pipeline")
    upto = min(sync_sys.tracker.fallback_frames, default=len(frames))
    a, b = sync_sys.trajectory[:upto], traj[:upto]
    same = len(a) == upto and all(
        np.array_equal(x.T_cw, y.T_cw) and x.made_keyframe == y.made_keyframe and x.state == y.state for x, y in zip(a, b)
    )
    print(
        f"{tag}: phase 10's first fallback at frame {upto if upto < len(frames) else 'none'}; states, poses and keyframes of "
        f"frames 0-{upto - 1} bit-equal to its synchronous run's: {same}",
        flush=True,
    )
    if not same:
        fail(f"{tag}: the classic pipeline differs from the synchronous run before a fallback")
    check_mono_launches(tag, launches, PER_EXTRACTION, len(frames))
    fs = sys_.frame_s[first + 1:]
    print(
        f"{tag}: frames after initialization: median {statistics.median(fs) * 1e3:.2f} ms/frame = "
        f"{len(fs) / sum(fs):.2f} frames/s on {card}",
        flush=True,
    )
    form_profile(tag, lambda: mono_system(cam, False, pipelined=True), frames, card, first + 3, 1, "frame")
    return launches


def radtan_phase(card):
    """Phase 19: radtan. extract_features on a distorted VGA frame on the
    card: its undistortion within 1e-3 px of the CPU's on the same
    detections, its segments as sets against the CPU port's (95% within 0.5
    px: kernels and plain versions round differently, and the detector's
    thresholds see it), the median endpoint distance to the true lines
    below 2 px; then the
    synchronous descriptor-stereo tracker over RADTAN_FRAMES distorted pairs
    within the JAX package's ATE x 1.05 + 0.01 m. Returns its launches."""
    import numpy as np
    import torch

    from tpuslam_torch.frontend.frame import FrontendParams, _undistort_feature_geometry, extract_features
    from tpuslam_torch.frontend.tracking import TrackerConfig
    from tpuslam_torch.geometry.camera import Distortion
    from tpuslam_torch.io.synthetic import observe_frame

    cam, dist, scene, frames = make_radtan_frames()
    fe = FrontendParams(dist=Distortion(**dist), cam=cam)
    img = torch.from_numpy(frames[0][0]).to(torch.float32) / 255.0
    gpu, cpu = extract_features(img.cuda(), fe), extract_features(img, fe)
    # the undistortion: the CPU's of the card's own detections
    raw = extract_features(img.cuda(), fe._replace(dist=Distortion(), cam=None))
    ref = _undistort_feature_geometry(type(raw)(*(x.cpu() for x in raw)), cam, fe.dist)
    und = float((gpu.endpoints.cpu() - ref.endpoints).abs().max())
    ep_g = gpu.endpoints.cpu().numpy()[gpu.valid.cpu().numpy() > 0.5]
    ep_c = cpu.endpoints.numpy()[cpu.valid.numpy() > 0.5]
    d0 = np.abs(ep_g[:, None] - ep_c[None]).max(axis=(-1, -2))
    d1 = np.abs(ep_g[:, None] - ep_c[None, :, ::-1]).max(axis=(-1, -2))
    best = np.minimum(d0, d1).min(axis=1)
    matched = best < 0.5
    obs = observe_frame(scene, 0)
    med = float(np.median(line_errors(ep_g, np.ones(len(ep_g)), obs.seg_uv[obs.seg_visible])))
    finite = bool(np.isfinite(gpu.endpoints.cpu().numpy()).all())
    print(
        f"radtan extract: the card's undistortion of its detections within {und:.2e} px of the CPU's (bound 1e-3); "
        f"{len(ep_g)} segments on the card, {len(ep_c)} on the CPU, {matched.mean():.1%} of the card's within 0.5 px of one "
        f"of the CPU's (the largest of those {best[matched].max(initial=0.0):.2e} px); median endpoint-to-true-line "
        f"{med:.4f} px (bound {RADTAN_LINE_ERR_PX} px); padding finite {finite} on {card}",
        flush=True,
    )
    if und > 1e-3 or matched.mean() < 0.95 or abs(len(ep_g) - len(ep_c)) > 0.05 * len(ep_c):
        fail("radtan: the card's undistorted segments differ from the CPU port's")
    if not med < RADTAN_LINE_ERR_PX or not finite:
        fail(f"radtan: median endpoint-to-true-line {med} px (bound {RADTAN_LINE_ERR_PX} px), padding finite {finite}")
    sys_, launches = stereo_form_phase(
        "radtan", cam, scene, frames, card, TrackerConfig(frontend=fe), None, JAX_RADTAN_ATE_M, PER_EXTRACTION, 0, 2, 1, "frame",
        mapping=False, warm=12,
    )
    return launches


# ---- BASELINE config #5: batched multi-sequence tracking and BA (phase 20) ----

# the batched kernels' calls per batched stereo frame: both cameras' batched
# extraction (the pyramid's blur per camera batch; per camera batch and
# level the LBD gradients, the front, the propagation and the three sums)
PER_MULTI_FRAME = {f"{name}_batch": per for name, per in PER_FRAME.items()}
MULTI_SCALING = (1, 2, 8)  # sequences per batch in the scaling run
MULTI_WARM, MULTI_TIMED = 4, 3  # frames before the timed ones, timed (and profiled) frames


def batch_kernel_phase(imgs, card) -> dict:
    """Phase 20a: each batched kernel on N images of one shape (the N
    sequences' first left frames, at 480x640 and the pyramid level 384x512)
    in one call, bit for bit N single-image calls and within its tolerance
    of the plain version (the single plain version per image); its device
    launches per call (torch.profiler: the single call's), device time per
    call in turns with N single calls, bound (N images' bytes or
    operations), plain time and the library call. Then the batched
    extraction bit-equal to N single extractions (every field, both levels
    inside). Returns {name: kernels-line fields} at 480x640."""
    import torch
    import torch.nn.functional as F

    from tpuslam_torch.frontend.frame import FrontendParams, extract_features
    from tpuslam_torch.kernels import image, lsd

    params = lsd.LSDParams()
    R, sigma = params.ccl_rounds, params.prefilter_sigma
    ntaps = image._blur_taps(sigma).numel()
    psig = 0.6 / 0.8  # the pyramid's blur
    N = imgs.shape[0]
    res = {}
    for level in (imgs, image.build_pyramid(imgs, 2, 0.8)[1].contiguous()):
        _, H, W = level.shape
        planes = lsd.ccl_inputs_batch(level, params)
        _, sup, lab0, mx0, cb = planes
        n_bits = int(sum(((cb >> d) & 1).sum() for d in range(8)))
        n_support = int(sup.sum())
        ptaps = image._blur_taps(psig).cuda()
        r = ptaps.numel() // 2
        padded = F.pad(level[:, None], (r, r, r, r), mode="replicate")
        taps2d = torch.outer(ptaps, ptaps)[None, None]
        sums = detector_sum_inputs_batch(level)
        per = lambda args, i: [x[i] if isinstance(x, torch.Tensor) else x for x in args]  # noqa: E731
        cases = {
            # name: (batched call, N single calls, plain version, library call, bound)
            "blur": (lambda: image.gaussian_blur_batch(level, psig), lambda: [image.gaussian_blur(x, psig) for x in level],
                     lambda: image.gaussian_blur_batch_torch(level, psig), lambda: F.conv2d(padded, taps2d),
                     bound_us("blur", N * H, W, ptaps.numel(), R, n_bits, n_support)),
            "gradients": (lambda: image.gradients_xy_batch(level, 255.0), lambda: [image.gradients_xy(x, 255.0) for x in level],
                          lambda: image.gradients_xy_batch_torch(level, 255.0), None,
                          bound_us("gradients", N * H, W, ntaps, R, n_bits, n_support)),
            "lsd_front": (lambda: lsd.ccl_inputs_batch(level, params), lambda: [lsd.ccl_inputs(x, params) for x in level],
                          None, None, bound_us("lsd_front", N * H, W, ntaps, R, n_bits, n_support)),
            "ccl": (lambda: lsd.ccl_propagate_batch(lab0, mx0, cb, R), lambda: [lsd.ccl_propagate(*per((lab0, mx0, cb), i), R) for i in range(N)],
                    lambda: lsd._ccl_batch_torch(lab0, mx0, cb, R), None, bound_us("ccl", N * H, W, ntaps, R, n_bits, n_support)),
        }
        for name, args in sums.items():
            K = args[3].shape[1] if name != "segment_moments" else args[2]
            V = args[0].shape[1] if name == "segment_moments" else 7
            n_items = args[0].shape[2] if name == "segment_moments" else args[0][0].numel()
            cases[name] = (
                lambda name=name, args=args: getattr(lsd, f"{name}_batch")(*args),
                lambda name=name, args=args: [getattr(lsd, name)(*per(args, i)) for i in range(N)],
                None, None, sums_bound_us(name, N * n_items, N * K, V),
            )
        for name, (batched, singles, plain, lib, (b_us, b_by)) in cases.items():
            tag = f"batched {name:17s} {N}x{(H, W)}"
            got, want = batched(), singles()
            got = got if isinstance(got, tuple) else (got,)
            want = [w if isinstance(w, tuple) else (w,) for w in want]
            same = all(torch.equal(got[j][i], want[i][j]) for i in range(N) for j in range(len(got)))
            if plain is not None:
                ref = plain()
                ref = ref if isinstance(ref, tuple) else (ref,)
                err = max(float((a.double() - b.double()).abs().max()) for a, b in zip(got, ref))
            elif name in lsd.SUMS:
                # each image's plain version on its own inputs, on the CPU (index_add_ in item order)
                plain_of = {"component_moments": lsd.component_moments_torch, "component_extents": lsd.component_extents_torch,
                            "segment_moments": lsd.segment_moments_torch}[name]
                args = sums[name]
                errs = [_sum_errors(name, got[0][i], plain_of(*(x.cpu() if isinstance(x, torch.Tensor) else x for x in per(args, i)))) for i in range(N)]
                err = max(e[1] for e in errs)  # relative, as sums_phase holds them
                if any(e[2] is False for e in errs):
                    fail(f"{tag}: t_min / t_max differ from the plain version")
                plain = lambda name=name, args=args, plain_of=plain_of: [plain_of(*per(args, i)) for i in range(N)]  # noqa: E731
            else:  # the front: each image against its plain version, as kernel_phase holds the single call
                err = 0.0
                for i in range(N):
                    x = level[i]
                    gx, gy, _, _ = image.image_gradients_torch(image.gaussian_blur_torch(x, sigma) * 255.0)
                    e, _, n_other = lsd.front_disagreements(tuple(p[i] for p in got), lsd.ccl_inputs_torch(x, params), gx, gy, params, TOL[name])
                    if n_other:
                        fail(f"{tag}: image {i}: integer planes differ from the plain version away from a threshold")
                    err = max(err, e)
                plain = lambda: [lsd.ccl_inputs_torch(x, params) for x in level]  # noqa: E731
            ok = same and err <= TOL[name]
            print(f"{tag}: bit-equal to {N} single-image calls: {same}; max_abs_err={err:.3g} (tol {TOL[name]}) "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                fail(f"{tag}: the batched kernel differs from its single-image calls or its plain version")
            if H != imgs.shape[1]:
                continue  # the second level: bit-equality and errors only
            # the wrapper's count of one call's device launches (a trace of a
            # single one-launch call can lose its only device record)
            counter = (image if name in image.KERNEL_LAUNCHES else lsd).KERNEL_LAUNCHES
            before = counter[f"{name}_batch"]
            batched()
            lpc = counter[f"{name}_batch"] - before
            if lpc != launches_per_call()[name]:
                fail(f"{tag}: {lpc} device launches per batched call, expected {launches_per_call()[name]} (the single call's)")
            dev_us, singles_us = in_turns((singles, max(1, REPS // N)), (batched, REPS))
            plain_ms = host_paced_ms(plain, 3)
            lib_ms = device_us(lib) / 1e3 if lib else None
            print(
                f"{tag}: device {dev_us:.3f} us per batched call ({dev_us / N:.3f} us per image), {N} single calls "
                f"{singles_us:.3f} us ({singles_us / N:.3f} us per image); bound {b_us:.3f} us ({b_by}, {b_us / dev_us:.1%} "
                f"of it); launches per call {lpc} (the wrapper's count); plain {plain_ms:.4f} ms (host-paced); library "
                f"{f'{lib_ms * 1e3:.3f} us' if lib_ms is not None else 'none'} on {card}",
                flush=True,
            )
            res[name] = dict(
                shape=f"{N}x{H}x{W}", batch=N, max_abs_err=err, device_us=dev_us, ms=dev_us / 1e3, plain_ms=plain_ms,
                bound_us=b_us, bound_ms=b_us / 1e3, bound_by=b_by, library_ms=lib_ms, per_image_us=dev_us / N,
                single_calls_us=singles_us, single_per_image_us=singles_us / N, launches_per_call_counted=lpc,
                bit_equal_to_single=same,
            )
    fp = FrontendParams()
    fb = extract_features(imgs, fp)
    for i in range(N):
        fs = extract_features(imgs[i], fp)
        bad = [name for name, a, b in zip(fs._fields, fb, fs) if not torch.equal(a[i], b)]
        if bad:
            fail(f"batched extraction: image {i} differs from its single extraction in {bad}")
    print(f"batched extraction of {N} VGA frames (both levels, detection, LBD, the level merge): every field bit-equal to "
          f"{N} single extractions ok", flush=True)
    return res


def detector_sum_inputs_batch(imgs):
    """{single entry name: args} of the three batched sums one batched
    detect_lines call makes on a (N, H, W) batch."""
    from tpuslam_torch.kernels import lsd

    seen, names = {}, {f"{name}_batch": name for name in lsd.SUMS}
    real = {name: getattr(lsd, name) for name in names}

    def grab(name):
        def call(*args):
            seen[names[name]] = args
            return real[name](*args)

        return call

    for name in names:
        setattr(lsd, name, grab(name))
    try:
        lsd.detect_lines(imgs, 256)
    finally:
        for name in names:
            setattr(lsd, name, real[name])
    if set(seen) != set(lsd.SUMS):
        fail(f"batched sums: detect_lines called {sorted(seen)}, expected the three batched sums")
    return seen


def multi_tracker(cams, mapping: bool, mesh=None):
    """tpuslam_torch.parallel.multi_seq.MultiTracker on the card (over
    ``mesh`` when given: its shards in processes of their own) over the
    sequences' calibrations (the default TrackerConfig), with a LocalMapper
    per sequence on its tracker's card when ``mapping``."""
    from tpuslam_torch.backend.mapping import MapperConfig
    from tpuslam_torch.parallel.multi_seq import MultiTracker

    return MultiTracker(cams, device="cuda", mesh=mesh, mapper_cfg=MapperConfig() if mapping else None)


def multi_feed(mt, frames, f: int):
    import numpy as np

    n = len(mt.cams)
    lefts = np.stack([seq[f][0] for seq in frames[:n]])
    rights = np.stack([seq[f][1] for seq in frames[:n]])
    return mt.track_stereo(lefts, rights, [f * 0.05] * n)


def multi_phase(card):
    """Phase 20: BASELINE config #5, N = MULTI_SEQ VGA stereo sequences with
    per-sequence calibrations tracked concurrently (MultiTracker, a
    LocalMapper each) on the card. (a) the batched kernels and the batched
    extraction bit-equal to single-image calls; (b) the main path: the
    launch counts set to 0 just before the sequences' MULTI_FRAMES frames
    and read just after (only batched kernels, their calls per batched
    frame), every frame after the first OK and one batched dispatch per
    steady frame, each sequence's ATE within the JAX MultiTracker's x 1.05 +
    0.01 m; (c) batched_ba of 8 toy problems at the bench rung (16, 256,
    1024) against 8 single run_lm solves, with their device ms and
    launches; (d) scaling: host ms, device busy ms and launches per
    sequence-frame at N = 1, 2 and 8 (tracking, no mapper), and the host
    syncs of one steady batched frame; (e) the split over a mesh
    (:func:`split_phase`). Returns ({name: kernels-line fields}, launches,
    the split's launches)."""
    import numpy as np
    import torch

    from tpuslam_torch.backend.lm import BAProblem, LMConfig, run_lm
    from tpuslam_torch.parallel import multi_seq
    from tpuslam_torch.parallel.sharded_ba import _toy_problem, batched_ba, stack_problems

    t_phase = time.perf_counter()
    cams, scenes, frames = make_multi_frames()
    N = len(cams)
    imgs = torch.stack([torch.from_numpy(seq[0][0]) for seq in frames]).cuda().float() / 255.0
    kres = batch_kernel_phase(imgs, card)

    # (b) the main path
    mt = multi_tracker(cams, mapping=True)
    calls = {"batched": 0}
    real = multi_seq.batched_track_step

    def counting(*a, **k):
        calls["batched"] += 1
        return real(*a, **k)

    multi_seq.batched_track_step = counting
    try:
        reset_launches()
        t0 = time.perf_counter()
        results = [multi_feed(mt, frames, f) for f in range(MULTI_FRAMES)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
    finally:
        multi_seq.batched_track_step = real
    states = [[r.state.name for r in res] for res in results]
    print(f"multi: {N} sequences x {MULTI_FRAMES} frames on {card}: {wall:.2f} s, {N * MULTI_FRAMES / wall:.2f} sequence-frames/s "
          f"(tracking and mapping); batched dispatches {calls['batched']}", flush=True)
    if any(st != "OK" for row in states[1:] for st in row):
        fail(f"multi: a frame after the first did not track OK: {states}")
    if calls["batched"] != MULTI_FRAMES - 1:
        fail(f"multi: {calls['batched']} batched dispatches, expected one per steady frame ({MULTI_FRAMES - 1})")
    calls_, device = launches
    want_lpc = launches_per_call()
    for name, n in calls_.items():
        per = PER_MULTI_FRAME.get(name, 0)
        lpc = want_lpc[name.removesuffix("_batch")]
        print(f"multi: {name} calls {n} (expected {per} x {MULTI_FRAMES}), device launches {device[name]}", flush=True)
        if n != per * MULTI_FRAMES or device[name] != n * lpc:
            fail(f"multi: {name}: {n} calls and {device[name]} device launches, expected {per * MULTI_FRAMES} and {lpc} per call")
    if len(JAX_MULTI_ATE_M) != N:
        fail(f"multi: {len(JAX_MULTI_ATE_M)} JAX references for {N} sequences")
    for s in range(N):
        traj = [res[s] for res in results]
        ate = ate_of(traj, scenes[s])
        bound = JAX_MULTI_ATE_M[s] * PIPELINED_ATE_FACTOR + ATE_MARGIN_M
        kfs = [r.frame_idx for r in traj if r.made_keyframe]
        print(f"multi: sequence {s} (fx {cams[s].fx}, baseline {cams[s].baseline:.3f}): keyframes {kfs}, ATE {ate:.5f} m, "
              f"bound {bound:.5f} m (JAX {JAX_MULTI_ATE_M[s]} m x {PIPELINED_ATE_FACTOR} + {ATE_MARGIN_M} m)", flush=True)
        if not ate <= bound:
            fail(f"multi: sequence {s}: ATE {ate} m above {bound} m")

    # (c) batched BA against single solves at the bench rung
    rng = np.random.default_rng(0)
    probs = [_toy_problem(rng, 16, 256, 1024, cams[0], device="cuda") for _ in range(8)]
    for dtype in (torch.float64, torch.float32):
        ps = [BAProblem(*(x.to(dtype) if x.is_floating_point() else x for x in p)) for p in probs]
        cfg = LMConfig(max_iters=4) if dtype == torch.float64 else LMConfig()
        out = batched_ba(stack_problems(ps), cams[0], cfg)
        singles = [run_lm(p, cams[0], cfg) for p in ps]
        for i, sgl in enumerate(singles):
            if dtype == torch.float64:
                gap = max(float((x[i] - y).abs().max()) - 1e-6 * float(y.abs().max()) for x, y in zip(out, sgl))
                ok = gap <= 1e-8
            else:
                gap = float((out.poses[i] - sgl.poses).abs().max())
                ok = (float(out.cost[i]) < 1e-4 and float(sgl.cost) < 1e-4 and abs(float(out.cost[i]) - float(sgl.cost)) <= 1e-5
                      and gap <= 5e-3)
            if not ok:
                fail(f"batched BA ({dtype}): problem {i} differs from its single solve (cost {float(out.cost[i])!r} against "
                     f"{float(sgl.cost)!r}, gap {gap!r})")
        print(f"batched BA ({str(dtype).removeprefix('torch.')}, {cfg.max_iters} iterations): 8 problems at (16, 256, 1024) "
              f"match 8 single run_lm solves; costs {[f'{float(c):.3g}' for c in out.cost]}", flush=True)
    batch = stack_problems(probs)
    # whole=False: a trace that lost a device record still counts (TRACES says how many)
    _, (b_us, b_launches, _) = profiled(lambda: batched_ba(batch, cams[0], LMConfig()), whole=False)
    _, (s_us, s_launches, _) = profiled(lambda: [run_lm(p, cams[0], LMConfig()) for p in probs], whole=False)
    torch.cuda.synchronize()
    t = time.perf_counter()
    batched_ba(batch, cams[0], LMConfig())
    torch.cuda.synchronize()
    b_wall = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    for p in probs:
        run_lm(p, cams[0], LMConfig())
    torch.cuda.synchronize()
    s_wall = (time.perf_counter() - t) * 1e3
    print(f"batched BA: 8 problems at (16, 256, 1024), 10 iterations: batched {b_wall:.2f} ms wall, {b_us / 1e3:.3f} ms device "
          f"busy, {b_launches} launches; 8 single solves {s_wall:.2f} ms wall, {s_us / 1e3:.3f} ms device busy, {s_launches} "
          f"launches on {card}", flush=True)

    # (d) scaling: tracking alone (mapping stays per sequence) at N = 1, 2, 8
    scaling = {}
    for n in MULTI_SCALING:
        m = multi_tracker(cams[:n], mapping=False)
        for f in range(MULTI_WARM):
            multi_feed(m, frames, f)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for f in range(MULTI_WARM, MULTI_WARM + MULTI_TIMED):
            multi_feed(m, frames, f)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t) * 1e3 / MULTI_TIMED
        nxt = iter(range(MULTI_WARM + MULTI_TIMED, MULTI_FRAMES))
        _, (busy_us, n_launch, _) = profiled(lambda: multi_feed(m, frames, next(nxt)), whole=False)
        scaling[n] = dict(host_ms_per_frame=host_ms, host_ms_per_seq_frame=host_ms / n, device_ms_per_seq_frame=busy_us / 1e3 / n,
                          launches_per_frame=n_launch, launches_per_seq_frame=n_launch / n)
        print(f"multi scaling N={n}: host {host_ms:.2f} ms per batched frame = {host_ms / n:.2f} ms per sequence-frame "
              f"({1e3 * n / host_ms:.2f} sequence-frames/s); device busy {busy_us / 1e3:.3f} ms per frame = "
              f"{busy_us / 1e3 / n:.3f} ms per sequence-frame; {n_launch} launches per frame = {n_launch / n:.1f} per "
              f"sequence-frame on {card}", flush=True)
    one, top = scaling[1], scaling[max(MULTI_SCALING)]
    nt = max(MULTI_SCALING)
    print(f"multi scaling: N={nt} against N=1: {top['launches_per_frame'] / one['launches_per_frame']:.2f}x the launches per "
          f"frame for {nt}x the sequences ({nt * one['launches_per_frame']} for {nt} trackers one by one); sequence-frames/s "
          f"{one['host_ms_per_seq_frame'] / top['host_ms_per_seq_frame']:.2f}x", flush=True)
    syncs = count_syncs(lambda: multi_feed(m, frames, MULTI_FRAMES - 1))
    print(f"multi: host syncs of one steady batched frame at N={n}: {len(syncs)} ({syncs}; the packed rows' read once, "
          f"and the host reads of each keyframe a sequence makes in it)", flush=True)
    one_card = {**scaling[max(MULTI_SCALING)], "mapping_seq_frames_per_s": N * MULTI_FRAMES / wall}
    split_launches = split_phase(card, cams, scenes, frames, one_card)
    print(f"multi: phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    for name, r in kres.items():
        r["scaling"] = {str(k): v for k, v in scaling.items()}
    return kres, launches, split_launches


# the C entry point of each batched kernel's counter
BATCH_ENTRY = {
    "blur_batch": "tpuslam_blur_batch", "gradients_batch": "tpuslam_gradients_xy_batch",
    "lsd_front_batch": "tpuslam_lsd_front_batch", "ccl_batch": "tpuslam_ccl_batch",
    "component_moments_batch": "tpuslam_component_moments_batch",
    "component_extents_batch": "tpuslam_component_extents_batch", "segment_moments_batch": "tpuslam_segment_sums_batch",
}


def split_mesh():
    """The split's mesh: the most cards that divide MULTI_SEQ where the
    machine has several (make_mesh), else two shards on cuda:0, which
    drives the shard processes on one card."""
    import torch

    from tpuslam_torch.parallel.sharded_ba import DeviceMesh, make_mesh

    have = torch.cuda.device_count()
    if have > 1:
        return make_mesh(max(n for n in range(1, have + 1) if MULTI_SEQ % n == 0))
    return DeviceMesh((torch.device("cuda", 0),) * 2)


def shard_sync(mt, s: int) -> None:
    """In a shard's process: wait for its card's work."""
    import torch

    torch.cuda.synchronize(mt.device)


def shard_frame_profile(mt, s: int, lefts, rights, ts) -> tuple:
    """In shard s's process: one frame of its rows under torch.profiler
    (`profiled`, whole=False): (device busy us, kernel records, card index)."""
    TRACES["checked"] = True  # the record check runs in the main process
    n = len(mt.trackers)
    sl = slice(s * n, (s + 1) * n)
    _, (busy_us, n_launch, _) = profiled(lambda: mt.track_stereo(lefts[sl], rights[sl], ts[sl]), whole=False)
    return busy_us, n_launch, mt.device.index


def split_phase(card, cams, scenes, frames, one_card: dict):
    """Phase 20e: config #5 split over a mesh (split_mesh), one process per
    shard. The main path: the counts of every shard (and of this process)
    set to 0 just before the MULTI_SEQ sequences' MULTI_FRAMES frames
    (MultiTracker over the mesh, a LocalMapper each in its shard's process)
    and read just after from the shards (MultiTracker.stats): every frame
    after the first OK, one batched dispatch per shard per steady frame,
    each shard's batched kernel calls PER_MULTI_FRAME x frames, each on its
    own card over its own images, none in this process, and each sequence's
    ATE within the JAX MultiTracker's x 1.05 + 0.01 m. Then batched_ba of 8
    toy problems at (16, 256, 1024) over the mesh against the unsplit call
    (float64, 4 iterations), and the split's host ms per batched frame,
    sequence-frames/s with mappers and without, device busy ms and launches
    per card (each shard's frame profiled in its process) beside one card's
    at N = MULTI_SEQ (`one_card`: part (d) and the main path of part (b)),
    and each shard process's start-up seconds. Returns the main path's
    (calls, device launches), summed over the shards."""
    import numpy as np
    import torch

    from tpuslam_torch.backend.lm import BAProblem, LMConfig
    from tpuslam_torch.parallel.shard_pool import pool_of
    from tpuslam_torch.parallel.sharded_ba import _toy_problem, batched_ba, stack_problems

    t_phase = time.perf_counter()
    mesh = split_mesh()
    k, N = len(mesh.devices), len(cams)
    cards = sorted({d.index for d in mesh.devices})
    print(f"split: {N} sequences over {k} shards on cards {cards} ({[str(d) for d in mesh.devices]}), one process each; "
          f"{torch.cuda.device_count()} card(s) on this machine", flush=True)
    t = time.perf_counter()
    pool = pool_of(mesh)
    print(f"split: {k} shard processes up in {time.perf_counter() - t:.2f} s (each ready after "
          f"{[round(x, 2) for x in pool.start_seconds]} s)", flush=True)
    mt = multi_tracker(cams, mapping=True, mesh=mesh)
    mt.reset_counts()
    reset_launches()
    t0 = time.perf_counter()
    results = [multi_feed(mt, frames, f) for f in range(MULTI_FRAMES)]
    mt.in_shards(shard_sync)
    wall = time.perf_counter() - t0
    stats = mt.stats()
    here = read_launches()
    mt.close()
    print(f"split: {N} sequences x {MULTI_FRAMES} frames over {k} shard processes: {wall:.2f} s, {N * MULTI_FRAMES / wall:.2f} "
          f"sequence-frames/s (tracking and mapping; one card's main path (part b) {one_card['mapping_seq_frames_per_s']:.2f}); "
          f"batched dispatches by shard {[sh['batched_dispatches'] for sh in stats['shards']]}", flush=True)
    states = [[r.state.name for r in res] for res in results]
    if any(st != "OK" for row in states[1:] for st in row):
        fail(f"split: a frame after the first did not track OK: {states}")
    if any(here[0].values()) or any(here[1].values()):
        fail(f"split: kernels launched in the main process during the split: {here}")
    pids = [sh["pid"] for sh in stats["shards"]]
    if pids != pool.pids or os.getpid() in pids:
        fail(f"split: the shards ran in processes {pids}, not the mesh's {pool.pids}")
    want_lpc = launches_per_call()
    calls_ = dict.fromkeys(stats["shards"][0]["calls"], 0)
    device = dict.fromkeys(stats["shards"][0]["launches"], 0)
    for s, sh in enumerate(stats["shards"]):
        if sh["batched_dispatches"] != MULTI_FRAMES - 1 or sh["device"] != str(mesh.devices[s]):
            fail(f"split: shard {s}: {sh['batched_dispatches']} batched dispatches on {sh['device']}, expected "
                 f"{MULTI_FRAMES - 1} on {mesh.devices[s]}")
        for name, n in sh["calls"].items():
            per = PER_MULTI_FRAME.get(name, 0)
            lpc = want_lpc[name.removesuffix("_batch")]
            calls_[name] += n
            device[name] += sh["launches"][name]
            if n != per * MULTI_FRAMES or sh["launches"][name] != n * lpc:
                fail(f"split: shard {s}: {name}: {n} calls and {sh['launches'][name]} device launches, expected "
                     f"{per * MULTI_FRAMES} and {lpc} per call")
            entries = {(dev, b): c for (e, dev, b), c in sh["entries"].items() if e == BATCH_ENTRY.get(name)}
            if per and entries != {(str(mesh.devices[s]), N // k): per * MULTI_FRAMES}:
                fail(f"split: shard {s}: {name}: launches by (card, images) {entries}, expected {per * MULTI_FRAMES} on "
                     f"{mesh.devices[s]} over {N // k} images each")
        if any(e not in BATCH_ENTRY.values() for e, _, _ in sh["entries"]):
            fail(f"split: shard {s} launched kernels other than the batched ones: {sorted(sh['entries'])}")
    for name, n in calls_.items():
        if PER_MULTI_FRAME.get(name, 0):
            print(f"split: {name} calls {n} ({k} shards x {PER_MULTI_FRAME[name]} x {MULTI_FRAMES}, each in its shard's process "
                  f"on its card over {N // k} images), device launches {device[name]}", flush=True)
    for s in range(N):
        traj = [res[s] for res in results]
        ate = ate_of(traj, scenes[s])
        bound = JAX_MULTI_ATE_M[s] * PIPELINED_ATE_FACTOR + ATE_MARGIN_M
        q = stats["sequences"][s]
        print(f"split: sequence {s} on {q['device']}: keyframes {q['keyframes']}, map lines {q['map_lines']}, ATE {ate:.5f} m, "
              f"bound {bound:.5f} m", flush=True)
        if not ate <= bound:
            fail(f"split: sequence {s}: ATE {ate} m above {bound} m")

    # batched BA over the mesh against the unsplit call
    rng = np.random.default_rng(0)
    probs = stack_problems([
        BAProblem(*(x.double() if x.is_floating_point() else x for x in _toy_problem(rng, 16, 256, 1024, cams[0], device="cuda:0")))
        for _ in range(8)
    ])
    cfg = LMConfig(max_iters=4)
    ref = batched_ba(probs, cams[0], cfg)
    out = batched_ba(probs, cams[0], cfg, mesh=mesh)
    gaps = [float((x - y).abs().max()) - 1e-6 * float(y.abs().max()) for x, y in zip(out, ref)]
    if max(gaps) > 1e-8 or any(x.device != mesh.devices[0] for x in out):
        fail(f"split: batched BA over the mesh differs from the unsplit call: {gaps}")
    print(f"split: batched BA (float64, 4 iterations) of 8 problems at (16, 256, 1024) over {k} shard processes equals the "
          f"unsplit call (largest gap beyond 1e-6 relative {max(gaps):.3g})", flush=True)

    # host and device time per batched frame, tracking alone
    m = multi_tracker(cams, mapping=False, mesh=mesh)
    for f in range(MULTI_WARM):
        multi_feed(m, frames, f)
    m.in_shards(shard_sync)
    t = time.perf_counter()
    for f in range(MULTI_WARM, MULTI_WARM + MULTI_TIMED):
        multi_feed(m, frames, f)
    m.in_shards(shard_sync)
    host_ms = (time.perf_counter() - t) * 1e3 / MULTI_TIMED
    f = MULTI_WARM + MULTI_TIMED
    lefts = np.stack([seq[f][0] for seq in frames])
    rights = np.stack([seq[f][1] for seq in frames])
    prof = m.in_shards(shard_frame_profile, lefts, rights, [f * 0.05] * N)
    m.close()
    mesh.close()
    by_card = {}
    for busy_us, n_launch, c in prof:
        us, n = by_card.get(c, (0.0, 0))
        by_card[c] = (us + busy_us, n + n_launch)
    busy_us, n_launch = sum(p[0] for p in prof), sum(p[1] for p in prof)
    print(f"split: host {host_ms:.2f} ms per batched frame ({1e3 * N / host_ms:.2f} sequence-frames/s, tracking alone) over "
          f"{k} shard processes on cards {cards}; device busy {busy_us / 1e3:.3f} ms and {n_launch} kernel records per frame in "
          f"all; per shard {[(round(p[0] / 1e3, 3), p[1]) for p in prof]}, per card "
          f"{ {c: (round(us / 1e3, 3), n) for c, (us, n) in sorted(by_card.items())} } (ms, launches) on {card}", flush=True)
    print(f"split: one card at N={N} (part d): host {one_card['host_ms_per_frame']:.2f} ms per batched frame "
          f"({1e3 * N / one_card['host_ms_per_frame']:.2f} sequence-frames/s); device busy "
          f"{one_card['device_ms_per_seq_frame'] * N:.3f} ms and {one_card['launches_per_frame']} launches per frame; the "
          f"split's host ms {host_ms / one_card['host_ms_per_frame']:.2f}x", flush=True)
    print(f"split: phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return calls_, device


# ---- the host surface: settings, the CLI, eval and RPE, map files (phase 21) ----
def write_cli_dataset(root: str) -> None:
    """The phase's dataset, through the CLI's make-synthetic."""
    from tpuslam_torch import cli

    cli.main(["make-synthetic", "--root", root, "--frames", str(CLI_FRAMES), "--seed", str(CLI_SEED),
              "--segments", str(CLI_SEGMENTS)])


def cli_main(argv) -> dict:
    """tpuslam_torch.cli.main(argv); its printed JSON summary, echoed."""
    import contextlib
    import io

    from tpuslam_torch import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(argv)
    text = out.getvalue().strip()
    print(f"cli {' '.join(argv[:1])}: {text[:400]}", flush=True)
    return json.loads(text.splitlines()[-1])


def cli_phase(card):
    """Phase 21: a settings file, the CLI's run (its defaults, then --fast)
    on a dataset written by its make-synthetic, eval and RPE of the run, and
    a map saved by the run loaded into a System(settings) that relocalizes
    a LOST frame against it. Returns the default run's (calls, device
    launches)."""
    import tempfile

    import numpy as np
    import torch

    from tpuslam_torch.eval.rpe import relative_pose_error
    from tpuslam_torch.frontend.tracking import TrackingState
    from tpuslam_torch.io.config import load_settings
    from tpuslam_torch.io.datasets import load_image_gray, load_synthetic
    from tpuslam_torch.slammap.serialize import load_map
    from tpuslam_torch.system import System

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as d:
        root = os.path.join(d, "ds")
        write_cli_dataset(root)
        seq = load_synthetic(root)
        fx, fy, cx, cy, w, h, b = open(os.path.join(root, "calib.txt")).read().split()
        yaml = os.path.join(d, "settings.yaml")
        with open(yaml, "w") as f:
            f.write(f"%YAML:1.0\nCamera.fx: {fx}\nCamera.fy: {fy}\nCamera.cx: {cx}\nCamera.cy: {cy}\n"
                    f"Camera.width: {int(float(w))}\nCamera.height: {int(float(h))}\nCamera.bf: {float(fx) * float(b)!r}\n")
        settings = load_settings(yaml)
        print(f"cli: dataset {len(seq)} frames {seq.cam.width}x{seq.cam.height}; settings camera {tuple(settings.cam)}", flush=True)
        for name, got, want in zip(settings.cam._fields, settings.cam, seq.cam):
            if isinstance(want, int) and not (isinstance(got, int) and got == want):
                fail(f"cli: settings camera {name} {got!r}, the dataset's {want!r}")
            if not abs(got - want) <= 1e-6:
                fail(f"cli: settings camera {name} {got!r}, the dataset's {want!r}")

        out, mp, log = (os.path.join(d, n) for n in ("traj.txt", "map.npz", "log.jsonl"))
        run = ["run", "--dataset", "synthetic", "--root", root]
        reset_launches()
        summary = cli_main([*run, "--out", out, "--save-map", mp, "--log", log])
        torch.cuda.synchronize()
        launches = read_launches()
        rows = [json.loads(line) for line in open(log)]
        frames = [r for r in rows if "frame" in r]
        states = [r["state"] for r in frames]
        kfs = [r["frame"] for r in frames if r["kf"]]
        ate = summary["ate_rmse"]
        bound = JAX_CLI_ATE_M + ATE_MARGIN_M
        print(f"cli run: {summary['frames']} frames, keyframes at frames {kfs}, {summary['lines']} lines, "
              f"{summary['loops']} loops, ATE {ate:.5f} m (bound {bound:.5f}: the JAX CLI's {JAX_CLI_ATE_M} + "
              f"{ATE_MARGIN_M}); {summary['fps']:.2f} frames/s ({summary['wall_s'] * 1e3 / summary['frames']:.2f} "
              f"ms/frame, file decode included) on {card}", flush=True)
        track_ms = [r["track_ms"] for r in frames]
        print(f"cli run: track_frame ms (host clock, the log's): first frame {track_ms[0]:.2f}, frames 1-{CLI_FRAMES - 1} "
              f"median {statistics.median(track_ms[1:]):.2f}; keyframe frames median "
              f"{statistics.median([r['track_ms'] for r in frames[1:] if r['kf']] or [float('nan')]):.2f} on {card}",
              flush=True)
        if len(frames) != CLI_FRAMES or any(st != "OK" for st in states[1:]):
            fail(f"cli run: a frame after the first did not track OK: {states}")
        if not ate <= bound:
            fail(f"cli run: ATE {ate} m above {bound} m")
        check_launches("cli", launches, CLI_FRAMES)

        fast = cli_main([*run, "--fast", "--out", os.path.join(d, "fast.txt")])
        fbound = JAX_CLI_FAST_ATE_M * CLI_FAST_ATE_FACTOR + ATE_MARGIN_M
        print(f"cli run --fast: {fast['keyframes']} keyframes, ATE {fast['ate_rmse']:.5f} m (bound {fbound:.5f}: the JAX "
              f"CLI's {JAX_CLI_FAST_ATE_M} x {CLI_FAST_ATE_FACTOR} + {ATE_MARGIN_M}); {fast['fps']:.2f} frames/s "
              f"({fast['wall_s'] * 1e3 / fast['frames']:.2f} ms/frame, file decode included, the flush not) on {card}",
              flush=True)
        if fast["frames"] != CLI_FRAMES or fast["ate_n"] != CLI_FRAMES or not fast["ate_rmse"] <= fbound:
            fail(f"cli run --fast: ATE {fast['ate_rmse']} m over {fast['ate_n']} frames, bound {fbound} m")

        ev = cli_main(["eval", "--est", out, "--gt", os.path.join(root, "groundtruth.txt")])
        print(f"cli eval: rmse {ev['rmse']!r} against the run's {ate!r}", flush=True)
        if not abs(ev["rmse"] - ate) <= 1e-6 or ev["n"] != summary["ate_n"]:
            fail(f"cli eval: rmse {ev['rmse']} over {ev['n']}, the run's {ate} over {summary['ate_n']}")
        est = np.stack([np.linalg.inv(np.asarray(r["pose"], np.float64).reshape(4, 4)) for r in frames])
        rpe = relative_pose_error(est, seq.gt_poses.astype(np.float64), delta=1)
        print(f"cli RPE (delta 1): translation {rpe.trans_rmse:.5f} m, rotation {rpe.rot_rmse_deg:.5f} deg over {rpe.n} "
              f"steps", flush=True)
        if not (rpe.n == CLI_FRAMES - 1 and np.isfinite(rpe.trans_rmse) and np.isfinite(rpe.rot_rmse_deg)):
            fail(f"cli RPE: {rpe}")

        saved = load_map(mp)
        sys_ = System(settings, loop_closing=False)
        sys_.load_map(mp)
        live, want = sys_.map_lines(), saved.lines.live_ids()
        n_kf = len(sys_.map.keyframes)
        print(f"cli load_map: {n_kf} keyframes, {len(live['ids'])} live lines, database {len(sys_.kf_db)} rows", flush=True)
        if not (np.array_equal(live["ids"], want) and np.array_equal(live["plucker"], saved.lines.plucker[want])
                and len(want) == summary["lines"]):
            fail("cli load_map: the live lines differ from the saved map's")
        if n_kf != summary["keyframes"] or len(sys_.kf_db) != n_kf:
            fail(f"cli load_map: {n_kf} keyframes and {len(sys_.kf_db)} database rows, the run saved {summary['keyframes']}")
        sys_.tracker.state = TrackingState.LOST
        it = seq.items[RELOC_FRAME]
        reset_launches()
        t = time.perf_counter()
        sys_.track_stereo(load_image_gray(it.left), load_image_gray(it.right), 100.0)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        reloc_launches = read_launches()
        r = sys_.trajectory[-1]
        gp = seq.gt_poses.astype(np.float64)  # T_wc; the map's world is frame 0's camera
        gt = (np.linalg.inv(gp[0]) @ gp[RELOC_FRAME])[:3, 3]
        err = float(np.linalg.norm(np.linalg.inv(np.asarray(r.T_cw, np.float64))[:3, 3] - gt))
        n = sys_.tracker.n_relocalizations
        print(f"cli reloc on the loaded map: state {r.state.name}, relocalizations {n}, centre error {err:.4f} m vs frame "
              f"{RELOC_FRAME}'s ground truth, {dt * 1e3:.1f} ms", flush=True)
        if r.state != TrackingState.OK or n != 1 or not err < 0.05:
            fail("cli reloc: the LOST tracker did not relocalize within 5 cm on the loaded map")
        check_launches("cli reloc", reloc_launches, 1)
        sys_.shutdown()
    print(f"cli: phase {time.perf_counter() - t_phase:.1f} s on {card}", flush=True)
    return launches


# ---- the bench: tpuslam_torch.bench and `cli bench` (phase 22) ----
def bench100_run(tag, card, per_extraction, noise_seed=None, via_cli: bool = False, devfeed: bool = True):
    """One run_benchmark(100, 6) (through `python -m tpuslam_torch.cli bench
    --frames 100 --warmup 6`, in process, with ``via_cli``; the device feed
    with ``devfeed``) with the launch counts set to 0 just before and read
    just after; its result checked: a JSON line per stage, the card named,
    one OK trajectory entry per frame, the native map mirror in use, each
    kernel's calls its count per extraction times the detector's runs the
    result reports. Returns (result, launches)."""
    import contextlib
    import io

    import torch

    from tpuslam_torch import bench, cli

    out = io.StringIO()
    os.environ["TPUSLAM_BENCH_DEVFEED"] = "1" if devfeed else "0"
    reset_launches()
    t = time.perf_counter()
    with contextlib.redirect_stdout(out):
        if via_cli:
            cli.main(["bench", "--frames", str(BENCH100_FRAMES), "--warmup", str(BENCH100_WARMUP)])
        else:
            bench.run_benchmark(frames=BENCH100_FRAMES, warmup=BENCH100_WARMUP, noise_seed=noise_seed)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = read_launches()
    rows = [json.loads(line) for line in out.getvalue().strip().splitlines()]
    res = rows[-1]
    n = BENCH100_FRAMES + BENCH100_WARMUP
    print(
        f"{tag}: fps_wall {res['fps_wall']:.2f}, fps_median {res['fps_median']:.2f}, track_ms_median "
        f"{res['track_ms_median']:.3f} ms, fps_device_feed {res.get('fps_device_feed', 'not run')}, local_ba_ms {res['local_ba_ms']:.2f} "
        f"(by rung {res.get('local_ba_ms_by_rung')}, {res['ba_submitted']} solves; solver process {res['ba_worker']}, fusion "
        f"deferred {res['fuse_defer']}, skipped {res['ba_skipped']}, resubmitted {res['ba_resubmitted']}, stale {res['ba_stale']}, "
        f"failed {res['ba_failed']}, cold {res.get('local_ba_cold', False)}, last stage ms {res.get('local_ba_stage_ms')}), "
        f"calls that ran a keyframe event {[round(x, 2) for x in res['keyframe_call_ms']]} ms, pretouch_s {res['pretouch_s']}, "
        f"wire_mbps {res['wire_mbps']:.1f}, flush_ms {res['flush_ms']:.1f}, keyframes at frames {res['keyframe_frames']}, "
        f"lines {res['lines']}, ATE {res['ate_rmse']:.5f} m; {len(rows)} JSON lines, {wall:.1f} s in all; device "
        f"{res['device']!r}, power limit {res['power_limit_w']} W ({card})",
        flush=True,
    )
    limit = float(card.rsplit(",", 1)[1].split()[0])
    if len(rows) != 2 + devfeed or "fps_device_feed" in rows[0] or res["device"] != torch.cuda.get_device_name(0):
        fail(f"{tag}: {len(rows)} JSON lines, device {res['device']!r}")
    if res["power_limit_w"] != limit:
        fail(f"{tag}: power limit {res['power_limit_w']} W in the result, {limit} W from nvidia-smi")
    if res["frames"] != BENCH100_FRAMES or res["tracked_ok"] != n:
        fail(f"{tag}: {res['tracked_ok']} of {n} frames tracked OK in frame order")
    if res["native_map"] is not True:
        fail(f"{tag}: the map's native mirror was not in use")
    solver = os.environ.get("TPUSLAM_BA_SUBPROCESS") == "1"
    if res["ba_worker"] != solver or res["fuse_defer"] != (os.environ.get("TPUSLAM_BENCH_FUSEDEFER") == "1"):
        fail(f"{tag}: solver process {res['ba_worker']}, fusion deferred {res['fuse_defer']}: not the configuration asked for")
    if solver and (res["ba_failed"] or res["ba_stale"] or res["ba_submitted"] < 1 or res.get("local_ba_cold")):
        fail(f"{tag}: {res['ba_submitted']} solves submitted, {res['ba_failed']} failed or abandoned, {res['ba_stale']} stale, "
             f"cold only {res.get('local_ba_cold', False)}")
    calls, device = launches
    want_lpc = launches_per_call()
    ext = res["extractions"]
    n_ext = sum(ext.values())
    for name, per in per_extraction.items():
        want = per * n_ext
        if calls[name] != want or device[name] != want * want_lpc[name] or want == 0:
            fail(f"{tag}: {name}: {calls[name]} calls and {device[name]} device launches, expected {want} calls ({per} x "
                 f"{n_ext} extractions {ext}) of {want_lpc[name]} launches")
    print(f"{tag}: kernel calls {({k: calls[k] for k in per_extraction})} = per extraction x {n_ext} extractions {ext}", flush=True)
    return res, launches


def multi_only() -> int:
    """Phase 20 alone after the kernel build (config #5 on cuda:0, then its
    split over split_mesh(): every card of a machine with several), for a
    call on several cards:

        python3 -c "import sys, chip_smoke; sys.exit(chip_smoke.multi_only())"
    """
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script runs on a CUDA device only")
    card = card_line()
    cards = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True,
                           text=True, check=True, timeout=60).stdout.strip().splitlines()
    print(f"cards: {torch.cuda.device_count()}: {cards}", flush=True)
    from tpuslam_torch.kernels import cuda_lib

    cuda_lib.build()
    cuda_lib.library()
    os.environ["TPUSLAM_NATIVE_MAP"] = "0"  # as main() runs phase 20
    os.environ.update(SYNC_ENV)
    multi_phase(card)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


def async_only() -> int:
    """Phase 22's two solo runs (the synchronous references) and phase 23
    alone after the kernel build:

        python3 -c "import sys, chip_smoke; sys.exit(chip_smoke.async_only())"
    """
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script runs on a CUDA device only")
    card = card_line()
    from tpuslam_torch.kernels import cuda_lib

    cuda_lib.build()
    cuda_lib.library()
    os.environ["TPUSLAM_NATIVE_MAP"] = "1"  # as main() runs phases 22-23
    os.environ.update(SYNC_ENV)
    os.environ.pop("TPUSLAM_BENCH_POINTS", None)
    sync_cli, _ = bench100_run("bench100 cli", card, PER_EXTRACTION, via_cli=True)
    os.environ["TPUSLAM_BENCH_POINTS"] = "1"
    sync_hybrid, _ = bench100_run("bench100 hybrid seed 0", card, PER_EXTRACTION_HYBRID, noise_seed=0)
    got = bench100_seeds([(f"async seed {k}", False, k, True) for k in BENCH100_SEEDS])
    async_phase(card, sync_cli, sync_hybrid, {k: got[(False, k, True)] for k in BENCH100_SEEDS})
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


def noisy_loop_frames(frames, seed: int):
    """The loop sequence with one grey level of image noise: -1, 0 or +1 per
    pixel from ``np.random.default_rng(seed)``, clipped to 0..255, the left
    then the right image of each frame (as ``tests/test_torch_loop_closing.py
    --noise K`` forms the JAX package's frames)."""
    import numpy as np

    rng = np.random.default_rng(seed)

    def noisy(img):
        return np.clip(img.astype(np.int16) + rng.integers(-1, 2, img.shape), 0, 255).astype(img.dtype)

    return [(noisy(il), noisy(ir)) for il, ir in frames]


def loop_noise_runs(seeds=tuple(range(1, 11))) -> int:
    """Phase 9's loop configuration (``loop_system``, synchronous, the
    native mirror off, as main() runs phase 9) over the loop sequence with
    one grey level of image noise per seed (``noisy_loop_frames``), one run
    per seed in this process: each run's closures, keyframes, OK frames and
    final keyframe-map ATE, then the median ATE:

        python3 -c "import sys, chip_smoke; sys.exit(chip_smoke.loop_noise_runs())"
    """
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script runs on a CUDA device only")
    card = card_line()
    from tpuslam_torch.kernels import cuda_lib

    cuda_lib.build()
    cuda_lib.library()
    os.environ["TPUSLAM_NATIVE_MAP"] = "0"
    os.environ.update(SYNC_ENV)
    cam, scene, frames = make_loop_frames()
    ates = []
    for seed in seeds:
        noisy = noisy_loop_frames(frames, seed)
        t = time.perf_counter()
        sys_ = loop_system(cam)
        for f, (il, ir) in enumerate(noisy):
            sys_.track_stereo(il, ir, f * 0.05)
        sys_.shutdown()
        ok = sum(1 for r in sys_.trajectory if r.state.name == "OK")
        ates.append(kf_map_ate(sys_.map, scene))
        print(f"loop noise seed {seed}: {time.perf_counter() - t:.1f} s, OK {ok}, keyframes {len(sys_.map.keyframes)}, loops "
              f"closed {sys_.loop_closer.closed_loops}, final keyframe-map ATE {ates[-1]!r} m on {card}", flush=True)
    print(f"loop noise seeds {list(seeds)}: final keyframe-map ATE median {statistics.median(ates)!r} m, "
          f"{sorted(ates)} on {card}", flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


def loop_solver_only(runs: int = 1) -> int:
    """Phase 23's loop configuration with its solver process
    (:func:`loop_solver_phase`) alone after the kernel build, ``runs``
    times in this process:

        python3 -c "import sys, chip_smoke; sys.exit(chip_smoke.loop_solver_only())"
    """
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script runs on a CUDA device only")
    card = card_line()
    from tpuslam_torch.kernels import cuda_lib

    cuda_lib.build()
    cuda_lib.library()
    os.environ["TPUSLAM_NATIVE_MAP"] = "1"  # as main() runs phase 23
    os.environ.update(ASYNC_ENV)
    for _ in range(runs):
        loop_solver_phase(card)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


def bench_turns(rounds: int = 2) -> int:
    """The lines-only `cli bench --frames 100 --warmup 6` run alone in this
    process, synchronous (SYNC_ENV) and asynchronous (ASYNC_ENV) in turns
    (sync, async, async, sync, ... ``rounds`` times), without the device
    feed: each run's fps_wall, the calls that ran a keyframe event and the
    solves, then each configuration's fps_wall median:

        python3 -c "import sys, chip_smoke; sys.exit(chip_smoke.bench_turns())"
    """
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script runs on a CUDA device only")
    card = card_line()
    from tpuslam_torch.kernels import cuda_lib

    cuda_lib.build()
    cuda_lib.library()
    os.environ["TPUSLAM_NATIVE_MAP"] = "1"
    os.environ.pop("TPUSLAM_BENCH_POINTS", None)
    got = {"sync": [], "async": []}
    for i, mode in enumerate(["sync", "async", "async", "sync"] * rounds):
        os.environ.update(SYNC_ENV if mode == "sync" else ASYNC_ENV)
        res, _ = bench100_run(f"turns {i + 1} {mode}", card, PER_EXTRACTION, via_cli=True, devfeed=False)
        got[mode].append(res)
    for mode, rows in got.items():
        print(f"turns: {mode}: fps_wall {[round(r['fps_wall'], 2) for r in rows]}, median "
              f"{statistics.median(r['fps_wall'] for r in rows):.2f}; the longest call with a keyframe event "
              f"{[round(max(r['keyframe_call_ms']), 2) for r in rows]} ms; solves {[r['ba_submitted'] for r in rows]}; "
              f"local_ba_ms {[round(r['local_ba_ms'], 2) for r in rows]} on {card}", flush=True)
    os.environ.update(SYNC_ENV)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


def bench100_child() -> int:
    """One seed run of phase 22 or 23 in a process of its own (see
    bench100_seeds): sys.argv[1] is the JSON [tag, points, seed, asynchronous]
    (ASYNC_ENV or SYNC_ENV). Runs bench100_run with its checks (a failed
    check exits 1) and prints the ATE and fps_wall as the last line."""
    tag, points, seed, asynchronous = json.loads(sys.argv[1])
    os.environ.update(ASYNC_ENV if asynchronous else SYNC_ENV)
    os.environ["TPUSLAM_NATIVE_MAP"] = "1"
    os.environ["TPUSLAM_BENCH_POINTS"] = "1" if points else "0"
    res, _ = bench100_run(tag, card_line(), PER_EXTRACTION_HYBRID if points else PER_EXTRACTION, noise_seed=seed, devfeed=False)
    print(json.dumps({"ate_rmse": res["ate_rmse"], "fps_wall": res["fps_wall"]}), flush=True)
    return 0


def bench100_seeds(jobs) -> dict:
    """The seed runs ``jobs`` ((tag, points, seed, asynchronous), ...), each
    in a process of its own (bench100_child), BENCH100_SLOTS at a time on
    the one card: a synchronous run's result does not depend on its timing,
    and an asynchronous one's barely does (seeds 0-4 gave the same
    keyframes 4, 5 and 7 at once, their ATEs within 1e-4 m), so they share
    the host, and the rates they print are not the bench's (the solo runs
    give those). Each child's output is printed; a child that fails, or
    runs past BENCH100_CHILD_S, fails the phase once all have ended.
    Returns {(points, seed, asynchronous): {"ate_rmse", "fps_wall"}}."""
    done = run_children("bench100_child", [json.dumps(job) for job in jobs], BENCH100_SLOTS, BENCH100_CHILD_S)
    out = {}
    for (tag, points, seed, asynchronous), proc in zip(jobs, done):
        stdout = proc.stdout
        for line in stdout.strip().splitlines()[:-1]:
            print(line, flush=True)
        if proc.returncode != 0:
            print(stdout.strip().splitlines()[-1:], proc.stderr[-4000:], flush=True)
            fail(f"{tag} seed {seed}: its process ended with code {proc.returncode}")
        out[(points, seed, asynchronous)] = json.loads(stdout.strip().splitlines()[-1])
    return out


def bench100_phase(card):
    """Phase 22: the bench, lines only (its CLI once, then noise seeds 0-4)
    and with hybrid points over frames with dots (seeds 0-4), each seed
    set's median ATE within the JAX package's median x 1.05 + 0.01 m; then
    run_ba_benchmark. The CLI run and the hybrid run of seed 0 run alone,
    with the device feed: their rates are the bench's; the other seed runs
    share the host (bench100_seeds), in one pool with phase 23's
    asynchronous seed runs (lines only, seeds 0-4). Returns the launches of
    the CLI run and of the hybrid run of seed 0, those two runs' results
    and the asynchronous seed runs' results by seed."""
    t0 = time.perf_counter()
    os.environ.pop("TPUSLAM_BENCH_POINTS", None)
    cli_res, cli_launches = bench100_run("bench100 cli", card, PER_EXTRACTION, via_cli=True)
    print(f"bench100 cli: ATE {cli_res['ate_rmse']!r} m (the JAX package's on the same frames {JAX_BENCH100_ATE_M!r} m)", flush=True)
    os.environ["TPUSLAM_BENCH_POINTS"] = "1"
    hybrid_res, hybrid_launches = bench100_run("bench100 hybrid seed 0", card, PER_EXTRACTION_HYBRID, noise_seed=0)
    os.environ.pop("TPUSLAM_BENCH_POINTS", None)
    os.environ.pop("TPUSLAM_BENCH_DEVFEED", None)
    t = time.perf_counter()
    jobs = [(f"bench100 seed {k} ({BENCH100_SLOTS} runs at once)", False, k, False) for k in BENCH100_SEEDS]
    jobs += [(f"bench100 hybrid seed {k} ({BENCH100_SLOTS} runs at once)", True, k, False) for k in BENCH100_SEEDS if k != 0]
    jobs += [(f"async seed {k} ({BENCH100_SLOTS} runs at once)", False, k, True) for k in BENCH100_SEEDS]
    got = bench100_seeds(jobs)
    got[(True, 0, False)] = hybrid_res
    print(f"bench100: {len(jobs)} seed runs (phase 23's asynchronous ones among them), {BENCH100_SLOTS} at a time, "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    for tag, points, jax_ates, solo in (
        ("bench100", False, JAX_BENCH100_SEED_ATES_M, cli_res), ("bench100 hybrid", True, JAX_HYBRID_BENCH100_SEED_ATES_M, hybrid_res)
    ):
        ates = [got[(points, k, False)]["ate_rmse"] for k in BENCH100_SEEDS]
        med, jmed = statistics.median(ates), statistics.median(jax_ates)
        bound = jmed * BENCH100_ATE_FACTOR + ATE_MARGIN_M
        print(f"{tag}: ATE over noise seeds {list(BENCH100_SEEDS)} {ates}, median {med:.5f} m; the JAX package's {list(jax_ates)}, "
              f"median {jmed:.5f} m; bound {bound:.5f} m (x {BENCH100_ATE_FACTOR} + {ATE_MARGIN_M}); fps_wall of the run alone "
              f"{solo['fps_wall']:.2f}, fps_device_feed {solo['fps_device_feed']:.2f} on {card}", flush=True)
        if not med <= bound:
            fail(f"{tag}: median ATE {med} m above {bound} m")
    ba_bench_phase(card)
    print(f"bench100: phase {time.perf_counter() - t0:.1f} s on {card}", flush=True)
    return cli_launches, hybrid_launches, cli_res, hybrid_res, {k: got[(False, k, True)] for k in BENCH100_SEEDS}


def ba_bench_phase(card) -> None:
    """run_ba_benchmark on the card: each rung's ms per solve and first
    solve, its launches per solve (the host's launch calls under
    torch.profiler), and its toy problem solved on the CPU
    too: the same initial cost (1e-5 relative), and both final costs at
    the float32 floor of these noiseless problems (at most 1e-8 of the
    initial cost; the final costs are rounding, so not compared)."""
    import numpy as np
    import torch

    from tpuslam_torch import bench
    from tpuslam_torch.backend.lm import LMConfig, run_lm
    from tpuslam_torch.parallel.sharded_ba import _toy_problem

    res = bench.run_ba_benchmark(quiet=True)
    rngs = {"cuda": np.random.default_rng(0), "cpu": np.random.default_rng(0)}
    for P_, L_, OL_ in bench.BA_RUNGS:
        probs = {d: _toy_problem(rng, P_=P_, L=L_, OL=OL_, cam=bench.VGA, device=d) for d, rng in rngs.items()}
        cost0 = {d: float(run_lm(p, bench.VGA, LMConfig(max_iters=0)).cost) for d, p in probs.items()}
        cpu = float(run_lm(probs["cpu"], bench.VGA, LMConfig(max_iters=8)).cost)
        def solve():
            return run_lm(probs["cuda"], bench.VGA, LMConfig(max_iters=8)).cost.item()

        solve()
        # the host's launch calls are always recorded; a trace here can lose
        # some device records (PERF.md section 7), so it is not taken again
        prof, (busy_us, n_records, _) = profiled(solve, whole=False)
        n = device_events(prof)[-1]
        key = f"P{P_}_L{L_}"
        got = res[f"ba_cost_{key}"]
        print(f"ba bench {(P_, L_, OL_)}: {res[f'ba_ms_{key}']:.2f} ms per solve (mean of 5), first solve "
              f"{res[f'ba_first_s_{key}'] * 1e3:.2f} ms, {n} kernel launch calls per solve (8 LM iterations; the trace "
              f"holds {n_records} device records, {busy_us / 1e3:.3f} ms device busy); cost "
              f"{cost0['cuda']!r} -> {got!r} on the card, {cost0['cpu']!r} -> {cpu!r} on the CPU ({card})", flush=True)
        if not abs(cost0["cuda"] - cost0["cpu"]) <= 1e-5 * cost0["cpu"]:
            fail(f"ba bench {key}: initial cost {cost0['cuda']} on the card, {cost0['cpu']} on the CPU")
        if not (got <= 1e-8 * cost0["cuda"] and cpu <= 1e-8 * cost0["cpu"]):
            fail(f"ba bench {key}: final cost {got} on the card, {cpu} on the CPU, from {cost0['cuda']}")
    torch.cuda.synchronize()


# ---- the asynchronous back end: the solver process and deferred fusion (phase 23) ----
# phases 1-22 run local and global BA in this process and fusion at the
# keyframe (their references and bit-equal repeats belong to that path);
# phase 23 runs the JAX bench's on-chip configuration
SYNC_ENV = {"TPUSLAM_BA_SUBPROCESS": "0", "TPUSLAM_BENCH_FUSEDEFER": "0"}
ASYNC_ENV = {"TPUSLAM_BA_SUBPROCESS": "1", "TPUSLAM_BENCH_FUSEDEFER": "1"}
SOLVER_TOL = 1e-5  # the solver process's solve against this process's, same card
ASYNC_PROFILE_RUNG = (24, 1024, 4096)  # the toy solves in flight during the profiled chunk
ASYNC_PROFILE_SOLVES = 5  # ~130 ms each: they outlast the chunk
ASYNC_PROFILE_FRAMES = 64


def solver_check(card) -> None:
    """A solver process on the card (BASolverWorker): its start-up time, then
    the toy problem at the bench's larger rung solved there twice (cold,
    warm) against solve_in_process on the card, every array and the cost
    within SOLVER_TOL; the child gone after close()."""
    import numpy as np
    import torch

    from tpuslam_torch import bench
    from tpuslam_torch.backend.ba_worker import BASolverWorker
    from tpuslam_torch.backend.lm import BAProblem
    from tpuslam_torch.backend.local_ba import LocalBAConfig, problem_arrays, solve_in_process
    from tpuslam_torch.parallel.sharded_ba import _toy_problem

    cfg = LocalBAConfig()
    P_, L_, OL_ = bench.BA_RUNGS[-1]
    prob = _toy_problem(np.random.default_rng(0), P_=P_, L=L_, OL=OL_, cam=bench.VGA, device="cpu")
    ref = solve_in_process(BAProblem(*[x.cuda() for x in prob]), bench.VGA, cfg)
    t = time.perf_counter()
    w = BASolverWorker(bench.VGA, warm_caps=(), device="cuda")
    try:
        w.wait_ready(300.0)
        up_s = time.perf_counter() - t
        got = []
        for _ in range(2):
            t = time.perf_counter()
            res, err = w.solve(problem_arrays(prob), cfg.lm, cfg.chi2_line, cfg.chi2_point, timeout=300.0)
            if res is None:
                fail(f"solver: the solve failed: {err}")
            got.append((res, (time.perf_counter() - t) * 1e3))
    finally:
        w.close()
    for (res, ms), which in zip(got, ("first", "second")):
        err = max(float(np.abs(np.asarray(res[k]) - np.asarray(ref[k])).max())
                  for k in ("poses", "lines", "points", "inl_l", "inl_p", "inl_l0", "inl_p0"))
        err = max(err, abs(res["cost"] - ref["cost"]))
        print(f"solver: {which} solve of the toy problem at {(P_, L_, OL_)} in the solver process: {ms:.2f} ms round trip, "
              f"{res['solve_ms']:.2f} ms in the child (warm {res['warm']}, stages {res['stage_ms']}); max abs difference to "
              f"the in-process solve on the card {err!r} (bound {SOLVER_TOL}) on {card}", flush=True)
        if not err <= SOLVER_TOL:
            fail(f"solver: the solver process's solve is {err} from the in-process solve on the card")
    print(f"solver: the process came up in {up_s:.2f} s (torch import, card opened); alive after close: {w.alive}", flush=True)
    if w.alive:
        fail("solver: the solver process outlived close()")
    torch.cuda.synchronize()


def async_profile_phase(card) -> None:
    """The bench configuration with the solver process and deferred fusion
    over make_frames(ASYNC_PROFILE_FRAMES): one steady chunk's calls under
    torch.profiler (this process's device work) with the solver idle, then
    with ASYNC_PROFILE_SOLVES toy solves at ASYNC_PROFILE_RUNG sent to the
    same solver just before (a poll right after the chunk tells which were
    still in flight): the tracking chunk's device busy ms and wall ms of
    each."""
    import numpy as np
    import torch

    from tpuslam_torch.backend.local_ba import problem_arrays
    from tpuslam_torch.parallel.sharded_ba import _toy_problem
    from tpuslam_torch.system import System, bench_configs

    cam, _, frames = make_frames(ASYNC_PROFILE_FRAMES)
    tcfg, mcfg = bench_configs(BENCH_C, fuse_defer=True)
    sys_ = System(cam, sensor="stereo", mapping=True, loop_closing=False, tracker_cfg=tcfg, mapper_cfg=mcfg, device="cuda")
    w = sys_._ba_worker
    if w is None:
        fail("async profile: the System started no solver process")
    w.wait_ready(300.0)
    f = 0

    def feed(n):
        nonlocal f
        for _ in range(n):
            sys_.track_stereo(*frames[f], f * 0.05)
            f += 1

    feed(1 + 2 * BENCH_C)
    torch.cuda.synchronize()
    P_, L_, OL_ = ASYNC_PROFILE_RUNG
    toy = problem_arrays(_toy_problem(np.random.default_rng(0), P_=P_, L=L_, OL=OL_, cam=cam, device="cpu"))
    ba = mcfg.ba
    out = {}
    busy_label = f"{ASYNC_PROFILE_SOLVES} toy solves sent just before"
    for label in ("solver idle", busy_label):
        walls, ids, still = [], [], []

        def run_chunk():
            if label != "solver idle":
                ids[:] = [w.submit(toy, ba.lm, ba.chi2_line, ba.chi2_point) for _ in range(ASYNC_PROFILE_SOLVES)]
                time.sleep(0.02)  # the child takes the first one up
            t = time.perf_counter()
            feed(BENCH_C)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
            still[:] = [w.poll(i, 0.0) is None for i in ids]  # a finished one is consumed here
            for i, busy in zip(ids, still):
                if busy and w.poll(i, 300.0) is None:
                    fail("async profile: a toy solve gave no result in 300 s")

        _, (busy_us, n_kernels, n_copies) = profiled(run_chunk, tries=3, whole=False)
        out[label] = busy_us
        print(f"async profile: one steady chunk's calls ({BENCH_C} frames, {label}; toy solves still in flight when the chunk "
              f"ended {still}): device busy {busy_us / 1e3:.3f} ms, {n_kernels} kernel launches, {n_copies} memcpy/memset, "
              f"{walls[-1] * 1e3:.2f} ms wall (device idle {1 - busy_us / 1e6 / walls[-1]:.1%}) on {card}", flush=True)
    sys_.shutdown()
    print(f"async profile: the tracking chunk's device busy ms, solver idle {out['solver idle'] / 1e3:.3f}, {busy_label} "
          f"{out[busy_label] / 1e3:.3f}; mapper solves {sys_.mapper.ba_submitted}, failed "
          f"{sys_.mapper.ba_failed} on {card}", flush=True)
    if sys_.mapper.ba_failed:
        fail("async profile: a mapper solve failed")


def loop_solver_run(card, seed=None, count: bool = False) -> dict:
    """One run of the loop configuration of phase 9 (System(cam) with its
    defaults) with its solver process over the loop sequence (noisy by
    ``seed`` when given: noisy_loop_frames): local BA asynchronous, answered
    at the first tick LOOP_SOLVER_LAG frames after its submit (the solver's
    real answer, waited for there if it is not in), global BA through the
    solver's blocking solve(); with ``count`` the launch counts set to 0
    just before and read just after. Prints the run and each closure's
    keyframe-map ATE before and after it, and before and after the next
    local-BA write-back. Fails unless a loop was closed, every global-BA
    round went through the solver in float64, no local-BA request
    submitted before a closure was written back after it, the OK frames
    are within 2 of the JAX package's and no solve failed. Returns the
    final keyframe-map ATE, closures, keyframes, OK frames, the stale
    solves and those written back, and with ``count`` the launches."""
    import numpy as np
    import torch

    import tpuslam_torch.backend.mapping as tmapping

    tag = "loop solver" if seed is None else f"loop solver seed {seed}"
    cam, scene, frames = make_loop_frames()
    if seed is not None:
        frames = noisy_loop_frames(frames, seed)
    sys_ = loop_system(cam)
    worker = sys_._ba_worker
    lc, mp_ = sys_.loop_closer, sys_.mapper
    if worker is None or lc.solver is not worker:
        fail(f"{tag}: the System started no solver process, or the loop closer does not use it")
    worker.wait_ready(300.0)
    # each closure's keyframe-map ATE before and after it, and before and
    # after the first local-BA write-back that follows it (what tracking and
    # the write-back each did since); each local-BA request's frame and
    # loops closed at its submit, and its write-backs after a later closure
    # (the invariant: none, the mapper drops them as ba_stale)
    closures, at_submit, at_frame, answered, stale_written = [], {}, {}, [], []
    frame, waited = [0], []
    inner_close, inner_submit, inner_poll, inner_apply = lc._close, worker.submit, worker.poll, tmapping.apply_result

    def close(kf, cand, ev=None):
        pre = kf_map_ate(sys_.map, scene)
        ok = inner_close(kf, cand, ev)
        if ok:
            closures.append([kf.kid, kf.frame_idx, cand, pre, kf_map_ate(sys_.map, scene), None])
        return ok

    def submit(*args, **kwargs):
        req_id = inner_submit(*args, **kwargs)
        at_submit[req_id], at_frame[req_id] = len(lc.closed_loops), frame[0]
        return req_id

    def poll(req_id, timeout=0.0):
        if req_id in at_frame and timeout <= 0:  # the mapper's tick: the fixed schedule
            if frame[0] - at_frame[req_id] < LOOP_SOLVER_LAG:
                return None
            t = time.perf_counter()
            out = inner_poll(req_id, timeout=LOOP_SOLVER_CHILD_S)
            waited.append(time.perf_counter() - t)
            if out is None:
                fail(f"{tag}: the solver gave no answer to local-BA request {req_id} in {LOOP_SOLVER_CHILD_S} s")
        else:  # a drain, or global BA's blocking solve
            out = inner_poll(req_id, timeout=timeout)
        if out is not None and req_id in at_submit:
            answered.append(req_id)
        return out

    def apply(slam_map, *args, **kwargs):
        waiting = [c for c in closures if c[5] is None]
        before = kf_map_ate(slam_map, scene) if waiting else None
        out = inner_apply(slam_map, *args, **kwargs)
        if len(lc.closed_loops) > at_submit[answered[-1]]:
            stale_written.append(answered[-1])
        for c in waiting:
            c[5] = (before, kf_map_ate(slam_map, scene))
        return out

    lc._close, worker.submit, worker.poll, tmapping.apply_result = close, submit, poll, apply
    try:
        if count:
            reset_launches()
        t = time.perf_counter()
        frame_s = []
        for f, (il, ir) in enumerate(frames):
            frame[0] = f
            t1 = time.perf_counter()
            sys_.track_stereo(il, ir, f * 0.05)
            torch.cuda.synchronize()
            frame_s.append(time.perf_counter() - t1)
        launches = read_launches() if count else None
        sys_.shutdown()
        wall = time.perf_counter() - t
    finally:
        tmapping.apply_result = inner_apply
    traj = sys_.trajectory
    ok = [r for r in traj if r.state.name == "OK"]
    final = kf_map_ate(sys_.map, scene)
    kf_s = [dt for r, dt in zip(traj[1:], frame_s[1:]) if r.made_keyframe]
    print(
        f"{tag}: {len(frames)} frames in {wall:.1f} s, OK {len(ok)} (JAX package {JAX_LOOP_OK_FRAMES}), keyframes "
        f"{len(sys_.map.keyframes)}, loops closed {lc.closed_loops}, gba_skipped {lc.gba_skipped}; final keyframe-map ATE "
        f"{final!r} m; local BA submitted {mp_.ba_submitted}, skipped {mp_.ba_skipped}, resubmitted "
        f"{mp_.ba_resubmitted}, stale {mp_.ba_stale} (written back after a closure: {len(stale_written)}), failed "
        f"{mp_.ba_failed}, answered at a lag of {LOOP_SOLVER_LAG} frame(s), {sum(w > 1e-3 for w in waited)} of {len(waited)} "
        f"waited for ({sum(waited) * 1e3:.1f} ms in all); warm solves median "
        f"{statistics.median(mp_.solve_ms) if mp_.solve_ms else float('nan'):.2f} ms, cold {[round(x, 1) for x in mp_.cold_solve_ms]}; "
        f"ms per frame median {statistics.median(frame_s[1:]) * 1e3:.2f}, keyframe frames median "
        f"{statistics.median(kf_s) * 1e3:.2f} on {card}",
        flush=True,
    )
    for rung, ms in mp_.solve_ms_by_rung.items():
        print(f"{tag}: local BA rung {rung}: {len(ms)} warm solves in the solver process, median {statistics.median(ms):.2f} ms", flush=True)
    for ev, rec in zip([e for e in lc.timings if e["closed"]], lc.closures):
        gba = rec.get("gba", {})
        solves = gba.get("solves", [])
        print(f"{tag}: closure at keyframe {ev['kid']}: global BA {ev.get('global_ba_ms', float('nan')):.2f} ms, rung "
              f"{gba.get('rung')}, {len(solves)} rounds through the solver ({', '.join(f'{ms:.2f}' for _, _, ms in solves)} ms in "
              f"the child) on {card}", flush=True)
        if not solves or not all(isinstance(a, dict) and a["poses"].dtype == np.float64 for a, _, _ in solves):
            fail(f"{tag}: the closure at keyframe {ev['kid']} did not solve global BA through the solver in float64")
    for kid, frame_idx, cand, pre, post, after_ba in closures:
        print(f"{tag}: closure of keyframe {kid} (frame {frame_idx}) to keyframe {cand}: keyframe-map ATE {pre:.5f} -> "
              f"{post:.5f} m (global BA included); the next local-BA write-back "
              f"{'none' if after_ba is None else '{:.5f} -> {:.5f} m'.format(*after_ba)}", flush=True)
    if not lc.closed_loops:
        fail(f"{tag}: no loop was closed")
    if stale_written:
        fail(f"{tag}: local-BA requests {stale_written} were assembled before a closure and written back after it")
    if len(ok) < JAX_LOOP_OK_FRAMES - 2:
        fail(f"{tag}: {len(ok)} OK frames, fewer than the JAX package's {JAX_LOOP_OK_FRAMES} - 2")
    if mp_.ba_failed or mp_.ba_submitted < 1 or worker.alive:
        fail(f"{tag}: {mp_.ba_submitted} solves submitted, {mp_.ba_failed} failed; solver alive after shutdown {worker.alive}")
    return dict(ate=final, closures=len(lc.closed_loops), keyframes=len(sys_.map.keyframes), ok=len(ok),
                stale=mp_.ba_stale, stale_written=len(stale_written), launches=launches)


def loop_solver_child() -> int:
    """One of phase 23's noisy loop runs with the solver (loop_solver_run)
    in a process of its own: sys.argv[1] is the noise seed. Its checks hold
    (a failed one exits 1); prints the run's result as the last line."""
    seed = int(sys.argv[1])
    os.environ.update(ASYNC_ENV)
    os.environ["TPUSLAM_NATIVE_MAP"] = "1"  # as main() runs phase 23
    from tpuslam_torch.kernels import cuda_lib

    cuda_lib.library()
    res = loop_solver_run(card_line(), seed=seed)
    res.pop("launches")
    print(json.dumps(res), flush=True)
    return 0


def loop_solver_phase(card):
    """The loop configuration with its solver process (loop_solver_run):
    the noiseless run in this process with the launch counts, the runs of
    LOOP_SOLVER_SEEDS meanwhile each in a process of its own (on the fixed
    schedule a run's result does not depend on its timing); the median
    final keyframe-map ATE of the five within phase 9's bound and within
    the JAX package's median on the same frames and schedule x 1.05 +
    0.01 m. Returns the noiseless run's launches."""
    import threading

    import torch

    t = time.perf_counter()
    box = {}
    pool = threading.Thread(target=lambda: box.update(done=run_children(
        "loop_solver_child", [str(k) for k in LOOP_SOLVER_SEEDS], len(LOOP_SOLVER_SEEDS), LOOP_SOLVER_CHILD_S)))
    pool.start()
    try:
        res = loop_solver_run(card, count=True)
    finally:
        pool.join()
    runs = [res]
    for seed, proc in zip(LOOP_SOLVER_SEEDS, box["done"]):
        for line in proc.stdout.strip().splitlines()[:-1]:
            print(line, flush=True)
        if proc.returncode != 0:
            print(proc.stdout.strip().splitlines()[-1:], proc.stderr[-4000:], flush=True)
            fail(f"loop solver seed {seed}: its process ended with code {proc.returncode}")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    ates = [r["ate"] for r in runs]
    med, jmed = statistics.median(ates), statistics.median(JAX_LOOP_LAG1_KF_ATES_M)
    bound9 = JAX_LOOP_KF_ATE_M * LOOP_KF_ATE_FACTOR + ATE_MARGIN_M
    bound = jmed * LOOP_KF_ATE_FACTOR + ATE_MARGIN_M
    print(f"loop solver: noiseless and noise seeds {list(LOOP_SOLVER_SEEDS)} at a lag of {LOOP_SOLVER_LAG} frame(s): final "
          f"keyframe-map ATE {ates}, median {med!r} m; closures {[r['closures'] for r in runs]}, keyframes "
          f"{[r['keyframes'] for r in runs]}, OK frames {[r['ok'] for r in runs]}, stale {[r['stale'] for r in runs]}, written "
          f"back after a closure {[r['stale_written'] for r in runs]}; the JAX package's {list(JAX_LOOP_LAG1_KF_ATES_M)}, median "
          f"{jmed!r} m; bounds: phase 9's {bound9:.5f} m, the JAX median's {bound:.5f} m (x {LOOP_KF_ATE_FACTOR} + "
          f"{ATE_MARGIN_M}); {time.perf_counter() - t:.1f} s on {card}", flush=True)
    if not med <= bound9:
        fail(f"loop solver: median final keyframe-map ATE {med} m above phase 9's bound {bound9} m")
    if not med <= bound:
        fail(f"loop solver: median final keyframe-map ATE {med} m above {bound} m")
    calls, device = res["launches"]
    want_lpc = launches_per_call()
    for name in PER_FRAME:
        if calls[name] == 0 or device[name] != calls[name] * want_lpc[name]:
            fail(f"loop solver: {name}: {calls[name]} calls, {device[name]} device launches")
    torch.cuda.synchronize()
    return res["launches"]


def async_phase(card, sync_cli, sync_hybrid, async_seeds):
    """Phase 23: the solver check, the bench in the JAX bench's on-chip
    configuration (solver process, deferred fusion): the CLI run (the
    JAX bench's noise stream) and the hybrid run of seed 0 alone in this
    process, each beside phase 22's synchronous run on the same frames;
    lines only over noise seeds 0-4 (``async_seeds``, run in child
    processes in phase 22's pool), the median ATE within phase 22's bound;
    then the loop configuration with its solver and the tracking chunk's
    device time with solves in flight. Returns the launches of the CLI run,
    the hybrid run and the loop run."""
    t0 = time.perf_counter()
    os.environ.update(ASYNC_ENV)
    solver_check(card)
    os.environ.pop("TPUSLAM_BENCH_POINTS", None)
    cli_res, cli_launches = bench100_run("async cli", card, PER_EXTRACTION, via_cli=True, devfeed=False)
    os.environ["TPUSLAM_BENCH_POINTS"] = "1"
    hybrid_res, hybrid_launches = bench100_run("async hybrid seed 0", card, PER_EXTRACTION_HYBRID, noise_seed=0, devfeed=False)
    os.environ.pop("TPUSLAM_BENCH_POINTS", None)
    os.environ.pop("TPUSLAM_BENCH_DEVFEED", None)
    for tag, sync, asyn in (("lines, the CLI run", sync_cli, cli_res), ("hybrid, seed 0", sync_hybrid, hybrid_res)):
        row = lambda r: (f"fps_wall {r['fps_wall']:.2f}, fps_median {r['fps_median']:.2f}, largest call with a keyframe event "  # noqa: E731
                         f"{max(r['keyframe_call_ms'], default=float('nan')):.2f} ms, local_ba_ms {r['local_ba_ms']:.2f}, "
                         f"{r['ba_submitted']} solves, ATE {r['ate_rmse']:.5f} m")
        print(f"async: {tag}: synchronous (phase 22) {row(sync)}; asynchronous {row(asyn)} on {card}", flush=True)
    ates = [async_seeds[k]["ate_rmse"] for k in BENCH100_SEEDS]
    med, jmed = statistics.median(ates), statistics.median(JAX_BENCH100_SEED_ATES_M)
    bound = jmed * BENCH100_ATE_FACTOR + ATE_MARGIN_M
    print(f"async: ATE over noise seeds {list(BENCH100_SEEDS)} {ates}, median {med:.5f} m (synchronous, phase 22: see "
          f"above); the JAX package's median {jmed:.5f} m; bound {bound:.5f} m", flush=True)
    if not med <= bound:
        fail(f"async: median ATE {med} m above {bound} m")
    loop_launches = loop_solver_phase(card)
    async_profile_phase(card)
    os.environ.update(SYNC_ENV)
    print(f"async: phase {time.perf_counter() - t0:.1f} s on {card}", flush=True)
    return cli_launches, hybrid_launches, loop_launches


def main() -> int:
    t_start = time.perf_counter()
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

    laps = [time.perf_counter()]

    def lap(what: str) -> None:
        laps.append(time.perf_counter())
        print(f"wall: {what} {laps[-1] - laps[-2]:.1f} s, {laps[-1] - t_start:.1f} s since the start", flush=True)

    cam, scene, frames = make_frames()
    kres = kernel_phase(frames, card)
    lap("phase 3 kernels")

    # phases 4-21 hold the port to JAX references taken with the JAX map's
    # native mirror off, so the port's mirror is off there too; phases 1-22
    # solve in this process and fuse at the keyframe (phase 23 does not)
    os.environ["TPUSLAM_NATIVE_MAP"] = "0"
    os.environ.update(SYNC_ENV)

    slice_sys, slice_launches = run_slice("slice", cam, scene, frames, card, mapping=False, jax_ate=JAX_ATE_M)
    lap("phase 4 slice")
    profile_phase(cam, frames, card)
    lap("phase 4 profile")
    sys_, map_launches = run_slice("mapping", cam, scene, frames, card, mapping=True, jax_ate=JAX_MAPPING_ATE_M)
    lap("phase 5 mapping")
    ba_phase(sys_, cam, card)
    lap("phase 6 BA")
    reloc_phase(sys_, scene, frames)
    lap("phase 7 relocalization")
    bench_launches, bench_traj = bench_phase(cam, scene, frames, card)
    lap("phase 8 bench")
    repeat_phase(cam, frames, bench_traj)
    lap("phase 8 repeat")
    bench_profile_phase(cam, frames, card)
    lap("phase 8 profile")
    _, dot_scene_, dot_frames = make_frames(draw_points=True)
    hybrid_launches, _ = bench_phase(cam, dot_scene_, dot_frames, card, points=True)
    lap("phase 9 hybrid bench")
    bench_profile_phase(cam, dot_frames, card, points=True)
    lap("phase 9 profile")
    loop_launches = loop_phase(card)
    lap("phase 9 loop")
    mono_launches, mono_lines_launches, mono_lines_sys = mono_phase(card)
    lap("phase 10 mono")
    mono_loop_launches = mono_loop_phase(card)
    lap("phase 11 mono loop")
    forms = pipelined_phases(card, cam, scene, frames, slice_sys)
    lap("phase 12-17 pipelined forms")
    pmono_launches = pipelined_mono_phase(card, mono_lines_sys)
    lap("phase 18 pipelined mono")
    radtan_launches = radtan_phase(card)
    lap("phase 19 radtan")
    multi_kres, multi_launches, split_launches = multi_phase(card)
    lap("phase 20 config #5")
    cli_launches = cli_phase(card)
    lap("phase 21 host surface")
    os.environ["TPUSLAM_NATIVE_MAP"] = "1"  # phase 22 runs with the mirror on, the JAX bench's default
    bench100_launches, bench100_hybrid_launches, sync_cli, sync_hybrid, async_seeds = bench100_phase(card)
    lap("phase 22 bench (and phase 23's seed runs)")
    async_launches, async_hybrid_launches, loop_solver_launches = async_phase(card, sync_cli, sync_hybrid, async_seeds)
    lap("phase 23 asynchronous back end")
    new_paths = {tag.replace(" ", "_"): launches[0] for tag, (launches, _) in forms.items()}
    new_paths.update(pipelined_mono=pmono_launches[0], radtan=radtan_launches[0], cli=cli_launches[0])

    calls, device = mono_launches  # this slice's path: mono (hybrid, the mode BASELINE.md recommends)
    kernels = [
        dict(
            name=name,
            route="cuda",
            source=KERNELS[name][0],
            replaces=KERNELS[name][1],
            launches=calls[name],
            launches_per_call=device[name] // calls[name],  # exact: the mono phase held it
            launches_by_path={
                "slice": slice_launches[0][name], "mapping": map_launches[0][name], "bench": bench_launches[0][name],
                "bench_hybrid": hybrid_launches[0][name], "loop": loop_launches[0][name], "mono": calls[name],
                "mono_lines": mono_lines_launches[0][name], "mono_loop": mono_loop_launches[0][name],
                **{path: calls_[name] for path, calls_ in new_paths.items()},
                "bench100": bench100_launches[0][name], "bench100_hybrid": bench100_hybrid_launches[0][name],
                "bench100_async": async_launches[0][name], "bench100_async_hybrid": async_hybrid_launches[0][name],
                "loop_solver": loop_solver_launches[0][name],
            },
            **kres[name],
        )
        for name in PER_FRAME
    ]
    # the resize's prefilter: one blur call per image extraction of the
    # hostscale phase beside the pyramid's
    hs_launches, hs_sys = forms["hostscale"]
    n_resize = hs_launches[0]["blur"] - hs_sys.n_images
    if n_resize != hs_sys.n_images:
        fail(f"hostscale: {n_resize} resize blur calls for {hs_sys.n_images} image extractions")
    kernels.append(
        dict(
            name="blur.resize", route="cuda", source=KERNELS["blur"][0], replaces=KERNELS["blur"][1], launches=n_resize,
            launches_per_call=hs_launches[1]["blur"] // hs_launches[0]["blur"], launches_by_path={"hostscale": n_resize, "cli": cli_launches[0]["blur"] - PER_FRAME["blur"] * CLI_FRAMES},
            **kres["blur.resize"],
        )
    )
    # the batched forms (phase 20), one launch for N images, launched on the
    # config-#5 path
    for name in PER_FRAME:
        kernels.append(
            dict(
                name=f"{name}.batch", route="cuda", source=KERNELS[name][0], replaces=KERNELS[name][1],
                launches=multi_launches[0][f"{name}_batch"],
                launches_per_call=multi_launches[1][f"{name}_batch"] // multi_launches[0][f"{name}_batch"],
                launches_by_path={
                    "multi": multi_launches[0][f"{name}_batch"], "multi_split": split_launches[0][f"{name}_batch"],
                    "cli": cli_launches[0][f"{name}_batch"],
                },
                **multi_kres[name],
            )
        )
    print(
        f"torch.profiler: {TRACES['taken']} traces, {TRACES['again']} taken again; the traces kept lack the device records "
        f"of {TRACES['records_lost']} kernel launches",
        flush=True,
    )
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all on {card}", flush=True)
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
