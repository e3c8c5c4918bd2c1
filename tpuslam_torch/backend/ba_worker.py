"""Persistent local-BA solver process (torch).

Counterpart of ``tpuslam.backend.ba_worker``. The reference runs local
mapping on a background thread whose solves never touch the tracking
thread. Here the LM+Schur solve runs in a child process on the System's
card: a solve is some 600 kernel launches per LM iteration, each paid on
the host, and host threads of one interpreter serialize on its lock, so a
solver thread would take its host time from the tracking thread; a process
has an interpreter of its own. Without MPS the two processes' kernels
time-slice the card.

- The parent does all map bookkeeping (window assembly, write-back,
  pruning), so mapping semantics stay those of the synchronous path; the
  child only solves (``local_ba.solve_arrays``).
- The problem travels as numpy arrays over a pipe (~1-2 MB per keyframe),
  the result the same way back.
- ``warm_caps`` (TPUSLAM_BA_WARM_CAPS, "P,L,OL;P,L,OL;...") name the
  (P, L, OL) rungs the child solves a toy problem at once it is up, so the
  first real solve does not pay cuBLAS and cuSOLVER set-up
  (TPUSLAM_BA_WORKER_WARMUP=0 leaves them out; ``pretouch`` does the same
  on request). The JAX package runs these in a throwaway warmer process
  that fills an XLA compile cache; there is no such cache here, so the
  warmer and its ``wait_warm`` / ``stop_warmer`` are not carried over.

Protocol: every request carries a client-assigned id and every response
echoes it. The client matches responses to ids and stashes out-of-order
arrivals, so a blocking :meth:`BASolverWorker.solve` (global BA at a loop
closure) can never consume the result of an in-flight :meth:`submit`
(local BA). All pipe sends go through one writer lock: a ~2 MB problem
exceeds the pipe's buffer, so two unlocked sends would interleave.

The child is started with multiprocessing's "spawn" (CUDA does not survive
a fork of a process that has initialised it) and imports ``torch`` and
this package (whose import sets the float32 pins), never JAX. A child that
cannot open its device, dies, or answers with an error raises in the
parent (``wait_ready``, ``poll``, ``solve``); it never falls back to
solving in the parent.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import threading
import time
from typing import Optional, Tuple

import numpy as np
import torch

from tpuslam_torch.device import resolve_device

# the diagonal rungs of LocalBAConfig's bucket lists, the JAX worker's default
DEFAULT_WARM = ((8, 128, 512), (16, 256, 1024), (24, 512, 2048), (24, 1024, 4096))


def parse_caps(text: str):
    """(P, L, OL) rungs from "P,L,OL;P,L,OL;..."."""
    return tuple(tuple(int(x) for x in part.split(",")) for part in text.split(";") if part.strip())


def _toy_solve(cam, rung, lm, chi2_line, chi2_point, device, seen: set):
    """``parallel.sharded_ba._toy_problem`` at ``rung`` solved through the
    real path (numpy in, ``solve_arrays``) twice, its bucket added to
    ``seen``: (first ms, second ms)."""
    from tpuslam_torch.backend.local_ba import problem_arrays, solve_arrays
    from tpuslam_torch.parallel.sharded_ba import _toy_problem

    P_, L_, OL_ = rung
    arrays = problem_arrays(_toy_problem(np.random.default_rng(0), P_=P_, L=L_, OL=OL_, cam=cam, device="cpu"))
    t0 = time.perf_counter()
    solve_arrays(arrays, cam, lm, chi2_line, chi2_point, device)
    t1 = time.perf_counter()
    solve_arrays(arrays, cam, lm, chi2_line, chi2_point, device)
    seen.add(_bucket_key(arrays, lm))
    return (t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3


def _bucket_key(arrays, lm) -> tuple:
    return tuple((f, np.shape(v), str(np.asarray(v).dtype)) for f, v in sorted(arrays.items())), repr(lm)


def _worker_main(conn, cam_tuple, device: str, warm_caps, n_threads: int):
    """The child: open ``device``, say ready, solve the warm rungs, then
    serve requests until the pipe closes or a None arrives."""
    from tpuslam_torch.backend.local_ba import LocalBAConfig, solve_arrays
    from tpuslam_torch.geometry.camera import Intrinsics

    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
            torch.zeros(1, device=dev).cpu()  # the context opens here
        else:
            torch.set_num_threads(n_threads)
    except Exception as e:  # reported by the parent's wait_ready
        conn.send(("err", -1, f"the BA solver process could not open {device}: {e!r}"))
        return
    conn.send(("ready", -1, None))
    cam = Intrinsics(*cam_tuple)
    ba = LocalBAConfig()
    seen = set()  # bucket keys solved by this incarnation
    for rung in warm_caps:
        _toy_solve(cam, rung, ba.lm, ba.chi2_line, ba.chi2_point, dev, seen)
        conn.send(("warmed", -1, tuple(rung)))
    while True:
        try:
            msg = conn.recv()
        except EOFError:
            return
        if msg is None:
            return
        kind, req_id, payload = msg
        try:
            if kind == "pretouch":
                rung, lm, chi2_line, chi2_point = payload
                first_ms, steady_ms = _toy_solve(cam, rung, lm, chi2_line, chi2_point, dev, seen)
                conn.send(("ok", req_id, {"pretouch_ms": first_ms, "steady_ms": steady_ms}))
            elif kind == "solve":
                arrays, lm, chi2_line, chi2_point = payload
                key = _bucket_key(arrays, lm)
                res = solve_arrays(arrays, cam, lm, chi2_line, chi2_point, dev)
                res["warm"] = key in seen  # False: the first solve of this bucket in this process
                seen.add(key)
                conn.send(("ok", req_id, res))
        except Exception as e:  # surfaced to the parent
            conn.send(("err", req_id, repr(e)))


class BASolverWorker:
    """Client handle of the persistent solver process on ``device`` (the
    System's card; ``device="cpu"`` runs the same child on the CPU)."""

    def __init__(self, cam, warm_caps=DEFAULT_WARM, device="cuda"):
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        env_caps = os.environ.get("TPUSLAM_BA_WARM_CAPS")
        if env_caps is not None:
            warm_caps = parse_caps(env_caps)
        self.device = dev
        self._ctor = (tuple(cam), tuple(tuple(int(x) for x in r) for r in warm_caps))
        self._spawn()

    def _spawn(self):
        cam, warm_caps = self._ctor
        warm = warm_caps if os.environ.get("TPUSLAM_BA_WORKER_WARMUP", "1") == "1" else ()
        ctx = mp.get_context("spawn")
        self._conn, child = ctx.Pipe()
        self._proc = ctx.Process(
            target=_worker_main, args=(child, cam, str(self.device), warm, torch.get_num_threads()), daemon=True
        )
        self._proc.start()
        child.close()
        self._ready = False
        self.n_warmed = 0  # warm rungs the child has solved
        self._send_lock = threading.Lock()
        self._next_id = 0
        self._stash: dict = {}  # req_id -> (kind, payload) received out of order

    @property
    def warm_caps(self):
        """The (P, L, OL) rungs this worker warms."""
        return self._ctor[1]

    def restart(self):
        """Stop and start the child again (after an abandoned drain: a late
        result of the old child cannot be paired with a new request, its pipe
        dies with it)."""
        self.close()
        self._spawn()

    def _recv(self):
        try:
            return self._conn.recv()
        except (EOFError, OSError):
            self._proc.join(timeout=5.0)
            raise RuntimeError(f"the BA solver process exited (exit code {self._proc.exitcode})") from None

    def wait_ready(self, timeout: float = 1800.0):
        """Block until the child has opened its device; raises if it could
        not, died or took longer than ``timeout`` s."""
        deadline = time.monotonic() + timeout
        while not self._ready:
            if not self._conn.poll(max(deadline - time.monotonic(), 0.0)):
                raise TimeoutError(f"the BA solver process did not come up in {timeout} s")
            try:
                kind, _, payload = self._recv()
            except RuntimeError as e:
                raise RuntimeError(
                    f"{e} during start-up. A script that builds a System at module top level must guard its entry "
                    "point with `if __name__ == '__main__':`: the solver process is spawned, which imports the main "
                    "module again; or set TPUSLAM_BA_SUBPROCESS=0 to solve in this process"
                ) from None
            if kind == "err":
                raise RuntimeError(payload)
            self._ready = kind == "ready"

    def _send_async(self, msg):
        """Send on a writer thread, under the one lock: a send larger than
        the pipe's buffer blocks until the child reads, which must not stall
        the tracking thread, and two sends must not interleave."""

        def locked_send():
            with self._send_lock:
                try:
                    self._conn.send(msg)
                except (OSError, ValueError):
                    pass  # the child is gone: the next receive raises

        t = threading.Thread(target=locked_send, daemon=True)
        t.start()
        return t

    def _request(self, kind: str, payload, timeout: float) -> int:
        self.wait_ready(timeout)
        self._next_id += 1
        self._send_async((kind, self._next_id, payload))
        return self._next_id

    def _recv_matching(self, req_id: int, timeout: float):
        """The response to ``req_id`` as (kind, payload), or None after
        ``timeout`` s; responses to other ids are stashed."""
        if req_id in self._stash:
            return self._stash.pop(req_id)
        deadline = time.monotonic() + timeout
        while True:
            if not self._conn.poll(max(deadline - time.monotonic(), 0.0)):
                return None
            kind, rid, payload = self._recv()
            if kind == "warmed":
                self.n_warmed += 1
                continue
            if kind == "ready":
                self._ready = True
                continue
            if rid == req_id:
                return kind, payload
            self._stash[rid] = (kind, payload)
            if time.monotonic() >= deadline:
                return None

    def pretouch(self, bucket, lm_cfg, chi2_line: float, chi2_point: float, timeout: float = 300.0) -> Optional[float]:
        """Blocking: a toy solve at the (P, L, OL) ``bucket`` in the child
        (result dropped). Returns its wall ms, None on timeout."""
        out = self.pretouch_wait(self.pretouch_async(bucket, lm_cfg, chi2_line, chi2_point, timeout), timeout)
        return None if out is None else out[0]

    def pretouch_async(self, bucket, lm_cfg, chi2_line: float, chi2_point: float, timeout: float = 300.0) -> int:
        """Enqueue a pretouch; returns the request id for :meth:`pretouch_wait`."""
        P_, L_, OL_ = bucket
        return self._request("pretouch", ((int(P_), int(L_), int(OL_)), lm_cfg, float(chi2_line), float(chi2_point)), timeout)

    def pretouch_wait(self, req_id: int, timeout: float = 300.0):
        """(first ms, second ms) of a pretouch's two toy solves, None on
        timeout; raises the child's error."""
        out = self._recv_matching(req_id, timeout)
        if out is None:
            return None
        kind, payload = out
        if kind != "ok":
            raise RuntimeError(f"BA solver pretouch failed: {payload}")
        return float(payload["pretouch_ms"]), float(payload["steady_ms"])

    # ---- the LocalMapper's asynchronous path ------------------------------
    def submit(self, prob_arrays: dict, lm_cfg, chi2_line: float, chi2_point: float) -> int:
        """Non-blocking: enqueue a solve of ``prob_arrays``
        (``local_ba.problem_arrays``); returns the request id to poll."""
        return self._request("solve", (prob_arrays, lm_cfg, float(chi2_line), float(chi2_point)), 1800.0)

    def poll(self, req_id: int, timeout: float = 0.0):
        """Result of solve ``req_id``: (result dict, None), (None, error), or
        None while it runs."""
        out = self._recv_matching(req_id, timeout)
        if out is None:
            return None
        kind, payload = out
        return (payload, None) if kind == "ok" else (None, str(payload))

    def solve(self, prob_arrays: dict, lm_cfg, chi2_line: float, chi2_point: float,
              timeout: float = 1800.0) -> Tuple[Optional[dict], Optional[str]]:
        """Blocking solve: (result dict, None) or (None, error). Safe while a
        :meth:`submit` is in flight: the child answers in order, and an
        earlier response is stashed for its own :meth:`poll`."""
        req_id = self._request("solve", (prob_arrays, lm_cfg, float(chi2_line), float(chi2_point)), timeout)
        out = self.poll(req_id, timeout)
        return (None, f"the BA solver process gave no result in {timeout} s") if out is None else out

    @property
    def alive(self) -> bool:
        return self._proc.is_alive()

    def close(self):
        """Ask the child to exit, wait up to 10 s, then terminate it."""
        try:
            if self._proc.is_alive():
                with self._send_lock:
                    self._conn.send(None)
                self._proc.join(timeout=10.0)
        except (OSError, ValueError):
            pass
        if self._proc.is_alive():
            self._proc.terminate()
            self._proc.join(timeout=5.0)
        self._conn.close()

    def __del__(self):
        if getattr(self, "_proc", None) is not None:
            self.close()
