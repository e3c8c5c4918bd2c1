"""One process per mesh entry (config #5's split) (torch).

The port is host-bound: a batched frame enqueues ~10,800 launches from the
host, and threads of one interpreter serialize on its lock. So a mesh of k
entries runs its shards in k processes, each with an interpreter and a
current device of its own, as the JAX package's one sharded program runs on
each of its mesh's chips.

- :class:`ShardPool` starts one child per mesh entry with multiprocessing's
  "spawn" (CUDA does not survive a fork of a process that has initialised
  it). An entry may repeat a card: ``(cuda:0, cuda:0)`` gives two processes
  on one card, whose kernels take turns on it. Each child makes its entry's
  device current and takes the parent's ``torch.get_num_threads()`` (the
  CPU's float results depend on the thread count). The kernel library is
  built in the parent before the spawn; each child only loads it.
- A request is a module-level function with picklable arguments (numpy
  arrays, configs): ``fn(ctx, *args)`` runs in the child with its
  :class:`ShardContext`, whose ``objects`` keep state between requests
  (a shard's trackers and mappers). :meth:`ShardPool.run` sends every
  shard's request before it reads any reply, and returns the replies in
  shard order.
- Failures are visible. A child's exception is raised in the parent, with
  a note naming the shard, its device and the child's traceback. A child
  that dies, or does not answer within the timeout, raises in the parent,
  which then ends every child of the pool. Nothing falls back to threads,
  to the calling process or to the CPU.
- :func:`pool_of` keeps one pool per mesh, started at its first use and
  reused for the mesh's life; ``DeviceMesh.close()`` (:func:`close_pool`)
  and the interpreter's exit end its children. A child inherits the
  environment as it was when the pool started.

A script that drives a split must guard its entry point with
``if __name__ == "__main__":``: spawn imports the main module again.
"""

from __future__ import annotations

import atexit
import multiprocessing as mp
import pickle
import threading
import time
import traceback
from typing import Callable, Dict, List, Sequence

import torch

DEFAULT_TIMEOUT = 900.0  # s a request may take before its shard counts as hung
START_TIMEOUT = 300.0  # s for a child to import the package and open its device


class ShardContext:
    """What a request sees in its child: the shard's index and device, and
    ``objects``, the state requests leave there by handle."""

    def __init__(self, index: int, device: torch.device):
        self.index = index
        self.device = device
        self.objects: Dict[int, object] = {}


def _child_main(conn, index: int, device: str, n_threads: int) -> None:
    """A shard process: open ``device``, say ready, then serve requests until
    the pipe closes or a None arrives."""
    try:
        torch.set_num_threads(n_threads)
        dev = torch.device(device)
        if dev.type == "cuda":
            from tpuslam_torch.kernels import cuda_lib

            torch.cuda.set_device(dev)
            torch.zeros(1, device=dev).cpu()  # the context opens here
            cuda_lib.library()  # built by the parent: loaded here
    except Exception:  # reported by the parent's start-up
        conn.send(("err", -1, (None, traceback.format_exc())))
        return
    conn.send(("ready", -1, None))
    ctx = ShardContext(index, dev)
    while True:
        try:
            msg = conn.recv()
        except (EOFError, OSError):
            return
        if msg is None:
            return
        req_id, fn, args = msg
        try:
            reply = ("ok", req_id, fn(ctx, *args))
        except BaseException as e:  # noqa: BLE001 -- raised again in the parent
            text = traceback.format_exc()
            try:
                pickle.loads(pickle.dumps(e))
            except Exception:
                e = RuntimeError(repr(e))
            reply = ("err", req_id, (e, text))
        conn.send(reply)


def _indexed(dev: torch.device) -> torch.device:
    """A CUDA device without an index as the current card."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class ShardFailed(RuntimeError):
    """A shard process died, hung or could not start."""


class ShardPool:
    """One child process per entry of ``devices``."""

    def __init__(self, devices: Sequence[torch.device], timeout: float = DEFAULT_TIMEOUT):
        self.devices = tuple(_indexed(torch.device(d)) for d in devices)
        self.timeout = timeout
        self._next_id = 0
        self._lock = threading.Lock()  # one request round at a time
        self.closed = False
        if any(d.type == "cuda" for d in self.devices):
            from tpuslam_torch.kernels import cuda_lib

            cuda_lib.library()  # built once here, before any child loads it
        ctx = mp.get_context("spawn")
        self._conns, self._procs = [], []
        n_threads = torch.get_num_threads()
        t0 = time.perf_counter()
        for s, dev in enumerate(self.devices):
            parent, child = ctx.Pipe()
            p = ctx.Process(target=_child_main, args=(child, s, str(dev), n_threads), daemon=True, name=f"shard-{s}")
            p.start()
            child.close()
            self._conns.append(parent)
            self._procs.append(p)
        self.start_seconds: List[float] = []
        try:
            for s in range(len(self.devices)):
                kind, _, payload = self._receive(s, START_TIMEOUT, "start-up")
                if kind == "err":
                    raise ShardFailed(f"shard {s} could not open {self.devices[s]}:\n{payload[1]}")
                self.start_seconds.append(time.perf_counter() - t0)
        except BaseException:
            self._close_locked(wait=0.0)
            raise

    @property
    def pids(self) -> List[int]:
        return [p.pid for p in self._procs]

    def _receive(self, s: int, timeout: float, what: str):
        """Shard ``s``'s next message; raises ShardFailed when the child dies
        or ``timeout`` s pass first."""
        conn, proc = self._conns[s], self._procs[s]
        deadline = time.monotonic() + timeout
        while not conn.poll(min(max(deadline - time.monotonic(), 0.0), 1.0)):
            if not proc.is_alive() and not conn.poll(0):
                raise ShardFailed(self._dead(s, what))
            if time.monotonic() >= deadline:
                raise ShardFailed(f"shard {s} on {self.devices[s]} gave no answer to {what} within {timeout} s")
        try:
            return conn.recv()
        except (EOFError, OSError):
            raise ShardFailed(self._dead(s, what)) from None

    def _dead(self, s: int, what: str) -> str:
        self._procs[s].join(timeout=5.0)
        text = (f"shard {s}'s process on {self.devices[s]} exited (exit code {self._procs[s].exitcode}) during {what}")
        if what == "start-up":
            text += (". A script that drives a split must guard its entry point with `if __name__ == '__main__':`: "
                     "the shard processes are spawned, which imports the main module again")
        return text

    def run(self, fn: Callable, args: Sequence[tuple]) -> list:
        """``[fn(ctx_s, *args[s]) for each shard s]``, each in its shard's
        process: every request is sent before any reply is read, and the
        replies come back in shard order. The first failing shard's
        exception (in shard order) is raised once every shard has answered;
        a dead shard, or one that gives no answer within ``timeout`` s,
        raises ShardFailed and ends the pool."""
        if len(args) != len(self.devices):
            raise ValueError(f"{len(args)} requests for {len(self.devices)} shards")
        with self._lock:
            if self.closed:
                raise ShardFailed("the shard processes were closed")
            self._next_id += 1
            req = self._next_id
            try:
                for s, a in enumerate(args):
                    try:
                        self._conns[s].send((req, fn, tuple(a)))
                    except (OSError, ValueError, BrokenPipeError):
                        raise ShardFailed(self._dead(s, f"{fn.__name__}")) from None
                deadline = time.monotonic() + self.timeout
                replies = []
                for s in range(len(self.devices)):
                    kind, rid, payload = self._receive(s, max(deadline - time.monotonic(), 0.0), fn.__name__)
                    if rid != req:
                        raise ShardFailed(f"shard {s} answered request {rid} to request {req}")
                    replies.append((kind, payload))
            except ShardFailed:
                self._close_locked(wait=0.0)
                raise
        for s, (kind, payload) in enumerate(replies):
            if kind == "err":
                exc, text = payload
                exc.add_note(f"in shard {s} of {len(self.devices)}, on {self.devices[s]}; the shard's traceback:\n{text}")
                raise exc
        return [payload for _, payload in replies]

    def close(self) -> None:
        """Ask every child to exit, wait up to 10 s, then terminate it."""
        with self._lock:
            self._close_locked()

    def _close_locked(self, wait: float = 10.0) -> None:
        """Ask every child to exit and wait ``wait`` s for it, then terminate
        it (at once after a failure: a hung child would not read the ask)."""
        self.closed = True
        for conn, proc in zip(self._conns, self._procs):
            if proc.is_alive():
                try:
                    conn.send(None)
                except (OSError, ValueError):
                    pass
        for conn, proc in zip(self._conns, self._procs):
            proc.join(timeout=wait)
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=5.0)
            if proc.is_alive():
                proc.kill()
                proc.join()
            conn.close()

    def __del__(self):
        if getattr(self, "_procs", None) is not None and not self.closed:
            self._close_locked()


_POOLS: Dict[object, ShardPool] = {}
_POOLS_LOCK = threading.Lock()


def _key(mesh) -> tuple:
    return tuple(_indexed(torch.device(d)) for d in mesh.devices), mesh.axis


def pool_of(mesh) -> ShardPool:
    """The running pool of ``mesh`` (a ``DeviceMesh`` of several entries),
    started at its first use, or again after it was closed."""
    with _POOLS_LOCK:
        pool = _POOLS.get(_key(mesh))
        if pool is None or pool.closed:
            pool = _POOLS[_key(mesh)] = ShardPool(mesh.devices)
        return pool


def close_pool(mesh) -> None:
    """End ``mesh``'s shard processes, if it has any."""
    with _POOLS_LOCK:
        pool = _POOLS.pop(_key(mesh), None)
    if pool is not None:
        pool.close()


@atexit.register
def close_all() -> None:
    """End every pool's shard processes."""
    with _POOLS_LOCK:
        pools = list(_POOLS.values())
        _POOLS.clear()
    for pool in pools:
        pool.close()
