"""What a run records besides the host stamps: a ``torch.profiler`` trace
of a span of the window read from its raw records (the reader of
``chip_smoke.trace_records``, copied), the card's kernels alone with
``--trace 0``; and with ``--trace 1`` the host's ops in that trace too and
the hand kernels' calls with their shapes (around
``kernels.cuda_lib.launch``)."""

from __future__ import annotations

import time
from typing import Dict, List, Optional

# the runtime calls in which the host waits for the card
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy")
COPIES = ("Memcpy", "Memset")


class LaunchRecorder:
    """Records (C entry point, shape of its first tensor, integer arguments)
    of every hand-kernel call while active."""

    def __init__(self):
        self.calls: List[tuple] = []
        self.on = False

    def __enter__(self):
        from tpuslam_torch.kernels import cuda_lib

        self._mod, self._orig = cuda_lib, cuda_lib.launch

        def launch(entry, t, what, *args):
            if self.on:
                self.calls.append((entry, tuple(t.shape), tuple(a for a in args if isinstance(a, int))))
            return self._orig(entry, t, what, *args)

        cuda_lib.launch = launch
        return self

    def __exit__(self, *exc):
        self._mod.launch = self._orig
        return False


class Profile:
    """A torch.profiler span: :meth:`start` and :meth:`stop` around host
    work; :meth:`read` returns the device records, the host ops and the
    host's waits of the span. ``host=False`` leaves the host's ops out (the
    CUDA runtime's calls stay)."""

    def __init__(self, host: bool = True):
        self.host = host
        self.prof = None
        self.t0 = self.t1 = 0.0

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA] if self.host else [ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)

    def read(self) -> Dict:
        """{"device": [(name, start_ns, end_ns)], "host": [(name, start_ns,
        end_ns)], "syncs": the host's waits for the card, "window_s": host
        seconds of the span}."""
        from torch.autograd import DeviceType

        dev, host, n_syncs = [], [], 0
        for e in self.prof.profiler.kineto_results.events():
            name = e.name()
            if e.device_type() == DeviceType.CUDA:
                dev.append((name, e.start_ns(), e.end_ns()))
            else:
                host.append((name, e.start_ns(), e.end_ns()))
                n_syncs += name in SYNC_CALLS
        # the span's own closing synchronize is the profiler's, not the program's
        return {"device": dev, "host": host, "syncs": max(n_syncs - 1, 0), "window_s": self.t1 - self.t0}


def busy_intervals(device: List[tuple]) -> List[tuple]:
    """The union of the device records' intervals, sorted (start, end) ns."""
    out = []
    for _, s, e in sorted(device, key=lambda r: r[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def breakdown(trace: Dict, top: int = 10) -> Dict:
    """The device operations that took the most time, and the longest idle
    gaps between device work, each labelled by the innermost host op active
    at its middle."""
    by_name: Dict[str, float] = {}
    for name, s, e in trace["device"]:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e9
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    busy = busy_intervals(trace["device"])
    gaps = sorted(((b[0] - a[1], a[1], b[0]) for a, b in zip(busy, busy[1:])), reverse=True)[:top]
    host = trace["host"]
    labelled = []
    for dur, s, e in gaps:
        mid = (s + e) // 2
        live = [h for h in host if h[1] <= mid <= h[2]]
        label = min(live, key=lambda h: h[2] - h[1])[0] if live else "no host op"
        labelled.append([label, dur / 1e9])
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": labelled}


def busy_seconds(trace: Dict) -> float:
    return sum(e - s for s, e in busy_intervals(trace["device"])) / 1e9


def kernel_records(trace: Dict, names: Optional[tuple] = None) -> List[tuple]:
    """Device kernel records (no copies), those whose name starts with one
    of ``names`` where given."""
    out = [r for r in trace["device"] if not r[0].startswith(COPIES)]
    if names is not None:
        out = [r for r in out if any(n in r[0] for n in names)]
    return out
