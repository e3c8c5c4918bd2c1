"""Drivers: the benchmark's hold on the system under test.

A configuration file builds one of these around the port's entry points.
Each hands in a frame per sequence, reports the poses that became
available, flushes, and records by reference what the comparison judges
besides the poses: the front end's detections of each frame and the
local-BA windows solved, each with the answer the program wrote back.
Nothing is copied or read back while the window runs.
"""

from __future__ import annotations

from typing import List, Tuple


class BACapture:
    """Local-BA windows solved in this process while ``on``, each with the
    program's answer."""

    def __init__(self):
        self.on = False
        self.records: List[Tuple[object, dict]] = []  # (problem, result)
        self._restore = []

    def watch_in_process(self) -> None:
        from tpuslam_torch.backend import local_ba

        solve = local_ba.solve_in_process

        def rec_solve(prob, *a, **k):
            res = solve(prob, *a, **k)
            if self.on:
                self.records.append((prob, res))
            return res

        local_ba.solve_in_process = rec_solve
        self._restore.append(lambda: setattr(local_ba, "solve_in_process", solve))

    def windows(self):
        """[(arrays dict, result dict)] in numpy."""
        return [({f: getattr(p, f).detach().cpu().numpy() for f in p._fields}, res) for p, res in self.records]

    def close(self) -> None:
        for undo in self._restore:
            undo()
        self._restore.clear()


class DetCapture:
    """The line detector's outputs while ``on``, by frame handed in:
    ``records[j]`` lists (input shape, endpoints, valid) of each call in
    call order (per camera batch, one call per pyramid level)."""

    def __init__(self):
        self.on = False
        self.frame = -1
        self.records = {}
        self._restore = []

    def watch(self) -> None:
        from tpuslam_torch.frontend import frame

        detect = frame.detect_lines

        def rec_detect(img, *a, **k):
            det = detect(img, *a, **k)
            if self.on:
                self.records.setdefault(self.frame, []).append((tuple(img.shape), det.endpoints, det.valid))
            return det

        frame.detect_lines = rec_detect
        self._restore.append(lambda: setattr(frame, "detect_lines", detect))

    def close(self) -> None:
        for undo in self._restore:
            undo()
        self._restore.clear()


class MultiDriver:
    """N stereo streams through ``MultiTracker.track_stereo``, one frame of
    each per call, every pose available when the call returns."""

    def __init__(self, tracker, device):
        self.mt = tracker
        self.device = device
        self.n_seq = len(tracker.cams)
        self.ba = BACapture()
        self.ba.watch_in_process()
        self.det = DetCapture()
        self.det.watch()

    def _mappers(self):
        return [tr.on_new_keyframe.__self__ for tr in self.mt.trackers if tr.on_new_keyframe is not None]

    def step(self, lefts, rights, t: float, j: int):
        self.det.frame = j
        rs = self.mt.track_stereo(lefts, rights, [t] * self.n_seq)
        return list(enumerate(rs))

    def flush(self):
        return []

    def record(self, on: bool) -> None:
        self.ba.on = self.det.on = on

    def sync(self) -> None:
        if self.device.type == "cuda":
            import torch

            torch.cuda.synchronize(self.device)

    def solve_ms(self) -> List[float]:
        return [ms for m in self._mappers() for ms in m.solve_ms]

    def shutdown(self) -> None:
        self.ba.close()
        self.det.close()
