"""Faults planted in the program's timed path underneath the harness, to
show that ``correct`` comes out false for each: ``control.py --fault`` on
the card, ``tests/cpu_cell.py --fault`` on the CPU. Plant one before the
configuration builds the system."""

from __future__ import annotations

FAULTS = ("unchanged", "altered", "ba_unchanged", "half_batch", "det_altered")


def plant(fault: str) -> None:
    """Break the program's timed path:

    - ``unchanged``: every tracking step returns the state it started from
      (the first frame's pose);
    - ``altered``: every 5th pose moved 1 m where it is produced;
    - ``ba_unchanged``: each local-BA solve returns its start;
    - ``half_batch``: half of the batch's sequences left out of each step;
    - ``det_altered``: every 5th segment slot of each detection moved 2 px
      where the detector produces it.
    """
    import numpy as np

    if fault in ("unchanged", "altered"):
        from tpuslam_torch.frontend import tracking

        init = tracking.FrameResult.__init__

        def patched(self, *a, **k):
            init(self, *a, **k)
            if fault == "unchanged":
                self.T_cw = np.eye(4, dtype=np.float32)
            elif self.frame_idx % 5 == 3:
                self.T_cw = self.T_cw.copy()
                self.T_cw[:3, 3] += 1.0

        tracking.FrameResult.__init__ = patched
    elif fault == "ba_unchanged":
        from tpuslam_torch.backend import local_ba
        from tpuslam_torch.geometry.plucker import plucker_normalize

        solve = local_ba.solve_in_process

        def patched_solve(prob, *a, **k):
            res = solve(prob, *a, **k)
            res["poses"] = prob.poses.cpu().numpy()
            res["lines"] = plucker_normalize(prob.lines).cpu().numpy()
            return res

        local_ba.solve_in_process = patched_solve
    elif fault == "half_batch":
        from tpuslam_torch.parallel import multi_seq

        track = multi_seq.MultiTracker.track_stereo

        def patched_track(self, lefts, rights, ts):
            rs = track(self, lefts, rights, ts)
            return rs[: len(rs) // 2]

        multi_seq.MultiTracker.track_stereo = patched_track
    elif fault == "det_altered":
        from tpuslam_torch.frontend import frame

        detect = frame.detect_lines

        def patched_detect(img, *a, **k):
            det = detect(img, *a, **k)
            ep = det.endpoints.clone()
            ep[..., ::5, :, :] += 2.0
            return det._replace(endpoints=ep)

        frame.detect_lines = patched_detect
    else:
        raise SystemExit(f"unknown fault {fault!r} (have {', '.join(FAULTS)})")
