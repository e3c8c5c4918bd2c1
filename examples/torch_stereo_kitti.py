#!/usr/bin/env python
"""Stereo KITTI odometry example on tpuslam_torch (reference-class `stereo_kitti` main;
the same run as examples/stereo_kitti.py, on the CUDA card).

    python examples/torch_stereo_kitti.py <kitti_odometry_root> [seq_id] [traj_out.txt]
"""

import sys

from tpuslam_torch.cli import main

if __name__ == "__main__":
    root = sys.argv[1]
    seq = sys.argv[2] if len(sys.argv) > 2 else "00"
    out = sys.argv[3] if len(sys.argv) > 3 else f"trajectory_kitti_{seq}.txt"
    main(
        [
            "run",
            "--dataset",
            "kitti",
            "--root",
            root,
            "--kitti-seq",
            seq,
            "--out",
            out,
            "--verbose",
        ]
    )
