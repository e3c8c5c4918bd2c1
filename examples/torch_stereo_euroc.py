#!/usr/bin/env python
"""Stereo EuRoC example on tpuslam_torch (reference-class `stereo_euroc` main;
the same run as examples/stereo_euroc.py, on the CUDA card).

    python examples/torch_stereo_euroc.py <euroc_sequence_dir> [traj_out.txt]
"""

import sys

from tpuslam_torch.cli import main

if __name__ == "__main__":
    root = sys.argv[1]
    out = sys.argv[2] if len(sys.argv) > 2 else "trajectory_euroc.txt"
    main(["run", "--dataset", "euroc", "--root", root, "--out", out, "--verbose"])
