#!/usr/bin/env python
"""Monocular TUM example on tpuslam_torch (reference-class `mono_tum` main;
the same run as examples/mono_tum.py, on the CUDA card).

    python examples/torch_mono_tum.py <tum_sequence_dir> [traj_out.txt]
"""

import sys

from tpuslam_torch.cli import main

if __name__ == "__main__":
    root = sys.argv[1]
    out = sys.argv[2] if len(sys.argv) > 2 else "trajectory_tum.txt"
    main(["run", "--dataset", "tum", "--root", root, "--mono", "--out", out, "--verbose"])
