"""The benchmark of tpuslam_torch on NVIDIA cards: run.py runs one cell of BENCHMARK.json."""
