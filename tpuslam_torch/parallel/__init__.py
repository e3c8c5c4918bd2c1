"""Batched multi-sequence tracking and batched local BA (BASELINE config #5)."""

from tpuslam_torch.parallel.sharded_ba import batched_ba, make_mesh

__all__ = ["batched_ba", "make_mesh"]
