"""Optimization back end: residuals, the pose-only LM, the LM+Schur local
bundle adjustment, local mapping, the keyframe database and DLT-Lines (torch)."""
