"""Optimization back end: line residuals and the pose-only LM (torch)."""
