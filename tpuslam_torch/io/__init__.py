"""Synthetic scenes, rendering and trajectory files (numpy)."""
