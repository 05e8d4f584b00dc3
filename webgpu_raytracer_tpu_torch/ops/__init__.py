"""Per-ray operations and the kernels' wrappers."""
