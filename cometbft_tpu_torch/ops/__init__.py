"""Device layer: field and curve arithmetic, the hand-written CUDA verify
kernels and their wrappers, and the host/device verification glue."""
