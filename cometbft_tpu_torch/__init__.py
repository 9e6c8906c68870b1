"""PyTorch/CUDA port of cometbft_tpu for one NVIDIA H100.

Modules sit at the same relative paths as the modules of ``cometbft_tpu``
they port, and are held against them by ``tests/test_torch_*.py``. The
package imports torch and numpy, never jax and nothing of cometbft_tpu.
Entry points take ``device=`` and default to ``"cuda"``.
"""
