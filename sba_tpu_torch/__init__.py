"""sba_tpu_torch — the PyTorch/CUDA port of sba_tpu for NVIDIA Hopper.

A second package beside ``sba_tpu`` (the JAX reference). It imports
``torch`` and numpy, never ``jax`` and nothing of ``sba_tpu``. Public
entry points take an explicit ``device`` (default ``"cuda"``): on CUDA
tensors the hot path runs hand-written kernels (``ops/ba_kernels.py``,
sources in ``csrc/``); on CPU tensors it runs their plain PyTorch twins.
"""
