"""Hand-written CUDA kernels of the port, their launch wrappers and plain twins.

Sources live in ``eradiate_tpu_torch/csrc``; :mod:`._build` compiles them
with ``nvcc`` for ``sm_90a`` at first use and loads them through ``ctypes``.
Nothing is built at import time.
"""
