"""PyTorch/CUDA port of the OnePiece reproduction.

A second package beside the JAX reference ``repro``: the same serving
system (``core``, ``cluster``), the Wan2.1-style I2V workflow in PyTorch
(``models``), and hand-written CUDA kernels for Hopper (``kernels``).  It
imports nothing of ``jax`` or ``repro``.  Entry points run on ``cuda``
unless the caller passes ``device="cpu"``.
"""
