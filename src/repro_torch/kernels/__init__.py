"""Hand-written CUDA kernels of the port, one module per kernel.

Each module holds the wrapper that launches its kernel on CUDA tensors
(and counts the launches in ``<wrapper>.launches``), and the plain
PyTorch version of the same function that the wrapper computes for CPU
tensors.  The sources live in ``repro_torch/csrc/`` and are built at
first use by :mod:`repro_torch.kernels._build`.
"""
