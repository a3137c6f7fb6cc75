"""PyTorch + CUDA port of the FEEL data-aware scheduling system.

Mirrors the module layout of the JAX reference package (``core/``,
``data/``, ``models/``, ``kernels/``) so every module has one
counterpart there.  The port imports ``torch`` and numpy only.  Entry
points run on the CUDA card unless the caller passes ``device="cpu"``
(:func:`repro_torch.device.resolve_device`); on the CPU every kernel
wrapper computes its plain PyTorch version instead of launching.
"""
