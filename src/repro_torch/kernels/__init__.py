"""Hand-written Hopper kernels of the port, one folder per kernel.

Each folder follows the reference's ``repro/kernels`` layout: the kernel's
wrapper (it checks its operands, launches the CUDA source in ``csrc/`` and
counts launches), an ``ops.py`` that dispatches by tensor device (``meta``
tensors to the route of ``_meta.py``: the kernel's output shapes and its
work by formula), and a ``ref.py`` plain version that the CPU path and
the card checks use.
Kernels build on first use (``_build.py``); importing builds nothing.
"""
