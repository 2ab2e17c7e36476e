"""PyTorch/CUDA port of the ``repro`` package (WALL-E reproduction).

Module for module this package mirrors ``src/repro``; each module names its
counterpart there. It imports ``torch`` and never ``jax`` or ``repro``.
Entry points (``experiment.build``/``run``, ``launch.train``) run on the
CUDA device unless the caller asks for the CPU.
"""
