"""PyTorch / CUDA port of the Hardless serving stack for NVIDIA Hopper.

A second package beside the JAX reference ``repro``: it imports ``torch``,
``numpy`` and the standard library, never JAX and nothing of ``repro``.
Its entry points run on the card (``device="cuda"``) unless the caller
asks for the CPU, where every kernel wrapper runs its plain PyTorch
version. Hand-written Hopper kernels live in ``csrc/`` and are built by
``kernels/build.py`` with ``nvcc`` at first use.
"""
