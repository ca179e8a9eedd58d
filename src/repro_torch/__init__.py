"""DuoServe-MoE on PyTorch and CUDA (NVIDIA Hopper).

The port of the ``repro`` JAX package: the same module layout (``configs``,
``core``, ``models``, ``kernels``, ``serving``), PyTorch tensors in place of
JAX arrays, and hand-written CUDA kernels (``csrc/``) in place of the Pallas
TPU kernels. It imports neither ``jax`` nor anything of ``repro``.

Entry points take ``device=`` and default to ``"cuda"``; the CPU path (the
kernels' plain PyTorch versions) is what the tests run.
"""
