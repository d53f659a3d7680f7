"""PyTorch + CUDA port of the dense decoder LM that ``repro`` trains and serves.

Layout mirrors the JAX package: ``configs``, ``models``, ``kernels`` (hand
written CUDA C++ for Hopper, with plain PyTorch versions beside them),
``serving``, ``launch`` and ``steps``.  Nothing here imports JAX or ``repro``.
"""
