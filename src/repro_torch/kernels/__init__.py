"""Hand-written CUDA kernels for Hopper (``csrc/``), their launchers, the
plain PyTorch versions (``ref``) and the model-layout wrappers (``ops``).
Nothing is built at import; ``_build`` compiles the sources at first launch."""
