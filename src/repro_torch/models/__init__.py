"""Decoder models (dense and hybrid): params, layers, the SSM mixer, stack
assembly, prefill/decode."""
