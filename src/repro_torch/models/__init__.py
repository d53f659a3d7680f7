"""Dense decoder model: params, layers, stack assembly, prefill/decode."""
