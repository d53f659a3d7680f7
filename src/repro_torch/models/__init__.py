"""The models of every family: params, layers, the SSM mixer, the MoE
layer, the xLSTM blocks, stack assembly, prefill/decode."""
