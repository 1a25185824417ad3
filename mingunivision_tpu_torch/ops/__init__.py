"""Plain PyTorch ops: norms, activations, dense, RoPE, attention, patching."""
