"""Plain PyTorch attention and the CUDA flash-attention kernel."""
