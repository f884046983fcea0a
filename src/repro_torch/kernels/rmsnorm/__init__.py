"""Plain PyTorch RMSNorm and its CUDA kernel."""
