"""Plain PyTorch Mamba-2 SSD scan and its CUDA kernel."""
