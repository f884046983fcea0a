"""Plain PyTorch RG-LRU scan and gates, and the CUDA scan kernel."""
