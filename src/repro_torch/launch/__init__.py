"""repro_torch.launch — the launchers."""
