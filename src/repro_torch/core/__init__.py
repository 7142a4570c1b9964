"""MARCA nonlinear units (plain PyTorch versions)."""
