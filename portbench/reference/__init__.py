"""The benchmark's plain reference (``gpvae.py``): plain PyTorch, nothing
of the measured package."""
