"""Latent-space ops and the hand-written CUDA kernels of the port."""
