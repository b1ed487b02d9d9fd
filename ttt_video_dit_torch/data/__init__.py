"""Data: the precomputed-latent loader and the synthetic data module."""
