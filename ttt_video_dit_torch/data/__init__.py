"""Data: the synthetic data module (the real-data loader is not ported yet)."""
