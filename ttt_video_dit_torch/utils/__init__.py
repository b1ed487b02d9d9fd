"""Utilities: the FLOP count and MFU, the safetensors layout, the training logger, EMA and misc helpers."""
