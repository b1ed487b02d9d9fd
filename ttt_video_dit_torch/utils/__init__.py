"""Utilities: the FLOP count and MFU."""
