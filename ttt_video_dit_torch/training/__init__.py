"""Training: the optimizer, the train step and the set-up helpers."""
