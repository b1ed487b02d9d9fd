"""Training: the optimizer, the train step, checkpoints, the step iterator and the set-up helpers."""
