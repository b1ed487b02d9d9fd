"""PyTorch + CUDA port of ttt_video_dit_tpu for NVIDIA Hopper GPUs.

The JAX package beside this one is the numerical reference. This package
imports torch and never jax; the only modules it shares with the JAX package
are the pure-stdlib configuration and sequence-metadata modules.
"""
