"""PyTorch + CUDA port of ttt_video_dit_tpu for NVIDIA Hopper GPUs.

The JAX package beside this one is the numerical reference. This package
imports torch and never jax, and nothing of the JAX package: it keeps its
own copies of the configuration and sequence-metadata modules.
"""
