"""Multi-GPU training and sampling: the device mesh, the parameter placement and the local-shard views the kernels take."""
