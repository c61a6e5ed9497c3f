"""Processes, meshes and partition rules over torch.distributed: DP over the
`data` axis, tensor parallelism over the `model` axis (multihost.py,
sharding.py, tp.py)."""
