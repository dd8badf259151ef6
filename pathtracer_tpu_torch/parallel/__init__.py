"""Sharding and multi-process rendering over torch.distributed: `mesh` (the
rank layout, pixel ranges, the sharded renders and training step) and
`launch` (the process group, the demo jobs, the kill-and-restart drill).
Port of `pathtracer_tpu/parallel`."""
