"""Data parallelism: the device mesh of the stream-sharded serving ticks and
the process group of data-parallel training (parallel/mesh.py)."""
