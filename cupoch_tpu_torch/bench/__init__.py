"""Benchmarks of the port: the RGB-D trajectory error (`ate`) and the
multi-rank scaling of the sharded ICP (`scaling`)."""
