"""Benchmarks of the port: the RGB-D trajectory error (`ate`)."""
