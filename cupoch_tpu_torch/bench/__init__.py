"""Benchmarks of the port: the per-op timing harness (`harness`, run
as ``python -m cupoch_tpu_torch.bench``), the RGB-D trajectory error
(`ate`) and the multi-rank scaling of the sharded ICP (`scaling`)."""
from .harness import BenchResult, run_benchmarks, time_op

__all__ = ["BenchResult", "run_benchmarks", "time_op"]
