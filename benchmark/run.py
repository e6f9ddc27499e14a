"""The benchmark of the PyTorch/CUDA port (`cupoch_tpu_torch`).

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of BENCHMARK.json on the card this process finds: set-up
(imports, the CUDA context, the port's kernels built or loaded from
`cupoch_tpu_torch/_build/`, the cell's warm frames), then a closed loop
of frames for `--seconds`, each frame's inputs made on the card from
the seed and the frame's index, then the comparison of a sample of the
frames with the plain reference under `benchmark/reference/`. With
`--trace 0` the result line holds the cell's end-to-end metrics, with
`--trace 1` its per-layer metrics, read from a CUDA-only profiler trace
and a stack sampler over the same window. The last line of standard
output is the result, a JSON object; the last lines of standard error
are the numbers compared, each beside its limit.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the script's own folder would shadow nothing useful; the checkout's
# root holds both the port and this package
if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(
        os.path.abspath(__file__)):
    sys.path[0] = ROOT
elif ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.lib import guard, registry  # noqa: E402

CACHE_DIR = os.path.join(ROOT, "benchmark", "_cache")


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def set_environment():
    """Caches at fixed paths inside the checkout; no library may load
    JAX behind the port's back."""
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(CACHE_DIR, sub)


def percentile(values, q):
    """The q-th percentile, linear between order statistics."""
    v = sorted(values)
    if not v:
        return float("nan")
    x = (len(v) - 1) * q / 100.0
    i = int(x)
    j = min(i + 1, len(v) - 1)
    return v[i] + (v[j] - v[i]) * (x - i)


class ReadContext:
    """What a per-layer metric's reader may read."""

    def __init__(self, cell, frames, window_s, summary, seconds, peaks):
        self.cell = cell
        self.frames = frames
        self.window_s = window_s
        self.trace = summary
        self.sampled = seconds
        self.peaks = peaks
        self.name = None

    def per_frame_ms(self, name=None):
        """Sampled ms a frame of metric `name` (default: the one being
        read)."""
        s = self.sampled.get(name or self.name, 0.0)
        if not self.frames or s <= 0.0:
            return None
        return s * 1e3 / self.frames


def run_cell(bench, workload, seed, seconds, trace, device="cuda",
             overrides=None, config_overrides=None):
    """One run of a cell. Returns (result dict, checks [(name, value,
    limit)]); `overrides` and `config_overrides` replace traffic and
    configuration parameters (the CPU tests run at small sizes). A
    frame that raises or returns no solution is attempted and failed:
    it counts in no rate, and any failed frame makes the run not
    correct (`failed_frames`, limit 0)."""
    import torch

    from benchmark.lib import peaks
    from benchmark.lib.sampler import StackSampler, mapping_of
    from benchmark.lib.trace import DeviceTrace, summarise

    cfg = registry.config(bench, workload["config"])
    cfg.update(config_overrides or {})
    traffic = registry.traffic(workload["traffic"])
    traffic.update(overrides or {})
    driver = registry.driver(traffic["driver"])
    dev = torch.device(device)
    card = dev.type == "cuda"
    if card:
        dev = torch.device("cuda", dev.index or 0)
        torch.cuda.set_device(dev)
    cell = driver.Cell(cfg, traffic, seed, dev)
    cell.warm(traffic["warm_frames"])
    if card:
        torch.cuda.synchronize()
    per_layer = registry.cell_metrics(bench, workload["name"], "per_layer")
    readers = {m["name"]: registry.metric_reader(m["name"])
               for m in per_layer} if trace else {}
    sampler = StackSampler(mapping_of(readers)) if trace else None
    tracer = DeviceTrace(torch) if trace and card else None
    setup_s = time.perf_counter() - T_START

    latencies, failed = [], 0
    if tracer:
        tracer.__enter__()
    if sampler:
        sampler.start()
    t0 = time.perf_counter()
    k = 0
    while time.perf_counter() - t0 < seconds:
        cell.prepare("window", k)
        f0 = time.perf_counter()
        ok = cell.run()
        lat = time.perf_counter() - f0
        latencies.append(lat)
        if cell.last is not None:
            cell.last["latency"] = lat
        failed += not ok
        k += 1
    if card:
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    if sampler:
        sampler.stop()
    if tracer:
        tracer.__exit__(None, None, None)
    frames = len(latencies)
    completed = frames - failed

    memory_peak = torch.cuda.max_memory_allocated(dev) if card else 0
    device = (guard.device_info(torch, workload["chips"]) if card
              else {"platform": "cpu", "kind": "cpu", "count": 1})
    device["memory_peak_bytes"] = int(memory_peak)
    metrics = {}
    result = {"correct": False, "attempted": frames, "failed": failed,
              "metrics": metrics, "device": device}
    if not trace:
        for m in registry.cell_metrics(bench, workload["name"],
                                       "end_to_end"):
            value = {
                "frames_per_s": lambda: completed / window_s,
                "frame_ms_p95": lambda: percentile(latencies, 95) * 1e3,
                "setup_s": lambda: setup_s,
            }[m["name"]]()
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        summary = summarise(tracer.intervals() if tracer else [], window_s,
                            sampler.timeline, t0)
        summary["window_s"] = window_s
        ctx = ReadContext(cell, frames, window_s, summary, sampler.seconds,
                          peaks)
        for m in per_layer:
            ctx.name = m["name"]
            value = readers[m["name"]].read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
        device["busy_s"] = summary["busy_s"]
        device["window_s"] = window_s
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}

    for line in cell.notes():
        print(line, file=sys.stderr)
    print(f"frames {frames}, failed {failed}, window {window_s:.3f} s, "
          f"latency median {statistics.median(latencies) * 1e3:.3f} ms, "
          f"set-up {setup_s:.3f} s, peak memory {memory_peak} bytes",
          file=sys.stderr)
    # the program's state goes before the reference runs on the card
    cell.release()
    gc.collect()
    if card:
        torch.cuda.empty_cache()
    checks = cell.check(traffic["limits"]) + [("failed_frames", failed, 0)]
    result["correct"] = all(v <= lim for _, v, lim in checks)
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, v, lim in checks}
    return result, checks


def main(argv=None):
    args = parse(argv)
    set_environment()
    import torch

    bench = registry.load_benchmark()
    workload = registry.cell(bench, args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < workload["chips"]:
        print(f"{args.workload} needs {workload['chips']} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(f"card: {guard.power_limit()}", file=sys.stderr)
    result, checks = run_cell(bench, workload, args.seed, args.seconds,
                              args.trace)
    found = guard.forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 3
    for name, value, limit in checks:
        print(f"check {name}: {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
