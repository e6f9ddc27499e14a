"""Readings that the limits of `correct` are set from, for one cell.

    python3 benchmark/control.py --workload <cell> --seeds <a,b,...> --frames <n>

For each seed, in one process: the cell's set-up and warm frames, `n`
frames through the program as a run's window makes them, then the
numbers `correct` compares for the program's frames (the lower
readings), then the control's (its upper readings): the plain
reference computed in bfloat16, put in the program's place. Prints one
JSON line a seed and, last, the widest program reading and the least
control reading of each number beside the cell's limits. Runs on the
card.
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if os.path.abspath(sys.path[0]) == os.path.dirname(os.path.abspath(__file__)):
    sys.path[0] = ROOT

from benchmark.lib import registry  # noqa: E402


def readings(bench, workload, seed, frames, device="cuda", overrides=None,
             config_overrides=None):
    """({number: program reading}, {number: control reading})."""
    import torch

    cfg = registry.config(bench, workload["config"])
    cfg.update(config_overrides or {})
    traffic = registry.traffic(workload["traffic"])
    traffic.update(overrides or {})
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", dev.index or 0)
        torch.cuda.set_device(dev)
    limits = traffic["limits"]

    cell = registry.driver(traffic["driver"]).Cell(cfg, traffic, seed, dev)
    cell.warm(traffic["warm_frames"])
    for i in range(frames):
        cell.prepare("window", i)
        cell.run()
    cell.release()
    program = {k: v for k, v, _ in cell.check(limits)}
    return program, cell.control("bfloat16"), limits


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--frames", type=int, required=True)
    args = p.parse_args(argv)
    os.environ["USE_FLAX"] = "0"
    bench = registry.load_benchmark()
    workload = registry.cell(bench, args.workload)
    lower, upper = {}, {}
    for seed in (int(s) for s in args.seeds.split(",")):
        program, control, limits = readings(bench, workload, seed,
                                            args.frames)
        print(json.dumps({"seed": seed, "program": program,
                          "control": control}), flush=True)
        for k in limits:
            lower[k] = max(lower.get(k, 0.0), program.get(k, 0.0))
            upper[k] = min(upper.get(k, float("inf")),
                           control.get(k, float("inf")))
    print(json.dumps({"lower": lower, "upper": upper, "limits": limits}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
