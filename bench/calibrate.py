"""The readings that a cell's limits are set from: the program's numbers
over many seeds and the control's over a few, in one process.

    python3 bench/calibrate.py --workload <cell> --seeds 1 2 ... \\
        --control-seeds 1 2 3 [--seconds 2]

For each seed it runs the cell as a run does (set-up, a short window at
the cell's own load, long enough to finish at least one whole cycle of
the mix, so its longest requests; then the check) and prints the numbers
compared, one JSON line a seed; then the control's (the reference in fp8
in the program's place) for each control seed.  A limit goes between the
largest program reading and the smallest control reading (PERF.md).
Benchmark runs do not run this.
"""
from __future__ import annotations

import argparse
import gc
import importlib
import json
import sys
import time
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parent.parent / "src"),
                str(Path(__file__).resolve().parent.parent)]

from bench import modelcfg, run  # noqa: E402
from bench import traffic as traffic_lib  # noqa: E402


def readings(workload: str, seed: int, seconds: float, control: bool,
             device="cuda:0", shrink=None, traffic_update=None) -> dict:
    import torch

    cell = {w["name"]: w for w in run.benchmark()["workloads"]}[workload]
    arch = modelcfg.arch(modelcfg.load(cell["config"]))
    if shrink is not None:
        arch = shrink(arch)
    tr = traffic_lib.load(cell["traffic"], cell["config"])
    tr.update(traffic_update or {})
    r = run.Run(cell, arch, run.port_config(arch), tr, seed, device, False)
    driver = importlib.import_module(f"bench.drivers.{r.kind}")
    t0 = time.perf_counter()
    st = driver.setup(r)
    r.win = driver.window(r, st, seconds)
    driver.release(st)
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    numbers, info = driver.check(r, st, control=control)
    out = {"workload": workload, "seed": seed, "control": control,
           "numbers": numbers, "checked": info, "run_s": t1 - t0,
           "check_s": time.perf_counter() - t1}
    del st
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    for control, seeds in ((False, args.seeds), (True, args.control_seeds)):
        for s in seeds:
            print(json.dumps(readings(args.workload, s, args.seconds,
                                      control)), flush=True)


if __name__ == "__main__":
    main()
