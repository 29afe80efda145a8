"""The benchmark of the PyTorch and CUDA port: one run of one cell.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cell's cards.  The
cell (an entry of ``BENCHMARK.json``'s ``workloads``) names a configuration
(``bench/configs/<config>.json``) and a traffic mix
(``bench/traffic/<traffic>.json``), whose ``kind`` names the driver
(``bench/drivers/<kind>.py``); each per-layer metric is read by
``bench/metrics/<name>.py``.  A run:

1. makes the weights from the seed on the card and warms up every shape
   of the cell's traffic (set-up, ``setup_s``, from the process's start),
   then keeps the interpreter's objects out of the garbage collector's
   full passes while the window runs;
2. measures the window for ``--seconds``, under ``torch.profiler`` with
   ``--trace 1``;
3. reads the card's peak memory, frees the program's state, and holds
   what the window produced to the plain reference (``bench/reference/``;
   the numbers and limits of ``bench/compare.py``), which decides
   ``correct``;
4. prints each number compared beside its limit as the last lines of its
   standard error, and one JSON line as the last of its standard output.

It exits non-zero and prints no result where there is no card or fewer
than the cell asks for, where the program cannot be imported, or where
JAX, jaxlib, flax or the JAX package is loaded once the window has closed.
Every cache it or the program builds lies inside the checkout.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))
# the program's and the libraries' caches, at fixed paths in the checkout
for _k, _d in (("TRITON_CACHE_DIR", "triton"),
               ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
               ("CUDA_CACHE_PATH", "nv")):
    os.environ.setdefault(_k, str(ROOT / ".bench_cache" / _d))
os.environ.setdefault("USE_FLAX", "0")

#: top-level module names that may not be loaded once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Run:
    """What a run knows: the cell, its configuration and traffic, and
    after the window its records and trace (the metric readers' input)."""

    def __init__(self, cell, arch, cfg, traffic, seed, device, trace):
        self.cell, self.arch, self.cfg = cell, arch, cfg
        self.traffic, self.kind = traffic, traffic["kind"]
        self.seed, self.device, self.tracing = seed, device, trace
        self.win = self.trace = None
        self.spans = set()
        self.peak = json.loads((ROOT / "bench" / "peaks.json").read_text())[
            "NVIDIA H100 80GB HBM3"]

    def span(self, name):
        """A labelled span in the trace (nothing untraced)."""
        if not self.tracing:
            return contextlib.nullcontext()
        import torch
        self.spans.add(name)
        return torch.profiler.record_function(name)


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def load_file(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bm: dict, name: str, key: str) -> list:
    """The entries of ``bm[key]`` that the cell reports: those that list
    it, or that list no cells (per-layer: whose end-to-end metric the cell
    reports)."""
    e2e = {m["name"] for m in bm["end_to_end"]
           if name in m.get("workloads", [name])}
    out = []
    for m in bm[key]:
        if "workloads" in m:
            if name in m["workloads"]:
                out.append(m)
        elif key == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


def port_config(arch):
    """The program's configuration of an Arch."""
    from repro_torch.configs.base import ModelConfig

    a = arch
    return ModelConfig(
        name=a.name, family="hybrid" if a.n_heads else "ssm",
        n_layers=a.n_layers, d_model=a.d_model, n_heads=a.n_heads,
        n_kv_heads=a.n_kv_heads, head_dim=a.head_dim, d_ff=a.d_ff,
        vocab_size=a.vocab, rope_kind="none", attn_period=a.attn_period,
        attn_offset=a.attn_offset, n_experts=a.n_experts, top_k=a.top_k,
        d_ff_expert=a.d_ff_expert, moe_period=a.moe_period,
        moe_offset=a.moe_offset, ssm_state=a.ssm_state, d_conv=a.d_conv,
        expand=a.d_inner // a.d_model, dt_rank=a.dt_rank,
        tie_embeddings=a.tie_embeddings, norm_eps=a.norm_eps,
        dtype=a.dtype, param_dtype=a.dtype)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def fail(msg: str, code: int) -> int:
    print(f"bench: {msg}", file=sys.stderr)
    return code


def main(argv=None, device=None, shrink=None, traffic_update=None,
         out=None, forbidden=FORBIDDEN) -> int:
    """One run; returns the exit code.  ``device`` None is the card, with
    its checks; the tests pass "cpu", with ``shrink`` (Arch -> Arch) and
    ``traffic_update`` to make the cell small, ``out`` (a list) to receive
    the result, and no ``forbidden`` modules (their process has loaded the
    JAX package for its own tests)."""
    from bench import compare, modelcfg

    args = parse(argv)
    bm = benchmark()
    cells = {w["name"]: w for w in bm["workloads"]}
    if args.workload not in cells:
        return fail(f"no workload {args.workload!r}", 2)
    cell = cells[args.workload]
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        return fail(f"the program cannot be imported: {e}", 5)
    import torch

    if device is None:
        if not torch.cuda.is_available():
            return fail("no CUDA device: the benchmark runs on the card", 3)
        if torch.cuda.device_count() < cell["chips"]:
            return fail(f"{torch.cuda.device_count()} CUDA devices, the "
                        f"cell asks for {cell['chips']}", 3)
        device = "cuda:0"
    from bench import traffic as traffic_lib
    from bench.trace import WINDOW, Trace

    arch = modelcfg.arch(modelcfg.load(cell["config"]))
    if shrink is not None:
        arch = shrink(arch)
    tr = traffic_lib.load(cell["traffic"], cell["config"])
    tr.update(traffic_update or {})
    run = Run(cell, arch, port_config(arch), tr, args.seed, device,
              bool(args.trace))
    driver = importlib.import_module(f"bench.drivers.{run.kind}")
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.set_device(torch.device(device))
        torch.cuda.reset_peak_memory_stats()

    st = driver.setup(run)
    # what set-up made lives to the end: a full collection of the
    # interpreter's objects in the window would stall it for 0.1-1 s
    gc.collect()
    gc.freeze()
    if args.trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        with profile(activities=acts) as prof:
            setup_s = time.perf_counter() - T_START
            with torch.profiler.record_function(WINDOW):
                run.win = driver.window(run, st, args.seconds)
        run.trace = Trace(prof, run.spans)
        del prof
    else:
        setup_s = time.perf_counter() - T_START
        run.win = driver.window(run, st, args.seconds)

    gc.unfreeze()

    if args.trace:
        metrics = {}
        for m in cell_metrics(bm, cell["name"], "per_layer"):
            reader = load_file(ROOT / "bench" / "metrics" / f"{m['name']}.py",
                               "bench_metric_" + m["name"].replace(".", "_"))
            v = reader.read(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = dict(driver.end_to_end(run, run.win), setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell_metrics(bm, cell["name"], "end_to_end")}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": cell["chips"],
           "memory_peak_bytes": (torch.cuda.max_memory_allocated()
                                 if cuda else 0)}
    if run.trace is not None:
        dev.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)

    driver.release(st)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers, info = driver.check(run, st)
    correct, compared = compare.judge(numbers,
                                      compare.limits(cell["name"]))

    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(forbidden))
    if loaded:
        return fail(f"loaded once the window closed: {', '.join(loaded)}", 4)
    result = {"correct": correct, "attempted": driver.attempted(run.win),
              "failed": 0, "metrics": metrics, "device": dev}
    if run.trace is not None:
        result["breakdown"] = {"device_ops": run.trace.device_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
    result["compared"] = compared
    print(f"window {json.dumps(driver.summary(run.win))}", file=sys.stderr)
    print(f"checked {json.dumps(info)}", file=sys.stderr)
    for k, v in compared.items():
        print(f"compared {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    if out is not None:
        out.append(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
