"""mfu.train: the traced window's MODEL_FLOPS of its train steps (6
N_active a token, bench/counts/model_flops.py) over the window's length
and the card's dense bf16 peak, in %."""
from bench.counts import model_flops


def read(run):
    if run.trace is None or run.kind != "train":
        return None
    w = run.win
    flops = model_flops.step_flops(run.arch, "train",
                                   w["steps"] * w["B"] * w["S"])
    return 100.0 * flops / (run.trace.window_s * run.peak["bf16_flops"])
