"""mfu.prefill: the traced window's MODEL_FLOPS of every prompt token it
prefilled (2 N_active a token, bench/counts/model_flops.py) over the
window's length and the card's dense bf16 peak, in %."""
from bench.counts import model_flops


def read(run):
    if run.trace is None or run.kind != "prefill":
        return None
    tokens = sum(S * B for S, B, _, _ in run.win["batches"])
    flops = model_flops.step_flops(run.arch, "prefill", tokens)
    return 100.0 * flops / (run.trace.window_s * run.peak["bf16_flops"])
