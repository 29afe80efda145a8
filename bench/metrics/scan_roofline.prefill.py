"""scan_roofline.prefill: the least time of the traced window's selective
scans (bench/counts/ssm_scan.py: one forward call a Mamba layer and
batch, from the shapes alone) over the device time of the scan's kernels,
in %.  None where no such kernel ran."""
from bench.counts import ssm_scan

#: the scan's kernels, by a part of their names
KERNELS = ("ssm_fwd", "ssm_bwd_tma", "ssm_bwd_dc")


def read(run):
    if run.trace is None or run.kind != "prefill":
        return None
    t = run.trace.kernel_s(KERNELS)
    if t <= 0:
        return None
    a, pk = run.arch, run.peak
    n = sum(1 for kind, _ in a.layers if kind == "mamba")
    least = sum(n * ssm_scan.least_seconds(
        *ssm_scan.forward(B, S, a.d_inner, a.ssm_state), pk["f32_flops"],
        pk["hbm_bytes_per_s"]) for S, B, _, _ in run.win["batches"])
    return 100.0 * least / t
