"""scan_roofline.train: the least time of the traced window's selective
scans, forward and backward (bench/counts/ssm_scan.py: one call of each
a Mamba layer and step, from the shapes alone; the program's recomputed
forward is not counted again) over the device time of the scan's kernels,
in %.  None where no such kernel ran."""
from bench.counts import ssm_scan

#: the scan's kernels, by a part of their names
KERNELS = ("ssm_fwd", "ssm_bwd_tma", "ssm_bwd_dc")


def read(run):
    if run.trace is None or run.kind != "train":
        return None
    t = run.trace.kernel_s(KERNELS)
    if t <= 0:
        return None
    a, pk, w = run.arch, run.peak, run.win
    n = sum(1 for kind, _ in a.layers if kind == "mamba")
    shape = (w["B"], w["S"], a.d_inner, a.ssm_state)
    least = sum(ssm_scan.least_seconds(*f(*shape), pk["f32_flops"],
                                       pk["hbm_bytes_per_s"])
                for f in (ssm_scan.forward, ssm_scan.backward))
    return 100.0 * w["steps"] * n * least / t
