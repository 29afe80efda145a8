"""The port's figure drivers (``benchmarks_torch/``), its HLO parser and the
card's roofline constants against the reference's (``benchmarks/``,
``repro.launch.hlo_analysis``).

* The HLO parser: the three cases of tests/test_hlo_analysis.py on the
  port's copy, and equal to the reference's output; ``CHIP`` holds the
  H100's figures and none of the TPU's.
* ``flops_model``: all five functions equal to the reference's for every
  (arch x shape).
* ``run_sim_torch`` (on the CPU) against ``run_sim_jax``: equal completion
  ticks and latencies for every policy of the reference's ``JAX_POLICIES``
  at 12 functions and 2 simulated seconds.
* fig5 and fig6 at 2 simulated seconds, and the serving rows at 24
  tenants: the derived columns equal to the reference's (and to
  ``chip_smoke.py``'s ``REF_SERVING``).
* The roofline row of a cell without collectives, and ``run.py``'s exit
  code when a module fails.
"""
import functools
import json
import pathlib
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmarks import common as jcommon  # noqa: E402
from benchmarks import fig5_static as jfig5  # noqa: E402
from benchmarks import fig6_window as jfig6  # noqa: E402
from benchmarks import fig11_baselines as jfig11  # noqa: E402
from benchmarks import flops_model as jflops  # noqa: E402
from benchmarks import serving_lags as jserving  # noqa: E402
from benchmarks_torch import common, fig5_static, fig6_window  # noqa: E402
from benchmarks_torch import flops_model, hlo_stats, roofline  # noqa: E402
from benchmarks_torch import run as run_mod  # noqa: E402
from benchmarks_torch import serving_lags  # noqa: E402
from repro.configs.base import SHAPES, list_configs  # noqa: E402
from repro.launch import hlo_analysis as jhlo  # noqa: E402
from repro_torch.launch import hlo_analysis  # noqa: E402

SYNTH = """\
HloModule jit_step

%body.1 (arg: (s32[], bf16[8,128])) -> (s32[], bf16[8,128]) {
  %p = (s32[], bf16[8,128]) parameter(0)
  %ag.1 = bf16[8,128]{1,0} all-gather(%x), replica_groups={}, dimensions={0}
  %ar.1 = f32[4,64]{1,0} all-reduce(%y), to_apply=%add
  ROOT %t = (s32[], bf16[8,128]) tuple(%i, %ag.1)
}

%cond.1 (arg: (s32[], bf16[8,128])) -> pred[] {
  %p2 = (s32[], bf16[8,128]) parameter(0)
  %c = s32[] constant(24)
  ROOT %cmp = pred[] compare(%i2, %c), direction=LT
}

ENTRY %main.9 (a: bf16[8,128]) -> bf16[8,128] {
  %w = (s32[], bf16[8,128]) while(%init), condition=%cond.1, body=%body.1
  %ag.2 = bf16[16,16]{1,0} all-gather(%z), dimensions={0}
  ROOT %r = bf16[8,128] get-tuple-element(%w), index=1
}
"""


def _parse(mod):
    comps = mod.parse_computations(SYNTH)
    assert set(comps) == {"body.1", "cond.1", "main.9"}
    assert comps["main.9"]["entry"]
    assert comps["body.1"]["collectives"][0][0] == "all-gather"
    assert comps["cond.1"]["consts"] == [24]
    assert comps["main.9"]["whiles"] == [("cond.1", "body.1")]
    return comps


def _trips(mod):
    stats = mod.collective_stats_attributed(SYNTH)
    assert stats["all-gather"]["bytes"] == 8 * 128 * 2 * 24 + 16 * 16 * 2
    assert stats["all-reduce"]["bytes"] == 4 * 64 * 4 * 2 * 24
    assert stats["total_bytes"] == (
        stats["all-gather"]["bytes"] + stats["all-reduce"]["bytes"])
    return stats


def _no_entry(mod):
    stats = mod.collective_stats_attributed(SYNTH.replace("ENTRY ", ""))
    assert stats["total_bytes"] > 0
    return stats


@pytest.mark.parametrize("case", [_parse, _trips, _no_entry],
                         ids=["parse_computations", "trip_attribution",
                              "no_entry_fallback"])
def test_hlo_parser_cases(case):
    assert case(hlo_analysis) == case(jhlo)


def test_chip_is_the_h100_and_carries_no_tpu_constant():
    c = hlo_analysis.CHIP
    assert (c.peak_flops, c.hbm_bw, c.hbm_bytes, c.link_bw, c.n_links) == (
        989e12, 3.35e12, 80e9, 25e9, 18)
    assert c.link_bw * c.n_links * 2 == 900e9  # NVLink 4, both ways
    tpu = {197e12, 819e9, 50e9, 16e9}
    assert not tpu & {c.peak_flops, c.hbm_bw, c.hbm_bytes, c.link_bw}
    assert hlo_stats.CHIP is c
    # nor does any source of the port carry them
    files = [*(ROOT / "src" / "repro_torch").rglob("*.py"),
             *(ROOT / "benchmarks_torch").glob("*.py"),
             *(ROOT / "examples_torch").glob("*.py"), ROOT / "chip_smoke.py"]
    for path in files:
        text = path.read_text()
        for const in ("197e12", "819e9", "16e9"):
            assert const not in text, f"{path} carries {const}"


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", list_configs())
def test_flops_model_equals_reference(arch, shape):
    assert flops_model.param_count(arch) == jflops.param_count(arch)
    assert (flops_model.active_param_count(arch)
            == jflops.active_param_count(arch))
    assert flops_model.model_flops(arch, shape) == jflops.model_flops(arch,
                                                                      shape)
    assert (flops_model.cell_flops(arch, shape)
            == jflops.cell_flops(arch, shape))
    for n_dev in (256, 512):
        assert (flops_model.memory_bytes(arch, shape, n_dev)
                == jflops.memory_bytes(arch, shape, n_dev))
    sh = SHAPES[shape]
    assert flops_model.step_model_flops(
        arch, sh.step, sh.global_batch, sh.seq_len) == jflops.model_flops(
            arch, shape)


@pytest.mark.parametrize("policy", jfig11.JAX_POLICIES)
def test_run_sim_torch_equals_run_sim_jax(policy):
    assert common.run_sim_torch.__kwdefaults__["device"] is None
    static = (jfig11.lightest_band_fns(12, n_bands_low=3)
              if policy == "lags-static" else None)
    kw = dict(duration=2.0, static_rt=static)
    lat, out = common.run_sim_torch("azure2021", 12, policy, device="cpu",
                                    **kw)
    jlat, jout = jcommon.run_sim_jax("azure2021", 12, policy, **kw)
    np.testing.assert_array_equal(out["done_tick"].numpy(),
                                  np.asarray(jout["done_tick"]))
    np.testing.assert_array_equal(lat, jlat)
    assert len(lat) > 0


@pytest.mark.parametrize("port,ref", [(fig5_static, jfig5),
                                      (fig6_window, jfig6)],
                         ids=["fig5", "fig6"])
def test_host_drivers_equal_reference(monkeypatch, port, ref):
    monkeypatch.setattr(port, "run_sim",
                        functools.partial(common.run_sim, duration=2.0))
    monkeypatch.setattr(ref, "run_sim",
                        functools.partial(jcommon.run_sim, duration=2.0))
    got, want = port.main(), ref.main()
    assert [(n, d) for n, _, d in got] == [(n, d) for n, _, d in want]


def test_serving_rows_equal_reference():
    got = serving_lags.main(densities=(24,), device="cpu")
    want = jserving.main(densities=(24,))
    assert [(n, d) for n, _, d in got] == [(n, d) for n, _, d in want]
    import chip_smoke

    assert chip_smoke.REF_SERVING == {n: d for n, _, d in want}


def test_roofline_row_without_collectives(tmp_path):
    """A cell whose report has no collectives has no wire bytes, as the
    reference's ``roofline_terms`` reads it."""
    cell = {"arch": "qwen3-8b", "shape": "train_4k", "mesh": "16x16",
            "status": "ok"}
    report = tmp_path / "r.json"
    report.write_text(json.dumps([cell, {"status": "skipped"}]))
    (name, _, derived), = roofline.main(str(report))
    assert name == "roofline.qwen3-8b.train_4k.16x16"
    d = dict(kv.split("=") for kv in derived.split(";"))
    assert d["collective_s"] == "0.0000"
    assert d["dominant"] == "compute"
    comp = flops_model.cell_flops("qwen3-8b", "train_4k") / 256 / 989e12
    assert d["compute_s"] == f"{comp:.4f}"
    mem = flops_model.memory_bytes("qwen3-8b", "train_4k", 256) / 3.35e12
    assert d["memory_s"] == f"{mem:.4f}"
    # with collectives the third term counts, over 18 NVLink links
    terms = hlo_stats.roofline_terms(dict(cell, collectives={
        "total_bytes": 450e9}))
    assert terms["collective_s"] == pytest.approx(1.0)


def test_run_reports_a_failed_module_and_exits_1(monkeypatch, capsys):
    def boom():
        raise RuntimeError("a figure failed")

    monkeypatch.setattr(fig5_static, "main", boom)
    assert run_mod.main(["fig5"]) == 1
    out = capsys.readouterr()
    assert "fig5.ERROR" in out.out and "a figure failed" in out.err
