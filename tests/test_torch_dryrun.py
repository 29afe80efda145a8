"""The port's dry run (``repro_torch.launch.dryrun``) against the
reference's shard arithmetic.

The CLI runs in a child process: it starts a fake default process group of
256 or 512 ranks, and this worker may hold another (the distributed
tests' gloo groups).  qwen3-8b x train_4k on both production meshes: the
bytes one device holds of the arguments and of the outputs equal the
reference's, computed here from ``repro.launch.specs.build_lowerable``'s
ShapeDtypeStructs and PartitionSpecs (no compile); the executed step's
figures are there (rank 0's FLOPs within [0.75, 2] of
``flops_model.cell_flops``' share of a device, collectives, temporaries),
the roofline reads its collectives, and only the code size is null, with
the reason; neither ``jax`` nor ``repro`` is imported by the child.  A rule-skipped cell gives the
reference's reason.  ``chip_smoke.py``'s ``REF_DRYRUN`` holds the same
arithmetic for every cell.
"""
import json
import math
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as JP

from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import get_config as jax_get_config
from repro.configs.base import list_configs
from repro.distributed import sharding as jsh
from repro.launch import specs as jspecs
from repro.models import model as jax_model
from repro.models.params import spec_to_pspecs, spec_to_sds
from repro_torch.distributed import sharding as sh
from repro_torch.launch import dryrun, hlo_analysis

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:  # benchmarks_torch
    sys.path.insert(0, str(ROOT))
from benchmarks_torch import flops_model, roofline  # noqa: E402
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
N_METRICS = 5  # nll, aux, loss, grad_norm, lr: f32 scalars, replicated


def _shard_bytes(sds, spec, sizes):
    n = list(sds.shape)
    for d, e in enumerate(spec):
        for a in () if e is None else ((e,) if isinstance(e, str) else e):
            assert n[d] % sizes[a] == 0
            n[d] //= sizes[a]
    return math.prod(n) * np.dtype(sds.dtype).itemsize


def _tree_bytes(tree, specs, sizes):
    lv = jax.tree_util.tree_leaves(tree)
    sp = ([JP()] * len(lv) if specs is None else jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, JP)))
    assert len(sp) == len(lv)
    return sum(_shard_bytes(s, p, sizes) for s, p in zip(lv, sp))


def ref_bytes(arch, shape_name, mesh_name):
    """(argument bytes, output bytes) one device holds in the reference's
    cell, the outputs placed as ``repro_torch.launch.specs`` states."""
    cfg, shape = jax_get_config(arch), JSHAPES[shape_name]
    dims, axes = MESHES[mesh_name]
    mesh = Mesh(np.asarray(jax.devices()[:1] * math.prod(dims)).reshape(dims),
                axes)
    sizes = dict(zip(axes, dims))
    low = jspecs.build_lowerable(cfg, shape, mesh)
    args = sum(_tree_bytes(a, s, sizes)
               for a, s in zip(low.args_sds, low.in_shardings))
    if shape.step == "train":
        return args, (_tree_bytes(low.args_sds[0], low.out_shardings[0], sizes)
                      + N_METRICS * 4)
    B = shape.global_batch
    logits = jax.ShapeDtypeStruct((B, cfg.vocab_size), cfg.dtype)
    out = _shard_bytes(logits, jsh.to_pspec(
        ("batch", "vocab"), rules=low.rules, mesh=mesh, shape=logits.shape),
        sizes)
    if not cfg.encoder_only:
        L = shape.seq_len + (jspecs.DECODE_PAD if shape.step == "decode"
                             else 0)
        cs = jax_model.cache_specs(cfg, B, L)
        out += _tree_bytes(spec_to_sds(cs), spec_to_pspecs(
            cs, rules=low.rules, mesh=mesh), sizes)
    return args, out


CHILD = """
import json, runpy, sys
sys.argv = ["dryrun"] + json.loads(sys.argv[1])
try:
    runpy.run_module("repro_torch.launch.dryrun", run_name="__main__")
finally:
    print(json.dumps(sorted(m for m in sys.modules
                            if m.split(".")[0] in ("jax", "jaxlib", "repro"))))
"""


def _cli(tmp_path, *argv):
    out = tmp_path / "report.json"
    proc = subprocess.run(
        [sys.executable, "-c", CHILD, json.dumps([*argv, "--out", str(out)])],
        cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"),
                       "PATH": "/usr/bin:/bin", "HOME": str(tmp_path)},
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
    return json.loads(out.read_text()), proc.stdout


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_cli_cell_equals_reference_bytes(tmp_path, mesh_name):
    argv = ["--arch", "qwen3-8b", "--shape", "train_4k"]
    if mesh_name == "2x16x16":
        argv.append("--multi-pod")
    (cell,), stdout = _cli(tmp_path, *argv)
    assert cell["status"] == "ok" and cell["mesh"] == mesh_name
    assert cell["step"] == "train"
    mem = cell["memory"]
    assert (mem["argument_size_in_bytes"], mem["output_size_in_bytes"]) == \
        ref_bytes("qwen3-8b", "train_4k", mesh_name)
    # the executed step's figures: rank 0's FLOPs near the analytic
    # model's share of a device, its collectives, its temporaries
    for key in ("flops", "bytes_accessed", "collectives", "compile_s"):
        assert cell[key] is not None
    assert mem["temp_size_in_bytes"] > 0
    assert cell["collectives"]["total_bytes"] > 0
    assert set(cell["collectives"]) == {*hlo_analysis.COLLECTIVE_FACTOR,
                                        "total_bytes"}
    n_dev = math.prod(MESHES[mesh_name][0])
    ratio = cell["flops"] / (flops_model.cell_flops("qwen3-8b", "train_4k")
                             / n_dev)
    print(f"{mesh_name}: rank 0's executed FLOPs / flops_model.cell_flops's "
          f"share = {ratio:.4f}")
    assert 0.75 <= ratio <= 2.0
    # eager PyTorch compiles no module: the one figure left null
    assert mem["generated_code_size_in_bytes"] is None
    assert "generated_code_size_in_bytes" in cell["unavailable"]
    assert cell["fits_card"] is True
    assert "above the card's 80 GB: 0 of 1 ok cells" in stdout
    # the roofline reads its collectives
    (_, _, derived), = roofline.main(str(tmp_path / "report.json"))
    terms = dict(kv.split("=") for kv in derived.split(";"))
    assert float(terms["collective_s"]) > 0


def test_cli_rule_skipped_cell(tmp_path):
    (cell,), _ = _cli(tmp_path, "--arch", "hubert-xlarge", "--shape",
                      "decode_32k")
    assert cell["status"] == "skipped"
    assert cell["reason"] == jspecs.cell_skip_reason(
        jax_get_config("hubert-xlarge"), "decode_32k")


def test_chip_smoke_ref_dryrun_is_the_reference():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    want = {}
    for mesh_name in MESHES:
        for arch in list_configs():
            for shape in JSHAPES:
                if not jspecs.cell_skip_reason(jax_get_config(arch), shape):
                    want[arch, shape, mesh_name] = ref_bytes(arch, shape,
                                                             mesh_name)
    assert len(want) == 62
    assert chip_smoke.REF_DRYRUN == want
    skipped = {(a, s): jspecs.cell_skip_reason(jax_get_config(a), s)
               for a in list_configs() for s in JSHAPES}
    assert chip_smoke.REF_SKIPPED == {k: v for k, v in skipped.items() if v}


def test_place_refuses_a_spec_that_does_not_divide():
    import torch

    mesh = sh.AbstractMesh(("data", "model"), (2, 2))
    with pytest.raises(ValueError, match="does not divide"):
        dryrun.place({"w": torch.empty((3, 4), device="meta")},
                     {"w": sh.P("data", None)}, mesh)


def test_a_failed_cell_is_reported_and_the_cli_exits_1(tmp_path,
                                                        monkeypatch, capsys):
    def boom(arch, shape, mp):
        raise RuntimeError("the partitioner refused it")

    monkeypatch.setattr(dryrun, "run_cell", boom)
    out = tmp_path / "r.json"
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "qwen3-8b", "--shape", "train_4k", "--out",
                     str(out)])
    assert e.value.code == 1
    (cell,) = json.loads(out.read_text())
    assert cell["status"] == "FAILED" and "partitioner" in cell["error"]
    assert "FAILED qwen3-8b x train_4k" in capsys.readouterr().err
