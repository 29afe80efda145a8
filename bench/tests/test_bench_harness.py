"""The harness: every cell resolves by name to its files, the traffic is
the seed's, the result line has its keys, and a run without a card or
without the program stops with no result."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from bench import modelcfg, run, traffic

ROOT = Path(__file__).resolve().parents[2]
BM = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BM["workloads"]]

#: each cell made small enough for the CPU
SMALL = {
    "prefill": {"token_budget": 64,
                "cycle": {"lengths": [16, 32, 64], "counts": [2, 1, 1]},
                "check": {"batches": 3, "rows": 2, "block": 4}},
    "train": {"batch": 2, "seq": 32},
}


def shrink(a):
    return modelcfg.small(a, n_layers=8 if a.n_heads else 2)


def small_run(cell, seed=2147483701, trace=0, **kw):
    kind = traffic.load(*(lambda w: (w["traffic"], w["config"]))(
        {w["name"]: w for w in BM["workloads"]}[cell]))["kind"]
    out = []
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                   "0.3", "--trace", str(trace)], device="cpu",
                  shrink=shrink, traffic_update=SMALL[kind], out=out,
                  forbidden=(), **kw)
    assert rc == 0
    return out[0]


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_resolves_to_its_files(cell):
    w = {w["name"]: w for w in BM["workloads"]}[cell]
    cfg = {c["name"]: c for c in BM["configs"]}[w["config"]]
    assert cfg["file"] == f"bench/configs/{w['config']}.json"
    a = modelcfg.arch(modelcfg.load(w["config"]))
    assert a.name == w["config"]
    t = traffic.load(w["traffic"], w["config"])
    assert (ROOT / "bench" / "drivers" / f"{t['kind']}.py").exists()
    assert (ROOT / "bench" / "limits" / f"{cell}.json").exists()
    for key in ("end_to_end", "per_layer"):
        ms = run.cell_metrics(BM, cell, key)
        assert ms, key
        for m in ms:
            if key == "per_layer":
                mod = run.load_file(ROOT / "bench" / "metrics" /
                                    f"{m['name']}.py", "m")
                assert callable(mod.read)
    names = {m["name"] for m in run.cell_metrics(BM, cell, "end_to_end")}
    assert "setup_s" in names and len(names) >= 2
    moves = {m["moves"] for m in run.cell_metrics(BM, cell, "per_layer")}
    assert moves <= names


def test_prefill_traffic_is_the_seeds():
    p = traffic.load("prefill_mix", "falcon-mamba-7b")
    a, b = (traffic.PrefillMix(p, s, 1000, "cpu") for s in (5, 5))
    c = traffic.PrefillMix(p, 6, 1000, "cpu")
    assert a.order(3) == b.order(3)
    assert sorted(a.order(3)) == sorted(c.order(3)) == sorted(a.lengths)
    assert a.order(0) != a.order(1) or a.order(1) != a.order(2)
    assert torch.equal(a.batch(2, 1, 512), b.batch(2, 1, 512))
    assert not torch.equal(a.batch(2, 1, 512), c.batch(2, 1, 512))
    assert a.batch(0, 0, 1024).shape == (4, 1024)
    assert a.shapes() == [(4096, 1), (2048, 2), (1024, 4), (512, 8)]


def test_train_traffic_is_the_seeds():
    p = traffic.load("train_2k", "falcon-mamba-7b-16L")
    a, b = (traffic.TrainMix(p, 2 ** 31 + 5, 65024, "cpu") for _ in "ab")
    x, y = a.batch(4), b.batch(4)
    assert torch.equal(x["tokens"], y["tokens"])
    assert x["tokens"].shape == (2, 2048)
    assert torch.equal(x["tokens"][:, 1:], x["targets"][:, :-1])
    assert not torch.equal(a.batch(5)["tokens"], x["tokens"])


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_the_result_line(cell, trace, capsys):
    res = small_run(cell, trace=trace)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    keys += ["breakdown"] * trace + ["compared"]
    assert list(res) == keys
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == res
    assert res["correct"] is True and res["attempted"] > 0
    want = {m["name"] for m in run.cell_metrics(
        BM, cell, "per_layer" if trace else "end_to_end")}
    # on the CPU no device kernel runs, so no roofline share is read
    assert set(res["metrics"]) <= want
    if not trace:
        assert set(res["metrics"]) == want
    lim = json.loads((ROOT / "bench" / "limits" / f"{cell}.json")
                     .read_text())
    assert set(res["compared"]) == set(lim)


def _bare_run(cwd):
    env = dict(os.environ, PYTHONPATH="")
    return subprocess.run(
        [sys.executable, "bench/run.py", "--workload", CELLS[0], "--seed",
         "1", "--seconds", "1", "--trace", "0"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = _bare_run(ROOT)
    assert p.returncode != 0 and p.stdout == ""
    assert "no CUDA device" in p.stderr


def test_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _bare_run(tmp_path)
    assert p.returncode != 0 and p.stdout == ""
    assert "cannot be imported" in p.stderr
