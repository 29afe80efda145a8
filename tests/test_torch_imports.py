"""Hygiene of the port: it imports neither JAX nor the reference package, its
entry points run on the card unless the CPU is asked for, and its kernel
wrappers never fall back from the card to the CPU."""
import ast
import pathlib
import types

import numpy as np
import pytest
import torch

import repro.fleet
import repro.obs
import repro.sched
import repro_torch.fleet
import repro_torch.obs
import repro_torch.sched

from repro_torch.configs.base import get_config, reduced
from repro_torch.kernels import _build
from repro_torch.kernels import decode_attention as dec_mod
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import lags_select as lags_mod
from repro_torch.kernels import ssm_scan as ssm_mod
from repro_torch.launch import serve
from repro_torch.models import model
from repro_torch.models.params import init_params
from repro_torch.sched import cuda_backend
from repro_torch.serving.engine import Engine, EngineConfig

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_reference(path):
    bad = {"jax", "jaxlib", "repro"} & set(_imported_roots(path))
    assert not bad, f"{path} imports {sorted(bad)}"


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_engine_raises_without_card_unless_cpu(no_card):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(EngineConfig(), {})
    assert Engine(EngineConfig(), {}, device="cpu").device.type == "cpu"


def test_model_entry_points_raise_without_card_unless_cpu(no_card):
    cfg = reduced(get_config("qwen3-8b"), n_layers=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_cache(cfg, 2, 8)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    cache = model.init_cache(cfg, 2, 8, device="cpu")
    batch = {"tokens": np.zeros((2, 1), np.int32)}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.decode_step(params, cfg, batch, cache, 0)
    logits, _ = model.decode_step(params, cfg, batch, cache, 0, device="cpu")
    assert logits.shape == (2, cfg.vocab_size)
    assert torch.isfinite(logits).all()


@pytest.mark.parametrize("name", ["qwen3-8b", "falcon-mamba-7b"])
def test_prefill_raises_without_card_unless_cpu(no_card, name):
    cfg = reduced(get_config(name), n_layers=2)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = {"tokens": np.zeros((2, 5), np.int32)}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.prefill(params, cfg, batch)
    logits, cache = model.prefill(params, cfg, batch, max_len=8, device="cpu")
    assert logits.shape == (2, cfg.vocab_size)
    assert torch.isfinite(logits).all()
    assert len(cache) == cfg.n_layers
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.decode_step(params, cfg, {"tokens": np.zeros((2, 1), np.int32)},
                          cache, 5)


@pytest.mark.parametrize("name", ["qwen2-moe-a2.7b", "qwen3-moe-235b-a22b",
                                  "jamba-v0.1-52b", "gemma3-27b",
                                  "qwen2-vl-7b", "hubert-xlarge"])
def test_new_families_raise_without_card_unless_cpu(no_card, name):
    """The MoE, hybrid, windowed, vision and encoder-only configs take the
    same entry points: cuda by default, the CPU only when asked."""
    from repro_torch.distributed import sharding
    from repro_torch.models import moe

    cfg = reduced(get_config(name))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg, torch.Generator())
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    if cfg.frontend == "audio_frames":
        batch = {"frames": np.zeros((2, 8, cfg.d_model), np.float32)}
    else:
        batch = {"tokens": np.zeros((2, 8), np.int32)}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.prefill(params, cfg, batch)
    logits, cache = model.prefill(params, cfg, batch, max_len=9, device="cpu")
    assert logits.shape == (2, cfg.vocab_size)
    assert torch.isfinite(logits).all()
    assert (cache is None) == cfg.encoder_only
    if cfg.n_experts:  # the reference's names, its mesh constraint too
        assert {"moe_specs", "_capacity", "moe"} <= set(vars(moe))
        assert vars(moe)["constrain"] is sharding.constrain


def test_serve_raises_without_card_unless_cpu(no_card, capsys):
    argv = ["--tenants", "8", "--duration", "0.5"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(argv)
    assert len(serve.main(argv + ["--device", "cpu"]).completed) >= 0
    assert "policy=lags" in capsys.readouterr().out


def test_tick_and_pick_on_cuda_request_raises(no_card):
    z = np.zeros(4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cuda_backend.tick_and_pick(z, z, z, np.ones(4, bool), 2)


def test_wrappers_do_not_fall_back_to_the_plain_version(monkeypatch):
    """A tensor that is not on the CPU never reaches the plain version."""
    def boom(*a, **k):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(lags_mod, "lags_select_plain", boom)
    monkeypatch.setattr(dec_mod, "decode_attention_plain", boom)
    monkeypatch.setattr(fa_mod, "flash_attention_plain", boom)
    monkeypatch.setattr(ssm_mod, "ssm_scan_plain", boom)
    m = lambda *s, dt=torch.float32: torch.empty(*s, dtype=dt, device="meta")  # noqa: E731
    with pytest.raises(ValueError, match="cuda or cpu"):
        lags_mod.lags_select(m(8), m(8), m(8), m(8, dt=torch.bool), 2)
    with pytest.raises(ValueError, match="cuda or cpu"):
        dec_mod.decode_attention(m(1, 2, 16), m(1, 2, 32, 16),
                                 m(1, 2, 32, 16), m(1, dt=torch.int32))
    with pytest.raises(ValueError, match="cuda or cpu"):
        fa_mod.flash_attention(m(1, 4, 32, 16), m(1, 2, 32, 16),
                               m(1, 2, 32, 16))
    with pytest.raises(ValueError, match="cuda or cpu"):
        ssm_mod.ssm_scan(m(1, 8, 32, 16), m(1, 8, 32, 16), m(1, 8, 16),
                         m(1, 32, 16))
    with pytest.raises(ValueError, match="several devices"):
        lags_mod.lags_select(m(8), torch.zeros(8), m(8), m(8, dt=torch.bool), 2)
    with pytest.raises(ValueError, match="several devices"):
        fa_mod.flash_attention(m(1, 4, 32, 16), torch.zeros(1, 2, 32, 16),
                               m(1, 2, 32, 16))
    with pytest.raises(ValueError, match="several devices"):
        ssm_mod.ssm_scan(m(1, 8, 32, 16), m(1, 8, 32, 16), m(1, 8, 16),
                         torch.zeros(1, 32, 16))


def test_backward_wrappers_run_only_on_cuda(monkeypatch):
    """The backward kernels' wrappers take tensors on a card: a tensor on
    the CPU or elsewhere raises, and never reaches the plain version."""
    def boom(*a, **k):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(fa_mod, "flash_attention_bwd_plain", boom)
    monkeypatch.setattr(ssm_mod, "ssm_scan_bwd_plain", boom)
    for dev in ("cpu", "meta"):
        t = lambda *s: torch.zeros(*s, device=dev)  # noqa: E731
        with pytest.raises(ValueError, match="runs on cuda"):
            fa_mod.flash_attention_bwd(t(1, 2, 8, 16), t(1, 2, 8, 16),
                                       t(1, 2, 8, 16), t(1, 2, 8, 16),
                                       t(1, 2, 8, 16))
        with pytest.raises(ValueError, match="runs on cuda"):
            ssm_mod.ssm_scan_bwd(t(1, 4, 32, 16), t(1, 4, 32, 16),
                                 t(1, 4, 16), t(1, 32, 16), t(1, 4, 32),
                                 None)


def test_train_entry_points_raise_without_card_unless_cpu(no_card, capsys):
    from repro_torch.launch import train
    from repro_torch.train import train_loop
    from repro_torch.train.data import TokenStream

    cfg = reduced(get_config("stablelm-1.6b"), n_layers=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_loop.init_state(cfg, torch.Generator())
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = TokenStream(cfg, 2, 8).batch_at(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.train_loss(params, cfg, batch)
    loss, _ = model.train_loss(params, cfg, batch, device="cpu")
    assert torch.isfinite(loss)
    argv = ["--reduced", "--steps", "1", "--batch", "2", "--seq", "8"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(argv)
    assert len(train.main(argv + ["--device", "cpu"])["losses"]) == 1
    assert "step 0: loss" in capsys.readouterr().out


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()


def _public(pkg):
    """The names a package exports, without its submodules."""
    return {n for n, v in vars(pkg).items()
            if not n.startswith("_") and not isinstance(v, types.ModuleType)}


@pytest.mark.parametrize("name", ["sched", "fleet", "obs"])
def test_packages_export_the_reference_names(name):
    port, ref = (getattr(repro_torch, name), getattr(repro, name))
    assert _public(port) == _public(ref)
    assert getattr(port, "__all__", None) == getattr(ref, "__all__", None)
    if name == "sched":
        from repro_torch.sched import PolicySpec, register, spec
        assert isinstance(spec("lags"), PolicySpec) and callable(register)


def test_chaos_fleet_raises_without_card_unless_cpu(no_card):
    from repro_torch.fleet import FaultSchedule, place, simulate_fleet_chaos
    asg = place("round-robin", 6, 2)
    crash = FaultSchedule.single_crash(1, 1.0, 2)
    kw = dict(duration_s=2.0, epoch_s=1.0, exec_s=0.1, backend="torch")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        simulate_fleet_chaos("lags", asg, crash, **kw)
    res = simulate_fleet_chaos("lags", asg, crash, device="cpu", **kw)
    assert res.epochs[0].fleet.backend == "torch" and res.n_completed > 0


def test_make_local_mesh_raises_without_card_unless_cpu(no_card):
    """The mesh is a cuda mesh unless the CPU is asked for: no card, no
    NCCL group, and nothing falls back to gloo."""
    import torch.distributed as dist

    from repro_torch.launch import mesh

    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.make_local_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.make_production_mesh()
    assert not dist.is_initialized()
    try:
        cpu = mesh.make_local_mesh(device="cpu")
        assert dist.get_backend() == "gloo" and cpu.device_type == "cpu"
    finally:
        dist.destroy_process_group()
    m = mesh.abstract_production_mesh(multi_pod=True)
    assert (m.mesh_dim_names, m.shape) == (("pod", "data", "model"),
                                           (2, 16, 16))
