"""Every config's sharded prefill, decode and train step, reduced, on a
small gloo mesh of CPU processes with DTensor's plans refused: prints,
for each config and step, "ok" or the first plan of DTensor's own (or
other error) and where the port made it.

    PYTHONPATH=src python tests/torch_plan_sweep.py 2x1 [KV,...] [B]

runs the mesh (data, model) = (2, 1) with each config's own KV heads
(KV 0) and with the KV heads of the list (e.g. 0,1), on batches of B
rows (default 4), S = 8.  Not a test: a sweep over configs and meshes
that the two-rank tests do not all run (one-rank axes, batches of one
row), about a minute a mesh.
"""
import json
import os
import sys
import tempfile
import traceback

CONFIGS = ["qwen3-8b", "stablelm-1.6b", "mistral-nemo-12b", "falcon-mamba-7b",
           "gemma3-27b", "hubert-xlarge", "qwen2-vl-7b", "qwen2-moe-a2.7b",
           "qwen3-moe-235b-a22b", "jamba-v0.1-52b"]
OVERRIDES = {"gemma3-27b": {"sliding_window": 4},
             "qwen2-vl-7b": {"n_vision_tokens": 4}}
S = 8


def _where(e) -> str:
    """The port's innermost frames of the error, outermost last."""
    frames = [f for f in traceback.extract_tb(e.__traceback__)
              if "repro_torch" in f.filename]
    return " <- ".join(f"{f.filename.split('repro_torch/')[1]}:{f.lineno}"
                       for f in frames[-3:][::-1])


def _batch(cfg, B, g):
    import torch

    if cfg.frontend == "audio_frames":
        batch = {"frames": torch.randn(B, S, cfg.d_model, generator=g)}
    else:
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                         generator=g, dtype=torch.int32)}
    if cfg.frontend == "vision":
        batch["vision_embeds"] = torch.randn(B, cfg.n_vision_tokens,
                                             cfg.d_model, generator=g)
        batch["positions"] = torch.arange(S, dtype=torch.int32)[
            None, :, None].expand(B, S, 3).contiguous()
    return batch


def _steps(cfg, mesh, B):
    """Prefill and two decode steps, then a train step, on ``mesh``."""
    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import specs
    from repro_torch.models import model
    from repro_torch.models import params as P
    from repro_torch.train import train_loop

    g = torch.Generator().manual_seed(0)
    batch = _batch(cfg, B, g)
    out = {}
    try:
        params = P.shard_params(cfg, P.init_params(
            cfg, torch.Generator().manual_seed(0), device="cpu"), mesh,
            sh.TRAIN_RULES)
        placed = sh.distribute(batch, specs._batch_sds(
            cfg, ShapeConfig("prefill", S, B, "prefill"), "prefill",
            sh.TRAIN_RULES, mesh)[1], mesh)
        with sh.sharding_ctx(mesh, sh.TRAIN_RULES):
            _, cache = model.prefill(params, cfg, placed, max_len=S + 16,
                                     device="cpu")
        if not cfg.encoder_only:
            low = specs.build_lowerable(cfg, ShapeConfig("decode", S, B,
                                                         "decode"), mesh)
            params = sh.distribute(params, low.in_shardings[0], mesh)
            cache = sh.distribute(cache, low.in_shardings[2], mesh)
            for i in range(2):
                step = {"tokens": torch.randint(
                    0, cfg.vocab_size, (B, 1), generator=g,
                    dtype=torch.int32)}
                if cfg.frontend == "vision":
                    step["positions"] = torch.full((B, 1, 3), S + i,
                                                   dtype=torch.int32)
                step = sh.distribute(step, low.in_shardings[1], mesh)
                with sh.sharding_ctx(mesh, low.rules):
                    _, cache = low.fn(params, step, cache, S + i)
        out["serve"] = "ok"
    except Exception as e:  # noqa: BLE001 - the sweep reports every error
        out["serve"] = f"{type(e).__name__}: {str(e)[:200]} @ {_where(e)}"
    try:
        batch = dict(batch, loss_mask=torch.ones(B, S), targets=torch.randint(
            0, cfg.vocab_size, (B, S), generator=g, dtype=torch.int32))
        low = specs.build_lowerable(cfg, ShapeConfig("train", S, B, "train"),
                                    mesh, train_loop.TrainConfig())
        state = train_loop.init_state(cfg, torch.Generator().manual_seed(0),
                                      device="cpu", mesh=mesh,
                                      rules=low.rules)
        placed = sh.distribute(batch, low.in_shardings[1], mesh)
        with sh.sharding_ctx(mesh, low.rules):
            low.fn(state, placed)
        out["train"] = "ok"
    except Exception as e:  # noqa: BLE001
        out["train"] = f"{type(e).__name__}: {str(e)[:200]} @ {_where(e)}"
    return out


def _rank(rank, world, shape, store, kvs, B, out):
    import torch_sharded_world as world_lib
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.launch.mesh import make_local_mesh

    with world_lib.gloo_rank(rank, world, store):
        mesh = make_local_mesh(*shape, device="cpu")
        res = {}
        for name in CONFIGS:
            for kv in kvs:
                ov = dict(OVERRIDES.get(name, {}), **(
                    {"n_kv_heads": kv} if kv else {}))
                for step, what in _steps(reduced(get_config(name), **ov),
                                         mesh, B).items():
                    res[f"{name} kv={kv or 'own'} {step}"] = what
        if rank == 0:
            with open(out, "w") as fh:
                json.dump(res, fh)


def main(argv):
    import torch.multiprocessing as mp

    shape = tuple(int(x) for x in argv[0].split("x"))
    kvs = [int(x) for x in argv[1].split(",")] if len(argv) > 1 else [0]
    B = int(argv[2]) if len(argv) > 2 else 4
    tmp = tempfile.mkdtemp()
    out = os.path.join(tmp, "out.json")
    mp.spawn(_rank, args=(shape[0] * shape[1], shape, f"{tmp}/store", kvs, B,
                          out), nprocs=shape[0] * shape[1])
    with open(out) as fh:
        for key, what in json.load(fh).items():
            print(f"{argv[0]} B={B} {key}: {what}")


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    main(sys.argv[1:])
