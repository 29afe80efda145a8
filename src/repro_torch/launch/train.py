"""End-to-end training driver with fault-tolerant checkpointing.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b \\
      --reduced --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt

Port of ``repro.launch.train``: the reference's flags, plus ``--device``
(default cuda; ``--device cpu`` runs on the CPU with the kernels' plain
versions).  Resume is automatic: if the checkpoint dir holds a committed
step whose hashes verify, training continues from it (deterministic data
makes the stream seamless).  ``--simulate-failure N`` exits hard with code
17 after step N to exercise the restart path.  Parameters are drawn from
seed 0 with the reference's init rule (``models/params.py``).
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import torch

from repro_torch.configs.base import get_config, reduced
from repro_torch.device import resolve
from repro_torch.distributed.fault import StragglerWatchdog
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import train_loop
from repro_torch.train.data import DataConfig, TokenStream
from repro_torch.train.optimizer import OptConfig


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--simulate-failure", type=int, default=-1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--obs-dir", default="",
                    help="record step-time metrics (and trace) run record")
    ap.add_argument("--trace", action="store_true",
                    help="capture per-step Chrome trace events")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve(args.device)

    if args.obs_dir or args.trace:
        import repro_torch.obs as obs

        obs.enable()
        if args.trace:
            obs.install_tracer()

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    tc = train_loop.TrainConfig(
        accum_steps=args.accum,
        compress_grads=args.compress_grads,
        opt=OptConfig(lr=args.lr, warmup_steps=5, total_steps=args.steps),
    )
    step_fn = train_loop.instrument_step(
        train_loop.make_train_step(cfg, tc),
        tokens_per_step=args.batch * args.seq * max(args.accum, 1))
    stream = TokenStream(cfg, args.batch, args.seq, DataConfig())

    start = 0
    gen = torch.Generator(device=dev).manual_seed(0)
    state = train_loop.init_state(cfg, gen, device=dev)
    if args.ckpt_dir:
        latest = ckpt_lib.latest_step(args.ckpt_dir)
        if latest is not None and ckpt_lib.verify(args.ckpt_dir, latest):
            state = ckpt_lib.restore(args.ckpt_dir, latest, state)
            start = latest
            print(f"resumed from step {latest}")

    watchdog = StragglerWatchdog(n_hosts=1)
    losses, seconds = [], []
    for step in range(start, args.steps):
        t0 = time.time()
        state, metrics = step_fn(state, stream.batch_at(step))
        loss = float(metrics["loss"])  # waits for the step
        losses.append(loss)
        seconds.append(time.time() - t0)
        watchdog.observe(0, seconds[-1])
        if step % 5 == 0 or step == args.steps - 1:
            print(f"step {step}: loss {loss:.4f} "
                  f"({time.time()-t0:.2f}s)")
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            ckpt_lib.save(args.ckpt_dir, step + 1, state)
        if args.simulate_failure == step:
            print("simulating hard failure", file=sys.stderr)
            sys.stdout.flush()
            os._exit(17)
    if args.obs_dir:
        from repro_torch.obs.recorder import record_run

        path = record_run(
            args.obs_dir,
            meta={
                "layer": "train", "arch": args.arch, "steps": args.steps,
                "batch": args.batch, "seq": args.seq, "accum": args.accum,
                "device": str(dev),
            },
        )
        print(f"run record -> {path}")
    return {"losses": losses, "final_step": args.steps, "seconds": seconds}


if __name__ == "__main__":
    main()
