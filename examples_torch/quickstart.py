"""Quickstart: train a small qwen3-family model end to end on the card.

  PYTHONPATH=src python examples_torch/quickstart.py               # the card
  PYTHONPATH=src python examples_torch/quickstart.py --device cpu  # seconds
  PYTHONPATH=src python examples_torch/quickstart.py --full  # 300 steps,
                                                             # B=16, S=512

Demonstrates the public API: config -> params -> train step (the
hand-written attention kernels forward and backward on the card) ->
checkpoints.

Port of ``examples/quickstart.py`` on ``repro_torch.launch.train.main``:
the reference's arguments plus ``--device``; the checkpoints go to a
temporary directory, removed at the end.
"""
import argparse
import sys
import tempfile

sys.path.insert(0, "src")

from repro_torch.launch.train import main as train_main  # noqa: E402


def run(full: bool = False, device: str = "cuda"):
    with tempfile.TemporaryDirectory(prefix="repro_quick_") as ckpt:
        return _run(full, device, ckpt)


def _run(full: bool, device: str, ckpt: str):
    if full:
        argv = [
            "--arch", "qwen3-8b", "--reduced", "--steps", "300",
            "--batch", "16", "--seq", "512", "--ckpt-dir", ckpt,
        ]
    else:
        argv = [
            "--arch", "qwen3-8b", "--reduced", "--steps", "30",
            "--batch", "8", "--seq", "128", "--ckpt-dir", ckpt,
        ]
    out = train_main(argv + ["--device", device])
    losses = out["losses"]
    print(f"first loss {losses[0]:.3f} -> last loss {losses[-1]:.3f}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"the loss did not fall: {losses}")
    print("OK")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    run(**vars(ap.parse_args()))
