"""Fault-tolerant checkpointing: per-leaf ``.npy`` files, a sha256 manifest,
an atomic commit.

Port of ``repro.train.checkpoint``:
  * every leaf of the tree is written as its own ``.npy`` file keyed by its
    path ("params/layers/3/attn/wq", "opt/mu/...", "opt/step");
  * atomic commit: write to ``step_N.tmp/``, fsync the manifest, rename to
    ``step_N/``; ``MANIFEST.json`` holds each file's sha256, shape and
    dtype, so a torn write is never visible as a valid checkpoint;
  * resume: ``latest_step`` finds the highest committed manifest, ``verify``
    checks its hashes, ``restore`` loads it into the structure and devices
    of a given tree.
numpy has no bfloat16: a bf16 leaf is stored as its raw 16 bits (uint16)
and the manifest names its dtype "bfloat16".  The reference's re-sharding
on restore waits for the port's sharding.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.train.tree import flatten_with_path, unflatten


def _flatten(tree) -> dict:
    return {"/".join(str(k) for k in path): leaf
            for path, leaf in flatten_with_path(tree)}


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _to_numpy(leaf):
    """(array to write, dtype name for the manifest)."""
    if torch.is_tensor(leaf):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.uint16).numpy(), "bfloat16"
        return t.numpy(), str(t.numpy().dtype)
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save(ckpt_dir: str, step: int, tree: Any) -> str:
    """Atomically write a checkpoint; returns the committed directory."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "files": {}}
    for key, leaf in _flatten(tree).items():
        arr, dtype = _to_numpy(leaf)
        fname = key.replace("/", "__") + ".npy"
        fpath = os.path.join(tmp, fname)
        np.save(fpath, arr)
        manifest["files"][key] = {
            "file": fname,
            "sha256": _sha256(fpath),
            "shape": list(arr.shape),
            "dtype": dtype,
        }
    with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic commit
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    """Highest step with a committed manifest."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and not d.endswith(".tmp"):
            mf = os.path.join(ckpt_dir, d, "MANIFEST.json")
            if os.path.exists(mf):
                steps.append(int(d.split("_")[1]))
    return max(steps) if steps else None


def verify(ckpt_dir: str, step: int) -> bool:
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    try:
        with open(os.path.join(d, "MANIFEST.json")) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError):
        return False
    for meta in manifest["files"].values():
        fpath = os.path.join(d, meta["file"])
        if not os.path.exists(fpath) or _sha256(fpath) != meta["sha256"]:
            return False
    return True


def restore(ckpt_dir: str, step: int, like: Any):
    """Restore into the structure of ``like``: each tensor leaf comes back
    on its ``like`` leaf's device, with its ``requires_grad``."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "MANIFEST.json")) as f:
        manifest = json.load(f)
    flat_like = _flatten(like)
    if set(flat_like) != set(manifest["files"]):
        raise ValueError(f"checkpoint/like mismatch: "
                         f"{set(flat_like) ^ set(manifest['files'])}")
    out = []
    for key, ref in flat_like.items():
        meta = manifest["files"][key]
        arr = np.load(os.path.join(d, meta["file"]))
        if meta["dtype"] == "bfloat16":
            t = torch.from_numpy(arr).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        if torch.is_tensor(ref):
            t = t.to(ref.device).requires_grad_(ref.requires_grad)
        out.append(t)
    return unflatten(like, out)
