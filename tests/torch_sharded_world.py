"""Shared by tests/test_torch_sharded_*.py: the reference's sharded prefill
and decode in a JAX subprocess, and the port's in gloo worlds.

``reference(tmp, name, overrides, meshes, prompt, noise)`` runs one JAX
subprocess (``XLA_FLAGS=--xla_force_host_platform_device_count=4``) that
initialises the reduced config's parameters and draws the batch that
``launch/specs.py::_batch_sds`` describes: tokens, or frames for the audio
frontend; for the vision frontend also vision embeddings over the first
rows and three position streams, row 1's stream 0 off the row index (in
prefill from position 5 on, in decode below the cache length).  Then on
each ("data", "model") mesh of its host devices it runs ``jax.jit(
model.prefill, in_shardings=...)`` under ``TRAIN_RULES`` (max_len = S +
``DECODE_PAD``, the batch placed by ``_batch_sds``' specs) and two
``decode_step``s through ``build_lowerable``'s decode cell under
``DECODE_RULES``, the cache placed by its ``cache_specs`` (the
encoder-only forward has neither cache nor decode).  With ``noise`` it
also measures how far its own unsharded outputs move when its embeddings
move by 1e-7 (relative), the tolerance of a chaotic stack.  It writes the
parameters, the batches, and each mesh's logits and cache (gathered) to
``.npz`` files.

``run_all(tmp, name, overrides, meshes)`` runs the port's same steps in
gloo worlds of data x model processes (forked by a server process that
imported torch and the port once, ``_spawn``; a ``FileStore``): parameters placed by ``params.shard_params`` and the batch
by ``_batch_sds``' specs, prefill under ``sharding_ctx(mesh,
TRAIN_RULES)``, then the decode cell's ``fn`` on arguments placed by its
``in_shardings`` under its rules.  Each rank records its local parameter
and cache bytes beside those its shards should hold by the rules, and the
local shapes its kernel wrappers ran on; rank 0 writes the gathered logits
and caches.  DTensor's own collectives and plans are refused in the
ranks (``gloo_rank``), and each rank records the collectives that prefill
and each decode step issue (``sharding.recording``).

``run_cases`` starts every case's reference at once, and runs each case's
worlds once its reference has ended.  A reference waits for one of
``REF_SLOTS`` lock files shared by the session's test workers before it
starts its work.  A reference, a world's ranks and a child of the dry
run's cells report their progress to a file as they start and end each
unit of their work; each fails once it has reported none for ``JOIN_S``
(a train reference: ``REF_TRAIN_S``), counted from its start or its last
report (``_left``), so that load slows it without failing it.

``fake_cells(cases)`` runs cells of the dry run (``launch/dryrun.py::
execute``) on reduced configs and small meshes of a fake process group in
a child process, and returns what each recorded.

This module imports no JAX, so that the spawned ranks do not either.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
# A world or a reference fails, instead of hanging, once it has reported no
# progress for this long: each child appends a line to its progress file
# as it starts and as it ends each unit of its work (a mesh, a step), and
# its deadline is that long after its start or its last line (``_left``),
# so that a host loaded by the other test workers slows every unit without
# failing it, while a child that hangs still fails within the limit
JOIN_S = 120
# a train reference's units are larger: the state's draw, and each mesh's
# compilation of the step (80 s for the reduced jamba's first beside the
# other test workers)
REF_TRAIN_S = 300
B, S = 2, 8  # batch and prompt; the cache holds S + DECODE_PAD = 24 rows
N_DECODE = 2
# one thread a process: a file's reference and its worlds' ranks run beside
# the other test workers' processes, and XLA's and torch's own thread pools
# (one thread a core each) would oversubscribe the cores many times over
ONE_THREAD = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
              "OPENBLAS_NUM_THREADS": "1"}

# JAX references that run at once, over every test worker of a session:
# each reference takes one of this many lock files before it starts
# (``_PRELUDE``'s ``take_slot``), so that the test workers' references,
# all of a file's started at once, do not oversubscribe the cores
REF_SLOTS = max(2, (os.cpu_count() or 4) // 2)

# the start of a child's script: its report of progress (``report``), and
# its slot among the references (``take_slot``), waited for with a report
# every 10 s, then held until the child ends
_PRELUDE = r"""
import os, time


def report(what):
    with open(os.environ["SHARDED_PROGRESS"], "a") as fh:
        fh.write(f"{time.time():.3f} {what}\n")


def take_slot():
    import fcntl

    slots, said = os.environ.get("SHARDED_SLOTS"), 0.0
    while slots:
        for i in range(int(os.environ["SHARDED_SLOT_COUNT"])):
            fh = open(os.path.join(slots, f"reference_slot{i}"), "a")
            try:
                fcntl.flock(fh, fcntl.LOCK_EX | fcntl.LOCK_NB)
                return fh
            except OSError:
                fh.close()
        if time.time() - said >= 10:
            report("waiting for a slot")
            said = time.time()
        time.sleep(0.2)


slot = take_slot()
report("started")
"""

REF_SCRIPT = _PRELUDE + r"""
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs.base import ShapeConfig, get_config, reduced
from repro.distributed.sharding import TRAIN_RULES, sharding_ctx
from repro.launch import specs
from repro.models import model
from repro.models.params import spec_to_pspecs

name, overrides, B, S, n_decode, meshes, noise, out = json.loads(sys.argv[1])
cfg = reduced(get_config(name), **overrides)
params = model.init_params(cfg, jax.random.PRNGKey(0))
report("parameters")
rng = np.random.default_rng(0)
L = S + specs.DECODE_PAD


def flat(tree, prefix):
    res = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        res[prefix + key] = np.asarray(leaf)
    return res


# the batches of _batch_sds: tokens or frames; vision rows and three
# position streams, row 1's stream 0 off the row index from position 5
# (prefill) and below the cache length (decode)
if cfg.frontend == "audio_frames":
    batch = {"frames": rng.standard_normal((B, S, cfg.d_model)).astype(
        cfg.dtype)}
else:
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32)}
steps = [{"tokens": rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)}
         for _ in range(0 if cfg.encoder_only else n_decode)]
if cfg.frontend == "vision":
    batch["vision_embeds"] = rng.standard_normal(
        (B, cfg.n_vision_tokens, cfg.d_model)).astype(cfg.dtype)
    idx = np.arange(S, dtype=np.int32)
    pos = np.stack([idx, idx // 4 + rng.integers(0, 3, S),
                    idx % 4 + rng.integers(0, 5, S)], -1).astype(np.int32)
    pos = np.broadcast_to(pos, (B, S, 3)).copy()
    pos[1, 5:, 0] += 3
    batch["positions"] = pos
    for i, st in enumerate(steps):
        st["positions"] = np.full((B, 1, 3), S + i, np.int32)
        st["positions"][1, 0] = [5 + i, S + i, S]
res = {"batch/" + k: v for k, v in batch.items()}
for i, st in enumerate(steps):
    res.update({f"step{i}/{k}": v for k, v in st.items()})
np.savez(out + "/params.npz", **flat(params, ""))


# unsharded: compiled once for every noise draw
prefill1 = jax.jit(lambda p, b: model.prefill(p, cfg, b, max_len=L))
decode1 = jax.jit(lambda p, b, c, n: model.decode_step(p, cfg, b, c, n))


def run(params, mesh):
    # prefill under TRAIN_RULES, then the decode cell's steps under its
    # rules, on mesh (None: unsharded); {key: array}
    got = {}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    if mesh is None:
        logits, cache = prefill1(params, jb)
    else:
        ns = lambda t: jax.tree_util.tree_map(
            lambda ps: NamedSharding(mesh, ps), t,
            is_leaf=lambda x: isinstance(x, P))
        pps = spec_to_pspecs(model.abstract_params(cfg), rules=TRAIN_RULES,
                             mesh=mesh)
        bps = specs._batch_sds(cfg, ShapeConfig("prefill", S, B, "prefill"),
                               "prefill", TRAIN_RULES, mesh)[1]
        with mesh, sharding_ctx(mesh, TRAIN_RULES):
            prefill = jax.jit(lambda p, b: model.prefill(p, cfg, b,
                                                         max_len=L),
                              in_shardings=(ns(pps), ns(bps)))
            logits, cache = prefill(params, jb)
    got["logits0"] = np.asarray(logits)
    got.update(flat(cache, "prefill/"))
    report("prefill")
    if not steps:
        return got
    if mesh is None:
        for i, st in enumerate(steps):
            logits, cache = decode1(params, {k: jnp.asarray(v) for k, v in
                                            st.items()}, cache,
                                   jnp.int32(S + i))
            got[f"logits{i + 1}"] = np.asarray(logits)
    else:
        low = specs.build_lowerable(cfg, ShapeConfig("decode", S, B,
                                                     "decode"), mesh)
        sh_in = ns(low.in_shardings)
        p_dec = jax.device_put(params, sh_in[0])
        cache = jax.device_put(cache, sh_in[2])
        with mesh, sharding_ctx(mesh, low.rules):
            decode = jax.jit(low.fn, in_shardings=sh_in)
            for i, st in enumerate(steps):
                b = jax.device_put({k: jnp.asarray(v) for k, v in
                                    st.items()}, sh_in[1])
                logits, cache = decode(p_dec, b, cache, jnp.int32(S + i))
                got[f"logits{i + 1}"] = np.asarray(logits)
                report(f"decode step {i}")
    got.update(flat(cache, "decode/"))
    return got


for shape in meshes:
    n = shape[0] * shape[1]
    mesh = Mesh(np.asarray(jax.devices()[:n]).reshape(shape),
                ("data", "model"))
    tag = f"{shape[0]}x{shape[1]}"
    res.update({f"{tag}/{k}": v for k, v in run(params, mesh).items()})
    report("mesh " + tag)
if noise:
    # the reference's own move, unsharded, when its embeddings move by
    # 1e-7 (relative): the most over ``noise`` draws, for each output
    clean = run(params, None)
    for seed in range(noise):
        report(f"noise {seed}")
        noisy = dict(params)
        noisy["embed"] = params["embed"] * (1 + 1e-7 * jax.random.normal(
            jax.random.PRNGKey(seed), params["embed"].shape))
        for k, v in run(noisy, None).items():
            d = float(np.abs(v.astype(np.float64) - clean[k]).max())
            res["move/" + k] = max(d, float(res.get("move/" + k, 0.0)))
np.savez(out + "/ref.npz", **res)
"""


# The reference's train step on each mesh: build_lowerable's train cell
# under jax.jit with its in_shardings (and the state's out_shardings), two
# steps on two batches; with each, the gradients the step takes (its own
# grads_of: value_and_grad, microbatches summed in f32 and divided, then
# constrain_like), handed out of the step in the parameters' layout by
# wrapping its apply_updates; with ``noise``, its own move on the first mesh
# under 1e-7 noise on the stack's inputs.
REF_TRAIN_SCRIPT = _PRELUDE + r"""
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs.base import ShapeConfig, get_config, reduced
from repro.distributed.sharding import sharding_ctx
from repro.launch import specs
from repro.train import optimizer, train_loop

name, overrides, B, S, accum, meshes, noise, out = json.loads(sys.argv[1])
cfg = reduced(get_config(name), **overrides)
state = train_loop.init_state(cfg, jax.random.PRNGKey(0))
report("state")
tc = train_loop.TrainConfig(accum_steps=accum)
rng = np.random.default_rng(0)


def flat(tree, prefix):
    res = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        res[prefix + key] = np.asarray(leaf)
    return res


def draw():
    # the first half of the rows keeps most positions, the second few: the
    # microbatches and the batch ranks' rows count unlike
    keep = np.where(np.arange(B)[:, None] < B // 2, 0.9, 0.3)
    draw = lambda: rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    b = {"tokens": draw(), "targets": draw(),
         "loss_mask": (rng.random((B, S)) < keep).astype(np.float32)}
    if cfg.frontend == "audio_frames":  # frames in place of the tokens
        del b["tokens"]
        b["frames"] = rng.standard_normal((B, S, cfg.d_model)).astype(
            cfg.dtype)
    if cfg.frontend == "vision":
        # vision rows over the first positions; three position streams,
        # row 1's stream 0 off the row index from position 5
        b["vision_embeds"] = rng.standard_normal(
            (B, cfg.n_vision_tokens, cfg.d_model)).astype(cfg.dtype)
        idx = np.arange(S, dtype=np.int32)
        pos = np.stack([idx, idx // 4 + rng.integers(0, 3, S),
                        idx % 4 + rng.integers(0, 5, S)], -1).astype(np.int32)
        pos = np.broadcast_to(pos, (B, S, 3)).copy()
        pos[1, 5:, 0] += 3
        b["positions"] = pos
    return b


batches = [draw() for _ in range(2)]
res = {f"batch{i}/{k}": v for i, b in enumerate(batches) for k, v in b.items()}
np.savez(out + "/params.npz", **flat(state.params, ""))
apply_updates = optimizer.apply_updates


def with_grads(params, grads, state, ocfg):
    # the step's own update, its metrics also holding the gradients it
    # takes (one compilation a mesh)
    p, st, m = apply_updates(params, grads, state, ocfg)
    return p, st, dict(m, grads=grads)


optimizer.apply_updates = with_grads
compiled = {}


def run(state, mesh, batches=batches):
    got = {}
    ns = lambda t: jax.tree_util.tree_map(
        lambda ps: NamedSharding(mesh, ps), t,
        is_leaf=lambda x: isinstance(x, P))
    low = specs.build_lowerable(cfg, ShapeConfig("train", S, B, "train"),
                                mesh, tc)
    sin = ns(low.in_shardings)
    if mesh not in compiled:  # the noise draws reuse one mesh's
        rep = NamedSharding(mesh, P())
        compiled[mesh] = jax.jit(low.fn, in_shardings=sin, out_shardings=(
            sin[0], dict({k: rep for k in ("aux", "grad_norm", "loss", "lr",
                                          "nll")},
                         grads=sin[0].params)))
    step = compiled[mesh]
    with mesh, sharding_ctx(mesh, low.rules):
        st = jax.device_put(state, sin[0])
        for i, b in enumerate(batches):
            jb = jax.device_put({k: jnp.asarray(v) for k, v in b.items()},
                                sin[1])
            st, m = step(st, jb)
            got.update(flat(m["grads"], f"grads{i}/"))
            got.update({f"metrics{i}/{k}": np.asarray(m[k])
                        for k in ("loss", "grad_norm", "lr")})
            got.update(flat(st.params, f"params{i}/"))
            got.update(flat(st.opt.mu, f"mu{i}/"))
            got.update(flat(st.opt.nu, f"nu{i}/"))
            report(f"step {i}")
    return got


first = None
for shape in meshes:
    n = shape[0] * shape[1]
    mesh = Mesh(np.asarray(jax.devices()[:n]).reshape(shape),
                ("data", "model"))
    got = run(state, mesh)
    first = first or (mesh, got)
    res.update({f"{shape[0]}x{shape[1]}/{k}": v for k, v in got.items()})
    report(f"mesh {shape[0]}x{shape[1]}")
if noise:
    # the reference's own move on the first mesh (its step compiled once)
    # when the stack's inputs, its embeddings and the batch's frames or
    # vision embeddings, move by 1e-7 (relative): the most over ``noise``
    # draws, for each entry of each output
    one, clean = first

    def moved(a, key):
        return (a * (1 + 1e-7 * np.asarray(jax.random.normal(
            key, a.shape)))).astype(a.dtype)

    for seed in range(noise):
        report(f"noise {seed}")
        key = jax.random.PRNGKey(seed)
        p = dict(state.params, embed=moved(state.params["embed"], key))
        bs = [{k: moved(v, jax.random.fold_in(key, 2 * j + n))
               if k in ("frames", "vision_embeds") else v
               for n, (k, v) in enumerate(sorted(b.items()))}
              for j, b in enumerate(batches)]
        for k, v in run(state._replace(params=p), one, bs).items():
            d = np.abs(v.astype(np.float64) - clean[k])
            res["move/" + k] = np.maximum(d, res.get("move/" + k, 0.0))
np.savez(out + "/ref.npz", **res)
"""
TRAIN_B = 4  # (2, 2) splits the batch; two microbatches of two rows


def reference_train(tmp: Path, name: str, overrides: dict, meshes,
                    accum: int = 1, seq: int = S,
                    noise: int = 0) -> subprocess.Popen:
    """Start the reference's train subprocess (REF_TRAIN_SCRIPT, B =
    ``TRAIN_B``, S = ``seq``; with ``noise`` draws, also its own move under
    1e-7 noise on the stack's inputs, ``move/<key>``); it writes
    tmp/params.npz, then tmp/ref.npz."""
    proc = _start(REF_TRAIN_SCRIPT, [name, overrides, TRAIN_B, seq, accum,
                                     [list(m) for m in meshes], noise,
                                     str(tmp)], tmp)
    proc.limit = REF_TRAIN_S
    return proc


def tag(shape) -> str:
    return f"{shape[0]}x{shape[1]}"


def _start(script: str, arg, tmp=None, slots=None) -> subprocess.Popen:
    """A JAX subprocess running ``script`` on ``arg`` (JSON), on four host
    devices, one thread: XLA's CPU client otherwise runs a pool of one
    thread a core.  A reference script (``_PRELUDE``) reports its progress
    to tmp/progress and takes one of ``REF_SLOTS`` lock files in ``slots``
    (default: the session's base temp dir, above the test worker's where
    pytest-xdist runs the workers; ``tmp`` lies in the worker's).  Its
    output goes to tmp/output, which no pipe can stop while it waits for
    its turn, and it is watched until it is waited for (``_watch``)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
                         "--xla_cpu_multi_thread_eigen=false", **ONE_THREAD)
    cmd = [sys.executable, "-c", script, json.dumps(arg)]
    if tmp is None:
        proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        proc.started, proc.progress = time.monotonic(), None
        return proc
    if slots is None:
        slots = Path(tmp).parent
        if "PYTEST_XDIST_WORKER" in os.environ:
            slots = slots.parent
    env.update(SHARDED_PROGRESS=str(tmp / "progress"),
               SHARDED_SLOTS=str(slots), SHARDED_SLOT_COUNT=str(REF_SLOTS))
    with open(tmp / "output", "w") as out:
        proc = subprocess.Popen(cmd, env=env, stdout=out,
                                stderr=subprocess.STDOUT)
    proc.started, proc.progress = time.monotonic(), tmp / "progress"
    proc.output = tmp / "output"
    _LIVE.append(proc)
    return proc


#: the references started and not yet waited for (``_watch``)
_LIVE: list = []


def _watch() -> None:
    """Kill each reference of ``_LIVE`` that runs and has reported no
    progress for its limit, marking it ``stalled`` for the wait that comes
    to it: a reference holds its slot until it ends, and the test waits
    for one reference at a time, while the others wait for slots."""
    for p in _LIVE:
        if p.poll() is None and _left(p, getattr(p, "limit", JOIN_S)) <= 0:
            p.stalled = True
            p.kill()


def report(progress, what: str) -> None:
    """Append "<time> <what>" to the progress file ``progress`` (a rank's
    report; a child's script has its own, ``_PRELUDE``)."""
    with open(progress, "a") as fh:
        fh.write(f"{time.time():.3f} {what}\n")


def _left(child, limit: float) -> float:
    """The seconds left to ``child`` (a reference's ``Popen`` or a world's
    spawn context, each with its ``started`` and ``progress``): ``limit``
    after its start or after the last line of its progress file, whichever
    is later."""
    last = child.started
    try:  # the file's time of change, on the monotonic clock
        last = max(last, time.monotonic() - time.time()
                   + os.path.getmtime(child.progress))
    except (OSError, TypeError):
        pass
    return last + limit - time.monotonic()


def _reports(child) -> str:
    """The child's progress file, each line's time from its start."""
    try:
        lines = Path(child.progress).read_text().splitlines()
    except (OSError, TypeError):
        return "  none"
    t0 = time.time() - (time.monotonic() - child.started)
    return "\n".join(f"  {float(t) - t0:8.1f} s {what}" for t, what in
                     (line.split(" ", 1) for line in lines)) or "  none"


def reference(tmp: Path, name: str, overrides: dict, meshes,
              prompt: int = S, noise: int = 0) -> subprocess.Popen:
    """Start the reference's subprocess (prompts of ``prompt`` positions;
    with ``noise`` draws, also its unsharded outputs' move under 1e-7
    noise on the embeddings, ``move/<key>``); it writes tmp/params.npz,
    then tmp/ref.npz."""
    return _start(REF_SCRIPT, [name, overrides, B, prompt, N_DECODE,
                               [list(m) for m in meshes], noise, str(tmp)],
                  tmp)


def _wait(proc: subprocess.Popen, limit: float, what: str) -> tuple:
    """Wait for the child ``proc`` to end and return its (stdout, stderr);
    kill it and fail once it has reported no progress for ``limit`` while
    it ran.  The other references are watched meanwhile (``_watch``)."""
    try:
        while True:
            _watch()
            if getattr(proc, "stalled", False) or (
                    proc.poll() is None and _left(proc, limit) <= 0):
                proc.kill()
                proc.communicate()
                raise AssertionError(f"{what} reported no progress in "
                                     f"{limit} s; its reports:\n"
                                     f"{_reports(proc)}")
            try:
                out, err = proc.communicate(timeout=min(max(
                    _left(proc, limit), 0.1), 5.0))
            except subprocess.TimeoutExpired:
                continue
            if not getattr(proc, "stalled", False):
                break
    finally:
        if proc in _LIVE:
            _LIVE.remove(proc)
    if getattr(proc, "output", None) is not None:
        out = Path(proc.output).read_text(errors="replace")
    return out, err


def wait_reference(proc: subprocess.Popen) -> None:
    """Wait for a reference to end; fail once it has reported no progress
    for ``JOIN_S`` (a train reference's ``REF_TRAIN_S``)."""
    if getattr(proc, "waited", False):
        return
    out, _ = _wait(proc, getattr(proc, "limit", JOIN_S), "the reference")
    if proc.returncode != 0:
        raise AssertionError(f"the reference failed:\n{out[-3000:]}")
    proc.waited = True


def _tree(npz, prefix: str = "") -> dict:
    """The nested parameter tree from the reference's flattened keys (those
    under ``prefix``, without it)."""
    root: dict = {}
    for key in npz.files:
        if not key.startswith(prefix):
            continue
        node = root
        parts = [int(p) if p.isdigit() else p
                 for p in key[len(prefix):].split("/")]
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = npz[key]
    for part in ("body", "rem"):  # an empty list leaves no key
        root["stack"].setdefault(part, {})
    return root


def _local_bytes(tree) -> int:
    from repro_torch.distributed.sharding import local
    from repro_torch.train.tree import leaves

    return sum(local(t).numel() * local(t).element_size()
               for t in leaves(tree))


def _rule_bytes(spec_tree, mesh, rules) -> int:
    """The bytes a rank's shards hold by the rules: each leaf's size over
    the mesh axes its resolved spec splits it by."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.train.tree import leaves

    sizes = sh.axis_sizes(mesh)
    total = 0
    for s in leaves(spec_tree):
        split = 1
        for entry in sh.to_pspec(s.logical, rules=rules, mesh=mesh,
                                 shape=s.shape):
            for a in ((entry,) if isinstance(entry, str) else entry or ()):
                split *= sizes[a]
        total += math.prod(s.shape) // split * s.dtype.itemsize
    return total


def _record_shapes():
    """Wrap the kernels' plain versions to record the local shapes they
    run on, the rows each decode_attention call attends to, as (kv_start
    or None, kv_len) lists, and, under autograd, the local shape of the
    gradient that comes back to each forward's (first) output, which the
    backward runs on; returns {kernel: [shape, ...], "decode_rows": [...],
    "<kernel>_grad": [shape, ...]}."""
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssm_scan as ssm

    seen: dict = {"flash_attention": [], "decode_attention": [],
                  "ssm_scan": [], "decode_rows": [],
                  "flash_attention_grad": [], "ssm_scan_grad": []}
    for mod, fn, key in ((fa, "flash_attention_plain", "flash_attention"),
                         (dec, "decode_attention_plain", "decode_attention"),
                         (ssm, "ssm_scan_plain", "ssm_scan")):
        orig = getattr(mod, fn)

        def wrapped(*a, _orig=orig, _key=key, **kw):
            seen[_key].append([list(a[0].shape), list(a[1].shape)])
            if _key == "decode_attention":
                start = kw.get("kv_start")
                seen["decode_rows"].append([
                    None if start is None else start.tolist(), a[3].tolist()])
            res = _orig(*a, **kw)
            first = res[0] if isinstance(res, tuple) else res
            if first.requires_grad:  # the gradient the backward runs on
                first.register_hook(lambda g, _k=_key: seen[
                    _k + "_grad"].append(list(g.shape)))
            return res

        setattr(mod, fn, wrapped)
    return seen


def _batches(ref):
    """The prefill batch and the decode steps' batches the reference
    drew, as torch tensors."""
    import torch

    def pick(prefix):
        return {k[len(prefix):]: torch.from_numpy(ref[k]) for k in ref.files
                if k.startswith(prefix)}

    steps = []
    while f"step{len(steps)}/tokens" in ref.files:
        steps.append(pick(f"step{len(steps)}/"))
    return pick("batch/"), steps


@contextmanager
def gloo_rank(rank: int, world: int, store: str, progress=None):
    """A rank of a gloo world of ``world`` processes (a ``FileStore`` at
    ``store``) as every rank here runs: on one thread (see ``ONE_THREAD``),
    with DTensor's own collectives and plans refused
    (``sharding.forbid_dtensor_collectives``, ``forbid_dtensor_plans``:
    every move goes through ``sharding``), its start reported to the
    progress file ``progress``; the group destroyed on leaving."""
    import torch
    import torch.distributed as dist

    from repro_torch.distributed import sharding as sh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        sh.forbid_dtensor_collectives()
        sh.forbid_dtensor_plans()
        if progress is not None:
            report(progress, f"rank {rank} started")
        yield
    finally:
        dist.destroy_process_group()


def _rank_main(rank, world, shape, store, name, overrides, tmp):
    progress = f"{tmp}/progress"
    with gloo_rank(rank, world, store, progress):
        from repro_torch.configs.base import ShapeConfig, get_config, reduced
        from repro_torch.distributed import sharding as sh
        from repro_torch.launch import specs
        from repro_torch.launch.mesh import make_local_mesh
        from repro_torch.models import model
        from repro_torch.models import params as P

        cfg = reduced(get_config(name), **overrides)
        full = P.from_jax_params(cfg, _tree(np.load(f"{tmp}/params.npz")),
                                 device="cpu")
        batch, steps = _batches(np.load(f"{tmp}/ref.npz"))
        S = next(iter(batch.values())).shape[1]
        mesh = make_local_mesh(*shape, device="cpu")
        seen = _record_shapes()
        out: dict = {}
        params = P.shard_params(cfg, full, mesh, sh.TRAIN_RULES)
        L = S + specs.DECODE_PAD
        # the batch placed as the reference's _batch_sds places it
        batch = sh.distribute(batch, specs._batch_sds(
            cfg, ShapeConfig("prefill", S, B, "prefill"), "prefill",
            sh.TRAIN_RULES, mesh)[1], mesh)
        with sh.sharding_ctx(mesh, sh.TRAIN_RULES), sh.recording() as coll:
            logits, cache = model.prefill(params, cfg, batch, max_len=L,
                                          device="cpu")
        out["collectives/prefill"] = coll
        report(progress, f"rank {rank} prefill")
        out["bytes/params_train"] = [_local_bytes(params), _rule_bytes(
            P.param_specs(cfg), mesh, sh.TRAIN_RULES)]
        got = {"logits0": sh.full(logits)}
        if cache is not None:
            out["bytes/cache_train"] = [_local_bytes(cache), _rule_bytes(
                model.cache_specs(cfg, B, L), mesh, sh.TRAIN_RULES)]
            for i, layer in enumerate(cache):
                for leaf, t in layer.items():
                    # a copy: a leaf replicated over every rank is the
                    # rank's own tensor, which decode updates in place
                    got[f"prefill/{i}/{leaf}"] = sh.full(t).clone()
        if steps:
            low = specs.build_lowerable(cfg, ShapeConfig("decode", S, B,
                                                         "decode"), mesh)
            params = sh.distribute(params, low.in_shardings[0], mesh)
            cache = sh.distribute(cache, low.in_shardings[2], mesh)
            for i, step in enumerate(steps):
                step = sh.distribute(step, low.in_shardings[1], mesh)
                with sh.sharding_ctx(mesh, low.rules), \
                        sh.recording() as coll:
                    logits, cache = low.fn(params, step, cache, S + i)
                out[f"collectives/decode{i}"] = coll
                report(progress, f"rank {rank} decode step {i}")
                got[f"logits{i + 1}"] = sh.full(logits)
            for i, layer in enumerate(cache):
                for leaf, t in layer.items():
                    got[f"decode/{i}/{leaf}"] = sh.full(t)
            out["bytes/params_decode"] = [_local_bytes(params), _rule_bytes(
                P.param_specs(cfg), mesh, sh.DECODE_RULES)]
            out["bytes/cache_decode"] = [_local_bytes(cache), _rule_bytes(
                model.cache_specs(cfg, B, L), mesh, sh.DECODE_RULES)]
        out["bytes/params_full"] = _local_bytes(full)
        out["shapes"] = seen
        with open(f"{tmp}/rank{rank}.json", "w") as fh:
            json.dump(out, fh)
        if rank == 0:
            np.savez(f"{tmp}/port.npz",
                     **{k: v.numpy() for k, v in got.items()})


def _state_bytes(cfg, mesh, rules) -> int:
    """The bytes of a rank's shards of the train state by the rules: the
    parameters, two f32 moments laid out alike, and the step."""
    import torch

    from repro_torch.models import params as P
    from repro_torch.train.tree import map_tree

    specs = P.param_specs(cfg)
    f32 = map_tree(lambda s: P.ParamSpec(s.shape, torch.float32, s.logical),
                   specs)
    return (_rule_bytes(specs, mesh, rules)
            + 2 * _rule_bytes(f32, mesh, rules) + 4)


def _train_rank_main(rank, world, shape, store, name, overrides, accum,
                     chunk, tmp):
    """The port's two train steps in a rank of a gloo world: the state from
    the reference's initial parameters (``state_from_jax(..., mesh=)``),
    placed with the batches by the train cell's in_shardings, each step
    under its rules; rank 0 writes the metrics, the gathered parameters
    and moments after each step and the gradients before it, and then the
    same from the port's unsharded step.  The loss runs in chunks of
    ``chunk`` rows (``chunked_lm_loss``; below S, each chunk recomputed in
    the backward pass) in both runs."""
    import functools
    import types

    import torch

    progress = f"{tmp}/progress"
    with gloo_rank(rank, world, store, progress):
        from repro_torch.configs.base import ShapeConfig, get_config, reduced
        from repro_torch.distributed import sharding as sh
        from repro_torch.launch import specs
        from repro_torch.launch.mesh import make_local_mesh
        from repro_torch.models import model
        from repro_torch.train import train_loop
        from repro_torch.train.tree import flatten_with_path, map_tree

        model.chunked_lm_loss = functools.partial(model.chunked_lm_loss,
                                                  chunk=chunk)
        cfg = reduced(get_config(name), **overrides)
        tree = _tree(np.load(f"{tmp}/params.npz"))
        zeros = map_tree(lambda a: np.zeros(a.shape, np.float32), tree)
        jstate = types.SimpleNamespace(params=tree, opt=types.SimpleNamespace(
            step=np.int32(0), mu=zeros, nu=zeros))
        ref = np.load(f"{tmp}/ref.npz")
        batches = [{k[len(f"batch{i}/"):]: torch.from_numpy(ref[k])
                    for k in ref.files if k.startswith(f"batch{i}/")}
                   for i in range(2)]
        seq = batches[0]["targets"].shape[1]
        tc = train_loop.TrainConfig(accum_steps=accum)
        mesh = make_local_mesh(*shape, device="cpu")
        seen = _record_shapes()
        low = specs.build_lowerable(cfg, ShapeConfig("train", seq, TRAIN_B,
                                                     "train"), mesh, tc)
        state = train_loop.state_from_jax(cfg, jstate, device="cpu",
                                          mesh=mesh, rules=low.rules)
        out = {"bytes/state": [_local_bytes(state),
                               _state_bytes(cfg, mesh, low.rules)]}
        got: dict = {}

        def record(prefix):
            @torch.no_grad()
            def hook(tree):
                # copies: a replicated leaf is the rank's own tensor, which
                # the next step updates in place
                for path, t in flatten_with_path(tree):
                    got[prefix + "/".join(map(str, path))] = sh.full(
                        t).clone()
            return hook

        for i, batch in enumerate(batches):
            low.fn.grad_hook = record(f"grads{i}/")
            batch = sh.distribute(batch, low.in_shardings[1], mesh)
            with sh.sharding_ctx(mesh, low.rules):
                state, metrics = low.fn(state, batch)
            for k in ("loss", "grad_norm", "lr"):
                got[f"metrics{i}/{k}"] = metrics[k]
            for part, t in (("params", state.params), ("mu", state.opt.mu),
                            ("nu", state.opt.nu)):
                record(f"{part}{i}/")(t)
            report(progress, f"rank {rank} step {i}")
        out["bytes/state_after"] = _local_bytes(state)
        out["shapes"] = json.loads(json.dumps(seen))  # before the plain run
        if rank == 0:  # the port's own unsharded step on the same inputs
            plain = train_loop.state_from_jax(cfg, jstate, device="cpu")
            step = train_loop.make_train_step(cfg, tc)
            for i, batch in enumerate(batches):
                step.grad_hook = record(f"plain/grads{i}/")
                plain, metrics = step(plain, batch)
                for k in ("loss", "grad_norm", "lr"):
                    got[f"plain/metrics{i}/{k}"] = metrics[k]
                for part, t in (("params", plain.params),
                                ("mu", plain.opt.mu), ("nu", plain.opt.nu)):
                    record(f"plain/{part}{i}/")(t)
                report(progress, f"rank {rank} unsharded step {i}")
            np.savez(f"{tmp}/port.npz", **{
                k: v.detach().numpy() for k, v in got.items()})
        with open(f"{tmp}/rank{rank}.json", "w") as fh:
            json.dump(out, fh)


# what the server process that forks the ranks imports, once a test worker
# (``forkserver``): a rank that imported torch and the port itself would
# spend about 4 s of CPU on it, and a run of the tests starts some 200
_PRELOAD = ["torch", "torch.distributed.tensor", "repro_torch.launch.specs",
            "repro_torch.models.model", "repro_torch.train.train_loop",
            "torch_sharded_world"]


def _spawn(tmp: Path, name: str, overrides: dict, shape, main=None,
           extra=()):
    import torch.multiprocessing as mp

    n = shape[0] * shape[1]
    mp.get_context("forkserver").set_forkserver_preload(_PRELOAD)
    # the ranks' own libraries read them too, as the server starts (the
    # first world's): the caller's process keeps its own
    saved = {k: os.environ.get(k) for k in ONE_THREAD}
    os.environ.update(ONE_THREAD)
    try:
        ctx = mp.start_processes(
            main or _rank_main, args=(n, tuple(shape), str(tmp / "store"),
                                      name, overrides, *extra, str(tmp)),
            nprocs=n, join=False, start_method="forkserver")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    ctx.started, ctx.progress = time.monotonic(), tmp / "progress"
    return ctx


def _join(ctxs: dict) -> None:
    """Wait for every world ({shape: spawn context}) to end; kill them all
    and fail once one has reported no progress for ``JOIN_S``."""
    left = dict(ctxs)
    try:
        while left:
            _watch()
            for shape, ctx in list(left.items()):
                if ctx.join(timeout=0.5):
                    del left[shape]
                elif _left(ctx, JOIN_S) <= 0:
                    raise AssertionError(
                        f"the {shape} world reported no progress in "
                        f"{JOIN_S} s; its reports:\n{_reports(ctx)}")
    finally:
        for ctx in ctxs.values():
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()


def run_all(tmp: Path, name: str, overrides: dict, meshes, proc=None,
            main=None, extra=()):
    """The reference on every mesh (``proc``, where it was started
    already), then the port's worlds on every mesh at once (each rank runs
    ``main``, default ``_rank_main``, with ``extra`` arguments): returns
    ({mesh tag: (the port's outputs, each rank's record)}, the reference's
    outputs)."""
    wait_reference(proc or reference(tmp, name, overrides, meshes))
    ctxs = {}
    for shape in meshes:
        d = tmp / tag(shape)
        d.mkdir()
        for f in ("params.npz", "ref.npz"):
            (d / f).symlink_to(tmp / f)
        ctxs[tuple(shape)] = _spawn(d, name, overrides, shape, main, extra)
    _join(ctxs)
    out = {}
    for shape in meshes:
        d = tmp / tag(shape)
        ranks = [json.loads((d / f"rank{r}.json").read_text())
                 for r in range(shape[0] * shape[1])]
        out[tag(shape)] = (np.load(d / "port.npz"), ranks)
    return out, np.load(tmp / "ref.npz")


def run_cases(tmp_path_factory, cases: dict, start=None, main=None,
              extra_of=None) -> dict:
    """``run_all`` for each case of {case: (config name, overrides,
    meshes, reference arguments)}: every case's reference started at once
    (``start(tmp, name, overrides, meshes, *arguments)``, default
    ``reference``; each waits for its slot, ``REF_SLOTS``), then each
    case's worlds in turn once its reference has ended, beside the later
    cases' references.  The ranks run ``main`` with ``extra_of(case)``'s
    arguments.  Returns {case: run_all's result}."""
    start = start or reference
    tmp = {c: tmp_path_factory.mktemp(f"sharded_{c}") for c in cases}
    procs = {c: start(tmp[c], *cases[c][:3], *cases[c][3]) for c in cases}
    out = {}
    try:
        for c, (name, overrides, meshes, _) in cases.items():
            out[c] = run_all(tmp[c], name, overrides, meshes, procs[c],
                             main, extra_of(c) if extra_of else ())
    except BaseException:
        for p in procs.values():
            p.kill()
            p.communicate()
            if p in _LIVE:
                _LIVE.remove(p)
        raise
    return out


def ref_layer(ref, prefix: str, cfg, i: int) -> dict:
    """Layer i's cache leaves from the reference's stacked cache."""
    from repro_torch.configs.base import scan_period

    P = scan_period(cfg)
    n_rep = cfg.n_layers // P
    out = {}
    for leaf in ("k", "v", "h", "conv"):
        if i < n_rep * P:
            key = f"{prefix}body/{i % P}/{leaf}"
            if key in ref.files:
                out[leaf] = ref[key][i // P]
        else:
            key = f"{prefix}rem/{i - n_rep * P}/{leaf}"
            if key in ref.files:
                out[leaf] = ref[key]
    return out


TOL = dict(rtol=2e-5, atol=2e-5)  # tests/test_kernels.py TOL[float32]


def _stacked(prefix: str, cfg, i: int, leaf: str) -> tuple:
    """(key, index or None) of layer i's ``leaf`` in the reference's
    stacked cache under ``prefix``."""
    from repro_torch.configs.base import scan_period

    P = scan_period(cfg)
    n_rep = cfg.n_layers // P
    if i < n_rep * P:
        return f"{prefix}body/{i % P}/{leaf}", i // P
    return f"{prefix}rem/{i - n_rep * P}/{leaf}", None


def assert_outputs_match(port, ref, shape, cfg, n_decode=N_DECODE,
                         widen=()):
    """Every logit and cache leaf of the port's run on ``shape`` against
    the reference's sharded run on the same mesh: within ``TOL``, the SSM
    state h's atol scaled by its largest entry
    (tests/test_torch_sharded_mamba.py).  The outputs named in ``widen``
    ("logits", "cache") are held to ``TOL`` plus 4x the reference's own
    move under 1e-7 noise on its embeddings (``reference(..., noise=)``),
    for a config whose reference differs from mesh to mesh by more than
    ``TOL`` there.  The outputs are exactly the logits of prefill and of
    each decode step and one of each layer's cache leaves after each."""
    t = tag(shape)
    n_logits = 1 if cfg.encoder_only else 1 + n_decode
    want = [f"logits{i}" for i in range(n_logits)]
    for step in () if cfg.encoder_only else ("prefill", "decode"):
        for i in range(cfg.n_layers):
            for leaf in ref_layer(ref, f"{t}/{step}/", cfg, i):
                want.append(f"{step}/{i}/{leaf}")
    assert sorted(port.files) == sorted(want)
    for key in want:
        if key.startswith("logits"):
            w, move = ref[f"{t}/{key}"], f"move/{key}"
        else:
            step, i, leaf = key.split("/")
            w = ref_layer(ref, f"{t}/{step}/", cfg, int(i))[leaf]
            move = _stacked(f"move/{step}/", cfg, int(i), leaf)[0]
        atol = TOL["atol"]
        if key.endswith("/h"):
            atol *= max(1.0, float(np.abs(w).max()))
        if ("logits" if key.startswith("logits") else "cache") in widen:
            atol += 4 * float(ref[move])
        np.testing.assert_allclose(port[key], w, rtol=TOL["rtol"], atol=atol,
                                   err_msg=f"{t} {key}")


def assert_rule_bytes(ranks, encoder_only=False):
    """Each rank's parameter and cache bytes, under both rule tables, equal
    those its shards hold by the rules."""
    keys = ("params_train",) if encoder_only else (
        "params_train", "cache_train", "params_decode", "cache_decode")
    for r, rec in enumerate(ranks):
        for key in keys:
            got, want = rec[f"bytes/{key}"]
            assert got == want, f"rank {r} {key}"


def kernel_shapes(cfg, shape, S: int, batch: int = B,
                  n_decode=None) -> dict:
    """The local (first two arguments') shapes each kernel wrapper runs on,
    a call each, in a rank of ``shape`` for prompts of S positions: prefill's
    flash_attention on the rank's batch rows and heads (every head where
    "model" does not divide them at G = 1; the reference's padding at G >
    1; one KV head paired with each rank's query heads where it splits
    those and not the KV heads); decode_attention on every head over the
    rank's cache rows (all of them where "model" does not divide them, and
    then on the rank's heads); ssm_scan on the rank's batch rows and inner
    channels.  ``batch``: the global batch; ``n_decode``: the decode steps
    (default: ``N_DECODE``, none for the encoder-only forward)."""
    from repro_torch.configs.base import layer_specs

    dp, tp = shape
    Bl, L, D = batch // dp, S + 16, cfg.head_dim
    H, Hkv, G = cfg.n_heads, cfg.n_kv_heads, cfg.q_per_kv
    if H % tp == 0:
        heads = H // tp
        kv = Hkv // tp if Hkv % tp == 0 else -(-heads // G)
    else:
        heads = kv = H if G == 1 else -(-H // tp)
    if L % tp == 0:
        dec = [[Bl, H, D], [Bl, Hkv, L // tp, D]]
    elif H % tp == 0:
        dec = [[Bl, H // tp, D], [Bl, kv, L, D]]
    else:  # decode does not pad
        dec = [[Bl, H, D], [Bl, Hkv, L, D]]
    I = cfg.d_inner // tp if cfg.d_inner % tp == 0 else cfg.d_inner
    scan = [Bl, S, I, cfg.ssm_state]
    specs = layer_specs(cfg)
    n_attn = sum(s.kind == "attn" for s in specs)
    if n_decode is None:
        n_decode = 0 if cfg.encoder_only else N_DECODE
    return {"flash_attention": [[[Bl, heads, S, D], [Bl, kv, S, D]]] * n_attn,
            "decode_attention": [dec] * (n_attn * n_decode),
            "ssm_scan": [[scan, scan]] * (len(specs) - n_attn)}


def train_kernel_shapes(cfg, shape, calls: int, accum: int = 1,
                        seq: int = S) -> dict:
    """The local shapes each kernel wrapper runs on in a rank of ``shape``
    over ``calls`` forward passes of a microbatch of the train batch cut
    into ``accum`` (a step with remat: two a microbatch, the forward and
    its recomputation), S = ``seq``, and the local shape of the gradient
    that comes back to each first pass's output: flash_attention's (b,
    heads, S, D), ssm_scan's y (b, S, I)."""
    one = kernel_shapes(cfg, shape, seq, batch=TRAIN_B // accum, n_decode=0)
    n_fwd = calls // 2
    out = {k: v * calls for k, v in one.items() if k != "decode_attention"}
    out["flash_attention_grad"] = [v[0] for v in one["flash_attention"]] * \
        n_fwd
    out["ssm_scan_grad"] = [v[0][:3] for v in one["ssm_scan"]] * n_fwd
    return out


# --- the dry run's cells on a fake group ---------------------------------

FAKE_SCRIPT = _PRELUDE + r"""
import json, sys
from contextlib import ExitStack
from unittest import mock
import torch
torch.set_num_threads(1)
from repro_torch.configs.base import ShapeConfig, get_config, reduced
from repro_torch.kernels import flash_attention as fa, ssm_scan as ssm
from repro_torch.launch import dryrun


def plain_fa(q, k, v, causal, window, q_pos, k_pos, route=None, **_):
    return fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                    q_pos=q_pos, k_pos=k_pos)


def plain_ssm(dA, dBx, C, h0, **_):
    return ssm.ssm_scan_plain(dA, dBx, C, h0)


out = {}
for key, (name, overrides, step, S, B, mesh, *routes) in json.loads(
        sys.argv[1]).items():
    cfg = reduced(get_config(name), **overrides)
    with ExitStack() as stack:
        if routes == ["plain"]:  # the CPU's route, on meta tensors
            stack.enter_context(mock.patch.object(fa, "_meta_forward",
                                                  plain_fa))
            stack.enter_context(mock.patch.object(ssm, "_meta_forward",
                                                  plain_ssm))
        w = dryrun.execute(cfg, ShapeConfig(step, S, B, step), mesh)
    shapes = {}
    for c in w["kernel_calls"]:
        shapes.setdefault(c.wrapper, []).append(
            c.shapes[0] if c.wrapper.endswith("_grad") else c.shapes)
    out[key] = dict(flops=w["flops"], bytes=w["bytes_accessed"],
                    temp=w["temp_size_in_bytes"], collectives=w["collectives"],
                    shapes=shapes, kernels=sorted({c.kernel for c in
                                                   w["kernel_calls"]}),
                    redistributions=w["dtensor_redistributions"],
                    lookup=w["labelled_collectives"].get("lookup", []))
    report("cell " + key)
print(json.dumps(out))
"""


def start_fake_cells(cases: dict) -> subprocess.Popen:
    """Start a child that executes the dry run's cells of {key: (config
    name, overrides of ``reduced``, step, S, global batch, mesh shape[,
    "plain"])}; ``fake_cells`` reads it.  A cell marked "plain" runs the
    attention and scan kernels' plain versions on the meta tensors in
    place of their shape-only routes: autograd through them gives the
    gradients the layouts they have on the CPU, where the routes give the
    card kernels' (the layout decides some of DTensor's plans).  It
    reports its progress to a temporary file, a line a cell."""
    fd, progress = tempfile.mkstemp(prefix="fake_cells_")
    os.close(fd)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               SHARDED_PROGRESS=progress, **ONE_THREAD)
    proc = subprocess.Popen([sys.executable, "-c", FAKE_SCRIPT,
                             json.dumps(cases)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    proc.started, proc.progress = time.monotonic(), progress
    return proc


def fake_cells(cases) -> dict:
    """{key: {"flops", "bytes", "temp", "collectives", "shapes" (the local
    shapes each kernel wrapper's meta route ran on, as ``_record_shapes``
    gives them), "kernels", "redistributions" (those DTensor planned by
    itself), "lookup" (the collectives of the embedding's lookup,
    ``sharding.labelled``)}} of the cells (a dict as ``start_fake_cells``
    takes, or the child it started)."""
    proc = cases if isinstance(cases, subprocess.Popen) else \
        start_fake_cells(cases)
    try:
        out, err = _wait(proc, JOIN_S, "the dry run's cells")
    finally:
        os.unlink(proc.progress)
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


# --- the train cases: the reference's steps against the port's ------------

GRAD_REL = 1e-4  # a gradient leaf is held within this much of its scale
METRICS = ("loss", "grad_norm", "lr")
PARTS = ("grads", "params", "mu", "nu")
STEPS = 2


def run_train_cases(tmp_path_factory, cases: dict) -> dict:
    """``run_cases`` of the train step for each case of {case: (config
    name, overrides, meshes, microbatches, the loss's chunk of rows, S,
    noise draws)}: the reference's ``REF_TRAIN_SCRIPT``, the port's
    ``_train_rank_main``."""
    return run_cases(
        tmp_path_factory,
        {c: (name, ov, meshes, (accum, seq, noise))
         for c, (name, ov, meshes, accum, _, seq, noise) in cases.items()},
        start=reference_train, main=_train_rank_main,
        extra_of=lambda c: cases[c][3:5])


def ref_tree(cfg, ref, prefix: str) -> dict:
    """{port path: array} of the reference's flattened tree under
    ``prefix``, carried over to the port's layout (``from_jax_params``)."""
    from repro_torch.models.params import from_jax_params
    from repro_torch.train.tree import flatten_with_path

    return {"/".join(map(str, p)): t.numpy() for p, t in flatten_with_path(
        from_jax_params(cfg, _tree(ref, prefix), device="cpu"))}


def ref_step(cfg, ref, prefix: str, i: int) -> dict:
    """{"metrics", "grads", "params", "mu", "nu"} of the reference's step i
    under ``prefix``: a mesh's tag and "/", or "move/" for its noise
    move."""
    return {"metrics": {k: ref[f"{prefix}metrics{i}/{k}"] for k in METRICS},
            **{part: ref_tree(cfg, ref, f"{prefix}{part}{i}/")
               for part in PARTS}}


def port_step(port, i: int, prefix: str = "") -> dict:
    """The same of the port's step i (``prefix`` "plain/": its unsharded
    step's)."""
    def tree(pre):
        return {k[len(pre):]: port[k] for k in port.files
                if k.startswith(pre)}

    return {"metrics": {k: port[f"{prefix}metrics{i}/{k}"] for k in METRICS},
            **{part: tree(f"{prefix}{part}{i}/") for part in PARTS}}


def assert_step(got, want, what="", move=None, widen=()):
    """``got`` against ``want`` (each ``ref_step``'s dict): the metrics and
    every leaf of params, mu and nu at ``TOL``, each gradient leaf within
    ``GRAD_REL`` of its largest |g|.  The outputs named in ``widen``
    (a metric's name, "<part>/<path>", or a prefix ending in "/" for
    every leaf under it) are held to that plus 4x the
    reference's own move under 1e-7 noise (``move``: ``ref_step(cfg,
    ref, "move/", i)``), the largest over the output, as
    ``assert_outputs_match`` widens."""
    def extra(part, key):
        name = key if part == "metrics" else f"{part}/{key}"
        if not any(name == w or w.endswith("/") and name.startswith(w)
                   for w in widen):
            return 0.0
        return 4 * float(np.max(move[part][key]))

    for k in METRICS:
        np.testing.assert_allclose(
            got["metrics"][k], want["metrics"][k], rtol=TOL["rtol"],
            atol=TOL["atol"] + extra("metrics", k), err_msg=f"{what} {k}")
    for part in PARTS:
        assert sorted(got[part]) == sorted(want[part]), part
        for path, w in want[part].items():
            if part == "grads":
                tol = dict(rtol=0, atol=max(
                    GRAD_REL * float(np.abs(w).max()), 1e-30))
            else:
                tol = dict(TOL)
            tol["atol"] = tol["atol"] + extra(part, path)
            np.testing.assert_allclose(got[part][path], w, **tol,
                                       err_msg=f"{what} {part} {path}")


def assert_train_matches(run, cfg, shape, widen=(), plain=False):
    """Both steps of the port's sharded run on ``shape`` (``run``: one
    case of ``run_train_cases``) against the reference's sharded step on
    the same mesh, or with ``plain`` the port's own unsharded step;
    ``widen`` as ``assert_step`` takes it, the reference's noise move from
    its run."""
    t = tag(shape)
    (port, _), ref = run[0][t], run[1]
    for i in range(STEPS):
        move = ref_step(cfg, ref, "move/", i) if widen else None
        want = (port_step(port, i, "plain/") if plain
                else ref_step(cfg, ref, f"{t}/", i))
        assert_step(port_step(port, i), want, f"{t} step {i}", move, widen)


def assert_train_state_bytes(run, shape):
    """Each rank holds the bytes of its shards of the state by the rules,
    before and after the steps."""
    for r, rec in enumerate(run[0][tag(shape)][1]):
        got, want = rec["bytes/state"]
        assert got == want, f"rank {r}"
        assert rec["bytes/state_after"] == want, f"rank {r} after the steps"


def _runs(calls: list) -> str:
    """A list of calls as runs of equal entries: "N x entry, ..."."""
    out = []
    for c in calls:
        if out and out[-1][1] == c:
            out[-1][0] += 1
        else:
            out.append([1, c])
    return ", ".join(f"{n} x {c}" for n, c in out) or "none"


def assert_kernel_calls(ranks, want: dict) -> None:
    """Each rank's record (``_record_shapes``'s lists) holds exactly the
    calls of ``want`` ({kernel: [shapes, ...]}); a mismatch names the rank,
    the kernel, the first index where the lists differ and both lists."""
    for r, rec in enumerate(ranks):
        for kernel, shapes in want.items():
            got = rec["shapes"][kernel]
            if got == shapes:
                continue
            i = next((i for i, (a, b) in enumerate(zip(got, shapes))
                      if a != b), min(len(got), len(shapes)))
            raise AssertionError(
                f"rank {r} {kernel}: {len(got)} calls, {len(shapes)} "
                f"expected; first difference at call {i}: "
                f"{got[i] if i < len(got) else 'none'} against "
                f"{shapes[i] if i < len(shapes) else 'none'}\n"
                f"  got:      {_runs(got)}\n  expected: {_runs(shapes)}")


def assert_train_kernel_shapes(run, cfg, shape, accum=1, seq=S):
    """Each microbatch of each step runs every layer's kernel twice (the
    forward and its recomputation under remat) on the rank's batch rows
    and heads or inner channels, and the backward on the gradient of the
    same local shape."""
    want = train_kernel_shapes(cfg, shape, 2 * STEPS * accum, accum, seq)
    assert sum(len(v) for v in want.values()) > 0
    assert_kernel_calls(run[0][tag(shape)][1], want)


# each case: the input's placements on the (1, 2) mesh's "model" axis, the
# output's, and whether every rank's consumer of the output is the same
# ("replicated": the whole loss on every rank) or each rank's own part
# ("partial": each rank's loss reads its half of the rows, and the ranks'
# losses sum to the whole); every loss is sum(W * Y) of the whole Y = X
GRAD_CASES = {
    "gather-replicated": ("shard", "replicate", "replicated"),
    "gather-partial": ("shard", "replicate", "partial"),
    "chunk": ("replicate", "shard", "replicated"),
    "all_reduce-replicated": ("partial", "replicate", "replicated"),
    "all_reduce-partial": ("partial", "replicate", "partial"),
    "reduce_scatter": ("partial", "shard", "replicated"),
    "psum-replicated": ("psum", None, "replicated"),
    "reduce_grad-partial": ("reduce_grad", None, "partial"),
}


def grad_world(rank, store, out_dir):
    """A rank of the world of ``GRAD_CASES``: writes {case: [the largest
    |gradient - W| of its shard, the gradient's placements]}."""
    import torch

    with gloo_rank(rank, 2, store):
        from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

        from repro_torch.distributed import sharding as sh
        from repro_torch.launch.mesh import make_local_mesh

        mesh = make_local_mesh(1, 2, device="cpu")
        pl = {"shard": Shard(0), "replicate": Replicate(),
              "partial": Partial()}
        gen = torch.Generator().manual_seed(0)  # the same on every rank
        X = torch.randn(4, 3, generator=gen, dtype=torch.float64)
        W = torch.randn(4, 3, generator=gen, dtype=torch.float64)
        mine = torch.zeros(4, 1, dtype=torch.float64)
        mine[2 * rank:2 * rank + 2] = 1.0  # the rank's half of the rows
        res = {}
        for case, (src, dst, consumer) in GRAD_CASES.items():
            with sh.sharding_ctx(mesh, sh.TRAIN_RULES):
                if src in ("psum", "reduce_grad"):
                    # psum: each rank holds a term, X / 2; reduce_grad: X
                    x = (X / 2 if src == "psum" else X).clone()
                    x.requires_grad_(True)
                    y = getattr(sh, src)(x, ("model",))
                    got_pl = None
                else:
                    local = {"shard": X[2 * rank:2 * rank + 2],
                             "replicate": X, "partial": X / 2}[src]
                    x = DTensor.from_local(local.clone(), mesh,
                                           [Replicate(), pl[src]],
                                           run_check=False, shape=X.shape,
                                           stride=X.stride())
                    x.requires_grad_(True)
                    yd = sh.redistribute(x, [Replicate(), pl[dst]])
                    y = sh.local(yd, partial=("model",) if consumer ==
                                 "partial" else ())
                    if dst == "shard":
                        y = torch.zeros_like(X).index_copy(
                            0, torch.arange(2 * rank, 2 * rank + 2), y)
                        consumer = "partial"  # each rank holds its rows
                w = W * mine if consumer == "partial" else W
                (w * y).sum().backward()
                g = x.grad
                if isinstance(g, DTensor):
                    got_pl = [repr(p) for p in g.placements]
                    g = g.to_local()
                want = W[2 * rank:2 * rank + 2] if src == "shard" else W
                res[case] = [float((g - want).abs().max()), got_pl]
        with open(os.path.join(out_dir, f"grads{rank}.json"), "w") as fh:
            json.dump(res, fh)


# --- the harness's own guards ---------------------------------------------

def plan_rank(rank, world, shape, store, name, overrides, tmp):
    """A rank of a (1, 2) world under ``gloo_rank`` that adds two DTensors
    laid out alike, which needs no plan, then a ``Shard(0)`` and a
    ``Partial()`` one, for which DTensor plans a redistribution of its
    own: the rank must fail there."""
    import torch
    import torch.distributed
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.launch.mesh import make_local_mesh

    with gloo_rank(rank, world, store, f"{tmp}/progress"):
        mesh = make_local_mesh(*shape, device="cpu")

        def placed(p):  # a (4, 3) DTensor: each rank's half, or its term
            return DTensor.from_local(torch.ones(2 if p.is_shard() else 4,
                                                 3), mesh, [Replicate(), p],
                                      run_check=False)

        placed(Shard(0)) + placed(Shard(0))
        report(f"{tmp}/progress", f"rank {rank} added alike")
        torch.distributed.barrier()  # both reported before either fails
        placed(Shard(0)) + placed(Partial())


def stall_rank(rank, world, shape, store, name, overrides, tmp):
    """A rank that reports its progress ``name`` times, ``overrides``
    seconds apart, then ends."""
    with gloo_rank(rank, world, store, f"{tmp}/progress"):
        for i in range(name):
            time.sleep(overrides)
            report(f"{tmp}/progress", f"rank {rank} {i}")
