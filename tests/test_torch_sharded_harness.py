"""The guards of ``tests/torch_sharded_world.py``, the harness of the
two-rank files (``tests/test_torch_sharded_*.py``).

* Every rank runs under ``gloo_rank``, which refuses DTensor's own
  collectives and the redistributions DTensor plans by itself
  (``sharding.forbid_dtensor_plans``): a rank that adds a ``Shard(0)`` and
  a ``Partial()`` DTensor fails, naming the plan, after an add of two
  operands laid out alike went through.
* A reference, a world and a child of the dry run's cells fail once they
  have reported no progress for their limit, counted from their start or
  their last report (``_left``), not from their spawn: a child that keeps
  reporting runs past the limit, and one that stops reporting fails
  within it (limits of a few seconds here).  A reference is held to its
  limit only while it runs: one that ended before the test came to it
  passes, and one that stalls while the test waits for another is killed
  meanwhile.
* At most ``REF_SLOTS`` references run at once (lock files shared by the
  test workers); the others report that they wait.
"""
import time

import pytest
from torch.multiprocessing import ProcessRaisedException

import torch_sharded_world as world


def test_a_live_rank_fails_on_a_plan_of_dtensors_own(tmp_path):
    ctx = world._spawn(tmp_path, None, None, (1, 2), world.plan_rank)
    with pytest.raises(ProcessRaisedException,
                       match=r"DTensor planned a redistribution of its own "
                             r"\(op: \(Replicate\(\), Partial\(sum\)\) -> "):
        world._join({(1, 2): ctx})
    reports = (tmp_path / "progress").read_text()
    for r in range(2):
        assert f"rank {r} added alike" in reports


REF_STEPS = world._PRELUDE + r"""
import json, sys
n, pause = json.loads(sys.argv[1])
for i in range(n):
    time.sleep(pause)
    report(f"step {i}")
"""


@pytest.mark.parametrize("n,pause,ends", [(12, 0.4, True), (1, 30, False)],
                         ids=["reports", "stalls"])
def test_a_reference_fails_only_once_it_reports_no_progress(
        tmp_path, n, pause, ends):
    """Limit 2 s: twelve reports 0.4 s apart (4.8 s in all) end; one
    report and then 30 s of silence fail about 2 s after the report."""
    proc = world._start(REF_STEPS, [n, pause], tmp_path, tmp_path)
    proc.limit = 2.0
    t0 = time.monotonic()
    if ends:
        world.wait_reference(proc)
        assert proc.returncode == 0
        assert time.monotonic() - t0 > 2 * proc.limit
    else:
        with pytest.raises(AssertionError, match="reported no progress in "
                                                 r"2.0 s; its reports:\n.*"
                                                 "started"):
            world.wait_reference(proc)
        assert proc.poll() is not None  # killed
        assert time.monotonic() - t0 < 10


@pytest.mark.parametrize("n,pause,ends", [(8, 0.5, True), (1, 60, False)],
                         ids=["reports", "stalls"])
def test_a_world_fails_only_once_it_reports_no_progress(
        tmp_path, monkeypatch, n, pause, ends):
    """``JOIN_S`` 3 s, waited from the ranks' first reports: eight more
    reports 0.5 s apart end; a world whose ranks report once more and then
    sleep 60 s fails about 3 s after, and its ranks are killed."""
    monkeypatch.setattr(world, "JOIN_S", 3)
    ctx = world._spawn(tmp_path, n, pause, (1, 2), world.stall_rank)
    progress = tmp_path / "progress"
    while not (progress.exists()
               and progress.read_text().count("started") == 2):
        assert all(p.is_alive() for p in ctx.processes)
        time.sleep(0.1)
    t0 = time.monotonic()
    if ends:
        world._join({(1, 2): ctx})
        assert time.monotonic() - t0 > world.JOIN_S
    else:
        with pytest.raises(AssertionError, match=r"the \(1, 2\) world "
                                                 "reported no progress in 3"):
            world._join({(1, 2): ctx})
        assert not any(p.is_alive() for p in ctx.processes)
        assert time.monotonic() - t0 < 30


def test_a_reference_is_held_to_its_limit_only_while_it_runs(tmp_path):
    """A reference that ended before the test came to wait for it passes,
    however long ago it last reported; one that stalls while the test
    waits for another is killed meanwhile (``_watch``), freeing its slot,
    and fails when the test comes to it."""
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    (tmp_path / "c").mkdir()
    ended = world._start(REF_STEPS, [1, 0.1], tmp_path / "a", tmp_path)
    stalls = world._start(REF_STEPS, [1, 30], tmp_path / "b", tmp_path)
    runs = world._start(REF_STEPS, [10, 0.5], tmp_path / "c", tmp_path)
    for p in (ended, stalls, runs):
        p.limit = 2.0
    time.sleep(2 * ended.limit)
    world.wait_reference(ended)
    world.wait_reference(runs)
    assert stalls.poll() is not None and stalls.stalled
    with pytest.raises(AssertionError, match="reported no progress"):
        world.wait_reference(stalls)
    assert not world._LIVE


def test_references_take_at_most_ref_slots_at_once(tmp_path, monkeypatch):
    """Five references on two slots: each holds its slot from its start
    (``started``) to its end, 1 s later; at most two hold one at a time,
    and the others report that they wait."""
    monkeypatch.setattr(world, "REF_SLOTS", 2)
    procs = []
    for i in range(5):
        (tmp_path / str(i)).mkdir()
        procs.append(world._start(REF_STEPS, [1, 1.0], tmp_path / str(i),
                                  tmp_path))
    spans = []
    for p in procs:
        world.wait_reference(p)
        lines = [line.split(" ", 1) for line in
                 p.progress.read_text().splitlines()]
        times = {what: float(t) for t, what in lines}
        spans.append((times["started"], times["step 0"]))
    for t, _ in spans:  # the references holding a slot at each start
        assert sum(a <= t < b for a, b in spans) <= 2
    assert max(b for _, b in spans) - min(a for a, _ in spans) > 2.5
    assert sum("waiting for a slot" in p.progress.read_text()
               for p in procs) >= 3
    assert sorted(f.name for f in tmp_path.glob("reference_slot*")) == [
        "reference_slot0", "reference_slot1"]


def test_the_deadline_runs_from_the_start_or_the_last_report(tmp_path):
    """``_left``: ``limit`` from the child's start while its progress file
    is missing or older, then from the file's last change."""
    import os
    import types

    child = types.SimpleNamespace(started=time.monotonic() - 50,
                                  progress=tmp_path / "progress")
    assert world._left(child, 120) == pytest.approx(70, abs=1)
    child.progress.write_text("0 started\n")
    os.utime(child.progress, (time.time() - 100, time.time() - 100))
    assert world._left(child, 120) == pytest.approx(70, abs=1)
    os.utime(child.progress, (time.time() - 10, time.time() - 10))
    assert world._left(child, 120) == pytest.approx(110, abs=1)
