"""Context-switch cost model, calibrated to the paper's ftrace measurements.

The paper (§3) finds the cost of one ``schedule()`` call is dominated not by
``pick_next_entity`` (left-most rb-tree node, cheap) but by re-inserting the
preempted entity *and its ancestors*: one ``put_prev_entity`` per cgroup
hierarchy level.  Each re-insert is an O(log |cfs_rq|) rb-tree insert into
that level's queue: the task into its group's rq (|rq| = runnable siblings)
and — when the switch crosses cgroups — the group entities into the parent
rqs (|rq| = runnable groups), repeated for ``depth-1`` upper levels.  A
same-group switch touches only the leaf rq, which is the paper's observation
that "overhead becomes increasingly significant as context switching occurs
between tasks that are not siblings within the same cgroup".

  cost_us = BASE
          + PUT * log2(1 + siblings)                       (leaf re-insert)
          + [cross] * ( PUT * log2(1 + groups) * (depth-1)  (ancestor chain)
                        + CROSS )                           (metric updates)
          + SET * depth                                     (set_next walk)

Calibration targets (asserted by tests/test_switch_cost.py):
  * standalone (depth 2), low colocation, short queues:      <  10 us  (Fig 3c)
  * standalone, density 19x (228 fns, cross-group):          ~  20 us  (Fig 3c)
  * CFS at high colocation (mixed):                          ~  21 us  (Fig 10)
  * LAGS at high colocation (mostly sibling switches):       ~  13 us  (Fig 10)
  * Knative cluster node (depth 5, 100 busy pods):           ~  48 us  (§3.2)

Copy of ``repro.core.switch_cost``: the port imports nothing of ``repro``.
"""
from __future__ import annotations

import numpy as np

BASE_US = 0.5
PUT_US = 1.55  # per log2(1+rq_len) rb-tree re-insert
SET_US = 0.35  # set_next_entity, per hierarchy level
CROSS_US = 1.0  # cgroup-crossing bookkeeping (load/metric updates)


def switch_cost_us(same_group, siblings=1.0, groups=2.0, depth: float = 2.0):
    """Vectorised cost of one context switch in microseconds.

    same_group: next task shares the cgroup of the previous task.
    siblings:   runnable threads in the previous task's cgroup (leaf rq len).
    groups:     runnable cgroups on the node (upper rq len).
    depth:      cgroup hierarchy depth (2 = faas.slice/func-N standalone
                microbenchmark; 5 = kubepods/burstable/pod/container Knative).
    """
    same = np.asarray(same_group, bool)
    sib = np.maximum(np.asarray(siblings, np.float64), 1.0)
    grp = np.maximum(np.asarray(groups, np.float64), 1.0)
    leaf = PUT_US * np.log2(1.0 + sib)
    upper = PUT_US * np.log2(1.0 + grp) * np.maximum(depth - 1.0, 1.0)
    cost = BASE_US + leaf + SET_US * depth + np.where(same, 0.0, upper + CROSS_US)
    return cost


def calibration_table():
    """Reference points used by tests (see docstring for provenance)."""
    return {
        "standalone_low_density": float(
            switch_cost_us(False, siblings=2, groups=4, depth=2)
        ),
        "standalone_density19_cross": float(
            switch_cost_us(False, siblings=4, groups=228, depth=2)
        ),
        "standalone_density19_same": float(
            switch_cost_us(True, siblings=4, groups=228, depth=2)
        ),
        "cluster_100pods_cross": float(
            switch_cost_us(False, siblings=8, groups=100, depth=5)
        ),
    }
