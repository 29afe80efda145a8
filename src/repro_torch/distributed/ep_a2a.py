"""Sort-based expert-parallel MoE dispatch over ``all_to_all``.

Port of ``repro.distributed.ep_a2a``: tokens stay on their data shard, are
bucketed by the peer that owns their expert with a fixed per-peer capacity,
exchanged with one ``all_to_all_single`` over a process group (the
reference's "model" axis inside ``shard_map``), run through the local
experts, and returned by the inverse exchange.  ``group=None`` is the
single-shard reference (one peer), used as the test oracle.  As in the
reference, the module is not wired into ``models/moe.py``.

``bucket_by_peer`` copies two behaviours of the reference's scatters
(checked against it on the CPU):

* Ownership depends on the data: the peer of an entry is ``id //
  max(1, (max(ids) + 1) // n_peers)`` over the ids this shard sees.  With
  ids {0, 1, 3, 4} and 2 peers, id 4 maps to peer 2; its slot lies past the
  buffer, JAX drops the write, and ``counts`` does not count it.  The port
  masks such entries before any index operation (torch's raise where JAX's
  drop).
* An overflowing bucket loses its last kept slot's metadata: an entry
  dropped by capacity is written to slot ``capacity - 1`` and the last
  write wins, so there ``src`` becomes -1, ``eid`` 0 and ``gate`` 0 while
  its row of ``send_x`` stays; only ``capacity - 1`` tokens of that bucket
  reach the combine.  Six tokens to one peer at capacity 4 give
  ``src = [0, 1, 2, -1]``, ``counts = [4]`` and the rows of tokens 0-3.

``expert_ffn`` groups the rows by local expert and runs one product per
expert instead of the reference's per-row gather of expert weights (an
(N, M, F) tensor, 5.8 MB a row at qwen2-moe's widths).  The combine adds
each token's gated rows in f32 in slot order and rounds once, as the
reference's scatter-add does on the CPU, and in that fixed order on the
card too (no atomics), so a call gives the same bits every time.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F


def bucket_by_peer(x, expert_ids, gate_w, n_peers: int, capacity: int):
    """Pack tokens into fixed-capacity per-peer send buffers.

    x: (T, M); expert_ids/gate_w: (T, K) global expert ids and gate weights.
    Returns (send_x (P, C, M), src (P, C) source token or -1, eid (P, C)
    global expert id, gate (P, C) f32, counts (P,) entries kept a peer).
    Overflow beyond ``capacity`` is dropped (capacity-factor semantics).
    """
    T, K = expert_ids.shape
    dev = x.device
    flat_ids = expert_ids.reshape(-1).long()
    flat_gate = gate_w.reshape(-1).float()
    flat_src = torch.arange(T, device=dev).repeat_interleave(K)
    div = torch.clamp((flat_ids.max() + 1) // n_peers, min=1)
    peer = flat_ids // div
    order = torch.sort(peer, stable=True).indices  # by peer, then entry
    peer_s = peer[order]
    in_range = peer_s < n_peers
    onehot = F.one_hot(torch.where(in_range, peer_s, 0), n_peers)
    onehot = onehot * in_range[:, None]
    slot = ((torch.cumsum(onehot, 0) - onehot) * onehot).sum(1)
    keep = slot < capacity
    dest = peer_s * capacity + torch.where(keep, slot, capacity - 1)
    kept = keep & in_range
    over = ~keep & in_range
    src_s, ids_s = flat_src[order], flat_ids[order]

    d = dest[kept]
    send_x = torch.zeros((n_peers * capacity, x.shape[1]), dtype=x.dtype,
                         device=dev)
    send_x.index_add_(0, d, x[src_s[kept]])  # unique slots: one add each
    m_src = torch.full((n_peers * capacity,), -1, dtype=torch.long,
                       device=dev)
    m_eid = torch.zeros((n_peers * capacity,), dtype=torch.long, device=dev)
    m_gate = torch.zeros((n_peers * capacity,), dtype=torch.float32,
                         device=dev)
    m_src[d] = src_s[kept]
    m_eid[d] = ids_s[kept]
    m_gate[d] = flat_gate[order][kept]
    # the reference's last write to an overflowing bucket's last slot
    last = peer_s[over] * capacity + capacity - 1
    m_src[last] = -1
    m_eid[last] = 0
    m_gate[last] = 0.0
    counts = (onehot * kept[:, None]).sum(0)
    return (send_x.reshape(n_peers, capacity, x.shape[1]),
            m_src.reshape(n_peers, capacity),
            m_eid.reshape(n_peers, capacity),
            m_gate.reshape(n_peers, capacity), counts)


def expert_ffn(xs, eids_local, w_gate, w_up, w_down):
    """Apply the owning shard's experts.  xs: (N, M); eids_local: (N,)
    local expert index; w_*: (E_local, M, F) / (E_local, F, M).  One SwiGLU
    product per expert over its rows, in xs's dtype."""
    E = w_gate.shape[0]
    out = torch.zeros_like(xs)
    order = torch.sort(eids_local, stable=True).indices
    counts = torch.bincount(eids_local, minlength=E).tolist()
    start = 0
    for e, n in enumerate(counts):
        if not n:
            continue
        rows = order[start:start + n]
        start += n
        xe = xs[rows]
        g = xe @ w_gate[e].to(xs.dtype)
        u = xe @ w_up[e].to(xs.dtype)
        out[rows] = (F.silu(g) * u) @ w_down[e].to(xs.dtype)
    return out


def _exchange(t, group):
    """all_to_all over dim 0 of (P, ...): chunk p goes to peer p, and the
    chunk from peer q lands at q."""
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t.contiguous(), group=group)
    return out


def _combine(flat_out, flat_src, flat_gate, T, K, dtype):
    """y[t] = the f32 sum over t's slots, in slot order, of out * gate,
    rounded once to ``dtype``: the reference's scatter-add on the CPU,
    which XLA runs in f32 for a bf16 array."""
    M = flat_out.shape[1]
    slots = torch.nonzero(flat_src >= 0).squeeze(1)
    src = flat_src[slots]
    by_src = torch.sort(src, stable=True)
    first = torch.searchsorted(by_src.values, by_src.values)
    rank = torch.empty_like(src)
    rank[by_src.indices] = torch.arange(src.numel(), device=src.device) - first
    table = torch.zeros((T, K, M), dtype=torch.float32,
                        device=flat_out.device)
    table[src, rank] = flat_out[slots].float() * flat_gate[slots, None]
    y = table[:, 0]
    for k in range(1, K):
        y = y + table[:, k]
    return y.to(dtype)


def moe_ep_a2a_local(x, expert_ids, gate_w, w_gate, w_up, w_down,
                     group=None, capacity_factor: float = 1.25):
    """One data shard's MoE through the bucketed exchange.

    ``group`` (a ``ProcessGroup`` over the expert shards, e.g.
    ``mesh.get_group("model")``) sends the buffers and their expert ids
    across ranks with ``all_to_all_single``; ``group=None`` is the
    single-shard reference (one peer).  w_*: this rank's experts,
    (E_local, M, F) / (E_local, F, M).  Returns y (T, M) in x's dtype.
    """
    T, M = x.shape
    K = expert_ids.shape[1]
    n_peers = dist.get_world_size(group) if group is not None else 1
    capacity = max(1, int(T * K * capacity_factor / max(n_peers, 1)))
    send_x, m_src, m_eid, m_gate, _ = bucket_by_peer(
        x, expert_ids, gate_w, n_peers, capacity)
    if group is not None:
        recv_x, recv_eid = _exchange(send_x, group), _exchange(m_eid, group)
    else:
        recv_x, recv_eid = send_x, m_eid
    E_local = w_gate.shape[0]
    out = expert_ffn(recv_x.reshape(-1, M), recv_eid.reshape(-1) % E_local,
                     w_gate, w_up, w_down).reshape(recv_x.shape)
    if group is not None:
        out = _exchange(out, group)
    return _combine(out.reshape(-1, M), m_src.reshape(-1),
                    m_gate.reshape(-1), T, K, x.dtype)
