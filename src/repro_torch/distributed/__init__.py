"""repro_torch.distributed — the host-level fault-tolerance control plane
(``fault``: health ladder, straggler watchdog, trend detector) and the
train step's gradient compression (``grad_compress``: the int8 pair and
top-k, without the collectives).

Port of ``repro.distributed``; its other modules (the compressed
collectives, expert dispatch, sharding) are not ported yet.
"""
