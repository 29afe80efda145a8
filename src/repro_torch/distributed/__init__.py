"""repro_torch.distributed — the host-level fault-tolerance control plane
(``fault``: health ladder, straggler watchdog, trend detector).

Port of ``repro.distributed``; its other modules (gradient compression,
expert dispatch, sharding) are not ported yet.
"""
