"""repro_torch.distributed — the multi-device layer and the host-level
fault-tolerance control plane, on ``torch.distributed``:

* ``fault``: health ladder, straggler watchdog, trend detector, remesh
  plans;
* ``grad_compress``: the train step's int8 pair with error feedback and
  top-k, and the collectives ``compressed_psum`` (int8 payload, int32 on
  the wire) and ``sparse_psum`` (top-k pairs through an all-gather) over a
  process group;
* ``ep_a2a``: sort-based expert-parallel MoE dispatch over
  ``all_to_all_single`` (not wired into ``models/moe.py``, as in the
  reference);
* ``sharding``: the logical-axis rule tables, ``to_pspec``, ``constrain``
  and ``named_sharding`` over ``DeviceMesh`` and DTensor placements, with
  ``AbstractMesh`` for meshes without devices.

Port of ``repro.distributed`` (which has no package file); its ``compat``
(a shim over JAX versions) has no counterpart.  The meshes are built by
``repro_torch.launch.mesh``.
"""
