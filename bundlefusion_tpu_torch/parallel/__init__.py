"""The multi-device path: ``torch.distributed`` ranks in place of a JAX mesh.

- ``mesh``: ``make_mesh`` over an initialised process group, the
  collectives, ``run_ranks`` to start a group of ranks;
- ``ba_sharded``: the corr-sharded Gauss-Newton / PCG solver and
  keyframe-sharded matching;
- ``map_sharded``: TSDF payload rows sharded by slot range.

The engine (``pipeline.online.BundleFusion(..., mesh=)``) uses ``mesh`` and
``ba_sharded``.
"""
