"""Frame-sharded parallel analysis engine.

Batched re-design of the reference's only distributed mechanism —
`System::traj_iter_map_reduce` (`src/system/parallel.rs:208`): there, each
OS thread clones the System, opens its own reader, strides frames, and
results are reduced after a join.  Here the same decomposition maps to the
hardware: the host decodes frame batches (native codec + prefetch thread),
`jax.device_put` shards the `[B, N, 3]` batch over the `frames` axis of a
`jax.sharding.Mesh`, one jitted step evaluates the per-frame analysis on
every device in parallel (XLA inserts the collectives), and reduction is
either concatenation of per-frame outputs or a `psum` tree on device.

The optional `atoms` mesh axis shards the atom dimension (the reference has
no analogue — its "sequence-parallel" equivalent, SURVEY §2.3) so systems
larger than one chip's HBM still fit: reductions over atoms become
`psum(axis='atoms')` inside `shard_map`.
"""

from .engine import (DeviceTrajectory, FrameEngine, make_mesh,
                     traj_iter_map_reduce)
from .multihost import merge_striped, striped_batches

__all__ = ["DeviceTrajectory", "FrameEngine", "make_mesh",
           "merge_striped", "striped_batches", "traj_iter_map_reduce"]
