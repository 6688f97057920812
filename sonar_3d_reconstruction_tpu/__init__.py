"""Accelerator-native probabilistic 3D sonar reconstruction framework.

A from-scratch JAX/XLA rebuild of the capabilities of the reference
``sonar_3d_reconstruction`` ROS2 package (multibeam-sonar seabed mapping with
log-odds Bayesian occupancy, reference scripts/3d_mapper.py): polar sonar pings
are backprojected through a 20-degree vertical-aperture fan into world space and
scatter-accumulated into a (dense or hashed-sparse) voxel occupancy map — as one
fused, fixed-shape XLA program per ping, scanned over ping sequences, and
shardable over a device mesh.

Layering (bottom to top):
  geometry   — batched SE(3) math (RPY/quaternion -> 4x4, pose chains)
  ops        — fixed-shape backprojection + scatter-accumulate/finalize updates
  grid       — map state: dense voxel grid and open-addressing hash grid
  models     — SonarMapper, the stateful flagship API (reference parity surface)
  pipeline   — ping-sequence scan, time synchronization, streaming
  parallel   — shard_map multi-chip sharding over a jax Mesh
  io         — image decode, PointCloud2/MarkerArray bytes, bag replay
  golden     — pure-NumPy oracle reproducing the reference numerics exactly
"""

__version__ = "0.1.0"

from sonar_3d_reconstruction_tpu.config import MapperConfig, load_config  # noqa: F401
