"""Frame records: the state-independent half of the map update.

A frame's contribution to the map is fully described by its compact
unique-voxel records (ops/dedup.py) plus a few reductions (bounds, range
check).  Computing them needs only the ping and its pose — NOT the map state
— so records for many pings can be computed in one batched dispatch (or on
other hosts for a different bag segment, SURVEY.md 5.8 DCN sharding) while
only the cheap sequential ``apply`` chains through the map state.  The
split preserves exact reference semantics: the adaptive update's sequential
dependency (3d_mapper.py:95-102) lives entirely in the apply step.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from sonar_3d_reconstruction_tpu.config import MapperConfig
from sonar_3d_reconstruction_tpu.ops.backproject import (
    FanTables,
    backproject_ping,
)
from sonar_3d_reconstruction_tpu.ops.dedup import (
    UniqueRecords,
    dedup_frame,
    dedup_frame_compact,
)
from sonar_3d_reconstruction_tpu.ops.packing import (
    pack_box_keys,
    pack_brick_keys,
    pack_keys,
)


class FrameAux(NamedTuple):
    """Per-frame reductions that accompany the unique records."""

    cmin: jnp.ndarray        # (3,) min updated-voxel center (inf if none)
    cmax: jnp.ndarray        # (3,) max updated-voxel center (-inf if none)
    range_fail: jnp.ndarray  # () bool: a valid key fell outside packable range
    n_valid: jnp.ndarray     # () int32 valid candidate emissions


def frame_records(
    image: jnp.ndarray,
    T_sonar_to_world: jnp.ndarray,
    tables: FanTables,
    cfg: MapperConfig,
    unique_budget: int,
    dtype=jnp.float32,
    frame_on=None,
    dedup_lane_budget: int = 0,
    brick_bits: int = 0,
    box_min=None,
    box_bits=None,
) -> Tuple[UniqueRecords, FrameAux]:
    """One ping -> (UniqueRecords, FrameAux). Pure, state-independent.

    ``dedup_lane_budget`` (optional) is dedup_frame's compaction-slice
    width: it must cover the frame's VALID candidates, while
    ``unique_budget`` only bounds its DISTINCT voxels.  Decoupling them
    lets hosts with measured statistics shrink the (U,)-wide record
    arrays — and the window sort, scans and stats that scale with U —
    without the compaction-coverage constraint inflating U (~14% on the
    bench survey).  Both overflows report through ``n_unique``.

    ``brick_bits`` > 0 packs keys brick-major (ops/packing.pack_brick_keys)
    for the grid/brick.py backend; 0 keeps the voxel packing.  Dedup
    semantics are identical either way (equal voxels <=> equal codes).

    ``box_min``/``box_bits`` (with ``brick_bits``) switch to single-u32
    box-relative keys (ops/packing.pack_box_keys) and return a
    CompactRecords instead — ~3x less sort traffic (the records program's
    dominant cost).  A candidate outside the box reports through
    ``range_fail`` (host gate compute_window_boxes makes that provably
    impossible for boxes it emits).
    """
    cand = backproject_ping(image, T_sonar_to_world, tables, cfg, dtype=dtype)
    valid = cand["valid"]
    if frame_on is not None:
        valid = valid & frame_on

    keys = jnp.floor(cand["points"] / cfg.voxel_resolution).astype(jnp.int32)
    if box_min is not None:
        assert brick_bits > 0 and box_bits is not None
        bkey, in_range = pack_box_keys(keys, box_min, box_bits, brick_bits)
    elif brick_bits:
        hi, lo, in_range = pack_brick_keys(keys, brick_bits)
    else:
        hi, lo, in_range = pack_keys(keys)
    range_fail = jnp.any(valid & ~in_range)
    valid = valid & in_range

    if box_min is not None:
        rec = dedup_frame_compact(
            bkey, cand["is_occupied"], valid, unique_budget,
            lane_budget=dedup_lane_budget,
        )
    else:
        rec = dedup_frame(
            hi, lo, cand["is_occupied"], valid, unique_budget,
            lane_budget=dedup_lane_budget,
        )

    # Bounds reduce over INT keys, not (N, 3) float centers: the center map
    # k -> (k + 0.5) * res is exact for packable k (|k| < 2^20 so k + 0.5
    # is exact in f32) and monotone through IEEE rounding (res > 0,
    # round-to-nearest preserves <=), so min/max commute with it — the
    # (3,)-wide affine runs once on the reduced keys instead of
    # materializing an (N, 3) float centers array.
    imax = jnp.iinfo(jnp.int32).max
    kmin = jnp.min(jnp.where(valid[:, None], keys, imax), axis=0)
    kmax = jnp.max(jnp.where(valid[:, None], keys, -imax), axis=0)
    n_valid = jnp.sum(valid).astype(jnp.int32)
    any_valid = n_valid > 0
    inf = jnp.asarray(jnp.inf, dtype)
    center = lambda k: (k.astype(dtype) + 0.5) * cfg.voxel_resolution
    aux = FrameAux(
        cmin=jnp.where(any_valid, center(kmin), inf),
        cmax=jnp.where(any_valid, center(kmax), -inf),
        range_fail=range_fail,
        n_valid=n_valid,
    )
    return rec, aux


def frame_records_batch(
    images: jnp.ndarray,        # (B, R, Bw)
    transforms: jnp.ndarray,    # (B, 4, 4)
    frame_on: jnp.ndarray,      # (B,) bool window mask
    tables: FanTables,
    cfg: MapperConfig,
    unique_budget: int,
    dtype=jnp.float32,
) -> Tuple[UniqueRecords, FrameAux]:
    """Records for a window of pings in one program (leading axis B)."""

    def one(image, T, on):
        return frame_records(
            image, T, tables, cfg, unique_budget, dtype, frame_on=on
        )

    return jax.vmap(one)(images, transforms, frame_on)
