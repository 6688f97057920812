"""Multi-device spatial sharding of the BRICK map (shard_map).

The brick backend (grid/brick.py — the fastest single-chip engine) sharded
with the same ownership design as parallel/shard.py's voxel-hash engine
(SURVEY.md section 5.8; the reference is a single Python process with zero
parallelism, so this layer is a new design, not a port):

  * Mesh axis ``"space"``: the brick table splits into S independent
    sub-tables.  A voxel's owner shard is a hash of its BRICK code mod S —
    whole bricks stay on one shard, so the window apply's dense in-brick
    chain evaluation (grid/brick.py step 3) runs entirely locally and the
    sharded map is bit-identical to single-chip.
  * Each shard re-derives the replicated candidate stream (backprojection
    is a small fraction of the step — cheaper than all-gathering an ~80 MB
    candidate window), filters the bricks it owns, and runs the
    standard sort-dedup + brick window apply on its local block.
  * Frame/window atomicity: any shard's overflow rejects the window on
    EVERY shard (``fail_reduce`` psum before any write), so the host grows
    all sub-tables and replays exactly like the single-chip wrapper.

Frame ordering (the adaptive update reads pre-window state) is preserved:
windows chain sequentially; parallelism is within a window.
"""

from __future__ import annotations

import functools
from functools import partial
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from sonar_3d_reconstruction_tpu.config import MapperConfig
from sonar_3d_reconstruction_tpu.grid.brick import (
    BrickGridState,
    DEFAULT_BRICK_BITS,
    apply_brick_records_batched,
    default_brick_budget,
    init_brick_grid,
)
from sonar_3d_reconstruction_tpu.grid.hash import (
    BUCKET_SLOTS,
    bucket_lookup,
    empty_key_rows,
    insert_unique,
)
from sonar_3d_reconstruction_tpu.ops.backproject import (
    FanTables,
    backproject_ping,
)
from sonar_3d_reconstruction_tpu.ops.dedup import dedup_frame
from sonar_3d_reconstruction_tpu.ops.packing import (
    EMPTY_HI,
    brick_layout,
    mix2,
    pack_brick_keys,
)
from sonar_3d_reconstruction_tpu.parallel.shard import make_mesh


class ShardedBrickState(NamedTuple):
    """Brick map pytree; leading axis S sharded over mesh axis "space".
    Bounds are global and replicated (each shard computes them over the
    full candidate stream), like ShardedHashState."""

    key_rows: jnp.ndarray    # (S, Cb/128, 256) uint32 brick codes
    log_odds: jnp.ndarray    # (S, Cb, vol)
    touched: jnp.ndarray     # (S, Cb, words) uint32
    min_bounds: jnp.ndarray  # (S, 3) global, replicated
    max_bounds: jnp.ndarray  # (S, 3)
    used: jnp.ndarray        # (S,) int32 touched voxels per shard
    poisoned: jnp.ndarray    # (S,) bool

    @property
    def local_capacity(self) -> int:
        return self.key_rows.shape[1] * BUCKET_SLOTS

    @property
    def brick_volume(self) -> int:
        return self.log_odds.shape[2]

    @property
    def brick_bits(self) -> int:
        return (self.brick_volume.bit_length() - 1) // 3  # vol == 2^(3b)


def _state_specs(axis_name: str) -> ShardedBrickState:
    return ShardedBrickState(
        P(axis_name), P(axis_name), P(axis_name), P(axis_name),
        P(axis_name), P(axis_name), P(axis_name),
    )


def init_sharded_brick_grid(
    mesh: Mesh,
    local_capacity: int = 1 << 14,
    dtype=jnp.float32,
    brick_bits: int = DEFAULT_BRICK_BITS,
) -> ShardedBrickState:
    assert local_capacity & (local_capacity - 1) == 0
    S = mesh.devices.size
    sh = NamedSharding(mesh, P("space"))
    one = init_brick_grid(local_capacity, dtype, brick_bits=brick_bits)
    big = jnp.asarray(jnp.inf, dtype)

    def rep(x):
        return jnp.broadcast_to(x[None], (S,) + x.shape)

    return ShardedBrickState(
        key_rows=jax.device_put(rep(one.key_rows), sh),
        log_odds=jax.device_put(rep(one.log_odds), sh),
        touched=jax.device_put(rep(one.touched), sh),
        min_bounds=jax.device_put(jnp.full((S, 3), big, dtype), sh),
        max_bounds=jax.device_put(jnp.full((S, 3), -big, dtype), sh),
        used=jax.device_put(jnp.zeros((S,), jnp.int32), sh),
        poisoned=jax.device_put(jnp.zeros((S,), bool), sh),
    )


def owner_shard_brick(
    hi: jnp.ndarray, lo: jnp.ndarray, brick_bits: int, n_shards: int
) -> jnp.ndarray:
    """Packed brick-major codes -> owner shard of the BRICK (offset and
    frame bits masked out, so every voxel of a brick lands together)."""
    _, o, _ = brick_layout(brick_bits)
    brick_lo = lo & jnp.uint32(0xFFFFFFFF ^ ((1 << (o + 4)) - 1))
    return (mix2(brick_lo, hi) % jnp.uint32(n_shards)).astype(jnp.int32)


def _local_brick(blk: ShardedBrickState) -> BrickGridState:
    return BrickGridState(
        key_rows=blk.key_rows[0],
        log_odds=blk.log_odds[0],
        touched=blk.touched[0],
        min_bounds=blk.min_bounds[0],
        max_bounds=blk.max_bounds[0],
        used=blk.used[0],
        poisoned=blk.poisoned[0],
    )


def _wrap_blk(local: BrickGridState) -> ShardedBrickState:
    return ShardedBrickState(
        key_rows=local.key_rows[None],
        log_odds=local.log_odds[None],
        touched=local.touched[None],
        min_bounds=local.min_bounds[None],
        max_bounds=local.max_bounds[None],
        used=local.used[None],
        poisoned=local.poisoned[None],
    )


@functools.lru_cache(maxsize=32)
def make_window_scan_sharded_brick(
    mesh: Mesh,
    tables: FanTables,
    cfg: MapperConfig,
    dtype=jnp.float32,
    axis_name: str = "space",
    unique_budget: Optional[int] = None,
    window: int = 8,
    brick_budget: Optional[int] = None,
    lane_budget: Optional[int] = None,
    insert_budget=None,
    brick_bits: int = DEFAULT_BRICK_BITS,
):
    """Sharded brick window-engine sequence runner:
    (state, images (P,R,B), transforms (P,4,4), start) -> (state, stats).

    Budget semantics mirror make_window_scan_sharded: ``brick_budget`` /
    ``lane_budget`` / ``insert_budget`` are PER-SHARD statics (the
    ownership hash splits bricks ~uniformly, so a shard needs ~1/S of the
    global budgets); ``insert_budget`` accepts an int or a [cold, warm]
    schedule (one compiled window program per distinct value).  Per-shard
    snug-sizing requirements are reported as ``*_max`` pmax stats alongside
    the psum'd global sums.
    """
    from sonar_3d_reconstruction_tpu.grid.hash import default_unique_budget
    from sonar_3d_reconstruction_tpu.ops.records import FrameAux

    if unique_budget is None:
        unique_budget = default_unique_budget(
            tables.candidates_per_ping(cfg.occupied_window)
        )
    if brick_budget is None:
        brick_budget = default_brick_budget(window, unique_budget)
    if insert_budget is None or isinstance(insert_budget, int):
        insert_schedule = (insert_budget,)
    else:
        insert_schedule = tuple(insert_budget)

    def local_window(blk, images, transforms, w_start, start, stop,
                     *, window_insert_budget):
        my = jax.lax.axis_index(axis_name)
        S = jax.lax.axis_size(axis_name)

        def frame(i):
            idx = w_start + i
            image = jax.lax.dynamic_index_in_dim(
                images, idx, 0, keepdims=False
            )
            T = jax.lax.dynamic_index_in_dim(
                transforms, idx, 0, keepdims=False
            )
            frame_on = (idx >= start) & (idx < stop)
            cand = backproject_ping(image, T, tables, cfg, dtype=dtype)
            keys = jnp.floor(
                cand["points"] / cfg.voxel_resolution
            ).astype(jnp.int32)
            hi, lo, in_range = pack_brick_keys(keys, brick_bits)
            valid = cand["valid"] & frame_on
            range_fail = jnp.any(valid & ~in_range)
            valid = valid & in_range
            active = valid & (
                owner_shard_brick(hi, lo, brick_bits, S) == my
            )
            rec = dedup_frame(hi, lo, cand["is_occupied"], active,
                              unique_budget)
            # global bounds over the REPLICATED valid set (int-key reduce,
            # ops/records.frame_records rationale) — identical on every
            # shard, reference 3d_mapper.py:560 semantics
            imax = jnp.iinfo(jnp.int32).max
            kmin = jnp.min(jnp.where(valid[:, None], keys, imax), axis=0)
            kmax = jnp.max(jnp.where(valid[:, None], keys, -imax), axis=0)
            any_valid = jnp.any(valid)
            inf = jnp.asarray(jnp.inf, dtype)
            center = lambda k: (k.astype(dtype) + 0.5) * cfg.voxel_resolution
            aux = FrameAux(
                cmin=jnp.where(any_valid, center(kmin), inf),
                cmax=jnp.where(any_valid, center(kmax), -inf),
                range_fail=range_fail,
                n_valid=jnp.sum(active).astype(jnp.int32),
            )
            return rec, aux

        recs, auxs = jax.lax.map(frame, jnp.arange(window, dtype=jnp.int32))
        new_local, stats = apply_brick_records_batched(
            _local_brick(blk), recs, auxs, cfg,
            brick_budget=brick_budget, lane_budget=lane_budget,
            insert_budget=window_insert_budget,
            fail_reduce=lambda f: jax.lax.psum(
                f.astype(jnp.int32), axis_name
            ) > 0,
        )
        stats = dict(stats)
        # per-shard maxima FIRST (for snug per-shard budget sizing); the
        # psums below overwrite the same keys with global sums
        for k in ("batch_n_unique", "batch_n_bricks", "batch_n_lanes",
                  "batch_n_need"):
            stats[k + "_max"] = jax.lax.pmax(stats[k], axis_name)
            stats[k] = jax.lax.psum(stats[k], axis_name)
        for k in ("num_occupied", "num_free", "num_candidates"):
            stats[k] = jax.lax.psum(stats[k], axis_name)
        for k in ("unique_overflow", "batch_overflow", "insert_overflow",
                  "pack_overflow"):
            stats[k] = jax.lax.psum(stats[k].astype(jnp.int32), axis_name) > 0
        return _wrap_blk(new_local), stats

    stats_specs = {
        "num_occupied": P(), "num_free": P(), "num_candidates": P(),
        "overflowed": P(), "unique_overflow": P(), "batch_overflow": P(),
        "insert_overflow": P(), "pack_overflow": P(), "range_fail": P(),
        "batch_n_unique": P(), "batch_n_bricks": P(), "batch_n_lanes": P(),
        "batch_n_need": P(), "batch_n_unique_max": P(),
        "batch_n_bricks_max": P(), "batch_n_lanes_max": P(),
        "batch_n_need_max": P(),
    }
    window_steps = {
        ib: jax.jit(
            shard_map(
                partial(local_window, window_insert_budget=ib),
                mesh=mesh,
                in_specs=(_state_specs(axis_name), P(), P(), P(), P(), P()),
                out_specs=(_state_specs(axis_name), stats_specs),
                check_vma=False,
            )
        )
        for ib in set(insert_schedule)
    }

    def scan(state, images, transforms, start=0):
        P_ = images.shape[0]
        images = jnp.asarray(images)
        transforms = jnp.asarray(transforms, dtype)
        start = jnp.asarray(start, jnp.int32)
        stop = jnp.int32(P_)
        window_stats = []
        for wi, w in enumerate(range(0, P_, window)):
            ib = insert_schedule[min(wi, len(insert_schedule) - 1)]
            state, stats = window_steps[ib](
                state, images, transforms, jnp.int32(w), start, stop
            )
            window_stats.append(stats)
        return state, {
            k: jnp.concatenate([s[k] for s in window_stats])[:P_]
            for k in (window_stats[0] if window_stats else {})
        }

    return scan


def run_grow_replay(
    *,
    st,
    images_dev,
    T_dev,
    n_frames: int,
    max_grow_retries: int,
    make_scan,
    growable_causes,
    rehash,
    label: str,
):
    """Shared sharded-engine host loop: run ``make_scan()()``, merge the
    per-frame stats of applied frames, and on overflow attribute the
    cause in priority order — the two fatal causes (``range_fail``,
    ``pack_overflow``) raise; ``growable_causes`` is an ordered tuple of
    ``(stat_key, grow_fn)`` where ``grow_fn()`` mutates the caller's
    budget state (via closure) before the poison-cleared replay; no
    matching cause falls through to ``rehash(new_st)`` (capacity).
    Used by both map_ping_sequence_sharded_brick and
    map_ping_sequence_sharded_frames so the two growth state machines
    cannot drift."""
    merged: Dict[str, np.ndarray] = {}
    start = 0
    for _ in range(max_grow_retries):
        new_st, stats = make_scan()(st, images_dev, T_dev, jnp.int32(start))
        over = np.asarray(stats["overflowed"])
        applied_hi = n_frames if not over.any() else int(np.argmax(over))
        for k, v in stats.items():
            arr = merged.setdefault(
                k, np.zeros((n_frames,), np.asarray(v).dtype)
            )
            arr[start:applied_hi] = np.asarray(v)[start:applied_hi]
        if not over.any():
            return new_st, merged
        start = applied_hi
        tail = slice(applied_hi, None)
        if bool(np.asarray(stats["range_fail"])[tail].any()):
            raise ValueError(
                f"frame >= {applied_hi}: voxel keys outside the packable "
                "range — check odometry frame offsets; growth cannot fix "
                "this"
            )
        if bool(np.asarray(stats["pack_overflow"])[tail].any()):
            raise ValueError(
                "a voxel received 2^16+ emissions in one frame (count "
                "packing width) — use the sharded hash engine for this "
                "degenerate geometry"
            )
        for key, grow_fn in growable_causes:
            if bool(np.asarray(stats[key])[tail].any()):
                grow_fn()
                st = new_st._replace(
                    poisoned=jnp.zeros_like(new_st.poisoned)
                )
                break
        else:
            st = rehash(new_st)
    raise RuntimeError(
        f"{label} growth did not converge after {max_grow_retries} retries"
    )


def map_ping_sequence_sharded_brick(
    images: np.ndarray,
    positions: np.ndarray,
    quaternions: np.ndarray,
    cfg: Optional[MapperConfig] = None,
    *,
    mesh: Optional[Mesh] = None,
    local_capacity: int = 1 << 14,
    state: Optional[ShardedBrickState] = None,
    dtype=jnp.float32,
    axis_name: str = "space",
    window: int = 8,
    unique_budget: Optional[int] = None,
    brick_budget: Optional[int] = None,
    lane_budget: Optional[int] = None,
    insert_budget=None,
    brick_bits: int = DEFAULT_BRICK_BITS,
    max_grow_retries: int = 12,
    effective: Optional[Dict] = None,
    fan_cap="auto",
    window_cap="auto",
    free_cap="auto",
) -> Tuple[ShardedBrickState, Dict[str, np.ndarray]]:
    """Sharded-brick equivalent of pipeline.map_ping_sequence: grow and
    replay from the first failed frame with full cause attribution (unique
    budget vs brick/lane budget vs insert budget vs capacity vs key range
    vs count packing), mirroring _map_ping_sequence_brick.  ``effective``,
    if given, receives the post-growth budgets so a stateful caller can
    pass them back next batch instead of re-growing."""
    from sonar_3d_reconstruction_tpu.grid.hash import default_unique_budget
    from sonar_3d_reconstruction_tpu.ops.backproject import (
        resolve_capped_tables,
    )
    from sonar_3d_reconstruction_tpu.pipeline import batched_sonar_to_world

    cfg = cfg or MapperConfig()
    mesh = mesh if mesh is not None else make_mesh(axis_name=axis_name)
    images = np.asarray(images)
    P_, R, B = images.shape
    tables = resolve_capped_tables(
        images, cfg, R, B, fan_cap=fan_cap, window_cap=window_cap,
        free_cap=free_cap,
    )
    T = batched_sonar_to_world(positions, quaternions, cfg)
    images_dev = jnp.asarray(images)
    T_dev = jnp.asarray(T, dtype)

    st = (
        state if state is not None
        else init_sharded_brick_grid(mesh, local_capacity, dtype, brick_bits)
    )
    if P_ == 0:
        return st, {}
    window = min(window, P_)
    if isinstance(insert_budget, list):
        insert_budget = tuple(insert_budget)
    def make_scan():
        return make_window_scan_sharded_brick(
            mesh, tables, cfg, dtype, axis_name, unique_budget,
            window, brick_budget, lane_budget, insert_budget, brick_bits,
        )

    def grow_unique():
        nonlocal unique_budget, brick_budget
        unique_budget = 2 * (
            unique_budget
            or default_unique_budget(
                tables.candidates_per_ping(cfg.occupied_window)
            )
        )
        brick_budget = None

    def grow_insert():
        nonlocal insert_budget
        if isinstance(insert_budget, tuple):
            insert_budget = tuple(2 * b for b in insert_budget)
        elif insert_budget is not None:
            insert_budget = 2 * insert_budget

    def grow_batch():
        nonlocal brick_budget, lane_budget
        ub = unique_budget or default_unique_budget(
            tables.candidates_per_ping(cfg.occupied_window)
        )
        brick_budget = 2 * (brick_budget or default_brick_budget(window, ub))
        if lane_budget is not None:
            # lanes_overflow reports through the same merged channel; a
            # snug lane budget would never recover from doubling bricks —
            # drop to the derived full-width default (sufficient)
            lane_budget = None

    out = run_grow_replay(
        st=st, images_dev=images_dev, T_dev=T_dev, n_frames=P_,
        max_grow_retries=max_grow_retries, make_scan=make_scan,
        growable_causes=(
            ("unique_overflow", grow_unique),
            ("insert_overflow", grow_insert),
            ("batch_overflow", grow_batch),
        ),
        rehash=lambda s: rehash_sharded_bricks(
            st=s, mesh=mesh, new_local_capacity=s.local_capacity * 2,
            axis_name=axis_name,
        ),
        label="sharded brick",
    )
    if effective is not None:
        effective.update(
            unique_budget=unique_budget, brick_budget=brick_budget,
            lane_budget=lane_budget, insert_budget=insert_budget,
        )
    return out


def rehash_sharded_bricks(
    st: ShardedBrickState, mesh: Mesh, new_local_capacity: int,
    axis_name: str = "space",
) -> ShardedBrickState:
    """Grow every per-shard brick sub-table (ownership is a pure function
    of the brick code, so entries never migrate between shards) and clear
    ``poisoned`` for replay; doubles again until every bucket fits."""
    while True:
        grown, overflowed = _grow_prog(mesh, axis_name, new_local_capacity)(
            st
        )
        if not bool(overflowed):
            return grown
        new_local_capacity *= 2


@functools.lru_cache(maxsize=32)
def _grow_prog(mesh: Mesh, axis_name: str, new_local_capacity: int):
    """Cached jitted grow program (same convention as the window builders
    above): rebuilding jit(shard_map(...)) per growth event would retrace
    — and recompile — every time."""

    def grow_block(blk):
        local = _local_brick(blk)
        hi, lo = local.key_hi, local.key_lo
        occupied = hi != EMPTY_HI
        fresh = empty_key_rows(new_local_capacity)
        bucket, found, _, fill = bucket_lookup(fresh, hi, lo)
        nrows, slots, overflowed, _ = insert_unique(
            fresh, hi, lo, occupied & ~found, bucket, fill
        )
        slots = jnp.minimum(slots, new_local_capacity)
        nlod = jnp.zeros(
            (new_local_capacity, local.brick_volume),
            local.log_odds.dtype,
        ).at[slots].set(local.log_odds, mode="drop")
        ntouched = jnp.zeros(
            (new_local_capacity, local.touched.shape[1]), jnp.uint32
        ).at[slots].set(local.touched, mode="drop")
        any_ovf = jax.lax.psum(
            overflowed.astype(jnp.int32), axis_name
        ) > 0
        return (
            _wrap_blk(BrickGridState(
                key_rows=nrows,
                log_odds=nlod,
                touched=ntouched,
                min_bounds=local.min_bounds,
                max_bounds=local.max_bounds,
                used=local.used,
                poisoned=jnp.zeros((), bool),
            )),
            any_ovf,
        )

    return jax.jit(
        shard_map(
            grow_block,
            mesh=mesh,
            in_specs=(_state_specs(axis_name),),
            out_specs=(_state_specs(axis_name), P()),
            check_vma=False,
        )
    )


def local_brick_states(state: ShardedBrickState) -> "list[BrickGridState]":
    """Per-shard views of a sharded brick map as plain BrickGridState
    sub-tables.  Shards own DISJOINT brick sets, so any read-only
    per-state operation (extraction, classification, point queries)
    distributes exactly: run it per shard and concatenate (or, for
    log-odds queries, sum — absent shards answer exactly 0.0)."""
    return [
        BrickGridState(
            key_rows=state.key_rows[s],
            log_odds=state.log_odds[s],
            touched=state.touched[s],
            min_bounds=state.min_bounds[s],
            max_bounds=state.max_bounds[s],
            used=state.used[s],
            poisoned=state.poisoned[s],
        )
        for s in range(state.key_rows.shape[0])
    ]


def default_local_capacity(initial_capacity: int, n_shards: int) -> int:
    """Per-shard brick capacity from a user-facing VOXEL-scale capacity
    (the SonarMapper/StreamingMapper ``initial_capacity`` contract):
    bricks ~ capacity >> 4, split across shards, floored at 128 and
    rounded up to the power of two init_sharded_brick_grid requires."""
    local = max(128, (initial_capacity >> 4) // n_shards)
    return 1 << (local - 1).bit_length()


def extract_occupied_sharded(
    state: ShardedBrickState, cfg
) -> Tuple[np.ndarray, np.ndarray]:
    """Occupied (points, probabilities) of a sharded brick map: the
    per-shard device compaction of grid/brick.extract_occupied_brick,
    concatenated (disjoint bricks — exact)."""
    from sonar_3d_reconstruction_tpu.grid.brick import extract_occupied_brick

    parts = [extract_occupied_brick(s, cfg) for s in local_brick_states(state)]
    return (
        np.concatenate([p[0] for p in parts]),
        np.concatenate([p[1] for p in parts]),
    )


def gather_sharded_brick_state(
    state: ShardedBrickState,
) -> Tuple[np.ndarray, np.ndarray]:
    """Pull the sharded brick map to host as ((N, 3) int32 touched voxel
    keys, (N,) log-odds) — the layout-independent view (shards hold
    disjoint bricks, so plain concatenation is exact).  Device slices are
    handed to the extractor directly: its compaction selects the occupied
    rows on device, so only O(occupied) data crosses to the host."""
    from sonar_3d_reconstruction_tpu.grid.brick import touched_voxels_brick

    keys, vals = [], []
    for local in local_brick_states(state):
        k, v = touched_voxels_brick(local)
        keys.append(k)
        vals.append(v)
    return (
        np.concatenate(keys) if keys else np.empty((0, 3), np.int32),
        np.concatenate(vals) if vals else np.empty((0,)),
    )


def sharded_brick_bounds(
    state: ShardedBrickState,
) -> Tuple[np.ndarray, np.ndarray]:
    """Global updated-voxel-center bounds — replicated, shard 0's copy."""
    return (
        np.asarray(state.min_bounds[0]),
        np.asarray(state.max_bounds[0]),
    )
