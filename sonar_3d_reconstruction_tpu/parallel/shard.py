"""Multi-device spatial sharding of the hashed voxel map (shard_map).

Design (SURVEY.md section 5.8; a design choice, not a port — the reference is
a single Python process over DDS with zero parallelism):

  * Mesh axis ``"space"``: the hash table is split into S independent
    bucketized sub-tables (grid/hash.py interleaved-row layout), one per
    device.  A voxel key's OWNER shard is a hash of its packed code mod S —
    independent of the in-shard bucket bits — so each shard resolves its
    keys entirely locally.
  * Within-ping data parallelism: backprojection + key packing are ordinary
    jit regions — GSPMD partitions them over the same mesh; the packed
    candidate stream is then all-gathered (XLA inserts the collective)
    so each shard can filter the candidates it owns and run the
    sort-dedup + bucket-table update (ops/dedup.py + grid/hash.py) on its
    local block.
  * Per-frame update semantics are identical to the single-chip path:
    ownership partitions the candidate set BEFORE dedup, so every per-voxel
    aggregate is computed entirely on the owner shard and sharded /
    single-chip maps hold identical log-odds.  Frame bounds (reference
    3d_mapper.py:112-115, :560) are computed over the full replicated
    candidate stream, so every shard carries the same global bounds.
  * Frame atomicity: if ANY shard overflows (unique budget or a bucket) the
    frame is rejected on EVERY shard (one psum decides before any
    write lands), so the host can grow all sub-tables and replay exactly as
    single-chip.

Frame ordering (the adaptive update reads pre-frame state, so pings are a
strict sequential scan) is preserved: steps chain over pings, parallelism is
within a ping.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from sonar_3d_reconstruction_tpu.config import MapperConfig
from sonar_3d_reconstruction_tpu.grid.hash import (
    BUCKET_SLOTS,
    DEFAULT_UNIQUE_BUDGET,
    HashGridState,
    apply_unique_records,
    empty_key_rows,
    voxel_keys,
)
from sonar_3d_reconstruction_tpu.ops.backproject import (
    FanTables,
    backproject_ping,
)
from sonar_3d_reconstruction_tpu.ops.dedup import dedup_frame
from sonar_3d_reconstruction_tpu.ops.packing import (
    EMPTY_HI,
    mix2,
    pack_keys,
    unpack_keys,
)


class ShardedHashState(NamedTuple):
    """Map state pytree; leading axis S is sharded over mesh axis "space".

    ``min_bounds``/``max_bounds`` hold the SAME global updated-voxel-center
    bounds on every shard (each shard computes them over the full replicated
    candidate stream), so a sharded run reproduces the single-chip
    ``get_point_cloud(include_free=True)["bounds"]`` semantics exactly.
    """

    key_rows: jnp.ndarray    # (S, C_local/8, 16) uint32 interleaved buckets
    log_odds: jnp.ndarray    # (S, C_local)
    min_bounds: jnp.ndarray  # (S, 3) global bounds, replicated across shards
    max_bounds: jnp.ndarray  # (S, 3)
    used: jnp.ndarray        # (S,) int32 occupied slots per shard
    poisoned: jnp.ndarray    # (S,) bool

    @property
    def local_capacity(self) -> int:
        return self.key_rows.shape[1] * BUCKET_SLOTS

    @property
    def key_hi(self) -> jnp.ndarray:
        """(S, C_local) uint32 flat hi words; EMPTY_HI = free."""
        S = self.key_rows.shape[0]
        return self.key_rows[:, :, :BUCKET_SLOTS].reshape(S, -1)

    @property
    def key_lo(self) -> jnp.ndarray:
        S = self.key_rows.shape[0]
        return self.key_rows[:, :, BUCKET_SLOTS:].reshape(S, -1)

    @property
    def keys(self) -> jnp.ndarray:
        """(S, C, 3) int32 unpacked view; empty slots read as EMPTY rows."""
        from sonar_3d_reconstruction_tpu.grid.hash import EMPTY

        hi, lo = self.key_hi, self.key_lo
        k = unpack_keys(hi, lo)
        return jnp.where((hi == EMPTY_HI)[..., None], EMPTY, k)


def make_mesh(devices=None, axis_name: str = "space") -> Mesh:
    """1D device mesh over all (or the given) devices."""
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis_name,))


def init_sharded_hash_grid(
    mesh: Mesh, local_capacity: int = 1 << 17, dtype=jnp.float32
) -> ShardedHashState:
    assert local_capacity & (local_capacity - 1) == 0
    S = mesh.devices.size
    sh = NamedSharding(mesh, P("space"))
    big = jnp.asarray(jnp.inf, dtype)
    rows = empty_key_rows(local_capacity)
    return ShardedHashState(
        key_rows=jax.device_put(
            jnp.broadcast_to(rows[None], (S,) + rows.shape), sh
        ),
        log_odds=jax.device_put(jnp.zeros((S, local_capacity), dtype), sh),
        min_bounds=jax.device_put(jnp.full((S, 3), big, dtype), sh),
        max_bounds=jax.device_put(jnp.full((S, 3), -big, dtype), sh),
        used=jax.device_put(jnp.zeros((S,), jnp.int32), sh),
        poisoned=jax.device_put(jnp.zeros((S,), bool), sh),
    )


def owner_shard(hi: jnp.ndarray, lo: jnp.ndarray, n_shards: int) -> jnp.ndarray:
    """Packed codes -> owner shard in [0, n_shards). Uses mix2 with swapped
    words so owner bits are independent of the in-shard bucket bits."""
    return (mix2(lo, hi) % jnp.uint32(n_shards)).astype(jnp.int32)


def _frame_bounds(hi, lo, valid, cfg, dtype):
    """Global updated-voxel-center bounds of this frame — computed from the
    full replicated candidate stream, identical on every shard (reference
    3d_mapper.py:560: bounds grow over every updated voxel's center)."""
    keys = unpack_keys(hi, lo)
    centers = (keys.astype(dtype) + 0.5) * cfg.voxel_resolution
    inf = jnp.asarray(jnp.inf, dtype)
    cmin = jnp.min(jnp.where(valid[:, None], centers, inf), axis=0)
    cmax = jnp.max(jnp.where(valid[:, None], centers, -inf), axis=0)
    return cmin, cmax


def _local_update(
    state_blk, hi, lo, occ, valid, range_fail, *, cfg, axis_name, unique_budget
):
    """Per-shard body: dedup the candidates this shard owns, update the
    local sub-table.  state_blk leaves have leading length-1 shard axis;
    candidates arrive fully replicated."""
    my = jax.lax.axis_index(axis_name)
    n_shards = jax.lax.axis_size(axis_name)
    active = valid & (owner_shard(hi, lo, n_shards) == my)

    rec = dedup_frame(hi, lo, occ, active, unique_budget)
    dtype = state_blk.log_odds.dtype
    local = HashGridState(
        key_rows=state_blk.key_rows[0],
        log_odds=state_blk.log_odds[0],
        min_bounds=state_blk.min_bounds[0],
        max_bounds=state_blk.max_bounds[0],
        used=state_blk.used[0],
        poisoned=state_blk.poisoned[0],
    )
    applied, stats, overflowed = apply_unique_records(local, rec, cfg)
    cmin, cmax = _frame_bounds(hi, lo, valid, cfg, dtype)

    my_failed = overflowed | range_fail | state_blk.poisoned[0]
    # frame atomicity: one psum decides accept/reject for every shard
    any_failed = jax.lax.psum(my_failed.astype(jnp.int32), axis_name) > 0

    applied_blk = ShardedHashState(
        key_rows=applied.key_rows[None],
        log_odds=applied.log_odds[None],
        min_bounds=jnp.minimum(state_blk.min_bounds[0], cmin)[None],
        max_bounds=jnp.maximum(state_blk.max_bounds[0], cmax)[None],
        used=applied.used[None],
        poisoned=state_blk.poisoned,
    )
    rejected = state_blk._replace(poisoned=jnp.ones((1,), bool))
    new_state = jax.tree_util.tree_map(
        lambda a, b: jnp.where(any_failed, a, b), rejected, applied_blk
    )

    zero = jnp.zeros((), jnp.int32)
    out_stats = {
        "num_occupied": jax.lax.psum(
            jnp.where(any_failed, zero, stats["num_occupied"]), axis_name
        ),
        "num_free": jax.lax.psum(
            jnp.where(any_failed, zero, stats["num_free"]), axis_name
        ),
        "num_candidates": jax.lax.psum(
            jnp.where(any_failed, zero, jnp.sum(active).astype(jnp.int32)),
            axis_name,
        ),
        "overflowed": any_failed,
        "unique_overflow": jax.lax.psum(
            rec.overflowed.astype(jnp.int32), axis_name
        ) > 0,
        "range_fail": range_fail,
    }
    return new_state, out_stats


def _state_specs(axis_name: str) -> ShardedHashState:
    return ShardedHashState(
        P(axis_name), P(axis_name), P(axis_name), P(axis_name),
        P(axis_name), P(axis_name),
    )


def make_sharded_ping_step(
    mesh: Mesh,
    tables: FanTables,
    cfg: MapperConfig,
    dtype=jnp.float32,
    axis_name: str = "space",
    unique_budget: int = None,
):
    """Build the jitted sharded single-ping step:
    (state, image, T, frame_active) -> (state, stats)."""
    if unique_budget is None:
        from sonar_3d_reconstruction_tpu.grid.hash import default_unique_budget

        unique_budget = default_unique_budget(
            tables.candidates_per_ping(cfg.occupied_window)
        )

    update = shard_map(
        partial(
            _local_update,
            cfg=cfg,
            axis_name=axis_name,
            unique_budget=unique_budget,
        ),
        mesh=mesh,
        in_specs=(_state_specs(axis_name), P(), P(), P(), P(), P()),
        out_specs=(
            _state_specs(axis_name),
            {
                "num_occupied": P(),
                "num_free": P(),
                "num_candidates": P(),
                "overflowed": P(),
                "unique_overflow": P(),
                "range_fail": P(),
            },
        ),
        check_vma=False,
    )

    @jax.jit
    def step(state: ShardedHashState, image, T, frame_active):
        cand = backproject_ping(image, T, tables, cfg, dtype=dtype)
        # within-ping data parallelism: GSPMD splits the candidate tensor
        # over the mesh; the shard_map boundary all-gathers the packed
        # stream for ownership filtering (one all-gather per ping).
        pts = jax.lax.with_sharding_constraint(
            cand["points"], NamedSharding(mesh, P(axis_name))
        )
        keys = voxel_keys(pts, cfg.voxel_resolution)
        hi, lo, in_range = pack_keys(keys)
        valid = cand["valid"] & frame_active
        range_fail = jnp.any(valid & ~in_range)
        valid = valid & in_range
        return update(state, hi, lo, cand["is_occupied"], valid, range_fail)

    return step


def sharded_ping_step(
    state: ShardedHashState,
    image: jnp.ndarray,
    T: jnp.ndarray,
    mesh: Mesh,
    tables: FanTables,
    cfg: MapperConfig,
    dtype=jnp.float32,
):
    """One-shot convenience wrapper (builds + calls the jitted step)."""
    step = make_sharded_ping_step(mesh, tables, cfg, dtype)
    return step(state, image, T, jnp.asarray(True))


def make_scan_pings_sharded(
    mesh: Mesh,
    tables: FanTables,
    cfg: MapperConfig,
    dtype=jnp.float32,
    axis_name: str = "space",
    unique_budget: int = None,
):
    """Build the sharded sequence runner:
    (state, images (P,R,B), transforms (P,4,4), start) -> (state, stats).
    Frames with index < start are no-ops (growth replay, see pipeline.py).

    Host-driven step chain (see the design note in pipeline.py)."""
    step = make_sharded_ping_step(
        mesh, tables, cfg, dtype, axis_name, unique_budget
    )

    @jax.jit
    def indexed_step(state, images, transforms, idx, start):
        image = jax.lax.dynamic_index_in_dim(images, idx, 0, keepdims=False)
        T = jax.lax.dynamic_index_in_dim(transforms, idx, 0, keepdims=False)
        return step(state, image, T, idx >= start)

    def run(state, images, transforms, start):
        P_ = images.shape[0]
        images = jnp.asarray(images)
        transforms = jnp.asarray(transforms, dtype)
        start = jnp.asarray(start, jnp.int32)
        per_step = []
        for i in range(P_):
            state, stats = indexed_step(
                state, images, transforms, jnp.int32(i), start
            )
            per_step.append(stats)
        stacked = {
            k: jnp.stack([s[k] for s in per_step])
            for k in (per_step[0] if per_step else {})
        }
        return state, stacked

    return run


def scan_pings_sharded(state, images, transforms, mesh, tables, cfg,
                       dtype=jnp.float32):
    """One-shot convenience wrapper over make_scan_pings_sharded."""
    scan = make_scan_pings_sharded(mesh, tables, cfg, dtype)
    return scan(state, images, transforms, jnp.int32(0))


# ---------------------------------------------------------------------------
# Sharded batched-apply window engine (sharded counterpart of
# pipeline.scan_pings_hash window>1 / grid/hash.apply_records_batched)
# ---------------------------------------------------------------------------

import functools


@functools.lru_cache(maxsize=32)
def make_window_scan_sharded(
    mesh: Mesh,
    tables: FanTables,
    cfg: MapperConfig,
    dtype=jnp.float32,
    axis_name: str = "space",
    unique_budget: Optional[int] = None,
    window: int = 8,
    batch_budget: Optional[int] = None,
    lane_budget: Optional[int] = None,
    insert_budget: Optional[int] = None,
):
    """Build the sharded window-engine sequence runner:
    (state, images (P,R,B), transforms (P,4,4), start) -> (state, stats).

    Per window, each shard computes records for its OWNED candidates of
    every frame (one lax.map), then applies the whole window to its local
    sub-table with ONE set of table operations (apply_records_batched with
    the same rank-stepped chain evaluation as single-chip — exact sequential
    semantics, since every voxel's whole chain lives on its owner shard).
    A batch that overflows on ANY shard is rejected on EVERY shard (the
    failure flag is psum-reduced before any write), so grow+replay matches
    the single-chip window engine bit-for-bit.

    ``lane_budget`` / ``insert_budget`` are PER-SHARD static values;
    ``insert_budget`` also accepts a [cold, warm, ...] TUPLE exactly like
    scan_pings_hash — one window program is compiled per distinct value
    (window 0 uses the first, later windows the last), so a fresh sharded
    map can run a generous cold first-window insert plan and a snug warm
    one after, matching the single-chip engine's measured-budget
    configuration.  The per-shard requirement for snug sizing is reported
    in ``batch_n_need_max`` / ``batch_n_unique_max`` (per-shard maxima —
    the psum'd ``batch_n_need`` is the global sum, which over-sizes a
    per-shard budget by ~S).

    Backprojection runs replicated inside the shard body (each shard
    re-derives the candidate stream rather than all-gathering an 80 MB
    window of candidates; it is a small fraction of the step).
    """
    from sonar_3d_reconstruction_tpu.grid.hash import (
        apply_records_batched,
        default_batch_budget,
        default_unique_budget,
    )
    from sonar_3d_reconstruction_tpu.ops.records import FrameAux

    if unique_budget is None:
        unique_budget = default_unique_budget(
            tables.candidates_per_ping(cfg.occupied_window)
        )
    if batch_budget is None:
        batch_budget = default_batch_budget(window, unique_budget)
    # normalize insert_budget to a tuple of per-window-position values; one
    # compiled window program per DISTINCT value (cold + warm = two)
    if insert_budget is None or isinstance(insert_budget, int):
        insert_schedule = (insert_budget,)
    else:
        insert_schedule = tuple(insert_budget)

    def local_window(state_blk, images, transforms, w_start, start, stop,
                     *, window_insert_budget):
        my = jax.lax.axis_index(axis_name)
        S = jax.lax.axis_size(axis_name)

        def frame(i):
            idx = w_start + i
            image = jax.lax.dynamic_index_in_dim(images, idx, 0, keepdims=False)
            T = jax.lax.dynamic_index_in_dim(
                transforms, idx, 0, keepdims=False
            )
            frame_on = (idx >= start) & (idx < stop)
            cand = backproject_ping(image, T, tables, cfg, dtype=dtype)
            keys = voxel_keys(cand["points"], cfg.voxel_resolution)
            hi, lo, in_range = pack_keys(keys)
            valid = cand["valid"] & frame_on
            range_fail = jnp.any(valid & ~in_range)
            valid = valid & in_range
            active = valid & (owner_shard(hi, lo, S) == my)
            rec = dedup_frame(
                hi, lo, cand["is_occupied"], active, unique_budget
            )
            cmin, cmax = _frame_bounds(hi, lo, valid, cfg, dtype)
            aux = FrameAux(
                cmin=cmin, cmax=cmax, range_fail=range_fail,
                n_valid=jnp.sum(active).astype(jnp.int32),
            )
            return rec, aux

        recs, auxs = jax.lax.map(frame, jnp.arange(window, dtype=jnp.int32))
        local = HashGridState(
            key_rows=state_blk.key_rows[0],
            log_odds=state_blk.log_odds[0],
            min_bounds=state_blk.min_bounds[0],
            max_bounds=state_blk.max_bounds[0],
            used=state_blk.used[0],
            poisoned=state_blk.poisoned[0],
        )
        new_local, stats = apply_records_batched(
            local, recs, auxs, cfg, batch_budget=batch_budget,
            lane_budget=lane_budget, insert_budget=window_insert_budget,
            fail_reduce=lambda f: jax.lax.psum(
                f.astype(jnp.int32), axis_name
            ) > 0,
        )
        stats = dict(stats)
        # per-shard maxima FIRST (hosts size per-shard snug budgets from
        # these; the psums below overwrite the keys with global sums)
        stats["batch_n_unique_max"] = jax.lax.pmax(
            stats["batch_n_unique"], axis_name
        )
        stats["batch_n_need_max"] = jax.lax.pmax(
            stats["batch_n_need"], axis_name
        )
        for k in ("num_occupied", "num_free", "num_candidates"):
            stats[k] = jax.lax.psum(stats[k], axis_name)
        for k in ("unique_overflow", "batch_overflow", "insert_overflow"):
            stats[k] = jax.lax.psum(stats[k].astype(jnp.int32), axis_name) > 0
        # owner-partitioned shards hold disjoint voxels: the global window
        # unique / required-insert counts are sums of the per-shard ones
        for k in ("batch_n_unique", "batch_n_need"):
            stats[k] = jax.lax.psum(stats[k], axis_name)
        new_blk = ShardedHashState(
            key_rows=new_local.key_rows[None],
            log_odds=new_local.log_odds[None],
            min_bounds=new_local.min_bounds[None],
            max_bounds=new_local.max_bounds[None],
            used=new_local.used[None],
            poisoned=new_local.poisoned[None],
        )
        return new_blk, stats

    stats_specs = {
        "num_occupied": P(), "num_free": P(), "num_candidates": P(),
        "overflowed": P(), "unique_overflow": P(), "batch_overflow": P(),
        "insert_overflow": P(), "batch_n_unique": P(), "batch_n_need": P(),
        "batch_n_unique_max": P(), "batch_n_need_max": P(),
        "range_fail": P(),
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


def map_ping_sequence_sharded(
    images: np.ndarray,
    positions: np.ndarray,
    quaternions: np.ndarray,
    cfg: Optional[MapperConfig] = None,
    *,
    mesh: Optional[Mesh] = None,
    local_capacity: int = 1 << 17,
    state: Optional[ShardedHashState] = None,
    dtype=jnp.float32,
    axis_name: str = "space",
    window: int = 1,
    unique_budget: Optional[int] = None,
    batch_budget: Optional[int] = None,
    lane_budget: Optional[int] = None,
    insert_budget=None,
    max_grow_retries: int = 12,
    fan_cap="auto",
    window_cap="auto",
    free_cap="auto",
) -> Tuple[ShardedHashState, Dict[str, np.ndarray]]:
    """Sharded equivalent of pipeline.map_ping_sequence: map a whole ping
    sequence over the mesh with grow+replay-from-first-failure and the same
    cause attribution (unique budget vs batch/lane budget vs insert budget
    vs capacity vs key range).  ``batch_budget``/``lane_budget`` are
    PER-SHARD statics; ``insert_budget`` accepts an int or a [cold, warm]
    schedule (see make_window_scan_sharded) — all forwarded to the window
    engine so a sharded deployment can run the single-chip engine's
    measured snug-budget configuration.  Returns (final sharded state,
    per-ping stats arrays)."""
    from sonar_3d_reconstruction_tpu.grid.hash import (
        default_batch_budget,
        default_unique_budget,
    )
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
        else init_sharded_hash_grid(mesh, local_capacity, dtype)
    )
    if P_ == 0:
        return st, {}
    window = min(window, P_)
    if isinstance(insert_budget, list):
        insert_budget = tuple(insert_budget)  # lru_cache key must hash
    merged: Dict[str, np.ndarray] = {}
    start = 0
    for _ in range(max_grow_retries):
        if window > 1:
            scan = make_window_scan_sharded(
                mesh, tables, cfg, dtype, axis_name, unique_budget,
                window, batch_budget, lane_budget, insert_budget,
            )
        else:
            scan = make_scan_pings_sharded(
                mesh, tables, cfg, dtype, axis_name, unique_budget
            )
        new_st, stats = scan(st, images_dev, T_dev, jnp.int32(start))
        over = np.asarray(stats["overflowed"])
        applied_hi = P_ if not over.any() else int(np.argmax(over))
        for k, v in stats.items():
            arr = merged.setdefault(k, np.zeros((P_,), np.asarray(v).dtype))
            arr[start:applied_hi] = np.asarray(v)[start:applied_hi]
        if not over.any():
            return new_st, merged
        start = applied_hi
        tail = slice(applied_hi, None)
        if bool(np.asarray(stats["range_fail"])[tail].any()):
            raise ValueError(
                f"frame >= {applied_hi}: voxel keys outside the packable "
                "±2^19-cell range — check odometry frame offsets; growing "
                "the table cannot fix this"
            )
        if bool(np.asarray(stats["unique_overflow"])[tail].any()):
            unique_budget = 2 * (
                unique_budget
                or default_unique_budget(
                    tables.candidates_per_ping(cfg.occupied_window)
                )
            )
            batch_budget = None
            st = new_st._replace(
                poisoned=jnp.zeros_like(new_st.poisoned)
            )
        elif "insert_overflow" in stats and bool(
            np.asarray(stats["insert_overflow"])[tail].any()
        ):
            # a snug insert schedule proved too tight: double every entry
            # (recompiles only the affected window programs)
            if isinstance(insert_budget, tuple):
                insert_budget = tuple(2 * b for b in insert_budget)
            elif insert_budget is not None:
                insert_budget = 2 * insert_budget
            else:  # cannot happen with insert_budget=None (plan unbudgeted)
                insert_budget = None
            st = new_st._replace(
                poisoned=jnp.zeros_like(new_st.poisoned)
            )
        elif "batch_overflow" in stats and bool(
            np.asarray(stats["batch_overflow"])[tail].any()
        ):
            ub = unique_budget or default_unique_budget(
                tables.candidates_per_ping(cfg.occupied_window)
            )
            batch_budget = 2 * (
                batch_budget or default_batch_budget(window, ub)
            )
            st = new_st._replace(
                poisoned=jnp.zeros_like(new_st.poisoned)
            )
        else:
            st = rehash_sharded(
                new_st, mesh, new_st.local_capacity * 2, axis_name
            )
    raise RuntimeError(
        f"sharded growth did not converge after {max_grow_retries} retries"
    )


def rehash_sharded(
    state: ShardedHashState, mesh: Mesh, new_local_capacity: int,
    axis_name: str = "space",
) -> ShardedHashState:
    """Host-triggered grow of every per-shard sub-table (the sharded
    equivalent of grid/hash.rehash): re-bucket each shard's entries into a
    larger local table — ownership is a function of the key, so entries
    never move between shards — and clear ``poisoned`` so the failed frame
    can be replayed.  Doubles again until every bucket fits."""
    from sonar_3d_reconstruction_tpu.grid.hash import bucket_lookup, insert_unique

    while True:
        def grow_block(blk):
            hi, lo = blk.key_hi[0], blk.key_lo[0]
            lod = blk.log_odds[0]
            occupied = hi != EMPTY_HI
            fresh = empty_key_rows(new_local_capacity)
            bucket, found, _, fill = bucket_lookup(fresh, hi, lo)
            nrows, slots, overflowed, n_ins = insert_unique(
                fresh, hi, lo, occupied & ~found, bucket, fill
            )
            nlod = jnp.zeros((new_local_capacity,), lod.dtype).at[slots].set(
                lod, mode="drop"
            )
            any_ovf = jax.lax.psum(overflowed.astype(jnp.int32), axis_name) > 0
            return (
                ShardedHashState(
                    key_rows=nrows[None],
                    log_odds=nlod[None],
                    min_bounds=blk.min_bounds,
                    max_bounds=blk.max_bounds,
                    used=n_ins[None],
                    poisoned=jnp.zeros((1,), bool),
                ),
                any_ovf,
            )

        grown, overflowed = jax.jit(
            shard_map(
                grow_block,
                mesh=mesh,
                in_specs=(_state_specs(axis_name),),
                out_specs=(_state_specs(axis_name), P()),
                check_vma=False,
            )
        )(state)
        if not bool(overflowed):
            return grown
        new_local_capacity *= 2


def gather_sharded_state(state: ShardedHashState):
    """Pull the sharded table to host as flat (keys (S*C,3), log_odds (S*C,))
    for extraction / checkpointing."""
    keys = np.asarray(state.keys).reshape(-1, 3)
    lo = np.asarray(state.log_odds).reshape(-1)
    return keys, lo


def sharded_bounds(state: ShardedHashState) -> Tuple[np.ndarray, np.ndarray]:
    """Global updated-voxel-center bounds (min, max) — replicated across
    shards, so shard 0's copy IS the answer (reference 3d_mapper.py:112-115)."""
    return (
        np.asarray(state.min_bounds[0]),
        np.asarray(state.max_bounds[0]),
    )
