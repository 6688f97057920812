"""Hashed sparse voxel grid — bucketized, packed-key, sort-dedup update path.

The accelerator-native replacement for the reference's dict-based "SimpleOctree"
(scripts/3d_mapper.py:19-194): a device-resident open hash table over packed
voxel codes, updated per frame from sort-deduplicated unique records
(ops/dedup.py) so that every per-key table operation runs on U ~ 10^4-10^5
unique voxels instead of N ~ 10^6 raw candidate emissions: indexed ops are
paid per index, while sorts, scans and elementwise ops stream.

Table layout: capacity C slots = C/128 buckets of 128 slots; keys stored
INTERLEAVED as one (C/128, 256) uint32 array — row r holds bucket r's 128 hi
words then its 128 lo words (ops/packing.py packing).  Buckets fill
left-to-right and entries are never removed, so a bucket's occupancy is a
prefix — "first empty slot" is just its fill count.

The 128-slot bucket is a LAYOUT decision: with 256 = 2*128 u32 words per
row, a bucket is one contiguous 1 KiB row, the flat view used by the
insert scatter is a free bitcast, and per-key compare work (2*256 lanes)
is noise next to the gather.

  * LOOKUP is ONE 256-wide row gather + elementwise compares — no probe
    loop at all.  The wide bucket costs the same number of indexed ops as
    a narrow one.
  * INSERT is collision-free by construction: new unique keys are sorted by
    bucket, ranked within equal buckets (running-max scan), and written at
    slot = bucket*128 + fill + rank in one scatter covering both key words.
  * A bucket asked to exceed 128 entries fails the frame atomically (the
    ``poisoned`` flag) and the host grows capacity and replays — with the
    load factor kept <= 0.25 (models/mapper.py), 128-deep bucket overflow
    is a practically-never event (Poisson tail at mean 32).

Per-frame update semantics are EXACTLY the reference's averaged adaptive
log-odds update (3d_mapper.py:523-567): per-voxel aggregates (count, n_occ)
come from the dedup pass; sum = n_occ*log_odds_occupied +
(count-n_occ)*log_odds_free reconstructs the reference's accumulated sum
because within a frame every emission carries one of those two constants;
occupied-priority typing is n_occ > 0.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from sonar_3d_reconstruction_tpu.config import MapperConfig
from sonar_3d_reconstruction_tpu.ops.dedup import (
    UniqueRecords,
    dedup_frame,
    running_max as _running_max,
)
from sonar_3d_reconstruction_tpu.ops.logodds import finalize_voxel_updates
from sonar_3d_reconstruction_tpu.ops.packing import (
    EMPTY_HI,
    mix2,
    pack_keys,
    unpack_keys,
)

# Slots per bucket (one row gather resolves a whole bucket; see the module
# docstring for the layout).
BUCKET_SLOTS = 128

# Legacy unpacked-view marker: rows of the ``keys`` property for empty slots.
EMPTY = np.int32(0x7FFFFFFF)

# Default static budget of unique voxels per frame (grown on overflow).
# Every per-key table op costs ~proportional to this; full-size 500x512
# pings emit ~50-75k unique voxels at 5 cm resolution.
DEFAULT_UNIQUE_BUDGET = 1 << 17


class HashGridState(NamedTuple):
    """Map state pytree. Capacity C is static per jitted program."""

    key_rows: jnp.ndarray   # (C/128, 256) uint32: [hi x128 | lo x128]/bucket
    log_odds: jnp.ndarray   # (C,) dtype
    min_bounds: jnp.ndarray  # (3,)
    max_bounds: jnp.ndarray  # (3,)
    used: jnp.ndarray       # () int32 occupied slot count
    poisoned: jnp.ndarray   # () bool: a frame failed; later frames skipped

    @property
    def capacity(self) -> int:
        return self.key_rows.shape[0] * BUCKET_SLOTS

    @property
    def key_hi(self) -> jnp.ndarray:
        """(C,) uint32 flat hi words (slot order); EMPTY_HI = free slot."""
        return self.key_rows[:, :BUCKET_SLOTS].reshape(-1)

    @property
    def key_lo(self) -> jnp.ndarray:
        """(C,) uint32 flat lo words (slot order)."""
        return self.key_rows[:, BUCKET_SLOTS:].reshape(-1)

    @property
    def keys(self) -> jnp.ndarray:
        """(C, 3) int32 unpacked view; empty slots read as [EMPTY]*3."""
        hi, lo = self.key_hi, self.key_lo
        k = unpack_keys(hi, lo)
        return jnp.where((hi == EMPTY_HI)[:, None], EMPTY, k)


def empty_key_rows(capacity: int) -> jnp.ndarray:
    assert capacity & (capacity - 1) == 0, "capacity must be a power of two"
    assert capacity >= BUCKET_SLOTS
    return jnp.full(
        (capacity // BUCKET_SLOTS, 2 * BUCKET_SLOTS), EMPTY_HI, jnp.uint32
    )


def init_hash_grid(capacity: int = 1 << 20, dtype=jnp.float32) -> HashGridState:
    big = jnp.asarray(jnp.inf, dtype)
    return HashGridState(
        key_rows=empty_key_rows(capacity),
        log_odds=jnp.zeros((capacity,), dtype),
        min_bounds=jnp.full((3,), big, dtype),
        max_bounds=jnp.full((3,), -big, dtype),
        used=jnp.zeros((), jnp.int32),
        poisoned=jnp.zeros((), bool),
    )


def voxel_keys(points: jnp.ndarray, resolution: float) -> jnp.ndarray:
    """floor(world / resolution) integer keys (reference 3d_mapper.py:63-66)."""
    return jnp.floor(points / resolution).astype(jnp.int32)


def bucket_lookup(
    key_rows: jnp.ndarray,
    u_hi: jnp.ndarray,
    u_lo: jnp.ndarray,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Resolve keys against the table in ONE 256-wide bucket-row gather.

    Returns (bucket (U,), found (U,), found_slot (U,), fill (U,)) where
    ``fill`` is the bucket's current entry count (= its first empty
    position, by the prefix-fill invariant).
    """
    n_buckets = key_rows.shape[0]
    bucket = (mix2(u_hi, u_lo) & jnp.uint32(n_buckets - 1)).astype(jnp.int32)
    rows = key_rows[bucket]                       # (U, 16)
    rows_hi = rows[:, :BUCKET_SLOTS]
    rows_lo = rows[:, BUCKET_SLOTS:]
    eq = (rows_hi == u_hi[:, None]) & (rows_lo == u_lo[:, None])
    found = jnp.any(eq, axis=1)
    found_slot = bucket * BUCKET_SLOTS + jnp.argmax(eq, axis=1).astype(jnp.int32)
    fill = jnp.sum(rows_hi != EMPTY_HI, axis=1).astype(jnp.int32)
    return bucket, found, found_slot, fill


class InsertPlan(NamedTuple):
    """Collision-free insert plan (see ``plan_insert``): everything needed
    to commit the writes, or to abort them without touching the table."""

    s_hi: jnp.ndarray      # (Ib,) key words in bucket-sorted order
    s_lo: jnp.ndarray
    s_bkt: jnp.ndarray     # (Ib,) uint32 bucket (0xFFFFFFFF = inactive)
    pos_c: jnp.ndarray     # (Ib,) int32 in-bucket position (clamped)
    fits: jnp.ndarray      # (Ib,) bool key is active and fits its bucket
    slots: jnp.ndarray     # (U,) int32 slots in RECORD order (capacity = none)
    overflowed: jnp.ndarray  # () bool a bucket would exceed BUCKET_SLOTS, or
    #                             the insert budget Ib was exceeded
    n_inserted: jnp.ndarray  # () int32
    n_need: jnp.ndarray      # () int32 keys that REQUIRED insertion (host
    #                             signal for sizing snug insert budgets)
    budget_overflow: jnp.ndarray  # () bool n_need exceeded the plan budget
    #                             (also folded into ``overflowed``)


def plan_insert(
    key_rows: jnp.ndarray,
    u_hi: jnp.ndarray,
    u_lo: jnp.ndarray,
    need: jnp.ndarray,
    bucket: jnp.ndarray,
    fill: jnp.ndarray,
    budget: Optional[int] = None,
) -> InsertPlan:
    """Plan a collision-free insert of mutually-distinct new keys.

    Keys flagged by ``need`` (unique among themselves and absent from the
    table) are sorted by bucket and ranked within equal buckets; key i's
    slot is bucket*128 + fill + rank.  No table writes happen here — commit
    with ``commit_insert`` (which can abort on a failure flag computed
    between the two, e.g. a cross-shard any-overflow reduction).

    ``budget`` (static, optional) slices the plan to its need-prefix: the
    bucket sort keys inactive lanes to the end, so all needed keys occupy a
    contiguous prefix and every commit-side indexed op (the slot unsort
    scatter here, both key-word scatters in ``commit_insert``) runs at Ib
    lanes instead of U.  On a warmed map the per-window insert count is a
    small fraction of its unique count, so a host-measured snug budget
    removes most of the insert cost; exceeding it sets ``overflowed``
    (all-or-nothing — callers already reject and regrow on that flag)."""
    u = u_hi.shape[0]
    Ib = u if budget is None else min(int(budget), u)
    capacity = key_rows.shape[0] * BUCKET_SLOTS
    maxu = jnp.uint32(0xFFFFFFFF)
    idx = jnp.arange(Ib, dtype=jnp.int32)

    ins_key = jnp.where(need, bucket.astype(jnp.uint32), maxu)
    s_bkt, s_hi, s_lo, s_fill, s_orig = jax.lax.sort(
        (ins_key, u_hi, u_lo, fill, jnp.arange(u, dtype=jnp.int32)),
        num_keys=1,
    )
    n_need = jnp.sum(need).astype(jnp.int32)
    budget_overflow = n_need > Ib
    s_bkt, s_hi, s_lo, s_fill, s_orig = (
        s_bkt[:Ib], s_hi[:Ib], s_lo[:Ib], s_fill[:Ib], s_orig[:Ib]
    )
    new_b = jnp.concatenate([jnp.ones((1,), bool), s_bkt[1:] != s_bkt[:-1]])
    start = _running_max(jnp.where(new_b, idx, -1))
    rank = idx - start
    active = s_bkt != maxu
    pos = s_fill + rank
    fits = active & (pos < BUCKET_SLOTS)
    overflowed = jnp.any(active & ~fits) | budget_overflow
    pos_c = jnp.minimum(pos, BUCKET_SLOTS - 1)
    slot = s_bkt.astype(jnp.int32) * BUCKET_SLOTS + pos_c
    # slots back in record order (dump lanes untouched -> capacity)
    slots = jnp.full((u,), capacity, jnp.int32).at[
        jnp.where(fits, s_orig, u)
    ].set(slot, mode="drop")
    n_inserted = jnp.sum(fits).astype(jnp.int32)
    return InsertPlan(
        s_hi=s_hi, s_lo=s_lo, s_bkt=s_bkt, pos_c=pos_c, fits=fits,
        slots=slots, overflowed=overflowed, n_inserted=n_inserted,
        n_need=n_need, budget_overflow=budget_overflow,
    )


def commit_insert(
    key_rows: jnp.ndarray, plan: InsertPlan, abort=None
) -> jnp.ndarray:
    """Write a planned insert's key words (both in ONE scatter into the
    interleaved rows — the flat view of the tile-aligned (C/128, 256) array
    is a free bitcast).  ``abort`` (scalar bool) turns every write into a
    dropped out-of-range scatter, leaving the table bit-identical — the
    all-or-nothing path with no whole-table select/copy."""
    n_buckets = key_rows.shape[0]
    flat_n = n_buckets * 2 * BUCKET_SLOTS
    write = plan.fits if abort is None else (plan.fits & ~abort)
    base = plan.s_bkt.astype(jnp.int32) * (2 * BUCKET_SLOTS) + plan.pos_c
    tgt_hi = jnp.where(write, base, flat_n)
    tgt_lo = jnp.where(write, base + BUCKET_SLOTS, flat_n)
    flat = key_rows.reshape(-1).at[
        jnp.concatenate([tgt_hi, tgt_lo])
    ].set(jnp.concatenate([plan.s_hi, plan.s_lo]), mode="drop")
    return flat.reshape(n_buckets, 2 * BUCKET_SLOTS)


def insert_unique(
    key_rows: jnp.ndarray,
    u_hi: jnp.ndarray,
    u_lo: jnp.ndarray,
    need: jnp.ndarray,
    bucket: jnp.ndarray,
    fill: jnp.ndarray,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """plan_insert + commit_insert in one call (keys that fit are written
    even when other buckets overflow — callers reject the frame as a whole
    via the ``overflowed`` flag).  Returns (key_rows, slots, overflowed,
    n_inserted)."""
    plan = plan_insert(key_rows, u_hi, u_lo, need, bucket, fill)
    return (
        commit_insert(key_rows, plan),
        plan.slots,
        plan.overflowed,
        plan.n_inserted,
    )


def apply_unique_records(
    state: HashGridState, rec: UniqueRecords, cfg: MapperConfig
) -> Tuple[HashGridState, Dict[str, jnp.ndarray], jnp.ndarray]:
    """Lookup/insert the frame's unique records and apply the averaged
    adaptive log-odds update.  Returns (applied_state, partial stats,
    overflowed) — caller handles poisoning/bounds."""
    capacity = state.capacity
    dtype = state.log_odds.dtype

    bucket, found, found_slot, fill = bucket_lookup(
        state.key_rows, rec.hi, rec.lo
    )
    need = rec.valid & ~found
    key_rows, new_slots, ins_overflow, n_inserted = insert_unique(
        state.key_rows, rec.hi, rec.lo, need, bucket, fill
    )
    slots = jnp.where(found, found_slot, new_slots)
    slots = jnp.where(rec.valid, slots, capacity)

    count = rec.count.astype(dtype)
    n_occ = rec.n_occ.astype(dtype)
    lo_sum = n_occ * cfg.log_odds_occupied + (count - n_occ) * cfg.log_odds_free
    occupied = rec.n_occ > 0  # occupied-priority typing (reference :544-545)

    cur = state.log_odds[jnp.minimum(slots, capacity - 1)]
    new_val = finalize_voxel_updates(cur, lo_sum, count, occupied, cfg)
    new_lo = state.log_odds.at[slots].set(
        jnp.where(rec.valid, new_val, 0), mode="drop"
    )

    overflowed = jnp.logical_or(rec.overflowed, ins_overflow)
    applied = state._replace(
        key_rows=key_rows,
        log_odds=new_lo,
        used=state.used + n_inserted,
    )
    stats = {
        "num_occupied": jnp.sum(rec.valid & occupied).astype(jnp.int32),
        "num_free": jnp.sum(rec.valid & ~occupied).astype(jnp.int32),
    }
    return applied, stats, overflowed


def default_batch_budget(window: int, unique_budget: int) -> int:
    """Snug cross-window unique budget.  Consecutive pings overlap heavily,
    so a small multiple of one frame's budget covers a window: measured on
    the 64-ping bench survey, the worst 8-ping window's distinct voxels
    exceed 2x the per-frame budget (the yaw sweep keeps exposing new cells)
    but every window fits in 3x.  Hosts double it on ``batch_overflow`` —
    each growth recompiles the apply program, so the default carries real
    headroom."""
    return min(window * unique_budget, 3 * unique_budget)


def default_unique_budget(n_candidates: int) -> int:
    """Snug static unique budget for a ping with n candidate lanes."""
    budget = 1 << max(
        3, min(n_candidates - 1, DEFAULT_UNIQUE_BUDGET - 1)
    ).bit_length()
    return min(budget, DEFAULT_UNIQUE_BUDGET)


def effective_unique_budget(tables, cfg: MapperConfig) -> int:
    """The unique budget a host-driven engine is effectively running with
    when none was given explicitly — the single implementation every
    grow-from-effective-value path doubles from (stream.py, pipeline.py,
    models/mapper.py; growing from the global DEFAULT over-allocates by up
    to 32x on small geometries)."""
    return default_unique_budget(
        tables.candidates_per_ping(cfg.occupied_window)
    )


def apply_frame_records(
    state: HashGridState,
    rec,   # ops.dedup.UniqueRecords
    aux,   # ops.records.FrameAux
    cfg: MapperConfig,
) -> Tuple[HashGridState, Dict[str, jnp.ndarray]]:
    """One frame's records -> map state transition (the sequential half of
    the update; records come from ops.records.frame_records).  Pure; applies
    the same poison-on-failure contract as update_hash_grid."""
    applied, stats, overflowed = apply_unique_records(state, rec, cfg)
    applied = applied._replace(
        min_bounds=jnp.minimum(state.min_bounds, aux.cmin),
        max_bounds=jnp.maximum(state.max_bounds, aux.cmax),
    )
    failed = overflowed | aux.range_fail | state.poisoned
    poisoned_state = state._replace(poisoned=jnp.ones((), bool))
    new_state = jax.tree_util.tree_map(
        lambda a, b: jnp.where(failed, a, b), poisoned_state, applied
    )
    zero = jnp.zeros((), jnp.int32)
    out = {
        "num_occupied": jnp.where(failed, zero, stats["num_occupied"]),
        "num_free": jnp.where(failed, zero, stats["num_free"]),
        "num_candidates": jnp.where(failed, zero, aux.n_valid),
        "overflowed": failed,
        "unique_overflow": rec.overflowed,
        # distinguished so hosts do NOT respond to unpackable keys by
        # growing the table (growth cannot fix a >±26 km world offset)
        "range_fail": aux.range_fail,
    }
    return new_state, out


def update_hash_grid(
    state: HashGridState,
    candidates: Dict[str, jnp.ndarray],
    cfg: MapperConfig,
    unique_budget: Optional[int] = None,
) -> Tuple[HashGridState, Dict[str, jnp.ndarray]]:
    """Apply one ping's candidate emissions to the hashed map. Pure function.

    ``candidates`` is the dict produced by ops.backproject.backproject_ping.
    If the frame overflows (unique budget, a bucket, or the key range) — or
    the state is already poisoned — the input state is returned unchanged
    with ``poisoned`` set, so a host driver can grow and replay (or, on
    ``range_fail``, abort: growth cannot fix an unpackable world offset).
    """
    from sonar_3d_reconstruction_tpu.ops.records import FrameAux

    dtype = state.log_odds.dtype
    pts = candidates["points"]
    occ = candidates["is_occupied"]
    valid = candidates["valid"]
    n = pts.shape[0]
    if unique_budget is None:
        unique_budget = default_unique_budget(n)

    keys = voxel_keys(pts, cfg.voxel_resolution)
    hi, lo, in_range = pack_keys(keys)
    range_fail = jnp.any(valid & ~in_range)
    valid = valid & in_range

    rec = dedup_frame(hi, lo, occ, valid, unique_budget)
    # bounds over updated voxel CENTERS (reference 3d_mapper.py:112-115, :560)
    centers = (keys.astype(dtype) + 0.5) * cfg.voxel_resolution
    inf = jnp.asarray(jnp.inf, dtype)
    aux = FrameAux(
        cmin=jnp.min(jnp.where(valid[:, None], centers, inf), axis=0),
        cmax=jnp.max(jnp.where(valid[:, None], centers, -inf), axis=0),
        range_fail=range_fail,
        n_valid=jnp.sum(valid).astype(jnp.int32),
    )
    return apply_frame_records(state, rec, aux, cfg)


def apply_records_batched(
    state: HashGridState,
    recs,   # ops.dedup.UniqueRecords stacked over B frames (leading axis B)
    auxs,   # ops.records.FrameAux stacked over B frames
    cfg: MapperConfig,
    batch_budget: Optional[int] = None,
    lane_budget: Optional[int] = None,
    insert_budget: Optional[int] = None,
    fail_reduce=None,
) -> Tuple[HashGridState, Dict[str, jnp.ndarray]]:
    """Apply a window of B frames with ONE set of table operations.

    ``lane_budget`` (default 2*batch_budget) bounds the per-(voxel, frame)
    record lanes carried into chain evaluation — it must cover the window's
    summed per-frame unique records, while ``batch_budget`` only covers its
    DISTINCT voxels.  Decoupling them lets hosts with measured statistics
    run the expensive per-unique table ops at a much tighter width than the
    lane prefix (both overflows reject the batch and report through
    ``batch_overflow``).

    ``insert_budget`` (default batch_budget) bounds the NEW keys a window
    may insert; see ``plan_insert`` — on a warmed map inserts are a small
    fraction of uniques, and the three insert-side scatters run at this
    width.  Exceeding it rejects the batch (``insert_overflow`` stat tells
    the host to grow just this budget); ``batch_n_need`` reports the
    measured requirement for snug sizing.

    ``fail_reduce`` (optional) maps the local () bool failure flag to the
    EFFECTIVE one before any select — the sharded engine passes a psum so a
    batch rejected on one shard is rejected on every shard atomically.

    The map is touched once per batch instead of once per frame: all B*U
    records sort by (voxel, frame), per-voxel update chains (at most B long,
    consecutive lanes after the sort) are evaluated with B-1 rank-stepped
    elementwise passes — exactly the sequential adaptive/clamped update the
    reference applies frame by frame — and only the final per-voxel values
    scatter into the table.

    All-or-nothing: any overflow (batch unique budget, lane budget, bucket,
    key range, or an already-poisoned state) rejects the WHOLE batch
    (``overflowed`` true for every frame) so the host can grow / fall back
    to per-frame apply; per-frame semantics are preserved because rejection
    turns every table write into a dropped out-of-range scatter — the table
    arrays come back bit-identical with NO whole-table select/copy.
    """
    B, U = recs.hi.shape
    capacity = state.capacity
    dtype = state.log_odds.dtype
    if batch_budget is None:
        batch_budget = default_batch_budget(B, U)
    n = B * U
    # Per-(voxel,frame) record lanes carried into chain evaluation: the big
    # sort puts every valid lane in a contiguous prefix, and distinct
    # (voxel,frame) records across a window measure ~2-3x its distinct
    # voxels (consecutive pings overlap), so 2*batch_budget lanes are the
    # default; all per-lane indexed ops then run at Lb lanes instead of B*U.
    Lb = min(n, max(lane_budget or 2 * batch_budget, batch_budget))

    hi = recs.hi.reshape(-1)
    lo = recs.lo.reshape(-1)
    count = recs.count.reshape(-1)
    n_occ = recs.n_occ.reshape(-1)
    # invalid lanes already carry EMPTY_HI keys and zero counts (dedup_frame)

    # The flattened lanes are frame-major and lax.sort is stable, so equal
    # keys keep ascending frame order WITHOUT carrying a frame payload —
    # one fewer 983k-lane sort array, and per-frame stats come straight
    # from the stacked records below instead of B x Lb lane masks.
    s_hi, s_lo, s_cnt, s_occ = jax.lax.sort(
        (hi, lo, count, n_occ), num_keys=2
    )
    idx = jnp.arange(n, dtype=jnp.int32)
    new_seg = jnp.concatenate(
        [jnp.ones((1,), bool), (s_hi[1:] != s_hi[:-1]) | (s_lo[1:] != s_lo[:-1])]
    )
    seg_valid = s_hi != EMPTY_HI
    rank = idx - _running_max(jnp.where(new_seg, idx, -1))
    rec_start = new_seg & seg_valid
    n_unique = jnp.sum(rec_start).astype(jnp.int32)
    batch_overflow = n_unique > batch_budget
    n_valid_lanes = jnp.sum(seg_valid).astype(jnp.int32)
    lanes_overflow = n_valid_lanes > Lb

    # slice every per-lane array to the lane budget (valid-prefix property)
    s_cnt, s_occ = s_cnt[:Lb], s_occ[:Lb]
    rank_l = rank[:Lb]

    # compact unique keys (stable sort keeps key order, so compacted lane
    # index == seg_id of the segment); record starts all live in the valid
    # prefix, so the compaction sort also runs at Lb lanes.  The lane
    # position payload records where each unique's segment STARTS — that is
    # what lets the chain seed be a ub-scatter and the result pickup a
    # ub-gather below, instead of Lb-indexed ops (the swap removes
    # 2*(Lb-ub) indexed lanes per window).
    not_rec = (~rec_start[:Lb]).astype(jnp.uint32)
    lane_pos = jnp.arange(Lb, dtype=jnp.int32)
    _, c_hi, c_lo, c_pos = jax.lax.sort(
        (not_rec, s_hi[:Lb], s_lo[:Lb], lane_pos), num_keys=1
    )
    ub = batch_budget

    def take(x, fill):
        if ub <= Lb:
            return x[:ub]
        return jnp.concatenate([x, jnp.full((ub - Lb,), fill, x.dtype)])

    lane = jnp.arange(ub, dtype=jnp.int32)
    valid_u = lane < n_unique
    c_hi = jnp.where(valid_u, take(c_hi, EMPTY_HI), EMPTY_HI)
    c_lo = jnp.where(valid_u, take(c_lo, EMPTY_HI), EMPTY_HI)
    c_pos = jnp.where(valid_u, take(c_pos, 0), Lb)

    bucket, found, found_slot, fill = bucket_lookup(
        state.key_rows, c_hi, c_lo
    )
    need = valid_u & ~found
    plan = plan_insert(
        state.key_rows, c_hi, c_lo, need, bucket, fill,
        budget=insert_budget,
    )
    insert_overflow = plan.budget_overflow

    range_fail = jnp.any(auxs.range_fail)
    # per-frame unique-budget overflow: NOT the .overflowed property (that
    # reads shape[0], which is B on the stacked tree, not the budget U)
    frame_overflow = jnp.any(recs.n_unique > U)
    failed = (
        batch_overflow
        | lanes_overflow
        | plan.overflowed
        | range_fail
        | frame_overflow
        | state.poisoned
    )
    if fail_reduce is not None:
        failed = fail_reduce(failed)

    key_rows = commit_insert(state.key_rows, plan, abort=failed)
    slots = jnp.where(found, found_slot, plan.slots)
    slots = jnp.where(valid_u, slots, capacity)

    # per-lane chain evaluation (on the Lb-lane prefix).  The pre-window
    # table value is only needed at each segment's START lane (rank 0): a
    # rank-s lane's final value comes from its left neighbor at pass s, so
    # the initial v of rank>0 lanes never propagates.  Seeding by scattering
    # the ub current values to the start lanes replaces the former Lb-wide
    # seg_id gather.
    cur_unique = state.log_odds[jnp.minimum(slots, capacity - 1)]
    cur = jnp.zeros((Lb,), dtype).at[c_pos].set(cur_unique, mode="drop")
    cnt_d = s_cnt.astype(dtype)
    occ_d = s_occ.astype(dtype)
    lo_sum = occ_d * cfg.log_odds_occupied + (cnt_d - occ_d) * cfg.log_odds_free
    occupied = s_occ > 0
    v = finalize_voxel_updates(cur, lo_sum, cnt_d, occupied, cfg)
    for s in range(1, B):
        v_prev = jnp.concatenate([v[:1], v[:-1]])
        v_s = finalize_voxel_updates(v_prev, lo_sum, cnt_d, occupied, cfg)
        v = jnp.where(rank_l == s, v_s, v)

    # final per-voxel values live at segment-END lanes; segments appear in
    # compacted (key-sorted) order, so unique k ends where unique k+1 starts
    # (the last one ends at the last valid lane) — a ub-gather instead of
    # the former Lb-wide scatter
    next_start = jnp.concatenate([c_pos[1:], jnp.full((1,), Lb, jnp.int32)])
    end_pos = jnp.where(lane + 1 < n_unique, next_start - 1, n_valid_lanes - 1)
    end_pos = jnp.clip(end_pos, 0, Lb - 1)
    new_unique = jnp.where(valid_u, v[end_pos], 0)
    # failure turns the value scatter into dropped writes too
    w_slots = jnp.where(failed, capacity, slots)
    new_lo = state.log_odds.at[w_slots].set(new_unique, mode="drop")

    zero = jnp.zeros((), jnp.int32)
    new_state = state._replace(
        key_rows=key_rows,
        log_odds=new_lo,
        min_bounds=jnp.where(
            failed,
            state.min_bounds,
            jnp.minimum(
                state.min_bounds, jnp.min(auxs.cmin, axis=0).astype(dtype)
            ),
        ),
        max_bounds=jnp.where(
            failed,
            state.max_bounds,
            jnp.maximum(
                state.max_bounds, jnp.max(auxs.cmax, axis=0).astype(dtype)
            ),
        ),
        used=state.used + jnp.where(failed, zero, plan.n_inserted),
        poisoned=state.poisoned | failed,
    )

    # per-frame stats straight from the stacked records (each valid record
    # is one unique voxel of its frame; occupied-priority typing n_occ > 0)
    rec_valid = recs.hi != jnp.uint32(EMPTY_HI)          # (B, U)
    rec_occ = rec_valid & (recs.n_occ > 0)
    zeroB = jnp.zeros((B,), jnp.int32)
    stats = {
        "num_occupied": jnp.where(
            failed, zeroB, jnp.sum(rec_occ, axis=1).astype(jnp.int32)
        ),
        "num_free": jnp.where(
            failed, zeroB,
            jnp.sum(rec_valid & ~rec_occ, axis=1).astype(jnp.int32),
        ),
        "num_candidates": jnp.where(failed, zeroB, auxs.n_valid),
        "overflowed": jnp.broadcast_to(failed, (B,)),
        "unique_overflow": jnp.broadcast_to(frame_overflow, (B,)),
        # batch budget exceeded: host should grow batch_budget only (a much
        # cheaper recompile than doubling the per-frame unique budget);
        # lane-budget overflow reports here too (its default is coupled,
        # Lb = 2*batch_budget, and growth raises both)
        "batch_overflow": jnp.broadcast_to(
            batch_overflow | lanes_overflow, (B,)
        ),
        # insert budget exceeded: host should grow insert_budget only
        "insert_overflow": jnp.broadcast_to(insert_overflow, (B,)),
        # measured distinct voxels / required inserts in this window
        # (reported even on failure — hosts use them to size snug budgets)
        "batch_n_unique": jnp.broadcast_to(n_unique, (B,)),
        "batch_n_need": jnp.broadcast_to(plan.n_need, (B,)),
        "range_fail": auxs.range_fail,
    }
    return new_state, stats


@partial(jax.jit, static_argnames=("new_capacity",))
def _rehash_once(state: HashGridState, new_capacity: int):
    """Re-insert every occupied slot into a new table of the given capacity.
    Returns (state, overflowed); on overflow the result table is invalid."""
    old_hi, old_lo = state.key_hi, state.key_lo
    occupied = old_hi != EMPTY_HI
    fresh = empty_key_rows(new_capacity)
    bucket, found, _, fill = bucket_lookup(fresh, old_hi, old_lo)
    key_rows, slots, overflowed, n_inserted = insert_unique(
        fresh, old_hi, old_lo, occupied & ~found, bucket, fill,
    )
    new_lo = jnp.zeros((new_capacity,), state.log_odds.dtype).at[slots].set(
        state.log_odds, mode="drop"
    )
    return (
        HashGridState(
            key_rows=key_rows,
            log_odds=new_lo,
            min_bounds=state.min_bounds,
            max_bounds=state.max_bounds,
            used=n_inserted,
            poisoned=jnp.zeros((), bool),
        ),
        overflowed,
    )


def rehash(state: HashGridState, new_capacity: int) -> HashGridState:
    """Host-triggered grow: re-insert into a larger table, clearing
    ``poisoned`` so the failed frame can be replayed.  Doubles again until
    every existing bucket fits."""
    while True:
        new_state, overflowed = _rehash_once(state, new_capacity=new_capacity)
        if not bool(overflowed):
            return new_state
        new_capacity *= 2


# ---------------------------------------------------------------------------
# Extraction (reference get_occupied_voxels / classified,
# 3d_mapper.py:127-188) — device-side compaction, O(occupied) host transfer.
#
# The publish path runs at 10 Hz (reference node:227-231) and the reference's
# own full-dict scan was flagged hot at scale (SURVEY.md 3.3).  Pulling the
# whole table to host is O(capacity) — ~64 MB per tick at 2^22 slots — so
# extraction instead compacts ON DEVICE with one stable sort on a small
# class key (selected voxels sort to the front, preserving slot order) and
# transfers only the occupied prefix: (hi, lo, value) ~ 12 bytes per
# selected voxel.  Probabilities/centers are finished on the host in
# float64, exactly as before.
# ---------------------------------------------------------------------------

def occupied_key_mask(state: HashGridState) -> np.ndarray:
    return np.asarray(state.key_hi) != np.uint32(EMPTY_HI)


def _exact_gt_threshold(thr: float, dtype) -> jnp.ndarray:
    """Device threshold t such that ``x > t`` in ``dtype`` equals the host's
    float64 comparison ``float64(x) > thr`` for every representable x.

    float32 values are exact in float64, so the f64 predicate partitions the
    f32 number line at thr; the largest representable value <= thr is the
    equivalent f32 cut point.  Without this, a value between f32(thr) and
    thr would classify differently on device than the host/golden path."""
    if dtype == jnp.float64:
        return jnp.asarray(thr, dtype)
    t32 = np.float32(thr)
    if np.float64(t32) > thr:
        t32 = np.nextafter(t32, np.float32(-np.inf))
    return jnp.asarray(t32, dtype)


@jax.jit
def _compact_by_class(key_rows, log_odds, class_key):
    """Stable-sort (class_key, hi, lo, value) so class 0 voxels lead, then
    class 1, ... — one device sort, no host-side masking at capacity."""
    hi = key_rows[:, :BUCKET_SLOTS].reshape(-1)
    lo = key_rows[:, BUCKET_SLOTS:].reshape(-1)
    counts = jnp.bincount(class_key, length=8)
    _, s_hi, s_lo, s_val = jax.lax.sort(
        (class_key.astype(jnp.uint32), hi, lo, log_odds), num_keys=1
    )
    return s_hi, s_lo, s_val, counts


def _unpack_np(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """Host unpack of packed voxel codes (ops/packing.unpack_keys in numpy)."""
    from sonar_3d_reconstruction_tpu.ops.packing import AXIS_BITS

    bias = np.int64(1 << (AXIS_BITS - 1))
    hi = hi.astype(np.uint32)
    lo = lo.astype(np.uint32)
    x = (hi >> np.uint32(12)).astype(np.int64)
    y = (((hi & np.uint32(0xFFF)) << np.uint32(8)) | (lo >> np.uint32(20))).astype(np.int64)
    z = (lo & np.uint32(0xFFFFF)).astype(np.int64)
    return (np.stack([x, y, z], axis=-1) - bias).astype(np.int32)


def _pull_prefix(arrays, n: int):
    """Transfer only the first n lanes of each device array (padded to a
    power of two so at most log2(C) slice programs ever compile)."""
    if n == 0:
        return [np.empty((0,), np.asarray(a[:1]).dtype) for a in arrays]
    n_pad = min(1 << (n - 1).bit_length(), arrays[0].shape[0])
    return [np.asarray(a[:n_pad])[:n] for a in arrays]


def extract_occupied_hash(
    state: HashGridState, cfg: MapperConfig
) -> Tuple[np.ndarray, np.ndarray]:
    from sonar_3d_reconstruction_tpu.ops.logodds import probability_to_log_odds

    thr = probability_to_log_odds(cfg.min_probability, cfg)
    t = _exact_gt_threshold(thr, state.log_odds.dtype)
    occ = (state.key_hi != EMPTY_HI) & (state.log_odds > t)
    s_hi, s_lo, s_val, counts = _compact_by_class(
        state.key_rows, state.log_odds, jnp.where(occ, 0, 1).astype(jnp.int32)
    )
    n = int(counts[0])
    hi, lo, val = _pull_prefix((s_hi, s_lo, s_val), n)
    points = (_unpack_np(hi, lo).astype(np.float64) + 0.5) * cfg.voxel_resolution
    probs = 1.0 / (1.0 + np.exp(-val.astype(np.float64)))
    return points.reshape(-1, 3), probs


def extract_classified_hash(
    state: HashGridState, cfg: MapperConfig
) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    free_thr = np.log(0.3 / 0.7)
    occ_thr = np.log(cfg.min_probability / (1.0 - cfg.min_probability))
    dtype = state.log_odds.dtype
    lo_v = state.log_odds
    touched = state.key_hi != EMPTY_HI
    # if/elif classification (reference 3d_mapper.py:169-176): free wins,
    # then occupied, else unknown — mutually exclusive even when
    # min_probability < 0.3 puts occ_thr below free_thr.  ``x < free_thr``
    # == ``NOT (x >= free_thr)``; the f64-exact cut for >= is the smallest
    # representable value >= thr, i.e. the > cut shifted one ulp — using
    # ~(x > t_ge_pred) with t from the predecessor logic keeps f32 parity.
    free_m = touched & ~(lo_v > _exact_gt_threshold(
        np.nextafter(free_thr, -np.inf), dtype
    ))
    occ_m = touched & ~free_m & (lo_v > _exact_gt_threshold(occ_thr, dtype))
    unk_m = touched & ~free_m & ~occ_m
    class_key = jnp.where(
        free_m, 0, jnp.where(occ_m, 1, jnp.where(unk_m, 2, 3))
    ).astype(jnp.int32)
    s_hi, s_lo, s_val, counts = _compact_by_class(
        state.key_rows, lo_v, class_key
    )
    n_free, n_occ, n_unk = int(counts[0]), int(counts[1]), int(counts[2])
    total = n_free + n_occ + n_unk
    hi, lo, val = _pull_prefix((s_hi, s_lo, s_val), total)
    out = {}
    for name, start, n in (
        ("free", 0, n_free),
        ("occupied", n_free, n_occ),
        ("unknown", n_free + n_occ, n_unk),
    ):
        h, l, v = hi[start:start + n], lo[start:start + n], val[start:start + n]
        points = (_unpack_np(h, l).astype(np.float64) + 0.5) * cfg.voxel_resolution
        probs = 1.0 / (1.0 + np.exp(-v.astype(np.float64)))
        out[name] = (points.reshape(-1, 3), probs)
    return out


def touched_voxels_hash(
    state: HashGridState,
) -> Tuple[np.ndarray, np.ndarray]:
    """Every touched voxel as (keys (N, 3) int32, log_odds (N,)) — the
    layout-independent dump io/checkpoint.py snapshots (hash twin of
    grid/brick.touched_voxels_brick).  Device-side compaction: pulling
    ``state.keys`` to host and masking there is O(capacity) through the
    slow device->host path; this transfers O(touched)."""
    touched = state.key_hi != EMPTY_HI
    s_hi, s_lo, s_val, counts = _compact_by_class(
        state.key_rows, state.log_odds,
        jnp.where(touched, 0, 1).astype(jnp.int32),
    )
    n = int(counts[0])
    hi, lo, val = _pull_prefix((s_hi, s_lo, s_val), n)
    return _unpack_np(hi, lo).reshape(-1, 3), val


# ---------------------------------------------------------------------------
# Point queries (reference SimpleOctree.get_log_odds / get_probability,
# 3d_mapper.py:117-126, and the world_to_key / key_to_world pair :53-81) —
# batched: the reference answers one coordinate per call from a Python
# dict; the batched equivalent resolves N query points in one bucket
# row gather.
# ---------------------------------------------------------------------------

def query_log_odds(
    state: HashGridState, points, cfg: MapperConfig
) -> np.ndarray:
    """Batched point query: (N, 3) world coords -> (N,) float log-odds,
    0.0 where the voxel was never updated.

    Quantization happens on the HOST in float64 (reference world_to_key
    3d_mapper.py:53-66 is float64 NumPy): flooring query coordinates in
    the map's compute dtype (f32 in production) would resolve
    voxel-boundary points to a neighboring cell and break parity with
    both the reference and the dense backend."""
    pts = np.asarray(points, np.float64).reshape(-1, 3)
    # clip far outside the packable range before the int cast (pack_keys'
    # in_range check rejects them; the clip just keeps the cast defined)
    keys = jnp.asarray(
        np.clip(
            np.floor(pts / cfg.voxel_resolution), -(2**30), 2**30
        ).astype(np.int32)
    )
    hi, lo_w, in_range = pack_keys(keys)
    _, found, found_slot, _ = bucket_lookup(state.key_rows, hi, lo_w)
    vals = state.log_odds[
        jnp.minimum(found_slot, state.capacity - 1)
    ]
    zero = jnp.zeros((), state.log_odds.dtype)
    return np.asarray(jnp.where(found & in_range, vals, zero))


def query_probability(
    state: HashGridState, points, cfg: MapperConfig
) -> np.ndarray:
    """Batched (N, 3) -> (N,) occupancy probabilities (reference
    3d_mapper.py:122-126); never-updated voxels answer 0.5."""
    lo = query_log_odds(state, points, cfg).astype(np.float64)
    return 1.0 / (1.0 + np.exp(-lo))


def keys_to_world(keys, resolution: float) -> np.ndarray:
    """Voxel keys -> voxel CENTER coordinates (reference key_to_world,
    3d_mapper.py:68-81: (key + 0.5) * resolution)."""
    return (np.asarray(keys, np.float64) + 0.5) * resolution
