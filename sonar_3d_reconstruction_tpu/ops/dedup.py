"""Sort-based per-frame voxel dedup (the accelerator-shaped replacement for the
reference's per-frame accumulation dict, scripts/3d_mapper.py:523-551).

Random scatter/gather is paid per index, while sorts, cumulative and
associative scans and elementwise ops stream over memory.  The frame update
therefore dedups candidates FIRST, entirely with sort/scan/elementwise primitives, and
touches the hash table only with ~U << N unique records:

  1. sort candidates by packed voxel code (invalid -> EMPTY_HI, sorts last);
  2. segment ENDS by neighbor compare; carry the global occupied-count
     cumsum and the lane index through the compaction, then recover each
     segment's count/occupied aggregates as ADJACENT DIFFERENCES between
     consecutive compacted records (valid segments tile a contiguous
     sorted prefix, and the is-end sort keeps records in key == lane
     order, so record i's predecessor end is record i-1's end);
  3. compact the segment-end records to the front with a second sort on
     the one-bit is-end key, truncated to a static unique budget.

The adjacent-difference step replaced two ``lax.cummax`` segment-rebase
scans with two shifts and two subtracts on the already-compacted arrays, at identical compaction-sort
payload width (csum+idx ride where count+occ rode).

Per-voxel aggregates are EXACT: within a frame every candidate of a voxel
carries one of two constant log-odds values (occupied/free), so the
reference's per-voxel ``sum`` is n_occ*log_odds_occupied +
(count-n_occ)*log_odds_free and its occupied-priority flag is n_occ > 0
(3d_mapper.py:542-551).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from sonar_3d_reconstruction_tpu.ops.packing import EMPTY32, EMPTY_HI


class UniqueRecords(NamedTuple):
    """Compact per-frame unique-voxel records (static length U)."""

    hi: jnp.ndarray        # (U,) uint32 packed key (EMPTY_HI on unused lanes)
    lo: jnp.ndarray        # (U,) uint32
    count: jnp.ndarray     # (U,) int32 candidates in the voxel this frame
    n_occ: jnp.ndarray     # (U,) int32 occupied-type candidates
    valid: jnp.ndarray     # (U,) bool
    n_unique: jnp.ndarray  # () int32 true unique count (may exceed U!)

    @property
    def overflowed(self) -> jnp.ndarray:
        return self.n_unique > self.hi.shape[0]


def running_max(x: jnp.ndarray) -> jnp.ndarray:
    """Inclusive running maximum — the segment rebase/rank primitive shared
    by dedup and the bucket-insert ranking.

    ``lax.cummax`` lowers to a reduce-window, while
    ``associative_scan(maximum)`` materializes half-width slice/pad
    intermediates at every level."""
    return jax.lax.cummax(x, axis=0)




def dedup_frame(
    hi: jnp.ndarray,
    lo: jnp.ndarray,
    occ: jnp.ndarray,
    valid: jnp.ndarray,
    unique_budget: int,
    lane_budget: int = 0,
) -> UniqueRecords:
    """Candidates (N,) -> UniqueRecords (unique_budget,).

    ``hi``/``lo``: packed voxel codes, ``occ``: occupied-type flag,
    ``valid``: emission mask.  If a frame has more unique voxels than the
    budget the records are truncated and ``n_unique`` reports the excess
    (callers poison the frame and retry with a larger budget).

    ``lane_budget`` (default ``min(n, 2*unique_budget)``): the compaction
    sort — one of the most expensive ops in the records program — runs on
    only the first
    ``lane_budget`` lanes.  Sort 1 puts every valid candidate in a
    contiguous prefix, so this is exact whenever the frame's valid-candidate
    count fits the budget; a frame that exceeds it is reported through
    ``n_unique`` (the unique-budget overflow path — doubling the unique
    budget doubles this budget with it, so the host's growth remedy is the
    right one for both causes).
    """
    n = hi.shape[0]
    if lane_budget <= 0:
        lane_budget = min(n, 2 * unique_budget)
    # the compacted arrays must cover the unique budget
    lane_budget = min(n, max(lane_budget, unique_budget))
    big = EMPTY_HI
    hi = jnp.where(valid, hi, big)
    lo = jnp.where(valid, lo, big)

    # is_stable=False: a stable sort carries an implicit iota tiebreak
    # array through every merge stage;
    # per-voxel aggregation is order-independent, so equal-key order is
    # irrelevant here
    hi, lo, occ_i = jax.lax.sort(
        (hi, lo, occ.astype(jnp.int32)), num_keys=2, is_stable=False
    )

    idx = jnp.arange(n, dtype=jnp.int32)

    # global inclusive occupied cumsum in sorted order.  Invalid lanes all
    # sort past the valid prefix, so their occ values only affect cumsum
    # lanes BEYOND the last record and never leak into any aggregate.
    csum_occ = jnp.cumsum(occ_i)

    new_seg = jnp.concatenate(
        [jnp.ones((1,), bool), (hi[1:] != hi[:-1]) | (lo[1:] != lo[:-1])]
    )
    is_end = jnp.concatenate([new_seg[1:], jnp.ones((1,), bool)])
    seg_valid = hi != big
    rec = is_end & seg_valid
    n_unique = jnp.sum(rec).astype(jnp.int32)
    # valid lanes overflowing the compaction slice must reject the frame;
    # report through the unique-overflow channel (see docstring)
    n_valid = jnp.sum(seg_valid).astype(jnp.int32)
    n_unique = jnp.where(
        n_valid > lane_budget, jnp.int32(n + 1), n_unique
    )

    # compaction: sort on the one-bit "not a record" key, on the
    # valid-prefix slice only.  The packed code is promoted into the sort
    # KEYS (records are distinct, so the order is fully determined) — that
    # keeps the compacted records key-sorted without paying for the stable
    # sort's implicit tiebreak array
    lb = lane_budget
    not_rec = (~rec[:lb]).astype(jnp.uint32)
    _, c_hi, c_lo, c_csum, c_idx = jax.lax.sort(
        (not_rec, hi[:lb], lo[:lb], csum_occ[:lb], idx[:lb]),
        num_keys=3, is_stable=False,
    )

    # per-segment aggregates as adjacent differences: valid segments tile
    # the sorted valid prefix contiguously and records come out of the
    # compaction in ascending key order == ascending end-lane order, so
    # record i's segment spans (end[i-1], end[i]].  count = end-index
    # difference, n_occ = end-cumsum difference; the first record's
    # predecessor is the virtual lane -1 with cumsum 0.
    c_count = c_idx - jnp.concatenate(
        [jnp.full((1,), -1, jnp.int32), c_idx[:-1]]
    )
    c_occ = c_csum - jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), c_csum[:-1]]
    )
    u = unique_budget

    def take(x, fill):
        if u <= lb:
            return x[:u]
        pad = jnp.full((u - lb,), fill, x.dtype)
        return jnp.concatenate([x, pad])

    lane = jnp.arange(u, dtype=jnp.int32)
    valid_u = lane < n_unique
    return UniqueRecords(
        hi=jnp.where(valid_u, take(c_hi, big), big),
        lo=jnp.where(valid_u, take(c_lo, big), big),
        count=jnp.where(valid_u, take(c_count, 0), 0),
        n_occ=jnp.where(valid_u, take(c_occ, 0), 0),
        valid=valid_u,
        n_unique=n_unique,
    )


class CompactRecords(NamedTuple):
    """Per-frame unique-voxel records with single-u32 BOX-RELATIVE keys
    (ops/packing.pack_box_keys; EMPTY32 on unused lanes).  Semantically
    identical to UniqueRecords — only the representation differs: the
    (count, n_occ) aggregates ride PRE-PACKED in the u32 payload the
    window apply sorts anyway (count<<16 | n_occ), and a frame where any
    voxel's count would not fit 16 bits reports ``pack_fail`` instead of
    carrying wide counts (detection is exact and budget-independent —
    see dedup_frame_compact)."""

    key: jnp.ndarray        # (U,) uint32 box key (V bits; EMPTY32 = unused)
    payload: jnp.ndarray    # (U,) uint32 count<<16 | n_occ (0 on unused)
    valid: jnp.ndarray      # (U,) bool
    n_unique: jnp.ndarray   # () int32 (may exceed U -> overflow)
    pack_fail: jnp.ndarray  # () bool: some voxel got 2^16+ candidates

    @property
    def overflowed(self) -> jnp.ndarray:
        return self.n_unique > self.key.shape[0]

    @property
    def count(self) -> jnp.ndarray:
        return (self.payload >> 16).astype(jnp.int32)

    @property
    def n_occ(self) -> jnp.ndarray:
        return (self.payload & jnp.uint32(0xFFFF)).astype(jnp.int32)


def dedup_frame_compact(
    key: jnp.ndarray,
    occ: jnp.ndarray,
    valid: jnp.ndarray,
    unique_budget: int,
    lane_budget: int = 0,
) -> CompactRecords:
    """dedup_frame for single-u32 box keys (< 2^30, so ``key << 1 | occ``
    still clears bit 31).  The sort carries ONE array where the wide path
    carries three (hi, lo, occ) — sort cost is ~linear in total bytes —
    and the compaction sort carries TWO where the wide path carries five:
    the lane index and occupied cumsum ride as mod-2^16 residues packed in
    one u32.  Their adjacent differences (count, n_occ) are < 2^16 for
    every representable record — the payload packs count into 16 bits —
    so the residue differences are exact; the one unrepresentable case
    (a voxel with 2^16+ candidates in one frame) is detected DIRECTLY on
    the sorted keys (a 65535-distant equal-key pair) and reported through
    ``pack_fail``, independent of any budget.  Aggregation logic
    (segment ends, adjacent differences) is otherwise identical.
    """
    n = key.shape[0]
    if lane_budget <= 0:
        lane_budget = min(n, 2 * unique_budget)
    lane_budget = min(n, max(lane_budget, unique_budget))
    # occupied bit folded into the sort key: EMPTY32 (all ones) for invalid
    # lanes sorts last and is unreachable from any valid (key << 1 | occ)
    skey = jnp.where(valid, (key << 1) | occ.astype(jnp.uint32), EMPTY32)
    (skey,) = jax.lax.sort((skey,), num_keys=1, is_stable=False)

    vox = skey >> 1
    # invalid lanes contribute their sentinel's low bit only BEYOND the last
    # record (they sort past every valid lane) — same argument as dedup_frame
    csum_occ = jnp.cumsum((skey & 1).astype(jnp.int32))
    # mod-2^16 residues of (lane index, occupied cumsum) packed in ONE u32
    # compaction-sort payload (see docstring)
    track = (
        ((jnp.arange(n, dtype=jnp.uint32) & jnp.uint32(0xFFFF)) << 16)
        | (csum_occ.astype(jnp.uint32) & jnp.uint32(0xFFFF))
    )

    new_seg = jnp.concatenate([jnp.ones((1,), bool), vox[1:] != vox[:-1]])
    is_end = jnp.concatenate([new_seg[1:], jnp.ones((1,), bool)])
    seg_valid = skey != EMPTY32
    rec = is_end & seg_valid
    n_unique = jnp.sum(rec).astype(jnp.int32)
    n_valid = jnp.sum(seg_valid).astype(jnp.int32)
    n_unique = jnp.where(n_valid > lane_budget, jnp.int32(n + 1), n_unique)

    # a voxel segment of 2^16+ candidates <=> an equal valid key pair at
    # distance 65535 in the sorted order (valid lanes are a prefix, so the
    # later lane being valid implies the earlier one is too; the occ bit
    # can split a voxel across two skey values, so compare VOX not skey)
    if n > 0xFFFF:
        pack_fail = jnp.any(
            (vox[0xFFFF:] == vox[:-0xFFFF]) & seg_valid[0xFFFF:]
        )
    else:
        pack_fail = jnp.zeros((), bool)

    # NOTE (occ-bit segment split): a voxel with BOTH occupied and free
    # candidates forms two adjacent skey segments (key<<1|0 then key<<1|1)
    # but ONE vox segment — new_seg/is_end compare vox, so the record and
    # its adjacent-difference aggregates span both halves exactly.
    lb = lane_budget
    c_key = jnp.where(rec[:lb], vox[:lb], EMPTY32)
    c_key, c_track = jax.lax.sort(
        (c_key, track[:lb]), num_keys=1, is_stable=False
    )

    idx16 = c_track >> 16
    csum16 = c_track & jnp.uint32(0xFFFF)
    # record i's segment spans (end[i-1], end[i]]; the virtual predecessor
    # of record 0 is lane -1 (0xFFFF mod 2^16) with cumsum 0
    prev_idx = jnp.concatenate(
        [jnp.full((1,), 0xFFFF, jnp.uint32), idx16[:-1]]
    )
    prev_csum = jnp.concatenate([jnp.zeros((1,), jnp.uint32), csum16[:-1]])
    c_count = (idx16 - prev_idx) & jnp.uint32(0xFFFF)
    c_occ = (csum16 - prev_csum) & jnp.uint32(0xFFFF)
    c_payload = (c_count << 16) | c_occ
    u = unique_budget

    def take(x, fill):
        if u <= lb:
            return x[:u]
        pad = jnp.full((u - lb,), fill, x.dtype)
        return jnp.concatenate([x, pad])

    lane = jnp.arange(u, dtype=jnp.int32)
    valid_u = lane < n_unique
    return CompactRecords(
        key=jnp.where(valid_u, take(c_key, EMPTY32), EMPTY32),
        payload=jnp.where(valid_u, take(c_payload, 0), 0),
        valid=valid_u,
        n_unique=n_unique,
        pack_fail=pack_fail,
    )


def dedup_frame_grouped(
    hi: jnp.ndarray,
    lo: jnp.ndarray,
    occ: jnp.ndarray,
    valid: jnp.ndarray,
    group: jnp.ndarray,
    n_groups: int,
    unique_budget: int,
    lane_budget: int = 0,
) -> Tuple[UniqueRecords, jnp.ndarray]:
    """dedup_frame with records ordered by (group, key) instead of (key):
    returns ``(records, rec_group (U,) int32)`` with every group's records
    CONTIGUOUS in the compacted output — the shape the frame-parallel
    exchange needs (parallel/shard_frames.py): per-group blocks then peel
    off as bandwidth-cheap dynamic slices instead of per-record gathers.

    ``group`` must be a pure function of the voxel key (equal keys =>
    equal groups, e.g. the brick-owner hash), so promoting it to the TOP
    sort key still groups equal voxels into single segments.  Because the
    first sort orders lanes by (group, key), segment ends remain in
    compacted-output order and the adjacent-difference aggregate
    reconstruction of dedup_frame stays exact (its correctness argument
    needs compacted order == sorted-lane order, which a post-hoc grouping
    re-sort would break).

    Cost vs dedup_frame: ONE extra u32 sort array in the first sort (the
    group ids); the compaction sort folds the group into its selection
    key (``group`` for records, ``n_groups`` for non-records) at
    unchanged width.
    """
    n = hi.shape[0]
    if lane_budget <= 0:
        lane_budget = min(n, 2 * unique_budget)
    lane_budget = min(n, max(lane_budget, unique_budget))
    big = EMPTY_HI
    hi = jnp.where(valid, hi, big)
    lo = jnp.where(valid, lo, big)
    gkey = jnp.where(valid, group.astype(jnp.uint32), jnp.uint32(n_groups))

    gkey, hi, lo, occ_i = jax.lax.sort(
        (gkey, hi, lo, occ.astype(jnp.int32)), num_keys=3, is_stable=False
    )

    idx = jnp.arange(n, dtype=jnp.int32)
    csum_occ = jnp.cumsum(occ_i)

    new_seg = jnp.concatenate(
        [jnp.ones((1,), bool), (hi[1:] != hi[:-1]) | (lo[1:] != lo[:-1])]
    )
    is_end = jnp.concatenate([new_seg[1:], jnp.ones((1,), bool)])
    seg_valid = hi != big
    rec = is_end & seg_valid
    n_unique = jnp.sum(rec).astype(jnp.int32)
    n_valid = jnp.sum(seg_valid).astype(jnp.int32)
    n_unique = jnp.where(
        n_valid > lane_budget, jnp.int32(n + 1), n_unique
    )

    lb = lane_budget
    sel = jnp.where(rec[:lb], gkey[:lb], jnp.uint32(n_groups))
    c_sel, c_hi, c_lo, c_csum, c_idx = jax.lax.sort(
        (sel, hi[:lb], lo[:lb], csum_occ[:lb], idx[:lb]),
        num_keys=3, is_stable=False,
    )

    c_count = c_idx - jnp.concatenate(
        [jnp.full((1,), -1, jnp.int32), c_idx[:-1]]
    )
    c_occ = c_csum - jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), c_csum[:-1]]
    )
    u = unique_budget

    def take(x, fill):
        if u <= lb:
            return x[:u]
        pad = jnp.full((u - lb,), fill, x.dtype)
        return jnp.concatenate([x, pad])

    lane = jnp.arange(u, dtype=jnp.int32)
    valid_u = lane < n_unique
    out_hi = jnp.where(valid_u, take(c_hi, big), big)
    out_lo = jnp.where(valid_u, take(c_lo, big), big)
    # the compacted selection key IS the record's group (n_groups on
    # non-record lanes by construction)
    out_group = jnp.where(
        valid_u,
        take(c_sel, jnp.uint32(n_groups)).astype(jnp.int32),
        n_groups,
    )
    return (
        UniqueRecords(
            hi=out_hi,
            lo=out_lo,
            count=jnp.where(valid_u, take(c_count, 0), 0),
            n_occ=jnp.where(valid_u, take(c_occ, 0), 0),
            valid=valid_u,
            n_unique=n_unique,
        ),
        out_group,
    )


def dedup_frame_compact_grouped(
    key: jnp.ndarray,
    occ: jnp.ndarray,
    valid: jnp.ndarray,
    group: jnp.ndarray,
    n_groups: int,
    key_bits: int,
    unique_budget: int,
    lane_budget: int = 0,
) -> Tuple[CompactRecords, jnp.ndarray]:
    """dedup_frame_compact with records ordered by (group, key): returns
    ``(records, rec_group (U,) int32)`` with every group's records
    CONTIGUOUS in the compacted output (the frame-parallel exchange shape,
    parallel/shard_frames.py) — the compact-key analog of
    dedup_frame_grouped.

    The group FOLDS into the single sort word above the key: the combined
    value ``comb = group << key_bits | key`` is itself a valid compact
    key (group is a pure function of the voxel key, so equal keys stay in
    single segments, comb segments == key segments, and the combined
    order is exactly (group, key) — per-group contiguity), so the WHOLE
    residue/pack_fail machinery is dedup_frame_compact run on ``comb``;
    this wrapper only splits (group, key) back out of the compacted
    records.  The caller guarantees
    ``ceil(log2 n_groups) + key_bits + 1 <= 31`` (the box-bit host gate
    sizes boxes under that budget), which is dedup_frame_compact's own
    key-width precondition on comb.
    """
    gbits = max(1, (max(n_groups - 1, 1)).bit_length())
    assert gbits + key_bits + 1 <= 31, (n_groups, key_bits)
    comb = (group.astype(jnp.uint32) << key_bits) | key
    rec = dedup_frame_compact(comb, occ, valid, unique_budget, lane_budget)
    out_group = jnp.where(
        rec.valid, (rec.key >> key_bits).astype(jnp.int32), n_groups
    )
    return (
        rec._replace(
            key=jnp.where(
                rec.valid, rec.key & jnp.uint32((1 << key_bits) - 1), EMPTY32
            ),
        ),
        out_group,
    )
