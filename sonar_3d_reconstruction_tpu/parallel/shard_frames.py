"""Frame-parallel sharded brick engine: records sharded over PINGS,
exchanged to brick owners over an all_to_all.

parallel/shard_brick.py replicates the records program (backprojection +
full-lattice sort-dedup) on EVERY shard and parallelizes only the
table/apply half — Amdahl-bound no matter how many devices whenever the
records program is the larger half of the step.  This engine shards BOTH
halves:

  * each shard computes records for its ~window/S of the window's frames
    (backprojection + owner-GROUPED dedup, ops/dedup.dedup_frame_grouped:
    records come out contiguous per owner shard at no extra sort arrays
    in the compaction);
  * per-(frame, owner) blocks peel off as bandwidth-cheap dynamic slices
    (NOT per-record gathers — indexed-op cost is per index entry) padded to a static ``xchg_budget``, and one
    ``lax.all_to_all`` over the mesh axis delivers every block to the
    shard that owns its bricks: ~16 B/record over the interconnect;
  * the standard per-shard brick window apply (grid/brick.py, unchanged)
    then runs on the shard's OWN records for ALL window frames — the
    same computation shard_brick.py performs, so results are
    bit-identical to the single-chip engine and the all-or-nothing
    window failure contract is preserved (any shard's overflow rejects
    the window everywhere via the psum fail_reduce).

Per-shard work: ~B/S frames of records + ~1/S of the apply — BOTH halves
scale with the mesh.  The reference (a single-process Python loop,
scripts/3d_mapper.py) has no counterpart; this layer follows SURVEY.md
section 5.7/5.8.

State layout, growth (rehash_sharded_bricks), host gather and
checkpointing are shared with parallel/shard_brick.py — the two engines
produce interchangeable ShardedBrickState pytrees.
"""

from __future__ import annotations

import functools
from functools import partial
from typing import Dict, Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from sonar_3d_reconstruction_tpu.config import MapperConfig
from sonar_3d_reconstruction_tpu.grid.brick import (
    DEFAULT_BRICK_BITS,
    apply_brick_records_batched,
    apply_brick_records_compact,
    default_brick_budget,
)
from sonar_3d_reconstruction_tpu.ops.backproject import (
    FanTables,
    backproject_ping,
)
from sonar_3d_reconstruction_tpu.ops.dedup import (
    UniqueRecords,
    dedup_frame_compact_grouped,
    dedup_frame_grouped,
)
from sonar_3d_reconstruction_tpu.ops.packing import (
    EMPTY32,
    EMPTY_HI,
    pack_box_keys,
    pack_brick_keys,
)
from sonar_3d_reconstruction_tpu.parallel.shard import make_mesh
from sonar_3d_reconstruction_tpu.parallel.shard_brick import (
    ShardedBrickState,
    _local_brick,
    _state_specs,
    _wrap_blk,
    init_sharded_brick_grid,
    owner_shard_brick,
    rehash_sharded_bricks,
    run_grow_replay,
)


def default_xchg_budget(unique_budget: int, n_shards: int) -> int:
    """Per-(frame, owner-shard) record-block budget.  The owner hash
    splits a frame's ~unique_budget records near-uniformly over S shards;
    2x headroom absorbs spatial skew (growable on ``xchg_overflow``)."""
    per_shard = -(-2 * unique_budget // n_shards)
    return max(1024, -(-per_shard // 128) * 128)


@functools.lru_cache(maxsize=32)
def make_window_scan_sharded_frames(
    mesh: Mesh,
    tables: FanTables,
    cfg: MapperConfig,
    dtype=jnp.float32,
    axis_name: str = "space",
    unique_budget: Optional[int] = None,
    window: int = 8,
    xchg_budget: Optional[int] = None,
    brick_budget: Optional[int] = None,
    lane_budget: Optional[int] = None,
    insert_budget=None,
    brick_bits: int = DEFAULT_BRICK_BITS,
    box_bits: Optional[Tuple[int, int, int]] = None,
    dense_mode: str = "bfv",  # library default — see pipeline.scan_pings_brick
    vox_budget: Optional[int] = None,
):
    """Frame-parallel sharded window-engine sequence runner:
    (state, images (P,R,B), transforms (P,4,4), start[, box_mins])
    -> (state, stats).

    ``xchg_budget``: static per-(frame, dest-shard) record-block width of
    the all_to_all exchange; overflow reports per-frame through the
    growable ``xchg_overflow`` stat.  ``brick_budget`` / ``lane_budget`` /
    ``insert_budget`` are PER-SHARD apply statics exactly as in
    make_window_scan_sharded_brick (lane budget bounds window *
    xchg_budget exchanged lanes).

    ``box_bits`` (static per-axis brick bits from
    ops/packing.compute_window_boxes, sized so that
    sum(bits) + 3*brick_bits + 1 + ceil(log2 S) <= 31) selects the
    COMPACT box-key path: the per-shard dedup folds the owner shard into
    a single-u32 sort word (ops/dedup.dedup_frame_compact_grouped), the
    exchange moves (key, payload) = 8 B/record instead of the wide
    four-array 16 B, and each owner runs the compact window apply
    (grid/brick.apply_brick_records_compact, incl. ``dense_mode`` /
    ``vox_budget``) — the same sort-byte savings as the single-device
    engine.  The scan then takes per-window
    ``box_mins`` as its fifth argument.  ``box_bits=None`` keeps the wide
    two-word path.
    """
    from sonar_3d_reconstruction_tpu.grid.hash import default_unique_budget
    from sonar_3d_reconstruction_tpu.ops.records import FrameAux

    S = int(mesh.devices.size)
    F = -(-window // S)  # frames per source shard (ceil)
    if unique_budget is None:
        unique_budget = default_unique_budget(
            tables.candidates_per_ping(cfg.occupied_window)
        )
    U = unique_budget
    UX = xchg_budget or default_xchg_budget(U, S)
    if brick_budget is None:
        brick_budget = default_brick_budget(window, UX * S) // S
    if insert_budget is None or isinstance(insert_budget, int):
        insert_schedule = (insert_budget,)
    else:
        insert_schedule = tuple(insert_budget)
    if box_bits is not None:
        V = sum(box_bits) + 3 * brick_bits
        gbits = max(1, (max(S - 1, 1)).bit_length())
        assert V + 1 + gbits <= 31, (box_bits, S)
        f_bits = max(1, (window - 1).bit_length())
        assert V + f_bits <= 31, (box_bits, window)

    def local_window(blk, images, transforms, w_start, start, stop,
                     box_min, *, window_insert_budget):
        my = jax.lax.axis_index(axis_name)
        P_total = images.shape[0]

        def src_frame(fi):
            i = my * F + fi  # window-relative frame this shard computes
            idx = w_start + i
            image = jax.lax.dynamic_index_in_dim(
                images, jnp.minimum(idx, P_total - 1), 0, keepdims=False
            )
            T = jax.lax.dynamic_index_in_dim(
                transforms, jnp.minimum(idx, P_total - 1), 0, keepdims=False
            )
            frame_on = (
                (idx >= start) & (idx < stop) & (i < window)
            )
            cand = backproject_ping(image, T, tables, cfg, dtype=dtype)
            keys = jnp.floor(
                cand["points"] / cfg.voxel_resolution
            ).astype(jnp.int32)
            hi, lo, in_range = pack_brick_keys(keys, brick_bits)
            valid = cand["valid"] & frame_on
            if box_bits is None:
                range_fail = jnp.any(valid & ~in_range)
                valid = valid & in_range
            else:
                bkey, in_box = pack_box_keys(
                    keys, box_min, box_bits, brick_bits
                )
                # boxes are host-proven inside the global range, so
                # in_box failures are the same growth-cannot-fix class
                range_fail = jnp.any(valid & ~(in_range & in_box))
                valid = valid & in_range & in_box
            owner = owner_shard_brick(hi, lo, brick_bits, S)
            if box_bits is None:
                rec, rec_owner = dedup_frame_grouped(
                    hi, lo, cand["is_occupied"], valid, owner, S, U
                )
                arrays = (
                    (rec.hi, EMPTY_HI), (rec.lo, EMPTY_HI),
                    (rec.count, 0), (rec.n_occ, 0),
                )
                pack_fail = jnp.zeros((), bool)
            else:
                rec, rec_owner = dedup_frame_compact_grouped(
                    bkey, cand["is_occupied"], valid, owner, S, V, U
                )
                arrays = ((rec.key, EMPTY32), (rec.payload, 0))
                pack_fail = rec.pack_fail

            # per-owner record counts -> contiguous block starts
            sid = jnp.arange(S, dtype=jnp.int32)
            cnt = jnp.sum(
                rec.valid[None, :] & (rec_owner[None, :] == sid[:, None]),
                axis=1,
            ).astype(jnp.int32)
            starts = jnp.concatenate(
                [jnp.zeros((1,), jnp.int32), jnp.cumsum(cnt)[:-1]]
            )
            xchg_ovf = jnp.any(cnt > UX)
            dedup_ovf = rec.n_unique > U

            def pad(x, fill):
                return jnp.concatenate(
                    [x, jnp.full((UX,), fill, x.dtype)]
                )

            p = tuple(pad(x, fill) for x, fill in arrays)
            fills = tuple(fill for _, fill in arrays)
            r = jnp.arange(UX, dtype=jnp.int32)
            blocks = []
            for d in range(S):
                m = r < cnt[d]
                blocks.append(tuple(
                    jnp.where(
                        m, jax.lax.dynamic_slice_in_dim(x, starts[d], UX),
                        fill,
                    )
                    for x, fill in zip(p, fills)
                ))
            b_arrays = tuple(
                jnp.stack([b[j] for b in blocks])  # (S, UX)
                for j in range(len(p))
            )
            # per-dest true record count; the overflow sentinel makes the
            # receiving apply reject the window through frame_overflow
            tx_n = jnp.where(dedup_ovf | xchg_ovf, jnp.int32(UX + 1), cnt)

            # global bounds over the frame's full valid set (int-key
            # reduce, ops/records.frame_records rationale)
            imax = jnp.iinfo(jnp.int32).max
            kmin = jnp.min(jnp.where(valid[:, None], keys, imax), axis=0)
            kmax = jnp.max(jnp.where(valid[:, None], keys, -imax), axis=0)
            any_valid = jnp.any(valid)
            inf = jnp.asarray(jnp.inf, dtype)
            center = lambda k: (k.astype(dtype) + 0.5) * cfg.voxel_resolution
            cmin = jnp.where(any_valid, center(kmin), inf)
            cmax = jnp.where(any_valid, center(kmax), -inf)
            n_valid = jnp.sum(valid).astype(jnp.int32)
            return (b_arrays, tx_n, dedup_ovf, xchg_ovf, pack_fail,
                    range_fail, cmin, cmax, n_valid)

        (b_arrays, tx_n, dedup_ovf, xchg_ovf, pack_fail, range_fail,
         cmin, cmax, n_valid) = jax.lax.map(
            src_frame, jnp.arange(F, dtype=jnp.int32)
        )

        # exchange: blocks (F, S_dest, UX) -> (F, S_src, UX); every
        # received block holds records THIS shard owns
        def xchg(x):
            return jax.lax.all_to_all(
                x, axis_name, split_axis=1, concat_axis=1
            )

        rx = tuple(xchg(x) for x in b_arrays)
        rx_n = xchg(tx_n[:, :, None])[..., 0]  # (F, S_src)

        # window frame f == src * F + fi: (F, S, ...) -> (B, ...)
        def frames_axis(x):
            return jnp.swapaxes(x, 0, 1).reshape(
                (S * F,) + x.shape[2:]
            )[:window]

        # per-frame aux, replicated via all_gather of the source values
        def gathered(x):
            return frames_axis(
                jnp.swapaxes(jax.lax.all_gather(x, axis_name), 0, 1)
            )

        lane = jnp.arange(UX, dtype=jnp.int32)
        n_uni = frames_axis(rx_n)  # (B,)
        if box_bits is None:
            rx_hi, rx_lo, rx_cnt, rx_occ = rx
            recs = UniqueRecords(
                hi=frames_axis(rx_hi),
                lo=frames_axis(rx_lo),
                count=frames_axis(rx_cnt),
                n_occ=frames_axis(rx_occ),
                valid=lane[None, :] < n_uni[:, None],
                n_unique=n_uni,
            )
        else:
            from sonar_3d_reconstruction_tpu.ops.dedup import CompactRecords

            rx_key, rx_pay = rx
            recs = CompactRecords(
                key=frames_axis(rx_key),
                payload=frames_axis(rx_pay),
                valid=lane[None, :] < n_uni[:, None],
                n_unique=n_uni,
                # the dedup detects count-width failures at the SOURCE;
                # gathered per-frame so the apply's pack path sees them
                pack_fail=gathered(pack_fail),
            )

        auxs = FrameAux(
            cmin=gathered(cmin),
            cmax=gathered(cmax),
            range_fail=gathered(range_fail),
            n_valid=gathered(n_valid),
        )
        g_dedup_ovf = gathered(dedup_ovf)  # (B,) identical on every shard
        g_xchg_ovf = gathered(xchg_ovf)

        fail_reduce = lambda f: jax.lax.psum(
            f.astype(jnp.int32), axis_name
        ) > 0
        if box_bits is None:
            new_local, stats = apply_brick_records_batched(
                _local_brick(blk), recs, auxs, cfg,
                brick_budget=brick_budget, lane_budget=lane_budget,
                insert_budget=window_insert_budget,
                fail_reduce=fail_reduce,
            )
        else:
            new_local, stats = apply_brick_records_compact(
                _local_brick(blk), recs, auxs, cfg, box_min, box_bits,
                brick_budget=brick_budget, lane_budget=lane_budget,
                insert_budget=window_insert_budget,
                vox_budget=vox_budget, dense_mode=dense_mode,
                fail_reduce=fail_reduce,
            )
        stats = dict(stats)
        for k in ("batch_n_unique", "batch_n_bricks", "batch_n_lanes",
                  "batch_n_need"):
            stats[k + "_max"] = jax.lax.pmax(stats[k], axis_name)
            stats[k] = jax.lax.psum(stats[k], axis_name)
        for k in ("num_occupied", "num_free"):
            stats[k] = jax.lax.psum(stats[k], axis_name)
        # pack_overflow included: after the exchange each shard applies a
        # DIFFERENT record subset, so the apply-side flags are all
        # shard-divergent and the host reads device 0's copy
        for k in ("batch_overflow", "insert_overflow", "pack_overflow"):
            stats[k] = jax.lax.psum(stats[k].astype(jnp.int32), axis_name) > 0
        # cause attribution from the SOURCE-side flags (the apply's
        # frame_overflow conflates dedup-U and exchange overflows — both
        # arrive as the n_unique sentinel)
        B = int(n_uni.shape[0])
        stats["unique_overflow"] = jnp.broadcast_to(
            jnp.any(g_dedup_ovf), (B,)
        )
        stats["xchg_overflow"] = jnp.broadcast_to(jnp.any(g_xchg_ovf), (B,))
        # exchange sizing requirement (max records any (frame, dest)
        # block carried; valid frames only)
        stats["xchg_n_max"] = jnp.broadcast_to(
            jax.lax.pmax(
                jnp.max(jnp.where(tx_n <= UX, tx_n, 0)), axis_name
            ),
            (B,),
        )
        # num_candidates needs NO psum here (contrast shard_brick): each
        # frame's aux.n_valid is the source shard's full-frame count,
        # already global and replicated by the all_gather
        return _wrap_blk(new_local), stats

    stats_specs = {
        "num_occupied": P(), "num_free": P(), "num_candidates": P(),
        "overflowed": P(), "unique_overflow": P(), "xchg_overflow": P(),
        "batch_overflow": P(), "insert_overflow": P(), "pack_overflow": P(),
        "range_fail": P(),
        "batch_n_unique": P(), "batch_n_bricks": P(), "batch_n_lanes": P(),
        "batch_n_need": P(), "batch_n_unique_max": P(),
        "batch_n_bricks_max": P(), "batch_n_lanes_max": P(),
        "batch_n_need_max": P(), "xchg_n_max": P(),
    }
    window_steps = {
        ib: jax.jit(
            shard_map(
                partial(local_window, window_insert_budget=ib),
                mesh=mesh,
                in_specs=(
                    _state_specs(axis_name), P(), P(), P(), P(), P(), P(),
                ),
                out_specs=(_state_specs(axis_name), stats_specs),
                check_vma=False,
            )
        )
        for ib in set(insert_schedule)
    }
    _zero_box = jnp.zeros((3,), jnp.int32)

    def scan(state, images, transforms, start=0, stop=None, box_mins=None):
        """``stop`` (host int): frames >= stop are padding — their window
        programs are SKIPPED entirely (a streaming chunk keeps its static
        shape; the tail windows would run full-lattice sorts on masked-off
        frames) and their stats rows are zero.  ``box_mins``
        ((n_windows, 3) int32, required when the builder got box_bits):
        per-window compact box origins."""
        P_ = images.shape[0]
        limit = P_ if stop is None else max(0, min(P_, int(stop)))
        if limit == 0:
            return state, {}
        assert (box_mins is not None) == (box_bits is not None), \
            "box_mins and the builder's box_bits go together"
        images = jnp.asarray(images)
        transforms = jnp.asarray(transforms, dtype)
        start = jnp.asarray(start, jnp.int32)
        stop_v = jnp.int32(limit)
        window_stats = []
        for wi, w in enumerate(range(0, limit, window)):
            ib = insert_schedule[min(wi, len(insert_schedule) - 1)]
            bm = (
                _zero_box if box_mins is None
                else jnp.asarray(box_mins[wi], jnp.int32)
            )
            state, stats = window_steps[ib](
                state, images, transforms, jnp.int32(w), start, stop_v, bm
            )
            window_stats.append(stats)
        out = {
            k: jnp.concatenate([s[k] for s in window_stats])[:P_]
            for k in (window_stats[0] if window_stats else {})
        }
        if limit < P_ and window_stats:
            pad = P_ - int(out["overflowed"].shape[0])
            if pad > 0:
                out = {
                    k: jnp.concatenate(
                        [v, jnp.zeros((pad,) + v.shape[1:], v.dtype)]
                    )
                    for k, v in out.items()
                }
        return state, out

    return scan


def map_ping_sequence_sharded_frames(
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
    xchg_budget: Optional[int] = None,
    brick_budget: Optional[int] = None,
    lane_budget: Optional[int] = None,
    insert_budget=None,
    brick_bits: int = DEFAULT_BRICK_BITS,
    max_grow_retries: int = 12,
    effective: Optional[Dict] = None,
    tables: Optional[FanTables] = None,
    stop: Optional[int] = None,
    fan_cap="auto",
    window_cap="auto",
    free_cap="auto",
    box_min_bits=None,
    dense_mode: str = "bfv",  # library default — see pipeline.scan_pings_brick
    vox_budget: Optional[int] = None,
    use_boxes: bool = True,
) -> Tuple[ShardedBrickState, Dict[str, np.ndarray]]:
    """Host wrapper: grow the right knob and replay from the first failed
    frame, with the frame-parallel engine's extra growable cause
    (``xchg_overflow`` -> double the exchange block budget).  Mirrors
    map_ping_sequence_sharded_brick otherwise; ``effective``, if given,
    receives the post-growth budgets for stateful callers.

    ``tables``: caller-provided fan tables (e.g. the streaming runtime's
    grow-only gated tables — any cap exact for these images is exact here
    too); when absent the host gates size the lattice caps exactly for
    THESE images ("auto", same contract as pipeline.map_ping_sequence).
    ``stop``: frames >= stop are padding kept only for static chunk
    shapes — never mapped, zero stats rows."""
    from sonar_3d_reconstruction_tpu.grid.hash import default_unique_budget
    from sonar_3d_reconstruction_tpu.ops.backproject import (
        resolve_capped_tables,
    )
    from sonar_3d_reconstruction_tpu.pipeline import batched_sonar_to_world

    cfg = cfg or MapperConfig()
    mesh = mesh if mesh is not None else make_mesh(axis_name=axis_name)
    S = int(mesh.devices.size)
    images = np.asarray(images)
    P_, R, B = images.shape
    if tables is None:
        tables = resolve_capped_tables(
            images if stop is None else images[: max(0, int(stop))],
            cfg, R, B, fan_cap=fan_cap, window_cap=window_cap,
            free_cap=free_cap,
        )
    T = batched_sonar_to_world(positions, quaternions, cfg)
    images_dev = jnp.asarray(images)
    T_dev = jnp.asarray(T, dtype)

    st = (
        state if state is not None
        else init_sharded_brick_grid(mesh, local_capacity, dtype, brick_bits)
    )
    if P_ == 0 or (stop is not None and stop <= 0):
        return st, {}
    window = min(window, P_)
    if isinstance(insert_budget, list):
        insert_budget = tuple(insert_budget)

    # compact box-key path whenever the survey's per-window extents fit
    # the tighter sharded budget: the owner shard folds into the dedup
    # sort word, so the box gate is sized with frame_bits' slot widened
    # to max(frame, 1 + owner) bits (compute_window_boxes checks
    # V + that <= 31, covering both the dedup and the apply layouts)
    from sonar_3d_reconstruction_tpu.ops.packing import compute_window_boxes

    boxes = None
    if use_boxes:
        gbits = max(1, (max(S - 1, 1)).bit_length())
        f_bits = max(1, (window - 1).bit_length())
        # size the boxes over the ACTIVE poses only: frames past `stop`
        # are masked in-scan but their poses would still widen the static
        # box bits (a zero-pose pad far from the survey can blow the u32
        # budget and silently force the wide fallback) — repeat the last
        # active pose over the pad instead, like stream.py's chunk pad
        pos3 = T[:, :3, 3]
        if stop is not None and 0 < stop < P_:
            pos3 = np.concatenate(
                [pos3[:stop], np.repeat(pos3[stop - 1 : stop],
                                        P_ - stop, axis=0)]
            )
        boxes = compute_window_boxes(
            pos3, cfg.max_range, cfg.voxel_resolution, window,
            brick_bits, frame_bits=max(f_bits, 1 + gbits),
            min_bits=box_min_bits,
        )

    def make_scan():
        scan = make_window_scan_sharded_frames(
            mesh, tables, cfg, dtype, axis_name, unique_budget, window,
            xchg_budget, brick_budget, lane_budget, insert_budget,
            brick_bits, None if boxes is None else boxes[1],
            dense_mode, vox_budget,
        )
        return partial(
            scan, stop=stop,
            box_mins=None if boxes is None else boxes[0],
        )

    def _default_ub():
        return unique_budget or default_unique_budget(
            tables.candidates_per_ping(cfg.occupied_window)
        )

    def grow_unique():
        nonlocal unique_budget, xchg_budget, brick_budget
        unique_budget = 2 * _default_ub()
        if xchg_budget is not None:
            # keep any exchange growth already proven necessary (it was
            # driven by ownership skew, which growing U does not address),
            # but let the re-derived default win if it is larger
            xchg_budget = max(
                xchg_budget, default_xchg_budget(unique_budget, S)
            )
        brick_budget = None  # monotone: its default scales with the new U

    def grow_xchg():
        nonlocal xchg_budget
        xchg_budget = 2 * (xchg_budget or default_xchg_budget(_default_ub(), S))

    def grow_insert():
        nonlocal insert_budget
        if isinstance(insert_budget, tuple):
            insert_budget = tuple(2 * b for b in insert_budget)
        elif insert_budget is not None:
            insert_budget = 2 * insert_budget

    def grow_batch():
        nonlocal brick_budget, vox_budget, lane_budget
        ux = xchg_budget or default_xchg_budget(_default_ub(), S)
        brick_budget = 2 * (
            brick_budget or default_brick_budget(window, ux * S) // S
        )
        if vox_budget is not None:
            # row-mode distinct-voxel budget reports through the same
            # batch_overflow channel (apply_brick_records_compact)
            vox_budget *= 2
        if lane_budget is not None:
            # lanes_overflow is folded into the same channel too; a snug
            # lane budget would otherwise never recover — drop to the
            # derived full-width default (guaranteed sufficient)
            lane_budget = None

    out = run_grow_replay(
        st=st, images_dev=images_dev, T_dev=T_dev, n_frames=P_,
        max_grow_retries=max_grow_retries, make_scan=make_scan,
        growable_causes=(
            ("unique_overflow", grow_unique),
            ("xchg_overflow", grow_xchg),
            ("insert_overflow", grow_insert),
            ("batch_overflow", grow_batch),
        ),
        rehash=lambda s: rehash_sharded_bricks(
            st=s, mesh=mesh, new_local_capacity=s.local_capacity * 2,
            axis_name=axis_name,
        ),
        label="sharded frame-parallel",
    )
    if effective is not None:
        effective.update(
            unique_budget=unique_budget, xchg_budget=xchg_budget,
            brick_budget=brick_budget, lane_budget=lane_budget,
            insert_budget=insert_budget, vox_budget=vox_budget,
            # named like the input param so stateful callers can splat
            # the dict straight back (sticky grow-only bits)
            box_min_bits=None if boxes is None else boxes[1],
        )
    return out
