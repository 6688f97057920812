"""Ping-sequence pipeline: one jitted lax.scan over a whole recorded sequence.

The reference processes pings strictly one at a time through Python callbacks
(scripts/3d_mapper.py:485-595 driven by scripts/3d_mapper_node.py:294-357).
On the accelerator the same sequential-by-construction map update (the adaptive log-odds
scale reads pre-frame state, SURVEY.md section 5.7) becomes a ``lax.scan``
whose per-step body is the fused backproject+scatter program — so an entire
bag segment is ONE XLA program with no host round-trips.

Hash-table growth under scan: capacity is static per compiled program, so the
scan carries a ``poisoned`` flag — the first frame that overflows the probe
budget stops all map writes (grid/hash.py) — plus a per-frame ``overflowed``
stats output.  The host wrapper ``map_ping_sequence`` doubles capacity and
replays from the first failed frame, using a traced ``start`` index so the
replay reuses the same compiled program (frames before ``start`` are no-ops).
"""

from __future__ import annotations

import math
from functools import partial
from typing import Any, Dict, Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from sonar_3d_reconstruction_tpu.config import MapperConfig
from sonar_3d_reconstruction_tpu.geometry import (
    pose_matrix_from_rpy,
    rotations_from_quaternions_np,
)
from sonar_3d_reconstruction_tpu.grid.dense import (
    DenseGridSpec,
    init_dense_grid,
    update_dense_grid,
)
from sonar_3d_reconstruction_tpu.grid.hash import (
    HashGridState,
    init_hash_grid,
    rehash,
    update_hash_grid,
)
from sonar_3d_reconstruction_tpu.ops.backproject import (
    FanTables,
    backproject_ping,
    build_fan_tables,
)


# ---------------------------------------------------------------------------
# Host-side batched pose chain (float64 for parity with the golden oracle;
# the device pipeline consumes the cast result)
# ---------------------------------------------------------------------------

def batched_sonar_to_world(
    positions: np.ndarray,
    quaternions: np.ndarray,
    cfg: MapperConfig,
) -> np.ndarray:
    """(P, 3) positions + (P, 4) xyzw quaternions -> (P, 4, 4) float64
    T_sonar_to_world = T_base_to_world @ T_sonar_to_base
    (reference 3d_mapper.py:519-521, batched over the whole sequence)."""
    positions = np.asarray(positions, np.float64)
    R = rotations_from_quaternions_np(quaternions)
    P = len(R)
    T = np.zeros((P, 4, 4), np.float64)
    T[:, :3, :3] = R
    T[:, :3, 3] = positions
    T[:, 3, 3] = 1.0
    T_s2b = pose_matrix_from_rpy(
        np.asarray(cfg.sonar_position, np.float64),
        np.asarray(cfg.sonar_orientation, np.float64),
    )
    return T @ T_s2b


# ---------------------------------------------------------------------------
# Jitted sequence scans
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# Sequence engines.
#
# DESIGN NOTE (why a host loop, not lax.scan): the map-update step writes
# scattered rows into the multi-10s-of-MB table state.  The engine was first
# built for a runtime whose in-place scatter (a lax.scan carry or a
# donated argument) took a very slow path, so every step is a separate
# jitted call with NO donation: the runtime copies the state and scatters
# into the fresh copy.  That choice has not been measured on the GPU, where
# the per-window state copy may now cost more than it saves.  Steps are
# dispatched asynchronously, so the host loop adds only dispatch overhead,
# and the chain of state dependencies keeps execution strictly ordered on
# device.
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("tables", "cfg", "dtype", "unique_budget"))
def hash_ping_step(
    state: HashGridState,
    images: jnp.ndarray,       # (P, R, B) full stacked sequence
    transforms: jnp.ndarray,   # (P, 4, 4)
    idx,                       # () int32 which ping to apply
    start,                     # () int32 frames < start are no-ops (replay)
    stop,                      # () int32 frames >= stop are no-ops (padding)
    *,
    tables: FanTables,
    cfg: MapperConfig,
    dtype=jnp.float32,
    unique_budget=None,
) -> Tuple[HashGridState, Dict[str, jnp.ndarray]]:
    """Apply ping ``idx`` of a stacked sequence to the hashed map (one XLA
    program per call; the full stack is passed so slicing happens on device
    in the same program)."""
    image = jax.lax.dynamic_index_in_dim(images, idx, 0, keepdims=False)
    T = jax.lax.dynamic_index_in_dim(transforms, idx, 0, keepdims=False)
    cand = backproject_ping(image, T, tables, cfg, dtype=dtype)
    frame_on = (idx >= start) & (idx < stop)
    cand = dict(cand, valid=cand["valid"] & frame_on)
    new_state, stats = update_hash_grid(
        state, cand, cfg, unique_budget=unique_budget
    )
    # a padded frame can't overflow, but a poisoned state must not report
    # success for it either
    stats = dict(stats, overflowed=stats["overflowed"] & frame_on)
    return new_state, stats


@partial(
    jax.jit,
    static_argnames=("tables", "cfg", "dtype", "unique_budget", "brick_bits"),
)
def _records_single(
    images,       # (P, R, B) full stacked sequence
    transforms,   # (P, 4, 4)
    idx,          # () int32 which ping
    start,
    stop,
    *,
    tables: FanTables,
    cfg: MapperConfig,
    dtype,
    unique_budget: int,
    brick_bits: int = 0,
):
    """State-independent half for ONE ping of a stacked sequence.
    ``brick_bits`` > 0 packs brick-major keys (the brick backend's
    layout) instead of the hash grid's."""
    from sonar_3d_reconstruction_tpu.ops.records import frame_records

    image = jax.lax.dynamic_index_in_dim(images, idx, 0, keepdims=False)
    T = jax.lax.dynamic_index_in_dim(transforms, idx, 0, keepdims=False)
    frame_on = (idx >= start) & (idx < stop)
    return frame_records(
        image, T, tables, cfg, unique_budget, dtype, frame_on=frame_on,
        brick_bits=brick_bits,
    )


@partial(
    jax.jit,
    static_argnames=("cfg", "batch_budget", "lane_budget", "insert_budget"),
)
def _apply_batched(
    state, recs, auxs, *, cfg: MapperConfig, batch_budget: int,
    lane_budget=None, insert_budget=None,
):
    from sonar_3d_reconstruction_tpu.grid.hash import apply_records_batched

    return apply_records_batched(
        state, recs, auxs, cfg, batch_budget=batch_budget,
        lane_budget=lane_budget, insert_budget=insert_budget,
    )


@partial(
    jax.jit,
    static_argnames=(
        "tables", "cfg", "dtype", "unique_budget", "window",
        "dedup_lane_budget", "brick_bits", "box_bits",
    ),
)
def _records_window(
    images,       # (P, R, B) full stacked sequence
    transforms,   # (P, 4, 4)
    w_start,      # () int32 first ping of the window
    start,
    stop,
    box_min=None,  # (3,) int32 window box origin (compact-key path)
    *,
    tables: FanTables,
    cfg: MapperConfig,
    dtype,
    unique_budget: int,
    window: int,
    dedup_lane_budget: int = 0,
    brick_bits: int = 0,
    box_bits=None,
):
    """Records for a whole window of pings in ONE dispatch.

    ``lax.map`` (a scan) compiles the per-ping records body once — unlike the
    vmapped variant, whose batched-sort HLO compiles far more slowly — and
    runs it sequentially on device, which costs nothing extra here
    because the per-ping bodies were already serialized by dispatch order.
    Window frames past ``stop`` (tail padding) produce empty records via the
    ``frame_on`` mask; the dynamic slice clamps their index reads.
    """
    from sonar_3d_reconstruction_tpu.ops.records import frame_records

    def body(i):
        idx = w_start + i
        image = jax.lax.dynamic_index_in_dim(images, idx, 0, keepdims=False)
        T = jax.lax.dynamic_index_in_dim(transforms, idx, 0, keepdims=False)
        frame_on = (idx >= start) & (idx < stop)
        return frame_records(
            image, T, tables, cfg, unique_budget, dtype, frame_on=frame_on,
            dedup_lane_budget=dedup_lane_budget, brick_bits=brick_bits,
            box_min=box_min, box_bits=box_bits,
        )

    return jax.lax.map(body, jnp.arange(window, dtype=jnp.int32))


def scan_pings_hash(
    state: HashGridState,
    images: jnp.ndarray,
    transforms: jnp.ndarray,
    start=None,
    stop=None,
    *,
    tables: FanTables,
    cfg: MapperConfig,
    dtype=jnp.float32,
    unique_budget=None,
    window: int = 1,
    batch_budget=None,
    lane_budget=None,
    insert_budget=None,
    dedup_lane_budget=0,
) -> Tuple[HashGridState, Dict[str, jnp.ndarray]]:
    """Whole ping sequence -> hashed map (host-driven chain of dispatches;
    see the design note above).  Frames outside [start, stop) contribute
    nothing (growth replay uses ``start``, chunked streaming pads with
    ``stop``).

    ``window`` > 1 switches to the BATCHED-APPLY engine: records for each
    ping are computed by per-ping dispatches (state-independent), then the
    whole window applies to the map with ONE set of table operations
    (grid/hash.apply_records_batched) — per-voxel update chains inside the
    window are evaluated with rank-stepped elementwise passes, preserving
    exact sequential semantics.  A failed batch (any overflow) is replayed
    per-frame, so behavior under growth matches window=1 exactly.

    Returns (final_state, per-ping stats dict of (P,) arrays).
    """
    P = images.shape[0]
    if P == 0:
        return state, {}
    start = jnp.int32(0) if start is None else jnp.asarray(start, jnp.int32)
    stop = jnp.int32(P) if stop is None else jnp.asarray(stop, jnp.int32)
    window = min(window, P)
    if unique_budget is None:
        tables_n = tables.candidates_per_ping(cfg.occupied_window)
        from sonar_3d_reconstruction_tpu.grid.hash import default_unique_budget

        unique_budget = default_unique_budget(tables_n)

    images_dev = jnp.asarray(images)
    T_dev = jnp.asarray(transforms, dtype)

    if window == 1:
        per_step = []
        for i in range(P):
            state, stats = hash_ping_step(
                state, images_dev, T_dev, jnp.int32(i), start, stop,
                tables=tables, cfg=cfg, dtype=dtype,
                unique_budget=unique_budget,
            )
            per_step.append(stats)
        return state, {
            k: jnp.stack([s[k] for s in per_step]) for k in per_step[0]
        }

    # Batched-apply engine: TWO dispatches per window — one lax.map records
    # program (all window pings, state-independent) and one batched apply.
    # Tail windows are dispatched full-width with frames >= stop masked off
    # (empty records), so every window reuses the same two compiled programs.
    # NOTE: no per-window sync — a failed batch poisons the state
    # (all-or-nothing, nothing applied) and every later frame reports
    # overflowed, so the callers' standard grow+replay-from-first-failure
    # logic recovers with exact window=1 semantics.
    from sonar_3d_reconstruction_tpu.grid.hash import default_batch_budget

    if batch_budget is None:
        batch_budget = default_batch_budget(window, unique_budget)
    window_stats = []
    for wi, w in enumerate(range(0, P, window)):
        # insert_budget may be per-window (a sequence): a fresh map's first
        # window inserts nearly ALL its uniques while later windows insert
        # only newly-swept territory, so deployments compile one "cold" and
        # one snug "warm" apply variant (each distinct value = one program)
        ib = (
            insert_budget[min(wi, len(insert_budget) - 1)]
            if isinstance(insert_budget, (list, tuple))
            else insert_budget
        )
        recs, auxs = _records_window(
            images_dev, T_dev, jnp.int32(w), start, stop,
            tables=tables, cfg=cfg, dtype=dtype,
            unique_budget=unique_budget, window=window,
            dedup_lane_budget=dedup_lane_budget,
        )
        state, stats = _apply_batched(
            state, recs, auxs, cfg=cfg, batch_budget=batch_budget,
            lane_budget=lane_budget, insert_budget=ib,
        )
        window_stats.append(stats)
    return state, {
        k: jnp.concatenate([s[k] for s in window_stats])[:P]
        for k in window_stats[0]
    }


@partial(
    jax.jit,
    static_argnames=("cfg", "brick_budget", "lane_budget", "insert_budget"),
)
def _apply_brick(
    state, recs, auxs, *, cfg: MapperConfig, brick_budget: int,
    lane_budget=None, insert_budget=None,
):
    from sonar_3d_reconstruction_tpu.grid.brick import (
        apply_brick_records_batched,
    )

    return apply_brick_records_batched(
        state, recs, auxs, cfg, brick_budget=brick_budget,
        lane_budget=lane_budget, insert_budget=insert_budget,
    )


def _window_body_brick_compact(
    state,
    images,
    transforms,
    w_start,
    start,
    stop,
    box_min,
    *,
    tables: FanTables,
    cfg: MapperConfig,
    dtype,
    unique_budget: int,
    window: int,
    dedup_lane_budget: int,
    brick_bits: int,
    box_bits,
    brick_budget: int,
    lane_budget=None,
    insert_budget=None,
    vox_budget=None,
    dense_mode: str = "scalar",
    records_batch: int = 1,
):
    """Records + apply for one window (compact box-key path) — the traced
    BODY shared by the one-window program (_window_step_brick_compact)
    and the multi-window group program (_multi_window_step_brick_compact).

    ``records_batch`` (static) groups the per-frame records computation:
    1 keeps today's sequential ``lax.map`` over frames (byte-identical
    HLO — the warm-cache contract); B > 1 vmaps the records body over
    groups of B frames, shrinking the loop's per-iteration overhead and
    batching the per-frame sorts, at B× the records intermediates in
    device memory.  ``window % records_batch == 0`` required.
    Results are identical either way: the body is per-frame pure and
    every op in it (sorts, scans, gathers) is row-independent under
    vmap."""
    from sonar_3d_reconstruction_tpu.grid.brick import (
        apply_brick_records_compact,
    )
    from sonar_3d_reconstruction_tpu.ops.records import frame_records

    def body(i):
        idx = w_start + i
        image = jax.lax.dynamic_index_in_dim(images, idx, 0, keepdims=False)
        T = jax.lax.dynamic_index_in_dim(transforms, idx, 0, keepdims=False)
        frame_on = (idx >= start) & (idx < stop)
        return frame_records(
            image, T, tables, cfg, unique_budget, dtype, frame_on=frame_on,
            dedup_lane_budget=dedup_lane_budget, brick_bits=brick_bits,
            box_min=box_min, box_bits=box_bits,
        )

    if records_batch == 0:
        # FULL UNROLL: one copy of the per-frame body per window frame in
        # one program — no while machinery and no vmapped-sort padding (the
        # records_batch>1 trade-off).  The price is compile time (the
        # body is compiled per frame instead of once) — measured, not
        # assumed, like every knob here.
        outs = [body(jnp.int32(i)) for i in range(window)]
        recs, auxs = jax.tree_util.tree_map(
            lambda *xs: jnp.stack(xs), *outs
        )
    elif records_batch == 1:
        recs, auxs = jax.lax.map(body, jnp.arange(window, dtype=jnp.int32))
    else:
        assert window % records_batch == 0, (
            f"records_batch {records_batch} must divide window {window}"
        )
        groups = jnp.arange(window, dtype=jnp.int32).reshape(
            window // records_batch, records_batch
        )
        if groups.shape[0] == 1:
            recs, auxs = jax.vmap(body)(groups[0])
        else:
            recs, auxs = jax.lax.map(jax.vmap(body), groups)
            # (G, B, ...) -> (window, ...), frame order preserved
            recs, auxs = jax.tree_util.tree_map(
                lambda x: x.reshape((window,) + x.shape[2:]), (recs, auxs)
            )
    return apply_brick_records_compact(
        state, recs, auxs, cfg, box_min, box_bits,
        brick_budget=brick_budget, lane_budget=lane_budget,
        insert_budget=insert_budget, vox_budget=vox_budget,
        dense_mode=dense_mode,
    )


_WINDOW_STEP_STATICS = (
    "tables", "cfg", "dtype", "unique_budget", "window",
    "dedup_lane_budget", "brick_bits", "box_bits", "brick_budget",
    "lane_budget", "insert_budget", "vox_budget", "dense_mode",
    "records_batch",
)


@partial(jax.jit, static_argnames=_WINDOW_STEP_STATICS)
def _window_step_brick_compact(
    state, images, transforms, w_start, start, stop, box_min, **kw
):
    """One window in ONE program — see _window_body_brick_compact.
    Fusing records + apply halves the per-window dispatches and keeps the
    records intermediates inside the program (strictly less traffic)."""
    return _window_body_brick_compact(
        state, images, transforms, w_start, start, stop, box_min, **kw
    )


@partial(jax.jit, static_argnames=_WINDOW_STEP_STATICS + ("group",))
def _multi_window_step_brick_compact(
    state, images, transforms, w_start, start, stop, box_mins, *,
    group: int, **kw,
):
    """``group`` consecutive windows chained inside ONE program: the fixed
    per-window host-chain + dispatch cost does not shard, and amortizing it
    over G windows divides it by G.

    ``box_mins`` is (group, 3) — one box origin per sub-window, indexed
    statically.  State flows window -> window exactly as the chained
    dispatches would: the all-or-nothing poison contract is unchanged (a
    failed window poisons the state; later windows in the same program
    see the poison and apply nothing).  Whether XLA's in-program aliasing
    of the big table buffers hits the slow in-place scatter path
    (pipeline.py design note) is what a group A/B measures.
    """
    window = kw["window"]
    # insert_budget may be per-sub-window (a static tuple: the cold first
    # window of a fresh map inserts nearly all its uniques)
    ib = kw.pop("insert_budget", None)
    all_stats = []
    for g in range(group):
        state, stats = _window_body_brick_compact(
            state, images, transforms, w_start + jnp.int32(g * window),
            start, stop, box_mins[g],
            insert_budget=ib[g] if isinstance(ib, tuple) else ib, **kw,
        )
        all_stats.append(stats)
    return state, {
        k: jnp.concatenate([s[k] for s in all_stats]) for k in all_stats[0]
    }


def scan_pings_brick(
    state,
    images: jnp.ndarray,
    transforms: jnp.ndarray,
    start=None,
    stop=None,
    *,
    tables: FanTables,
    cfg: MapperConfig,
    dtype=jnp.float32,
    unique_budget=None,
    window: int = 8,
    brick_budget=None,
    lane_budget=None,
    insert_budget=None,
    vox_budget=None,
    # "bfv" library default: it writes the chain evaluation's layout
    # directly, where scalar pays a dense-buffer relayout copy; the two
    # are bit-identical by test (grid/brick.apply_brick_records_compact)
    dense_mode: str = "bfv",
    dedup_lane_budget=0,
    boxes=None,
    records_batch: int = 1,
    window_group: int = 1,
):
    """Whole ping sequence -> brick map (host-driven window engine; the
    brick backend is window-batched by construction — grid/brick.py — and
    window=1 degenerates to per-ping apply).  Budgets/overflow contract
    mirror scan_pings_hash.

    ``window_group`` > 1 (compact box-key path only) chains G consecutive
    windows inside ONE compiled program
    (_multi_window_step_brick_compact), dividing the fixed per-window
    host-chain + dispatch cost by G.  Results are identical: state flows
    window -> window exactly as chained dispatches, including the poison
    contract.  A short tail (< G windows) runs a smaller group program.

    ``boxes``: optional ``(box_mins (n_windows, 3) int32, (ax, ay, az))``
    from ops/packing.compute_window_boxes (the host gate proves coverage)
    — switches records + apply to the single-u32 box-relative key engine
    (~3x less sort traffic at identical results).  ``None`` keeps the
    global two-word keys.  The window partition here is
    ``range(0, P, window)`` — box_mins must be computed for the SAME
    partition (window index ``wi`` uses ``box_mins[wi]``).
    """
    from sonar_3d_reconstruction_tpu.grid.brick import (
        check_dense_mode,
        default_brick_budget,
    )
    from sonar_3d_reconstruction_tpu.grid.hash import default_unique_budget

    check_dense_mode(dense_mode)
    P = images.shape[0]
    if P == 0:
        return state, {}
    start = jnp.int32(0) if start is None else jnp.asarray(start, jnp.int32)
    stop = jnp.int32(P) if stop is None else jnp.asarray(stop, jnp.int32)
    window = min(window, P)
    # records_batch must divide the (possibly clamped) window; snap to the
    # gcd so short sequences never fail on a perf-only knob (0 = full
    # unroll, passed through unchanged)
    if records_batch != 0:
        records_batch = max(1, math.gcd(int(records_batch), window))
    if unique_budget is None:
        unique_budget = default_unique_budget(
            tables.candidates_per_ping(cfg.occupied_window)
        )
    if brick_budget is None:
        brick_budget = default_brick_budget(window, unique_budget)

    images_dev = jnp.asarray(images)
    T_dev = jnp.asarray(transforms, dtype)
    bb = state.brick_bits

    box_mins, box_bits = (None, None) if boxes is None else (
        np.asarray(boxes[0], np.int32), tuple(boxes[1])
    )

    def _ib(wi):
        return (
            insert_budget[min(wi, len(insert_budget) - 1)]
            if isinstance(insert_budget, (list, tuple))
            else insert_budget
        )

    common = dict(
        tables=tables, cfg=cfg, dtype=dtype, unique_budget=unique_budget,
        window=window, dedup_lane_budget=dedup_lane_budget, brick_bits=bb,
        box_bits=box_bits, brick_budget=brick_budget,
        lane_budget=lane_budget, vox_budget=vox_budget,
        dense_mode=dense_mode, records_batch=records_batch,
    )
    wins = list(range(0, P, window))
    if box_bits is not None and window_group > 1:
        window_stats = []
        wi = 0
        while wi < len(wins):
            g = min(window_group, len(wins) - wi)
            if g > 1:
                state, stats = _multi_window_step_brick_compact(
                    state, images_dev, T_dev, jnp.int32(wins[wi]), start,
                    stop, jnp.asarray(box_mins[wi:wi + g]), group=g,
                    insert_budget=tuple(_ib(wi + k) for k in range(g)),
                    **common,
                )
            else:
                state, stats = _window_step_brick_compact(
                    state, images_dev, T_dev, jnp.int32(wins[wi]), start,
                    stop, jnp.asarray(box_mins[wi]),
                    insert_budget=_ib(wi), **common,
                )
            window_stats.append(stats)
            wi += g
        return state, {
            k: jnp.concatenate([s[k] for s in window_stats])[:P]
            for k in window_stats[0]
        }

    window_stats = []
    for wi, w in enumerate(wins):
        ib = _ib(wi)
        box_min = (
            None if box_mins is None else jnp.asarray(box_mins[wi])
        )
        if box_bits is not None:
            # fused records+apply: one dispatch per window
            state, stats = _window_step_brick_compact(
                state, images_dev, T_dev, jnp.int32(w), start, stop,
                box_min, insert_budget=ib, **common,
            )
        else:
            recs, auxs = _records_window(
                images_dev, T_dev, jnp.int32(w), start, stop, box_min,
                tables=tables, cfg=cfg, dtype=dtype,
                unique_budget=unique_budget, window=window,
                dedup_lane_budget=dedup_lane_budget, brick_bits=bb,
                box_bits=box_bits,
            )
            state, stats = _apply_brick(
                state, recs, auxs, cfg=cfg, brick_budget=brick_budget,
                lane_budget=lane_budget, insert_budget=ib,
            )
        window_stats.append(stats)
    return state, {
        k: jnp.concatenate([s[k] for s in window_stats])[:P]
        for k in window_stats[0]
    }


@partial(jax.jit, static_argnames=("tables", "spec", "cfg", "dtype"))
def dense_ping_step(
    state,
    images: jnp.ndarray,
    transforms: jnp.ndarray,
    idx,
    *,
    tables: FanTables,
    spec: DenseGridSpec,
    cfg: MapperConfig,
    dtype=jnp.float32,
):
    image = jax.lax.dynamic_index_in_dim(images, idx, 0, keepdims=False)
    T = jax.lax.dynamic_index_in_dim(transforms, idx, 0, keepdims=False)
    cand = backproject_ping(image, T, tables, cfg, dtype=dtype)
    return update_dense_grid(state, cand, spec, cfg)


def scan_pings_dense(
    state,
    images: jnp.ndarray,
    transforms: jnp.ndarray,
    *,
    tables: FanTables,
    spec: DenseGridSpec,
    cfg: MapperConfig,
    dtype=jnp.float32,
):
    """Whole ping sequence -> dense bounded map (host-driven step chain)."""
    P = images.shape[0]
    images = jnp.asarray(images)
    transforms = jnp.asarray(transforms, dtype)
    per_step = []
    for i in range(P):
        state, stats = dense_ping_step(
            state, images, transforms, jnp.int32(i),
            tables=tables, spec=spec, cfg=cfg, dtype=dtype,
        )
        per_step.append(stats)
    stacked = {
        k: jnp.stack([s[k] for s in per_step])
        for k in (per_step[0] if per_step else {})
    }
    return state, stacked


# ---------------------------------------------------------------------------
# Host wrapper: end-to-end sequence mapping with hash growth + replay
# ---------------------------------------------------------------------------

def map_ping_sequence(
    images: np.ndarray,
    positions: np.ndarray,
    quaternions: np.ndarray,
    cfg: Optional[MapperConfig] = None,
    *,
    backend: str = "hash",
    initial_capacity: int = 1 << 20,
    dense_spec: Optional[DenseGridSpec] = None,
    state: Optional[Any] = None,
    dtype=jnp.float32,
    max_grow_retries: int = 12,
    window: int = 1,
    unique_budget: Optional[int] = None,
    effective: Optional[Dict[str, int]] = None,
    fan_cap: Any = "auto",
    window_cap: Any = "auto",
    free_cap: Any = "auto",
    box_min_bits=None,
    budgets: Optional[Dict[str, Any]] = None,
) -> Tuple[Any, Dict[str, np.ndarray]]:
    """Map a whole recorded ping sequence in one (or, after growth, few) scans.

    Args:
      images: (P, range_bins, bearing_bins) polar intensity images.
      positions / quaternions: (P, 3) and (P, 4) odometry poses
        (reference /fast_lio/odometry stream).
      state: resume from an existing map state (default: fresh).
      budgets: optional deployment budget plan (utils/autotune.tune_sequence
        or the CLI's `tune` output): snug unique/brick/batch, apply-side
        lane/insert/vox/dedup-slice budgets, capacity, and dense_mode.  A
        stale plan is safe — the first overflow drops the snug extras and
        replays under the normal cause-attributed growth.  The plan's
        backend/window must match (asserted).
      effective: optional dict the hash backend fills with the settings the
        sequence settled on after growth ({unique_budget, batch_budget,
        capacity, fan_cap}) — callers that re-drive scan_pings_hash directly
        (bench, resumed replays) must reuse these or the first window
        overflows.
      fan_cap: "auto" (default) sizes the static occupied-fan width exactly
        for THESE images on the host (ops/backproject.required_fan_cap) —
        returns that stop short of max_range shrink the candidate lattice
        substantially; an int forces a width; 0/None uses the max_range
        worst case.  All choices are exactly equivalent for the given
        images; they differ only in compiled-program shape.
      window_cap: "auto" (default) sizes the static occupied-window depth
        exactly for THESE images (ops/backproject.required_window_cap) —
        a return slab thinner than cfg.occupied_window shrinks the
        dominant lattice axis; an int forces a depth; 0/None uses the
        config worst case.  Same exact-equivalence contract as fan_cap.
      free_cap: "auto" (default) sizes the static free-lattice depth
        exactly for THESE images (ops/backproject.required_free_cap) —
        free bins at/past the deepest first hit are statically dead, and
        the free lattice shrinks ~quadratically with the cap.  Same
        exact-equivalence contract.

    Returns (final_state, per-ping stats dict of (P,) arrays).
    """
    cfg = cfg or MapperConfig()
    from sonar_3d_reconstruction_tpu.grid import check_state_backend

    if backend not in ("hash", "brick", "dense"):
        raise ValueError(f"unknown backend {backend!r}")
    check_state_backend(state, backend)
    images = np.asarray(images)
    P, R, B = images.shape
    if P == 0:
        empty_i = np.zeros((0,), np.int32)
        empty_b = np.zeros((0,), bool)
        if backend == "dense":
            # same empty-stats shape scan_pings_dense produces for P == 0,
            # and a dense state the caller can resume/extract from
            if state is None:
                if dense_spec is None:
                    reach = cfg.max_range + 2.0
                    dense_spec = DenseGridSpec.for_world_bounds(
                        (-reach,) * 3, (reach,) * 3, cfg.voxel_resolution
                    )
                state = init_dense_grid(dense_spec, dtype)
            return state, {}
        if state is None and backend == "brick":
            from sonar_3d_reconstruction_tpu.grid.brick import init_brick_grid

            state = init_brick_grid(1 << 15, dtype)
        return (
            state if state is not None
            else init_hash_grid(initial_capacity, dtype),
            {
                "num_occupied": empty_i, "num_free": empty_i,
                "num_candidates": empty_i, "overflowed": empty_b,
                "unique_overflow": empty_b, "range_fail": empty_b,
            },
        )
    from sonar_3d_reconstruction_tpu.ops.backproject import (
        resolve_capped_tables,
    )

    tables = resolve_capped_tables(
        images, cfg, R, B, fan_cap=fan_cap, window_cap=window_cap,
        free_cap=free_cap,
    )
    T = batched_sonar_to_world(positions, quaternions, cfg)

    images_dev = jnp.asarray(images)
    T_dev = jnp.asarray(T, dtype)

    if backend == "dense":
        if dense_spec is None:
            reach = cfg.max_range + 2.0
            dense_spec = DenseGridSpec.for_world_bounds(
                (-reach,) * 3, (reach,) * 3, cfg.voxel_resolution
            )
        st = state if state is not None else init_dense_grid(dense_spec, dtype)
        st, stats = scan_pings_dense(
            st, images_dev, T_dev, tables=tables, spec=dense_spec, cfg=cfg,
            dtype=dtype,
        )
        return st, {k: np.asarray(v) for k, v in stats.items()}

    if budgets is not None:
        # real errors, not asserts: a mismatched plan under python -O would
        # otherwise be silently applied (e.g. a brick capacity used as a
        # hash slot count)
        if budgets.get("backend", backend) != backend:
            raise ValueError(
                f"budget plan was tuned for backend="
                f"{budgets.get('backend')!r}, not {backend!r}"
            )
        if budgets.get("window", window) != window:
            raise ValueError(
                f"budget plan was tuned for window="
                f"{budgets.get('window')}, not {window}"
            )
        if unique_budget is None:
            unique_budget = budgets.get("unique_budget")

    if backend == "brick":
        if state is None and budgets is not None and budgets.get("capacity"):
            from sonar_3d_reconstruction_tpu.grid.brick import init_brick_grid

            state = init_brick_grid(int(budgets["capacity"]), dtype)
        return _map_ping_sequence_brick(
            images_dev, T_dev, cfg, tables=tables, state=state,
            dtype=dtype, window=max(window, 1),
            unique_budget=unique_budget, effective=effective,
            max_grow_retries=max_grow_retries,
            sonar_positions=T[:, :3, 3], box_min_bits=box_min_bits,
            budgets=budgets,
        )

    if backend != "hash":
        raise ValueError(f"unknown backend {backend!r}")
    window = max(window, 1)  # same sanitation as the brick branch

    from sonar_3d_reconstruction_tpu.grid.hash import (
        default_batch_budget,
        default_unique_budget,
    )

    if unique_budget is None:
        # resolve the snug default HERE so growth doubles from the budget
        # actually in effect, not from DEFAULT_UNIQUE_BUDGET (which can
        # over-allocate records lanes by >8x after one overflow)
        unique_budget = default_unique_budget(
            tables.candidates_per_ping(cfg.occupied_window)
        )

    def _report(final_state) -> None:
        if effective is not None:
            effective["unique_budget"] = unique_budget
            effective["batch_budget"] = (
                batch_budget
                if batch_budget is not None
                else default_batch_budget(min(window, P), unique_budget)
            )
            effective["capacity"] = final_state.key_hi.shape[0]
            effective["fan_cap"] = tables.nvo_cap
            effective["window_cap"] = tables.effective_window(
                cfg.occupied_window
            )
            effective["free_cap"] = tables.free_cap

    if state is None and budgets is not None and budgets.get("capacity"):
        initial_capacity = int(budgets["capacity"])
    st = state if state is not None else init_hash_grid(initial_capacity, dtype)
    merged: Dict[str, np.ndarray] = {}
    start = 0
    batch_budget = None
    extras: Dict[str, Any] = {}
    if budgets is not None:
        batch_budget = budgets.get("batch_budget")
        extras = {
            "lane_budget": budgets.get("lane_budget"),
            "insert_budget": budgets.get("insert_budget"),
            "dedup_lane_budget": budgets.get("dedup_lane_budget") or 0,
        }
    for _ in range(max_grow_retries):
        new_st, stats = scan_pings_hash(
            st, images_dev, T_dev, jnp.int32(start),
            tables=tables, cfg=cfg, dtype=dtype, unique_budget=unique_budget,
            window=window, batch_budget=batch_budget, **extras,
        )
        over = np.asarray(stats["overflowed"])
        # merge this attempt's stats for frames it actually applied
        applied_hi = P if not over.any() else int(np.argmax(over))
        for k, v in stats.items():
            arr = merged.setdefault(
                k, np.zeros((P,), np.asarray(v).dtype)
            )
            arr[start:applied_hi] = np.asarray(v)[start:applied_hi]
        if not over.any():
            _report(new_st)
            return new_st, merged
        # grow and replay from the first failed frame.  With window > 1 the
        # batch is rejected all-or-nothing, so the CAUSE flags may sit at a
        # later frame than argmax(overflowed) — inspect the whole failed tail.
        start = applied_hi
        tail = slice(applied_hi, None)
        if bool(np.asarray(stats["range_fail"])[tail].any()):
            raise ValueError(
                f"frame >= {applied_hi}: voxel keys outside the packable "
                "±2^19-cell range (±26 km at 5 cm) — check odometry frame "
                "offsets; growing the table cannot fix this"
            )
        if extras:
            # a snug budget plan proved stale: drop ALL plan values first
            # (they are sized together) and replay at the safe pre-tuning
            # budgets before any growth
            extras = {}
            if budgets is not None:
                unique_budget = int(
                    budgets.get("safe_unique_budget") or unique_budget * 2
                )
                batch_budget = budgets.get("safe_batch_budget")
            st = new_st._replace(poisoned=jnp.zeros((), bool))
            continue
        if bool(np.asarray(stats["unique_overflow"])[tail].any()):
            # per-frame budget too small: double it and re-derive the batch
            # budget from the new value
            unique_budget *= 2
            batch_budget = None
            st = new_st._replace(poisoned=jnp.zeros((), bool))
        elif "batch_overflow" in stats and bool(
            np.asarray(stats["batch_overflow"])[tail].any()
        ):
            # cross-window budget too small: double only it (recompiles only
            # the apply program, not the per-ping records pipeline)
            if batch_budget is None:
                batch_budget = default_batch_budget(
                    min(window, P), unique_budget
                )
            batch_budget *= 2
            st = new_st._replace(poisoned=jnp.zeros((), bool))
        else:
            st = rehash(new_st, new_capacity=new_st.key_hi.shape[0] * 2)
    raise RuntimeError(
        f"hash capacity growth did not converge after {max_grow_retries} retries"
    )


def _map_ping_sequence_brick(
    images_dev,
    T_dev,
    cfg: MapperConfig,
    *,
    tables: FanTables,
    state,
    dtype,
    window: int,
    unique_budget: Optional[int],
    effective: Optional[Dict[str, int]],
    max_grow_retries: int,
    sonar_positions=None,
    box_min_bits=None,
    budgets: Optional[Dict[str, Any]] = None,
) -> Tuple[Any, Dict[str, np.ndarray]]:
    """Brick-backend host wrapper: grow-and-replay with cause attribution
    (unique / brick+lane / insert budget / capacity), mirroring the hash
    branch of map_ping_sequence.

    ``sonar_positions`` (host (P, 3) float64 sonar-frame origins, i.e.
    T_sonar_to_world translations): enables the compact box-key engine
    when the per-window voxel extents fit a u32
    (ops/packing.compute_window_boxes — on typical surveys they do)."""
    from sonar_3d_reconstruction_tpu.grid.brick import (
        default_brick_budget,
        init_brick_grid,
        rehash_bricks,
    )
    from sonar_3d_reconstruction_tpu.grid.hash import default_unique_budget
    from sonar_3d_reconstruction_tpu.ops.packing import compute_window_boxes

    P = images_dev.shape[0]
    if unique_budget is None:
        unique_budget = default_unique_budget(
            tables.candidates_per_ping(cfg.occupied_window)
        )
    st = state if state is not None else init_brick_grid(1 << 15, dtype)
    boxes = None
    if sonar_positions is not None:
        boxes = compute_window_boxes(
            sonar_positions, cfg.max_range, cfg.voxel_resolution,
            min(window, P), st.brick_bits,
            frame_bits=max(1, (min(window, P) - 1).bit_length()),
            min_bits=box_min_bits,
        )
    merged: Dict[str, np.ndarray] = {}
    start = 0
    brick_budget = None
    extras: Dict[str, Any] = {}
    plan_active = False
    if budgets is not None:
        brick_budget = budgets.get("brick_budget")
        extras = {
            "lane_budget": budgets.get("lane_budget"),
            "insert_budget": budgets.get("insert_budget"),
            "vox_budget": budgets.get("vox_budget"),
            "dense_mode": budgets.get("dense_mode", "bfv"),
            "dedup_lane_budget": budgets.get("dedup_lane_budget") or 0,
        }
        plan_active = True
    for _ in range(max_grow_retries):
        new_st, stats = scan_pings_brick(
            st, images_dev, T_dev, jnp.int32(start),
            tables=tables, cfg=cfg, dtype=dtype,
            unique_budget=unique_budget, window=window,
            brick_budget=brick_budget, boxes=boxes, **extras,
        )
        over = np.asarray(stats["overflowed"])
        applied_hi = P if not over.any() else int(np.argmax(over))
        for k, v in stats.items():
            arr = merged.setdefault(k, np.zeros((P,), np.asarray(v).dtype))
            arr[start:applied_hi] = np.asarray(v)[start:applied_hi]
        if not over.any():
            if effective is not None:
                effective["unique_budget"] = unique_budget
                effective["brick_budget"] = (
                    brick_budget
                    if brick_budget is not None
                    else default_brick_budget(min(window, P), unique_budget)
                )
                effective["capacity"] = new_st.capacity
                effective["fan_cap"] = tables.nvo_cap
                effective["window_cap"] = tables.effective_window(
                    cfg.occupied_window
                )
                effective["free_cap"] = tables.free_cap
                effective["box_bits"] = None if boxes is None else boxes[1]
            return new_st, merged
        start = applied_hi
        tail = slice(applied_hi, None)
        if bool(np.asarray(stats["range_fail"])[tail].any()):
            raise ValueError(
                f"frame >= {applied_hi}: voxel keys outside the packable "
                "range — check odometry frame offsets; growth cannot fix this"
            )
        if bool(np.asarray(stats["pack_overflow"])[tail].any()):
            raise ValueError(
                f"frame >= {applied_hi}: a voxel received 2^16+ emissions "
                "in one frame (count packing width) — use backend='hash' "
                "for this degenerate geometry"
            )
        if plan_active:
            # a snug budget plan proved stale: drop ALL plan values first
            # (they are sized together) and replay at the safe pre-tuning
            # budgets before any growth (keep dense_mode — it is a
            # representation choice, not a size)
            plan_active = False
            extras = {"dense_mode": extras.get("dense_mode", "bfv")}
            unique_budget = int(
                budgets.get("safe_unique_budget") or unique_budget * 2
            )
            brick_budget = budgets.get("safe_brick_budget")
            st = new_st._replace(poisoned=jnp.zeros((), bool))
            continue
        if bool(np.asarray(stats["unique_overflow"])[tail].any()):
            unique_budget *= 2
            brick_budget = None
            st = new_st._replace(poisoned=jnp.zeros((), bool))
        elif bool(np.asarray(stats["batch_overflow"])[tail].any()):
            if brick_budget is None:
                brick_budget = default_brick_budget(
                    min(window, P), unique_budget
                )
            brick_budget *= 2
            st = new_st._replace(poisoned=jnp.zeros((), bool))
        else:
            st = rehash_bricks(new_st, new_capacity=new_st.capacity * 2)
    raise RuntimeError(
        f"brick growth did not converge after {max_grow_retries} retries"
    )
