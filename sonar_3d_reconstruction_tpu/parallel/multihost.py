"""Multi-host (DCN) ping-stream sharding via precomputed frame records.

SURVEY.md 5.8: across hosts the natural axis is the PING STREAM — but the
adaptive log-odds update reads pre-frame state (3d_mapper.py:95-102), so raw
map merges are order-dependent and inexact.  The exact decomposition used
here follows from the records split (ops/records.py):

  * a frame's unique-voxel records are STATE-INDEPENDENT — any host can
    compute records for its bag segment with zero communication;
  * only the cheap per-frame APPLY (lookup/insert/adaptive-average, ~U keys)
    must run sequentially in stream order on the host that owns the map.

So: every host calls ``records_for_segment`` on its slice of the bag
(the expensive 95% — backprojection, packing, sort-dedup), ships the compact
records (a few MB per frame) over DCN, and one host folds them in order with
``apply_record_segments``.  Results are bit-identical to single-host
processing of the whole bag.

This module is mesh-free (plain host-level parallelism); device-mesh
parallelism is parallel/shard.py.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

import functools

import numpy as np

import jax
import jax.numpy as jnp

from sonar_3d_reconstruction_tpu.config import MapperConfig
from sonar_3d_reconstruction_tpu.grid.hash import (
    HashGridState,
    default_unique_budget,
)
from sonar_3d_reconstruction_tpu.ops.backproject import build_fan_tables
from sonar_3d_reconstruction_tpu.ops.dedup import UniqueRecords
from sonar_3d_reconstruction_tpu.ops.records import FrameAux
from sonar_3d_reconstruction_tpu.pipeline import (
    _apply_batched,
    _records_single,
    batched_sonar_to_world,
)


@functools.partial(
    jax.jit, static_argnames=("cfg", "brick_budget")
)
def _apply_brick_batched(state, recs, auxs, *, cfg, brick_budget):
    from sonar_3d_reconstruction_tpu.grid.brick import (
        apply_brick_records_batched,
    )

    return apply_brick_records_batched(
        state, recs, auxs, cfg, brick_budget=brick_budget
    )


def _empty_records(unique_budget: int, dtype) -> Tuple[UniqueRecords, FrameAux]:
    u = unique_budget
    return (
        UniqueRecords(
            hi=np.full((0, u), 0xFFFFFFFF, np.uint32),
            lo=np.full((0, u), 0xFFFFFFFF, np.uint32),
            count=np.zeros((0, u), np.int32),
            n_occ=np.zeros((0, u), np.int32),
            valid=np.zeros((0, u), bool),
            n_unique=np.zeros((0,), np.int32),
        ),
        FrameAux(
            cmin=np.zeros((0, 3)),
            cmax=np.zeros((0, 3)),
            range_fail=np.zeros((0,), bool),
            n_valid=np.zeros((0,), np.int32),
        ),
    )


def records_for_segment(
    images: np.ndarray,
    positions: np.ndarray,
    quaternions: np.ndarray,
    cfg: MapperConfig,
    *,
    unique_budget: Optional[int] = None,
    dtype=jnp.float32,
    brick_bits: int = 0,
) -> Tuple[UniqueRecords, FrameAux]:
    """Records for a contiguous bag segment (host-local, no map state).

    Returns stacked (UniqueRecords, FrameAux) with leading axis = number of
    pings, as HOST numpy pytrees ready to ship over DCN.  ``brick_bits``
    > 0 produces brick-major keys for a BrickGridState fold.
    """
    images = np.asarray(images)
    P = images.shape[0]
    if P == 0:
        return _empty_records(unique_budget or 8, dtype)
    R, B = images.shape[1:]
    tables = build_fan_tables(cfg, R, B)
    if unique_budget is None:
        unique_budget = default_unique_budget(
            tables.candidates_per_ping(cfg.occupied_window)
        )
    T = batched_sonar_to_world(positions, quaternions, cfg)
    images_dev = jnp.asarray(images)
    T_dev = jnp.asarray(T, dtype)

    chunks = []
    for i in range(P):
        chunks.append(
            _records_single(
                images_dev, T_dev, jnp.int32(i), jnp.int32(0), jnp.int32(P),
                tables=tables, cfg=cfg, dtype=dtype,
                unique_budget=unique_budget, brick_bits=brick_bits,
            )
        )
    recs = jax.tree_util.tree_map(
        lambda *xs: np.stack([np.asarray(x) for x in xs]),
        *[c[0] for c in chunks],
    )
    auxs = jax.tree_util.tree_map(
        lambda *xs: np.stack([np.asarray(x) for x in xs]),
        *[c[1] for c in chunks],
    )
    return UniqueRecords(*recs), FrameAux(*auxs)


def apply_record_segments(
    state: HashGridState,
    segments: Iterable[Tuple[UniqueRecords, FrameAux]],
    cfg: MapperConfig,
    *,
    window: int = 8,
    batch_budget: Optional[int] = None,
    start: int = 0,
) -> Tuple[HashGridState, List[dict]]:
    """Fold precomputed record segments into the map IN ORDER.

    ``segments`` must be ordered by stream time (segment s's last ping
    precedes segment s+1's first).  Returns (state, list of per-frame stats
    dicts).  A poisoned frame (overflow) poisons the rest — the caller grows
    capacity / unique budget / batch budget and replays from the first
    failed frame, exactly as pipeline.map_ping_sequence does (the
    ``map_ping_sequence_multihost`` wrapper below implements that loop).

    ``start`` skips the first ``start`` frames (across segments) — the
    replay cursor.  Window re-alignment at the replay point is exact: the
    batched apply preserves per-frame sequential semantics regardless of
    window boundaries.  ``batch_budget`` overrides the per-window distinct-
    voxel budget (default: the snug ``min(w*u, 4*u)``).
    """
    all_stats: List[dict] = []
    skip = int(start)
    for recs, auxs in segments:
        if skip:
            P_seg = recs.hi.shape[0]
            take = min(skip, P_seg)
            skip -= take
            if take == P_seg:
                continue
            recs = jax.tree_util.tree_map(lambda x: x[take:], recs)
            auxs = jax.tree_util.tree_map(lambda x: x[take:], auxs)
        P = recs.hi.shape[0]
        if P == 0:
            continue
        w = min(window, P)
        pad = (-P) % w
        if pad:
            def padder(x):
                fill = np.zeros((pad,) + x.shape[1:], x.dtype)
                if x.dtype == np.uint32:
                    fill[:] = np.uint32(0xFFFFFFFF)  # EMPTY_HI lanes
                return np.concatenate([np.asarray(x), fill])

            # padded frames carry EMPTY keys / False valid / zero counts -> no-ops
            recs = UniqueRecords(*(padder(x) for x in recs))
            auxs = FrameAux(
                cmin=np.concatenate(
                    [np.asarray(auxs.cmin), np.full((pad, 3), np.inf)]
                ),
                cmax=np.concatenate(
                    [np.asarray(auxs.cmax), np.full((pad, 3), -np.inf)]
                ),
                range_fail=np.concatenate(
                    [np.asarray(auxs.range_fail), np.zeros(pad, bool)]
                ),
                n_valid=np.concatenate(
                    [np.asarray(auxs.n_valid), np.zeros(pad, np.int32)]
                ),
            )
        recs_dev = jax.tree_util.tree_map(jnp.asarray, recs)
        auxs_dev = jax.tree_util.tree_map(jnp.asarray, auxs)
        u = recs.hi.shape[1]
        brick = hasattr(state, "brick_volume")
        if brick:
            from sonar_3d_reconstruction_tpu.grid.brick import (
                default_brick_budget,
            )
        for b in range(0, P + pad, w):
            rec_w = jax.tree_util.tree_map(lambda x: x[b : b + w], recs_dev)
            aux_w = jax.tree_util.tree_map(lambda x: x[b : b + w], auxs_dev)
            if brick:
                # records must carry brick-major keys
                # (records_for_segment(brick_bits=state.brick_bits))
                state, stats = _apply_brick_batched(
                    state, rec_w, aux_w, cfg=cfg,
                    brick_budget=batch_budget
                    or default_brick_budget(w, u),
                )
            else:
                state, stats = _apply_batched(
                    state, rec_w, aux_w, cfg=cfg,
                    batch_budget=batch_budget or min(w * u, 4 * u),
                )
            for i in range(min(w, P - b)):
                all_stats.append(
                    {k: np.asarray(v)[i] for k, v in stats.items()}
                )
    return state, all_stats


def map_ping_sequence_multihost(
    images: np.ndarray,
    positions: np.ndarray,
    quaternions: np.ndarray,
    cfg: Optional[MapperConfig] = None,
    *,
    n_hosts: int = 2,
    window: int = 8,
    dtype=jnp.float32,
    initial_capacity: int = 1 << 20,
    state: Optional[HashGridState] = None,
    unique_budget: Optional[int] = None,
    batch_budget: Optional[int] = None,
    max_grow_retries: int = 12,
    backend: str = "hash",
) -> Tuple[HashGridState, List[dict]]:
    """map_ping_sequence-grade host wrapper for the DCN decomposition:
    split the ping stream into ``n_hosts`` contiguous
    segments, compute each segment's records independently (what each host
    would do with its bag slice), fold them in stream order, and on any
    overflow grow the RIGHT knob and replay from the first failed frame:

      * ``unique_overflow``  -> double the per-frame unique budget and
        RECOMPUTE the records (they are budget-shaped — in deployment the
        owning host broadcasts the new budget to the record producers);
      * ``batch_overflow``   -> double the apply's window budget (records
        are reused — only the fold re-runs);
      * capacity / bucket    -> rehash the map 2x (records reused);
      * ``range_fail``       -> raise (growth cannot fix an unpackable key).

    Results are bit-identical to pipeline.map_ping_sequence on the same
    inputs (``backend="hash"`` or ``"brick"`` — record segments carry the
    matching key layout and the fold applies to the matching table).
    Returns (state, per-frame stats dicts for all applied frames).
    """
    from sonar_3d_reconstruction_tpu.grid import check_state_backend
    from sonar_3d_reconstruction_tpu.grid.hash import init_hash_grid, rehash

    cfg = cfg or MapperConfig()
    # fail fast on a resumed state whose type contradicts the backend: the
    # record key layout below is chosen by ``backend`` while the apply
    # dispatches on the state type — a mismatch would corrupt silently
    check_state_backend(state, backend)
    images = np.asarray(images)
    P = images.shape[0]
    if backend == "brick":
        from sonar_3d_reconstruction_tpu.grid.brick import (
            DEFAULT_BRICK_BITS,
            init_brick_grid,
        )

        brick_bits = (
            state.brick_bits if state is not None else DEFAULT_BRICK_BITS
        )
        st = state if state is not None else init_brick_grid(
            max(128, initial_capacity >> 4), dtype
        )
    else:
        brick_bits = 0
        st = state if state is not None else init_hash_grid(
            initial_capacity, dtype
        )
    if P == 0:
        return st, []
    bounds = np.linspace(0, P, n_hosts + 1).astype(int)

    def compute_segments(ub):
        return [
            records_for_segment(
                images[a:b], positions[a:b], quaternions[a:b], cfg,
                unique_budget=ub, dtype=dtype, brick_bits=brick_bits,
            )
            for a, b in zip(bounds[:-1], bounds[1:])
            if b > a
        ]

    segments = compute_segments(unique_budget)
    applied: List[dict] = [None] * P
    start = 0
    for _ in range(max_grow_retries):
        new_st, stats = apply_record_segments(
            st, segments, cfg, window=window, batch_budget=batch_budget,
            start=start,
        )
        over = [bool(s["overflowed"]) for s in stats]
        n_ok = len(stats) if True not in over else over.index(True)
        for i in range(n_ok):
            applied[start + i] = stats[i]
        if True not in over:
            return new_st, applied
        tail = stats[n_ok:]
        start = start + n_ok
        if any(bool(s["range_fail"]) for s in tail):
            raise ValueError(
                f"frame >= {start}: voxel keys outside the packable range "
                "— check odometry frame offsets; growth cannot fix this"
            )
        if any(bool(s.get("pack_overflow", False)) for s in tail):
            raise ValueError(
                "a voxel received 2^16+ emissions in one frame — use "
                "backend='hash' for this degenerate geometry"
            )
        if any(bool(s["unique_overflow"]) for s in tail):
            if unique_budget is None:
                R, B = images.shape[1:]
                tables = build_fan_tables(cfg, R, B)
                unique_budget = default_unique_budget(
                    tables.candidates_per_ping(cfg.occupied_window)
                )
            unique_budget *= 2
            batch_budget = None
            segments = compute_segments(unique_budget)
            st = new_st._replace(poisoned=jnp.zeros((), bool))
        elif any(bool(s.get("batch_overflow", False)) for s in tail):
            if batch_budget is None:
                u = segments[0][0].hi.shape[1]
                w = min(window, P)
                if backend == "brick":
                    from sonar_3d_reconstruction_tpu.grid.brick import (
                        default_brick_budget,
                    )

                    batch_budget = default_brick_budget(w, u)
                else:
                    batch_budget = min(w * u, 4 * u)
            batch_budget *= 2
            st = new_st._replace(poisoned=jnp.zeros((), bool))
        elif backend == "brick":
            from sonar_3d_reconstruction_tpu.grid.brick import rehash_bricks

            st = rehash_bricks(new_st, new_st.capacity * 2)
        else:
            st = rehash(new_st, new_capacity=new_st.key_hi.shape[0] * 2)
    raise RuntimeError(
        f"multihost growth did not converge after {max_grow_retries} retries"
    )
