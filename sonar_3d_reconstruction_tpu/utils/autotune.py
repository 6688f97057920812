"""Deployment budget tuning: measured snug budgets for a survey.

The engines run fastest with NON-DEFAULT budgets sized to the sensor /
environment: every apply-side indexed op, the window sort, and the dedup
compaction slice scale with them.  The bench has always tuned itself from a warmup run's measured stats;
this module makes the same machinery a user-facing feature:

    plan = tune_sequence(images, positions, quats, cfg)   # one warmup
    state, stats = map_ping_sequence(..., budgets=plan)    # tuned runs
    # or: python -m sonar_3d_reconstruction_tpu tune BAG --out plan.json
    #     python -m sonar_3d_reconstruction_tpu map-bag BAG --budgets plan.json

Budgets derive from emission counts, which are platform-independent and
deterministic for given inputs, so a plan tuned on CPU is valid on the GPU.
A stale plan can only cost a growth replay (every overflow is detected and
cause-attributed), never correctness.  Reference anchor: the reference has
no analog — its dict store has no static shapes to size (SimpleOctree,
scripts/3d_mapper.py:19-194); this is the static-shape deployment knob.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np


def _round_up(x, m=8192):
    return int(-(-x // m) * m)


def snug_budgets_hash(
    stats: Dict[str, np.ndarray], window: int, unique_budget: int,
    batch_budget: int,
) -> Dict[str, Any]:
    """Snug budgets for the hash backend from a warmup run's stats.

    Margins match the bench's long-validated formulas: 1.25x uniques
    (rounded to 8192), 1.1x valid candidates for the dedup slice, 1.15x
    batch/insert, with a [cold, warm] insert schedule (a fresh map's first
    window inserts nearly everything)."""
    out: Dict[str, Any] = {
        "unique_budget": unique_budget,
        "batch_budget": batch_budget,
        "lane_budget": None,
        "insert_budget": None,
        "dedup_lane_budget": 0,
        "safe_unique_budget": unique_budget,
        "safe_batch_budget": batch_budget,
    }
    per_frame = (np.asarray(stats["num_occupied"])
                 + np.asarray(stats["num_free"])).astype(np.int64)
    max_frame = int(per_frame.max())
    max_valid = int(np.asarray(stats["num_candidates"]).max())
    snug_u = min(_round_up(1.25 * max_frame), unique_budget)
    out["dedup_lane_budget"] = max(_round_up(1.1 * max_valid), snug_u)
    snug_b = batch_budget
    if "batch_n_unique" in stats:
        max_batch = int(np.asarray(stats["batch_n_unique"]).max())
        snug_b = min(_round_up(1.15 * max_batch), batch_budget)
        pad = (-len(per_frame)) % window
        win_lanes = np.pad(per_frame, (0, pad)).reshape(-1, window).sum(axis=1)
        out["lane_budget"] = max(_round_up(1.1 * int(win_lanes.max())), snug_b)
    if "batch_n_need" in stats:
        need = np.asarray(stats["batch_n_need"]).astype(np.int64)
        pad = (-len(need)) % window
        win_need = np.pad(need, (0, pad)).reshape(-1, window).max(axis=1)
        cold = min(_round_up(1.15 * int(win_need[0])), snug_b)
        warm = min(_round_up(1.15 * int(win_need[1:].max())), cold) \
            if len(win_need) > 1 else cold
        out["insert_budget"] = [cold, warm]
    out["unique_budget"] = snug_u
    out["batch_budget"] = snug_b
    return out


def snug_budgets_brick(
    stats: Dict[str, np.ndarray], window: int, unique_budget: int,
    brick_budget: int, dense_mode: str = "scalar",
) -> Dict[str, Any]:
    """Snug budgets for the brick backend from a warmup run's stats.

    Tighter margins than the hash path (1.1x/4096 uniques, 1.05x/4096
    dedup slice): brick emission counts are bit-deterministic for fixed
    inputs and growth+replay protects correctness regardless.  The dedup
    compaction slice only pays while SMALLER than the candidate lattice —
    the caller compares against it."""
    out: Dict[str, Any] = {
        "unique_budget": unique_budget,
        "brick_budget": brick_budget,
        "lane_budget": None,
        "insert_budget": None,
        "vox_budget": None,
        "dedup_lane_budget": 0,
        "safe_unique_budget": unique_budget,
        "safe_brick_budget": brick_budget,
    }
    max_frame = int(
        (np.asarray(stats["num_occupied"])
         + np.asarray(stats["num_free"])).max()
    )
    max_valid = int(np.asarray(stats["num_candidates"]).max())
    snug_u = min(_round_up(1.1 * max_frame, 4096), unique_budget)
    out["dedup_lane_budget"] = max(_round_up(1.05 * max_valid, 4096), snug_u)
    out["brick_budget"] = min(
        _round_up(1.15 * int(np.asarray(stats["batch_n_bricks"]).max()), 1024),
        brick_budget,
    )
    out["lane_budget"] = _round_up(
        1.1 * int(np.asarray(stats["batch_n_lanes"]).max())
    )
    need = np.asarray(stats["batch_n_need"]).astype(np.int64)
    pad = (-len(need)) % window
    win_need = np.pad(need, (0, pad)).reshape(-1, window).max(axis=1)
    cold = _round_up(1.15 * int(win_need[0]), 1024)
    warm = min(_round_up(1.15 * int(win_need[1:].max()), 1024), cold) \
        if len(win_need) > 1 else cold
    out["insert_budget"] = [cold, warm]
    out["unique_budget"] = snug_u
    if dense_mode == "row":
        out["vox_budget"] = _round_up(
            1.1 * int(np.asarray(stats["batch_n_unique"]).max()), 4096
        )
    return out


def tune_sequence(
    images: np.ndarray,
    positions: np.ndarray,
    quaternions: np.ndarray,
    cfg=None,
    *,
    backend: str = "brick",
    window: int = 8,
    dense_mode: str = "bfv",
    dtype=None,
    initial_capacity: Optional[int] = None,
) -> Dict[str, Any]:
    """One warmup mapping run -> a deployment budget plan (JSON-able dict).

    The plan feeds ``map_ping_sequence(..., budgets=plan)`` (or the CLI's
    ``map-bag --budgets``); it records the backend/window/dense_mode it was
    tuned for plus the survey-measured snug budgets and capacity."""
    import jax.numpy as jnp

    from sonar_3d_reconstruction_tpu.config import MapperConfig
    from sonar_3d_reconstruction_tpu.pipeline import map_ping_sequence

    if cfg is None:
        cfg = MapperConfig()
    if dtype is None:
        dtype = jnp.float32
    kwargs: Dict[str, Any] = {}
    if backend == "brick":
        from sonar_3d_reconstruction_tpu.grid.brick import init_brick_grid

        kwargs["state"] = init_brick_grid(
            initial_capacity or (1 << 16), dtype
        )
    elif initial_capacity:
        kwargs["initial_capacity"] = initial_capacity

    effective: Dict[str, Any] = {}
    _, stats = map_ping_sequence(
        images, positions, quaternions, cfg, backend=backend, dtype=dtype,
        window=window, effective=effective, **kwargs,
    )
    if backend == "brick":
        budgets = snug_budgets_brick(
            stats, window, effective["unique_budget"],
            effective["brick_budget"], dense_mode,
        )
    else:
        budgets = snug_budgets_hash(
            stats, window, effective["unique_budget"],
            effective["batch_budget"],
        )
    budgets.update(
        backend=backend,
        window=window,
        dense_mode=dense_mode,
        capacity=int(effective["capacity"]),
        fan_cap=int(effective["fan_cap"]),
        window_cap=int(effective["window_cap"]),
        free_cap=int(effective.get("free_cap", 0)),
    )
    return budgets
