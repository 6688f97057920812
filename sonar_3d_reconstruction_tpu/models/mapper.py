"""SonarMapper — the stateful flagship API (reference-parity surface).

Drop-in equivalent of the reference ``SonarTo3DMapper``
(scripts/3d_mapper.py:197-650): ``process_sonar_image(polar_image, position,
quaternion) -> stats`` and ``get_point_cloud(include_free) -> dict`` with the
same stats/result fields — implemented as a thin stateful shell over the pure
jitted device pipeline:

  backproject_ping -> update_{hash,dense}_grid      (one XLA program per ping)

plus the host-side concerns the device cannot own:
  * fan-table (re)build when the incoming image geometry changes
    (reference 3d_mapper.py:511-517 rebuilds bearing angles on width change)
  * hash-table growth: on load-factor trip or probe overflow the host doubles
    capacity (rehash) and replays the failed ping
  * frame counters and wall-clock processing statistics
    (reference 3d_mapper.py:303-311, 569-572)

For maximum throughput on long recorded sequences use
pipeline.map_ping_sequence (lax.scan over pings) instead of this per-ping API.
"""

from __future__ import annotations

import time
from functools import partial
from typing import Any, Dict, Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from sonar_3d_reconstruction_tpu.config import MapperConfig, config_from_dict
from sonar_3d_reconstruction_tpu.geometry import (
    pose_matrix_from_quaternion,
    pose_matrix_from_rpy,
)
from sonar_3d_reconstruction_tpu.grid.dense import (
    DenseGridSpec,
    extract_classified,
    extract_occupied,
    init_dense_grid,
    update_dense_grid,
)
from sonar_3d_reconstruction_tpu.grid.hash import (
    DEFAULT_UNIQUE_BUDGET,
    extract_classified_hash,
    extract_occupied_hash,
    init_hash_grid,
    rehash,
    update_hash_grid,
)
from sonar_3d_reconstruction_tpu.ops.backproject import (
    FanTables,
    backproject_ping,
    build_fan_tables,
)

# grow when used slots exceed this fraction of capacity (kept low so 8-deep
# hash buckets essentially never fill, grid/hash.py)
_MAX_LOAD = 0.25

# lazily-built jitted frame_records (debug update-count tracking)
_frame_records_jit = None


@partial(jax.jit, static_argnames=("tables", "cfg", "dtype", "unique_budget"))
def _hash_step(state, image, T, *, tables, cfg, dtype, unique_budget):
    cand = backproject_ping(image, T, tables, cfg, dtype=dtype)
    return update_hash_grid(state, cand, cfg, unique_budget=unique_budget)


@partial(
    jax.jit,
    static_argnames=(
        "tables", "cfg", "dtype", "unique_budget", "brick_bits",
        "brick_budget",
    ),
)
def _brick_step(state, image, T, *, tables, cfg, dtype, unique_budget,
                brick_bits, brick_budget=None):
    from sonar_3d_reconstruction_tpu.grid.brick import (
        apply_brick_records_batched,
    )
    from sonar_3d_reconstruction_tpu.ops.records import frame_records

    rec, aux = frame_records(
        image, T, tables, cfg, unique_budget, dtype, brick_bits=brick_bits
    )
    recs = jax.tree_util.tree_map(lambda x: x[None], rec)
    auxs = jax.tree_util.tree_map(lambda x: x[None], aux)
    state, stats = apply_brick_records_batched(
        state, recs, auxs, cfg, brick_budget=brick_budget
    )
    return state, {k: v[0] if v.ndim else v for k, v in stats.items()}


@partial(jax.jit, static_argnames=("tables", "spec", "cfg", "dtype"))
def _dense_step(state, image, T, *, tables, spec, cfg, dtype):
    cand = backproject_ping(image, T, tables, cfg, dtype=dtype)
    return update_dense_grid(state, cand, spec, cfg)


class SonarMapper:
    """Stateful sonar-to-3D mapper (reference SonarTo3DMapper parity,
    3d_mapper.py:197-650) over one of four map backends: "hash" (default,
    per-voxel bucketized hash grid), "brick" (sparse-of-dense 4x4x4 brick
    table — fastest at survey scale), "brick-sharded" (the brick table
    sharded over a jax Mesh via the frame-parallel engine; every read
    path distributes exactly), or "dense" (bounded dense grid)."""

    def __init__(
        self,
        config: Optional[Any] = None,
        *,
        backend: str = "hash",
        dense_spec: Optional[DenseGridSpec] = None,
        initial_capacity: int = 1 << 20,
        dtype=jnp.float32,
        track_update_counts: bool = False,
        mesh=None,
    ):
        if config is None:
            self.cfg = MapperConfig()
        elif isinstance(config, MapperConfig):
            self.cfg = config
        else:  # dict in library-level units (reference 3d_mapper.py:252-254)
            self.cfg = config_from_dict(config)
        self.dtype = dtype
        self.backend = backend
        if backend == "dense":
            if dense_spec is None:
                reach = self.cfg.max_range + 2.0
                dense_spec = DenseGridSpec.for_world_bounds(
                    (-reach,) * 3, (reach,) * 3, self.cfg.voxel_resolution
                )
            self.dense_spec = dense_spec
            self.state = init_dense_grid(dense_spec, dtype)
        elif backend == "hash":
            self.state = init_hash_grid(initial_capacity, dtype)
        elif backend == "brick":
            from sonar_3d_reconstruction_tpu.grid.brick import init_brick_grid

            # brick capacity counts BRICKS (~1/30 of voxels on realistic
            # surveys); grow/replay is the safety net either way
            self.state = init_brick_grid(
                max(128, initial_capacity >> 4), dtype
            )
        elif backend == "brick-sharded":
            # multi-chip brick map over a jax Mesh, driven by the
            # frame-parallel engine (parallel/shard_frames.py); every read
            # path distributes exactly over the disjoint per-shard brick
            # sub-tables (parallel/shard_brick.local_brick_states)
            from sonar_3d_reconstruction_tpu.parallel.shard import make_mesh
            from sonar_3d_reconstruction_tpu.parallel.shard_brick import (
                default_local_capacity,
                init_sharded_brick_grid,
            )

            self.mesh = mesh if mesh is not None else make_mesh()
            self.state = init_sharded_brick_grid(
                self.mesh,
                default_local_capacity(
                    initial_capacity, int(self.mesh.devices.size)
                ),
                dtype,
            )
            # sticky post-growth budgets threaded back into every batch
            self._sharded_budgets: Dict[str, Any] = {}
        else:
            raise ValueError(f"unknown backend {backend!r}")

        self.T_sonar_to_base = pose_matrix_from_rpy(
            np.asarray(self.cfg.sonar_position, np.float64),
            np.asarray(self.cfg.sonar_orientation, np.float64),
        )
        self._tables: Optional[FanTables] = None
        # sticky compact box-key bits for the brick backend (map_sequence)
        self._box_bits = None
        # static per-frame unique-voxel budget; doubled on unique_overflow
        self._unique_budget: Optional[int] = None
        # brick backend's distinct-brick budget; doubled on batch_overflow
        self._brick_budget: Optional[int] = None
        # optional per-voxel update-count histograms (reference debug stats,
        # 3d_mapper.py:306-308, 549-551, printed every 10 frames :575-585);
        # host-side dicts keyed by voxel triple, fed from per-frame unique
        # records.  Counts are candidate EMISSIONS (the reference increments
        # once per ray emission, :550-551) — already aggregated per voxel in
        # rec.count, so surfacing them costs nothing extra.
        # ``frame_update_counts`` covers only the most recent frame
        # (cleared per frame, reference :525).
        self.track_update_counts = track_update_counts
        self.voxel_update_counts: Dict[Tuple[int, int, int], int] = {}
        self.frame_update_counts: Dict[Tuple[int, int, int], int] = {}
        self.frame_count = 0
        self.processed_frame_count = 0
        self.last_processing_time = 0.0
        self.total_processing_time = 0.0
        self._last_stats: Dict[str, int] = {}

    # ------------------------------------------------------------------
    def _tables_for(self, shape: Tuple[int, int]) -> FanTables:
        if self._tables is None or (
            self._tables.range_bins,
            self._tables.bearing_bins,
        ) != shape:
            self._tables = build_fan_tables(self.cfg, shape[0], shape[1])
        return self._tables

    def _grow(self) -> None:
        new_cap = self.state.capacity * 2
        self.state = rehash(self.state, new_capacity=new_cap)

    def _process_brick(self, image_dev, T_dev, tables):
        """Per-ping brick-backend step with reactive grow/replay (cause
        attribution mirrors pipeline._map_ping_sequence_brick)."""
        from sonar_3d_reconstruction_tpu.grid.brick import rehash_bricks
        from sonar_3d_reconstruction_tpu.grid.hash import (
            effective_unique_budget,
        )

        while True:
            new_state, stats = _brick_step(
                self.state, image_dev, T_dev, tables=tables, cfg=self.cfg,
                dtype=self.dtype,
                unique_budget=self._unique_budget
                or effective_unique_budget(tables, self.cfg),
                brick_bits=self.state.brick_bits,
                brick_budget=self._brick_budget,
            )
            if not bool(stats["overflowed"]):
                self.state = new_state
                return stats
            if bool(stats["range_fail"]):
                raise ValueError(
                    "voxel keys outside the packable range: check odometry "
                    "frame offsets — growing the table cannot fix this"
                )
            if bool(stats["pack_overflow"]):
                raise ValueError(
                    "a voxel received 2^16+ emissions in one frame — use "
                    "backend='hash' for this degenerate geometry"
                )
            if bool(stats["unique_overflow"]):
                self._unique_budget = 2 * (
                    self._unique_budget
                    or effective_unique_budget(tables, self.cfg)
                )
                self.state = self.state._replace(poisoned=jnp.zeros((), bool))
            elif bool(stats["batch_overflow"]):
                # a very sparse geometry can exceed the default distinct-
                # brick budget even in one frame: double just that knob
                from sonar_3d_reconstruction_tpu.grid.brick import (
                    default_brick_budget,
                )

                self._brick_budget = 2 * (
                    self._brick_budget
                    or default_brick_budget(
                        1,
                        self._unique_budget
                        or effective_unique_budget(tables, self.cfg),
                    )
                )
                self.state = self.state._replace(poisoned=jnp.zeros((), bool))
            else:
                # remaining causes are capacity/bucket pressure
                self.state = rehash_bricks(
                    self.state, new_capacity=self.state.capacity * 2
                )

    def _process_sharded(self, images, positions, quaternions, window=8):
        """Route a ping batch through the frame-parallel sharded engine
        (growth handled inside its wrapper); sticky budgets carried across
        calls.  Returns the per-ping stats arrays."""
        from sonar_3d_reconstruction_tpu.parallel.shard_frames import (
            map_ping_sequence_sharded_frames,
        )

        eff: Dict[str, Any] = {}
        self.state, stats = map_ping_sequence_sharded_frames(
            images, positions, quaternions, self.cfg, mesh=self.mesh,
            state=self.state, dtype=self.dtype,
            window=min(window, images.shape[0]), effective=eff,
            # worst-case (uncapped) tables: the stateful mapper sees many
            # batches and per-batch auto caps would recompile whenever a
            # deeper return arrives (same rationale as map_sequence's
            # fan_cap=None for the single-chip backends)
            fan_cap=None, window_cap=None, free_cap=None,
            **self._sharded_budgets,
        )
        self._sharded_budgets = {
            k: v for k, v in eff.items() if v is not None
        }
        return stats

    # ------------------------------------------------------------------
    def process_sonar_image(
        self, polar_image: np.ndarray, robot_position, robot_orientation
    ) -> Dict[str, Any]:
        """One ping -> map update. Mirrors reference process_sonar_image
        (3d_mapper.py:485-595) including its stats dict fields."""
        t0 = time.time()
        self.frame_count += 1
        self.processed_frame_count += 1

        polar_image = np.asarray(polar_image)
        if self.backend == "brick-sharded":
            # host arrays only — the sharded wrapper computes the transform
            # and uploads the ping itself (no duplicated device transfer)
            seq_stats = self._process_sharded(
                polar_image[None],
                np.asarray(robot_position, np.float64)[None],
                np.asarray(robot_orientation, np.float64)[None],
            )
            stats = {
                k: int(np.asarray(v)[-1]) for k, v in seq_stats.items()
            }
            if self.track_update_counts:
                self._record_sequence_update_counts(
                    polar_image[None],
                    np.asarray(robot_position, np.float64)[None],
                    np.asarray(robot_orientation, np.float64)[None],
                )
            return self._finish_ping(stats, t0)

        tables = self._tables_for(polar_image.shape)
        T = (
            pose_matrix_from_quaternion(
                np.asarray(robot_position, np.float64),
                np.asarray(robot_orientation, np.float64),
            )
            @ self.T_sonar_to_base
        )
        image_dev = jnp.asarray(polar_image)
        T_dev = jnp.asarray(T, self.dtype)

        if self.backend == "dense":
            self.state, stats = _dense_step(
                self.state,
                image_dev,
                T_dev,
                tables=tables,
                spec=self.dense_spec,
                cfg=self.cfg,
                dtype=self.dtype,
            )
        elif self.backend == "brick":
            stats = self._process_brick(image_dev, T_dev, tables)
        else:
            # proactive growth, then replay-on-overflow as a backstop
            while True:
                # .capacity is pure shape math; key_hi would dispatch a
                # device slice+reshape copy of half the key table per ping
                cap = self.state.capacity
                if int(self.state.used) > _MAX_LOAD * cap:
                    self._grow()
                    continue
                new_state, stats = _hash_step(
                    self.state,
                    image_dev,
                    T_dev,
                    tables=tables,
                    cfg=self.cfg,
                    dtype=self.dtype,
                    unique_budget=self._unique_budget,
                )
                if bool(stats["overflowed"]):
                    if bool(stats["range_fail"]):
                        raise ValueError(
                            "voxel keys outside the packable ±2^19-cell "
                            "range (±26 km at 5 cm): check odometry frame "
                            "offsets — growing the table cannot fix this"
                        )
                    if bool(stats["unique_overflow"]):
                        # double from the budget actually in effect — when
                        # unset, the step used the snug per-geometry default,
                        # often far below DEFAULT_UNIQUE_BUDGET
                        from sonar_3d_reconstruction_tpu.grid.hash import (
                            effective_unique_budget,
                        )

                        self._unique_budget = 2 * (
                            self._unique_budget
                            or effective_unique_budget(tables, self.cfg)
                        )
                        self.state = self.state._replace(
                            poisoned=jnp.zeros((), bool)
                        )
                    else:
                        self._grow()
                    continue
                self.state = new_state
                break

        # the emission-count recompute is map-state-independent, so it
        # serves hash, brick AND dense identically (the brick-sharded path
        # records via its early return above)
        if self.track_update_counts:
            self._record_update_counts(image_dev, T_dev, tables)
        return self._finish_ping(stats, t0)

    def _finish_ping(self, stats, t0: float) -> Dict[str, Any]:
        """Assemble the reference-schema per-ping result dict
        (3d_mapper.py:587-595) from a backend step's stats."""
        out = {
            k: int(v)
            for k, v in stats.items()
            if not (
                k == "overflowed"
                or k.endswith("_overflow")
                or k.endswith("_fail")
            )
        }
        self.last_processing_time = time.time() - t0
        self.total_processing_time += self.last_processing_time
        result = {
            "frame_count": self.frame_count,
            "processed_count": self.processed_frame_count,
            "num_occupied": out["num_occupied"],
            "num_free": out["num_free"],
            "num_voxels": self.num_voxels,
            "processing_time": self.last_processing_time,
            "avg_processing_time": self.total_processing_time
            / max(1, self.processed_frame_count),
        }
        self._last_stats = out
        return result

    # ------------------------------------------------------------------
    def map_sequence(
        self, images, positions, quaternions, window: int = 1
    ) -> Dict[str, np.ndarray]:
        """Batch API: map a whole recorded sequence through the pipeline
        (much faster than per-ping process_sonar_image for offline replay —
        no per-frame host sync; ``window`` > 1 opts into the batched-apply
        engine).  Updates this mapper's state in place; returns per-ping
        stats arrays.  Hash, brick and brick-sharded backends."""
        if self.backend not in ("hash", "brick", "brick-sharded"):
            raise ValueError(
                "map_sequence requires the hash, brick or brick-sharded "
                "backend"
            )
        from sonar_3d_reconstruction_tpu.pipeline import map_ping_sequence

        t0 = time.time()
        images = np.asarray(images)
        n = images.shape[0]
        if self.backend == "brick-sharded":
            stats = self._process_sharded(
                images, positions, quaternions, window=max(1, window)
            )
            if self.track_update_counts:
                self._record_sequence_update_counts(images, positions,
                                                    quaternions)
            self.frame_count += n
            self.processed_frame_count += n
            dt = time.time() - t0
            self.last_processing_time = dt / max(1, n)
            self.total_processing_time += dt
            return stats
        # exact (max_range-sized) fan tables: the stateful mapper may see
        # many batches, and per-batch auto-capped tables would recompile the
        # pipeline whenever a deeper return arrives; one-shot offline
        # callers (cli map-bag --offline, bench) opt into fan_cap="auto".
        # The brick backend's compact box-key bits are STICKY grow-only
        # across batches (box_min_bits) for the same reason.
        eff = {}
        self.state, stats = map_ping_sequence(
            images, positions, quaternions, self.cfg,
            state=self.state, dtype=self.dtype, window=window,
            unique_budget=self._unique_budget, fan_cap=None, window_cap=None,
            free_cap=None, backend=self.backend, effective=eff,
            box_min_bits=self._box_bits,
        )
        if eff.get("box_bits") is not None:
            self._box_bits = eff["box_bits"]
        # persist the budgets the sequence settled on (growth may have
        # raised them): without this every subsequent batch would replay
        # the same overflow -> grow -> multi-minute recompile cycle the
        # per-ping paths avoid with their sticky budgets
        if eff.get("unique_budget"):
            self._unique_budget = int(eff["unique_budget"])
        if self.backend == "brick" and eff.get("brick_budget"):
            self._brick_budget = int(eff["brick_budget"])
        if self.track_update_counts:
            self._record_sequence_update_counts(images, positions,
                                                quaternions)
        self.frame_count += n
        self.processed_frame_count += n
        dt = time.time() - t0
        self.last_processing_time = dt / max(1, n)
        self.total_processing_time += dt
        return stats

    # ------------------------------------------------------------------
    def _record_sequence_update_counts(
        self, images, positions, quaternions
    ) -> None:
        """Per-ping emission-count recording for a whole batch (the
        records recompute is map-state-independent, so it serves every
        backend identically)."""
        from sonar_3d_reconstruction_tpu.pipeline import (
            batched_sonar_to_world,
        )

        tables = self._tables_for(images.shape[1:])
        T_all = batched_sonar_to_world(positions, quaternions, self.cfg)
        for i in range(images.shape[0]):
            self._record_update_counts(
                jnp.asarray(images[i]), jnp.asarray(T_all[i], self.dtype),
                tables,
            )

    def _record_update_counts(self, image_dev, T_dev, tables) -> None:
        """Debug path (reference voxel_update_counts / frame_update_counts,
        3d_mapper.py:306-308, 525, 549-551): count candidate EMISSIONS per
        voxel — per frame and accumulated over the run.  Recomputes the
        frame's unique records — roughly doubles per-ping cost, so it is
        opt-in like the reference's debug prints."""
        from sonar_3d_reconstruction_tpu.grid.hash import (
            effective_unique_budget,
        )
        from sonar_3d_reconstruction_tpu.ops.packing import unpack_keys
        from sonar_3d_reconstruction_tpu.ops.records import frame_records

        global _frame_records_jit
        if _frame_records_jit is None:
            _frame_records_jit = jax.jit(
                frame_records,
                static_argnames=("tables", "cfg", "unique_budget", "dtype"),
            )
        budget = self._unique_budget or effective_unique_budget(
            tables, self.cfg
        )
        while True:  # a too-small budget would silently truncate the counts
            rec, _ = _frame_records_jit(
                image_dev, T_dev, tables=tables, cfg=self.cfg,
                unique_budget=budget, dtype=self.dtype,
            )
            if not bool(rec.overflowed):
                break
            budget *= 2
            self._unique_budget = budget
        keys = np.asarray(unpack_keys(rec.hi, rec.lo))
        valid = np.asarray(rec.valid)
        counts = np.asarray(rec.count)[valid]
        self.frame_update_counts = {}  # reset per frame (reference :525)
        for k, c in zip(map(tuple, keys[valid]), counts):
            c = int(c)
            self.frame_update_counts[k] = c
            self.voxel_update_counts[k] = self.voxel_update_counts.get(k, 0) + c

    def update_count_histogram(self) -> Dict[int, int]:
        """{emissions-per-voxel: number-of-voxels} (reference print :575-585)."""
        hist: Dict[int, int] = {}
        for c in self.voxel_update_counts.values():
            hist[c] = hist.get(c, 0) + 1
        return dict(sorted(hist.items()))

    def frame_update_stats(self) -> Dict[str, float]:
        """The reference's per-frame debug aggregates (3d_mapper.py:575-585):
        max/avg emissions per touched voxel in the LAST frame, the running
        max across all frames, and voxels with >10 emissions this frame.
        Empty dict when nothing was tracked (mirrors the ``if`` guard :575)."""
        if not self.frame_update_counts:
            return {}
        vals = self.frame_update_counts.values()
        return {
            "max_updates_frame": max(vals),
            "avg_updates_frame": sum(vals) / len(vals),
            "max_updates_total": max(self.voxel_update_counts.values()),
            "voxels_over_10_frame": sum(1 for v in vals if v > 10),
        }

    def format_frame_update_stats(self) -> str:
        """The reference's every-10-frames debug block (3d_mapper.py:579-585),
        one string instead of prints."""
        s = self.frame_update_stats()
        if not s:
            return ""
        return (
            f"[DEBUG] Frame {self.frame_count}:\n"
            f"  Max updates in frame: {s['max_updates_frame']}\n"
            f"  Avg updates in frame: {s['avg_updates_frame']:.1f}\n"
            f"  Max total updates: {s['max_updates_total']}\n"
            f"  Voxels with >10 updates in frame: {s['voxels_over_10_frame']}"
        )

    def format_update_histogram(self) -> str:
        hist = self.update_count_histogram()
        total = sum(hist.values())
        lines = [f"voxel update counts over {self.frame_count} frames "
                 f"({total} voxels):"]
        for c, n in hist.items():
            lines.append(f"  {c:4d} updates: {n} voxels")
        return "\n".join(lines)

    # ------------------------------------------------------------------
    @property
    def num_voxels(self) -> int:
        if self.backend == "dense":
            return int(jnp.sum(self.state.touched))
        if self.backend == "brick-sharded":
            return int(np.asarray(self.state.used).sum())
        return int(self.state.used)  # hash: slots; brick: touched voxels

    def get_point_cloud(self, include_free: bool = False) -> Dict[str, Any]:
        """Map extraction with the reference result schema
        (3d_mapper.py:597-642)."""
        cfg = self.cfg
        if include_free:
            if self.backend == "dense":
                cls = extract_classified(self.state, self.dense_spec, cfg)
            elif self.backend == "brick":
                from sonar_3d_reconstruction_tpu.grid.brick import (
                    extract_classified_brick,
                )

                cls = extract_classified_brick(self.state, cfg)
            elif self.backend == "brick-sharded":
                from sonar_3d_reconstruction_tpu.grid.brick import (
                    extract_classified_brick,
                )
                from sonar_3d_reconstruction_tpu.parallel.shard_brick import (
                    local_brick_states,
                )

                parts = [
                    extract_classified_brick(s, cfg)
                    for s in local_brick_states(self.state)
                ]
                cls = {
                    k: (
                        np.concatenate([p[k][0] for p in parts]),
                        np.concatenate([p[k][1] for p in parts]),
                    )
                    for k in ("occupied", "free", "unknown")
                }
            else:
                cls = extract_classified_hash(self.state, cfg)
            if self.backend == "brick-sharded":
                from sonar_3d_reconstruction_tpu.parallel.shard_brick import (
                    sharded_brick_bounds,
                )

                bmin, bmax = sharded_brick_bounds(self.state)
            else:
                bmin = np.asarray(self.state.min_bounds)
                bmax = np.asarray(self.state.max_bounds)
            occupied, free, unknown = cls["occupied"], cls["free"], cls["unknown"]
            return {
                "occupied": occupied,
                "free": free,
                "unknown": unknown,
                "num_voxels": self.num_voxels,
                "num_occupied": len(occupied[0]),
                "num_free": len(free[0]),
                "num_unknown": len(unknown[0]),
                "frame_count": self.frame_count,
                "processed_count": self.processed_frame_count,
                "bounds": {
                    "min": bmin if cfg.dynamic_expansion else None,
                    "max": bmax if cfg.dynamic_expansion else None,
                },
            }
        if self.backend == "dense":
            points, probs = extract_occupied(self.state, self.dense_spec, cfg)
        elif self.backend == "brick":
            from sonar_3d_reconstruction_tpu.grid.brick import (
                extract_occupied_brick,
            )

            points, probs = extract_occupied_brick(self.state, cfg)
        elif self.backend == "brick-sharded":
            from sonar_3d_reconstruction_tpu.parallel.shard_brick import (
                extract_occupied_sharded,
            )

            points, probs = extract_occupied_sharded(self.state, cfg)
        else:
            points, probs = extract_occupied_hash(self.state, cfg)
        return {
            "points": points,
            "probabilities": probs,
            "num_voxels": self.num_voxels,
            "num_occupied": len(points),
            "frame_count": self.frame_count,
            "processed_count": self.processed_frame_count,
        }

    def query_probabilities(self, points) -> np.ndarray:
        """Batched point query: (N, 3) world coords -> (N,) occupancy
        probabilities; never-updated voxels answer 0.5.  The batched
        form of the reference's per-point SimpleOctree.get_probability
        (3d_mapper.py:122-126): one bucket row gather resolves every
        query."""
        if self.backend == "dense":
            from sonar_3d_reconstruction_tpu.grid.dense import (
                query_probability_dense,
            )

            return query_probability_dense(
                self.state, points, self.dense_spec, self.cfg
            )
        if self.backend == "brick":
            from sonar_3d_reconstruction_tpu.grid.brick import (
                query_probability_brick,
            )

            return query_probability_brick(self.state, points, self.cfg)
        if self.backend == "brick-sharded":
            lo = self._sharded_log_odds(points)
            return 1.0 / (1.0 + np.exp(-lo))
        from sonar_3d_reconstruction_tpu.grid.hash import query_probability

        return query_probability(self.state, points, self.cfg)

    def _sharded_log_odds(self, points) -> np.ndarray:
        """(N,) float64 log-odds summed over the per-shard sub-tables: a
        voxel lives on exactly one shard and absent shards answer exactly
        0.0, so the sum equals the single-chip query."""
        from sonar_3d_reconstruction_tpu.grid.brick import (
            query_log_odds_brick,
        )
        from sonar_3d_reconstruction_tpu.parallel.shard_brick import (
            local_brick_states,
        )

        lo = None
        for s in local_brick_states(self.state):
            v = query_log_odds_brick(s, points, self.cfg).astype(np.float64)
            lo = v if lo is None else lo + v
        return lo

    def get_probability(self, x: float, y: float, z: float) -> float:
        """Occupancy probability of the voxel containing (x, y, z)
        (reference SimpleOctree.get_probability, 3d_mapper.py:122-126)."""
        return float(self.query_probabilities([[x, y, z]])[0])

    def get_log_odds(self, x: float, y: float, z: float) -> float:
        """Log-odds of the voxel containing (x, y, z); 0.0 if never
        updated (reference SimpleOctree.get_log_odds, 3d_mapper.py:117-120)."""
        if self.backend == "dense":
            p = self.get_probability(x, y, z)
            return float(np.log(p / (1.0 - p)))
        if self.backend == "brick":
            from sonar_3d_reconstruction_tpu.grid.brick import (
                query_log_odds_brick,
            )

            return float(
                query_log_odds_brick(self.state, [[x, y, z]], self.cfg)[0]
            )
        if self.backend == "brick-sharded":
            return float(self._sharded_log_odds([[x, y, z]])[0])
        from sonar_3d_reconstruction_tpu.grid.hash import query_log_odds

        return float(query_log_odds(self.state, [[x, y, z]], self.cfg)[0])

    def clear(self) -> None:
        """Alias of reset_map (reference SimpleOctree.clear,
        3d_mapper.py:190-194)."""
        self.reset_map()

    def reset_map(self) -> None:
        """Clear the map (reference reset_map, 3d_mapper.py:644-650)."""
        if self.backend == "dense":
            self.state = init_dense_grid(self.dense_spec, self.dtype)
        elif self.backend == "brick":
            from sonar_3d_reconstruction_tpu.grid.brick import init_brick_grid

            self.state = init_brick_grid(
                self.state.capacity, self.dtype,
                brick_bits=self.state.brick_bits,
            )
        elif self.backend == "brick-sharded":
            from sonar_3d_reconstruction_tpu.parallel.shard_brick import (
                init_sharded_brick_grid,
            )

            self.state = init_sharded_brick_grid(
                self.mesh, int(self.state.local_capacity), self.dtype,
                int(self.state.brick_bits),
            )
        else:
            self.state = init_hash_grid(self.state.capacity, self.dtype)
        self.frame_count = 0
        self.processed_frame_count = 0
        self.total_processing_time = 0.0
        self.voxel_update_counts.clear()
        self.frame_update_counts.clear()
