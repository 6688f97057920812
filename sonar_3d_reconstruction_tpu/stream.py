"""Streaming runtime: bag replay -> time sync -> chunked device mapping.

The ROS-free equivalent of the reference node's ingest loop
(scripts/3d_mapper_node.py:191-357): pair the sonar-image and odometry
streams with the ±slop approximate time synchronizer, decode images, and run
the paired pings through the device pipeline — batched into fixed-size
chunks so every chunk reuses one compiled lax.scan (tail padded via the
scan's stop index).

A ``publish`` callback fires at the configured rate in STREAM TIME (the
reference publishes on a 10 Hz wall timer decoupled from ingest,
node:227-231); offline replay maps that to bag timestamps.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

import jax.numpy as jnp

from sonar_3d_reconstruction_tpu.config import MapperConfig, StreamConfig
from sonar_3d_reconstruction_tpu.grid.hash import (
    extract_occupied_hash,
    init_hash_grid,
    rehash,
)
from sonar_3d_reconstruction_tpu.io.bag import ImageMsg, OdometryMsg
from sonar_3d_reconstruction_tpu.io.image import decode_image
from sonar_3d_reconstruction_tpu.io.pointcloud import serialize_pointcloud2
from sonar_3d_reconstruction_tpu.io.timesync import ApproximateTimeSync
from sonar_3d_reconstruction_tpu.ops.backproject import build_fan_tables
from sonar_3d_reconstruction_tpu.pipeline import (
    batched_sonar_to_world,
    scan_pings_hash,
)


@dataclass
class StreamStats:
    """Counters mirroring the reference's periodic frame logs (node:345-357)
    plus the dropped/unsynced counter the reference lacks (SURVEY.md 5.3)
    and real arrival->state-committed latency percentiles (BASELINE.md
    metric "p50 ping→map latency")."""

    pings_in: int = 0
    poses_in: int = 0
    pairs: int = 0
    frames_mapped: int = 0
    decode_errors: int = 0
    dropped_unsynced: int = 0
    chunks: int = 0
    # growth EVENTS: one per retry on the single-chip backends, but at most
    # one per chunk on brick-sharded (its wrapper converges internally) —
    # comparable within a backend, not across backends
    grows: int = 0
    fan_cap_recompiles: int = 0
    window_cap_recompiles: int = 0
    free_cap_recompiles: int = 0
    box_bits_recompiles: int = 0
    device_time: float = 0.0
    stamp_skew_sum: float = 0.0  # measured sonar<->odom stamp delta (node:352-357)
    # wall-clock seconds from a ping's (decoded, paired) arrival to its
    # frame being COMMITTED in device map state — measured per frame, the
    # chunk flush syncs on the overflow check so commit time is real
    latencies: List[float] = field(default_factory=list)

    def latency_percentiles(self) -> Dict[str, float]:
        if not self.latencies:
            return {"p50": 0.0, "p95": 0.0, "max": 0.0}
        arr = np.asarray(self.latencies)
        return {
            "p50": float(np.percentile(arr, 50)),
            "p95": float(np.percentile(arr, 95)),
            "max": float(arr.max()),
        }

    def summary(self) -> Dict[str, Any]:
        d = {k: v for k, v in self.__dict__.items() if k != "latencies"}
        d["avg_stamp_skew"] = (
            self.stamp_skew_sum / self.pairs if self.pairs else 0.0
        )
        lat = self.latency_percentiles()
        d["latency_p50_s"] = lat["p50"]
        d["latency_p95_s"] = lat["p95"]
        d["latency_max_s"] = lat["max"]
        return d


class StreamingMapper:
    """Chunked streaming front-end over the hashed-map scan pipeline.

    Feed pings/poses in any interleaving (``on_ping`` / ``on_pose``), or an
    entire bag (``run_bag``); call ``finish()`` to flush the tail.

    Latency vs throughput: a ping waits until its chunk fills before any
    device work happens, so the worst-case ping->map latency is
    ``chunk_size / ping_rate`` plus the chunk's device time.  The default
    chunk of 32 maximizes throughput for offline replay; the documented
    LOW-LATENCY configuration is ``chunk_size == window`` (e.g. both 8),
    which bounds the wait to one window while keeping the batched-apply
    engine — per-frame arrival->committed latencies are measured into
    ``stats.latencies`` either way (p50/p95 in ``stats.summary()``).
    """

    def __init__(
        self,
        cfg: Optional[MapperConfig] = None,
        stream_cfg: Optional[StreamConfig] = None,
        *,
        chunk_size: int = 32,
        window: int = 8,
        initial_capacity: int = 1 << 20,
        dtype=jnp.float32,
        publish: Optional[Callable[[Dict], None]] = None,
        fan_cap: Any = "auto",
        window_cap: Any = "auto",
        free_cap: Any = "auto",
        unique_budget: Optional[int] = None,
        batch_budget: Optional[int] = None,
        backend: str = "hash",
        mesh=None,
        budgets: Optional[Dict[str, Any]] = None,
        incremental_publish: Optional[bool] = None,
    ):
        # a deployment budget plan (utils/autotune.tune_sequence) seeds the
        # SIZES the stream would otherwise discover as it goes: table
        # capacity, the snug unique/batch/brick budgets, and the grow-only
        # fan/window/free caps (seeding the caps means the FIRST chunk
        # compiles the final-cap programs — no mid-stream cap recompiles on
        # data the plan covered).  Apply-side micro-budgets
        # (lane/insert/vox) are offline-only; the stream keeps its own
        # host-gated machinery for those.  A stale plan is safe — every
        # overflow is detected and the normal growth takes over.
        if budgets is not None:
            if budgets.get("backend", backend) != backend:
                raise ValueError(
                    f"budget plan was tuned for backend="
                    f"{budgets.get('backend')!r}, not {backend!r}"
                )
            eff_window = max(1, min(window, chunk_size))
            if budgets.get("window", eff_window) != eff_window:
                raise ValueError(
                    f"budget plan was tuned for window="
                    f"{budgets.get('window')}, not {eff_window}"
                )
            if budgets.get("capacity"):
                # plan capacity counts table rows for its backend (bricks
                # for brick); undo the brick >>4 voxel-heuristic below
                initial_capacity = int(budgets["capacity"])
                if backend == "brick":
                    initial_capacity <<= 4
            if unique_budget is None:
                unique_budget = budgets.get("unique_budget")
            if batch_budget is None and backend == "hash":
                batch_budget = budgets.get("batch_budget")
            self._plan = budgets
        else:
            self._plan = None
        self.cfg = cfg or MapperConfig()
        self.stream_cfg = stream_cfg or StreamConfig()
        self.chunk_size = chunk_size
        # windowed batched apply (grid/hash.apply_records_batched): one set
        # of table operations per `window` pings — ~4x the per-ping engine's
        # throughput at identical (bit-exact) semantics.  window=1 falls
        # back to the per-ping engine.
        self.window = max(1, min(window, chunk_size))
        self.dtype = dtype
        self.publish = publish
        self.backend = backend
        if backend == "brick":
            from sonar_3d_reconstruction_tpu.grid.brick import init_brick_grid

            # capacity counts BRICKS (~1/30 of voxels on realistic surveys)
            self.state = init_brick_grid(
                max(128, initial_capacity >> 4), dtype
            )
        elif backend == "hash":
            self.state = init_hash_grid(initial_capacity, dtype)
        elif backend == "brick-sharded":
            # multi-chip live streaming: chunks flow through the
            # frame-parallel engine (parallel/shard_frames.py) with the
            # SAME host-gated capped tables as the single-chip backends
            # (any cap exact for the gated images is exact sharded too).
            # Sharded chunks default to the compact box-key exchange
            # (_run_chunk_sharded threads box_min_bits; sticky grow-only,
            # wide two-word fallback for unpackable extents).
            from sonar_3d_reconstruction_tpu.parallel.shard import make_mesh
            from sonar_3d_reconstruction_tpu.parallel.shard_brick import (
                init_sharded_brick_grid,
            )

            self.mesh = mesh if mesh is not None else make_mesh()
            from sonar_3d_reconstruction_tpu.parallel.shard_brick import (
                default_local_capacity,
            )

            self.state = init_sharded_brick_grid(
                self.mesh,
                default_local_capacity(
                    initial_capacity, int(self.mesh.devices.size)
                ),
                dtype,
            )
            self._sharded_budgets: Dict[str, Any] = {}
        else:
            raise ValueError(f"unknown backend {backend!r}")
        self.stats = StreamStats()
        self._tables = None
        self._tables_shape: Optional[Tuple[int, int]] = None
        self._unique_budget: Optional[int] = unique_budget
        self._batch_budget: Optional[int] = batch_budget
        self._brick_budget: Optional[int] = None
        # per-chunk host-gated occupied-fan cap ("auto", an int, or None for
        # the max_range worst case).  "auto" sizes the static fan width from
        # the deepest above-threshold return seen SO FAR (monotone grow-only,
        # so a deeper mid-stream return costs one recompile — the compile
        # cache makes repeats cheap) — live replay then runs the same
        # candidate lattice as offline fan_cap="auto" instead of the ~2x
        # max_range worst case.
        self._fan_cap_mode = fan_cap
        self._fan_cap: int = 0
        # per-chunk host-gated occupied-WINDOW depth, same grow-only
        # contract as the fan cap: "auto" sizes the static window depth
        # from the thickest return slab seen so far
        self._window_cap_mode = window_cap
        self._window_cap: int = 0
        # per-chunk host-gated FREE-lattice depth, same grow-only contract:
        # "auto" sizes the static free depth from the deepest first hit
        # seen so far (ops/backproject.required_free_cap)
        self._free_cap_mode = free_cap
        self._free_cap: int = 0
        if self._plan is not None:
            if backend == "brick":
                self._brick_budget = self._plan.get("brick_budget")
            # seed the grow-only caps at the plan's measured values (only
            # meaningful in "auto" mode — explicit modes keep their ints)
            if self._fan_cap_mode == "auto":
                self._fan_cap = int(self._plan.get("fan_cap") or 0)
            if self._window_cap_mode == "auto":
                self._window_cap = int(self._plan.get("window_cap") or 0)
            if self._free_cap_mode == "auto":
                self._free_cap = int(self._plan.get("free_cap") or 0)
        # sticky per-axis brick bits for the brick backend's compact
        # box-key engine (grow-only: a chunk needing wider axes adopts the
        # wider program once; a chunk whose box cannot fit at all falls
        # back to the wide two-word engine for that chunk)
        self._box_bits: Optional[Tuple[int, int, int]] = None
        self._chunk_images: List[np.ndarray] = []
        self._chunk_positions: List[np.ndarray] = []
        self._chunk_quats: List[np.ndarray] = []
        self._chunk_stamps: List[float] = []
        self._chunk_arrivals: List[float] = []
        self._next_publish_t: Optional[float] = None
        # incremental publish: host-side published view
        # + pose-derived dirty regions (grid/brick.py incremental section).
        # None = auto (on for the single-chip brick backend).  The ticks
        # then pull O(changed-bricks) instead of O(occupied) — exact and
        # byte-identical output (superset dirty regions, same point order).
        if incremental_publish is None:
            incremental_publish = backend == "brick"
        self.incremental_publish = bool(incremental_publish) and (
            backend == "brick"
        )
        self._host_view = None  # grid.brick.BrickHostView once seeded
        self._dirty_boxes: List[np.ndarray] = []  # (2, 3) int32 per chunk
        self._sync = ApproximateTimeSync(
            self._on_pair,
            queue_size=self.stream_cfg.sync_queue_size,
            slop=self.stream_cfg.sync_slop,
        )

    # -- ingestion ------------------------------------------------------
    def on_ping(self, image_msg: ImageMsg) -> None:
        self.stats.pings_in += 1
        self._sync.add_ping(image_msg, image_msg.stamp)
        self.stats.dropped_unsynced = self._sync.dropped

    def on_pose(self, odom_msg: OdometryMsg) -> None:
        self.stats.poses_in += 1
        self._sync.add_pose(odom_msg, odom_msg.stamp)
        self.stats.dropped_unsynced = self._sync.dropped

    def _on_pair(self, image_msg: ImageMsg, odom_msg: OdometryMsg) -> None:
        self.stats.pairs += 1
        self.stats.stamp_skew_sum += abs(image_msg.stamp - odom_msg.stamp)
        try:
            img = decode_image(
                image_msg.data,
                image_msg.height,
                image_msg.width,
                image_msg.encoding,
                image_msg.step,
                image_msg.is_bigendian,
            )
        except Exception:
            # drop-and-log policy for ANY decode failure (unsupported
            # encoding, truncated payload, ...) — reference node:313-316
            # wraps conversion in a bare except and drops the frame
            self.stats.decode_errors += 1
            return
        shape = img.shape
        if self._chunk_images and self._chunk_images[0].shape != shape:
            self._flush_chunk()  # geometry change: new compiled program
        self._chunk_images.append(img)
        self._chunk_positions.append(np.asarray(odom_msg.position))
        self._chunk_quats.append(np.asarray(odom_msg.orientation))
        self._chunk_stamps.append(image_msg.stamp)
        self._chunk_arrivals.append(time.perf_counter())
        if len(self._chunk_images) >= self.chunk_size:
            self._flush_chunk()

    # -- device work ----------------------------------------------------
    def _resolve_tables(
        self, shape: Tuple[int, int], stacked: np.ndarray
    ) -> None:
        """(Re)build fan tables for this image geometry and the current
        host-gated caps (see __init__ fan_cap note).  ``stacked`` is the
        chunk's image block, stacked ONCE by the caller and shared by all
        three gates."""
        cap = self._fan_cap
        if self._fan_cap_mode == "auto":
            from sonar_3d_reconstruction_tpu.ops.backproject import (
                required_fan_cap,
            )

            need = required_fan_cap(stacked, self.cfg, shape[0])
            if need > cap:
                if cap:  # a deeper return arrived: adopt + recompile
                    self.stats.fan_cap_recompiles += 1
                cap = need
        elif self._fan_cap_mode:
            cap = int(self._fan_cap_mode)
        wcap = self._window_cap
        if self._window_cap_mode == "auto":
            from sonar_3d_reconstruction_tpu.ops.backproject import (
                required_window_cap,
            )

            wneed = required_window_cap(stacked, self.cfg, shape[0])
            if wneed > wcap:
                if wcap:  # a thicker return slab arrived: adopt + recompile
                    self.stats.window_cap_recompiles += 1
                wcap = wneed
        elif self._window_cap_mode:
            wcap = int(self._window_cap_mode)
        fcap = self._free_cap
        if self._free_cap_mode == "auto":
            from sonar_3d_reconstruction_tpu.ops.backproject import (
                required_free_cap,
            )

            fneed = required_free_cap(stacked, self.cfg, shape[0])
            if fneed > fcap:
                if fcap:  # a deeper first hit arrived: adopt + recompile
                    self.stats.free_cap_recompiles += 1
                fcap = fneed
        elif self._free_cap_mode:
            fcap = int(self._free_cap_mode)
        if (
            self._tables is None
            or self._tables_shape != shape
            or cap != self._fan_cap
            or wcap != self._window_cap
            or fcap != self._free_cap
        ):
            self._tables = build_fan_tables(
                self.cfg, shape[0], shape[1], fan_cap=cap, window_cap=wcap,
                free_cap=fcap,
            )
            self._tables_shape = shape
            self._fan_cap = cap
            self._window_cap = wcap
            self._free_cap = fcap

    def _flush_chunk(self) -> None:
        n = len(self._chunk_images)
        if n == 0:
            return
        try:
            self._flush_chunk_inner(n)
        except BaseException:
            # the raising paths (range_fail, pack_overflow, retries
            # exhausted) poison/abandon THIS chunk; the buffers must still
            # clear, or the next ingested pair flushes chunk_size+1 frames
            # and the pad count goes negative — masking the real error
            for buf in (self._chunk_images, self._chunk_positions,
                        self._chunk_quats, self._chunk_stamps,
                        self._chunk_arrivals):
                buf.clear()
            raise

    def _flush_chunk_inner(self, n: int) -> None:
        shape = self._chunk_images[0].shape
        stacked = np.stack(self._chunk_images)
        self._resolve_tables(shape, stacked)

        pad = self.chunk_size - n
        images = np.concatenate(
            [stacked,
             np.zeros((pad,) + shape, self._chunk_images[0].dtype)]
        ) if pad else stacked
        # pad poses by REPEATING the last real pose (padded frames are
        # masked off via the scan's stop index, but the brick backend's
        # per-window boxes cover every pose in the window — a zero-pose pad
        # far from the survey would needlessly widen or break the box)
        positions = np.stack(
            self._chunk_positions + [self._chunk_positions[-1]] * pad
        )
        quats = np.stack(
            self._chunk_quats + [self._chunk_quats[-1]] * pad
        )
        if self.backend == "brick-sharded":
            # host arrays only: the sharded wrapper computes transforms and
            # uploads the chunk itself (no duplicated multi-MB transfer)
            t0 = time.perf_counter()
            self._run_chunk_sharded(images, positions, quats, n)
            self._finish_chunk(t0, n)
            return
        T = batched_sonar_to_world(positions, quats, self.cfg)
        images_dev = jnp.asarray(images)
        T_dev = jnp.asarray(T, self.dtype)
        t0 = time.perf_counter()
        if self.backend == "brick":
            self._run_chunk_brick(images_dev, T_dev, n, T[:, :3, 3])
            self._finish_chunk(t0, n)
            return
        start = 0
        for _retry in range(12):
            new_state, stats = scan_pings_hash(
                self.state,
                images_dev,
                T_dev,
                jnp.int32(start),
                jnp.int32(n),
                tables=self._tables,
                cfg=self.cfg,
                dtype=self.dtype,
                unique_budget=self._unique_budget,
                window=self.window,
                batch_budget=self._batch_budget,
            )
            over = np.asarray(stats["overflowed"])
            if not over.any():
                self.state = new_state
                break
            # with window > 1 a batch rejects all-or-nothing, so the cause
            # flags may sit later than the first overflowed frame — inspect
            # the whole failed tail (same contract as map_ping_sequence)
            start = int(np.argmax(over))
            tail = slice(start, None)
            if bool(np.asarray(stats["range_fail"])[tail].any()):
                raise ValueError(
                    f"chunk frame {start}: voxel keys outside the packable "
                    "±2^19-cell range — check odometry frame offsets"
                )
            if bool(np.asarray(stats["unique_overflow"])[tail].any()):
                from sonar_3d_reconstruction_tpu.grid.hash import (
                    effective_unique_budget,
                )

                # double from the budget actually in effect (the snug
                # geometry-derived default, NOT the global
                # DEFAULT_UNIQUE_BUDGET — same over-allocation fix as
                # map_ping_sequence / models.mapper)
                self._unique_budget = 2 * (
                    self._unique_budget
                    or effective_unique_budget(self._tables, self.cfg)
                )
                # the batch budget derives from the unique budget by
                # default; re-derive it from the grown value
                self._batch_budget = None
                self.state = new_state._replace(poisoned=jnp.zeros((), bool))
            elif "batch_overflow" in stats and bool(
                np.asarray(stats["batch_overflow"])[tail].any()
            ):
                from sonar_3d_reconstruction_tpu.grid.hash import (
                    default_batch_budget,
                    effective_unique_budget,
                )

                if self._batch_budget is None:
                    ub = self._unique_budget or effective_unique_budget(
                        self._tables, self.cfg
                    )
                    self._batch_budget = default_batch_budget(
                        min(self.window, self.chunk_size), ub
                    )
                self._batch_budget *= 2
                self.state = new_state._replace(poisoned=jnp.zeros((), bool))
            else:
                self.state = rehash(new_state, self.state.key_hi.shape[0] * 2)
            self.stats.grows += 1
        else:
            raise RuntimeError(
                "hash growth did not converge after 12 retries in one chunk"
            )
        self._finish_chunk(t0, n)

    def _run_chunk_brick(self, images_dev, T_dev, n: int, sonar_pos) -> None:
        """Brick-backend chunk engine with the same grow/replay contract.

        ``sonar_pos``: host (chunk_size, 3) sonar origins — enables the
        compact box-key engine with STICKY grow-only per-axis bits (one
        recompile when a chunk needs wider axes; a chunk that cannot fit a
        u32 key at all runs the wide engine)."""
        from sonar_3d_reconstruction_tpu.grid.brick import (
            default_brick_budget,
            rehash_bricks,
        )
        from sonar_3d_reconstruction_tpu.grid.hash import (
            effective_unique_budget,
        )
        from sonar_3d_reconstruction_tpu.ops.packing import (
            compute_window_boxes,
        )
        from sonar_3d_reconstruction_tpu.pipeline import scan_pings_brick

        w = min(self.window, self.chunk_size)
        boxes = compute_window_boxes(
            sonar_pos, self.cfg.max_range, self.cfg.voxel_resolution, w,
            self.state.brick_bits,
            frame_bits=max(1, (w - 1).bit_length()),
            min_bits=self._box_bits,
        )
        if boxes is not None:
            bits = boxes[1]
            if self._box_bits is not None and bits != self._box_bits:
                self.stats.box_bits_recompiles += 1
            self._box_bits = bits

        start = 0
        for _retry in range(12):
            new_state, stats = scan_pings_brick(
                self.state, images_dev, T_dev, jnp.int32(start), jnp.int32(n),
                tables=self._tables, cfg=self.cfg, dtype=self.dtype,
                unique_budget=self._unique_budget,
                window=self.window, brick_budget=self._brick_budget,
                boxes=boxes,
            )
            over = np.asarray(stats["overflowed"])
            if not over.any():
                self.state = new_state
                return
            start = int(np.argmax(over))
            tail = slice(start, None)
            if bool(np.asarray(stats["range_fail"])[tail].any()):
                raise ValueError(
                    f"chunk frame {start}: voxel keys outside the packable "
                    "range — check odometry frame offsets"
                )
            if bool(np.asarray(stats["pack_overflow"])[tail].any()):
                raise ValueError(
                    "a voxel received 2^16+ emissions in one frame — use "
                    "backend='hash' for this degenerate geometry"
                )
            if bool(np.asarray(stats["unique_overflow"])[tail].any()):
                self._unique_budget = 2 * (
                    self._unique_budget
                    or effective_unique_budget(self._tables, self.cfg)
                )
                self._brick_budget = None
                self.state = new_state._replace(poisoned=jnp.zeros((), bool))
            elif bool(np.asarray(stats["batch_overflow"])[tail].any()):
                if self._brick_budget is None:
                    ub = self._unique_budget or effective_unique_budget(
                        self._tables, self.cfg
                    )
                    self._brick_budget = default_brick_budget(
                        min(self.window, self.chunk_size), ub
                    )
                self._brick_budget *= 2
                self.state = new_state._replace(poisoned=jnp.zeros((), bool))
            else:
                self.state = rehash_bricks(new_state, self.state.capacity * 2)
            self.stats.grows += 1
        raise RuntimeError(
            "brick growth did not converge after 12 retries in one chunk"
        )

    def _run_chunk_sharded(self, images, positions, quats, n: int) -> None:
        """Multi-chip chunk engine: the frame-parallel sharded wrapper
        handles growth internally; sticky post-growth budgets are threaded
        back through ``effective`` so later chunks start where this one
        ended (each adoption counts as one grow).  ``images`` keeps the
        padded static chunk shape; ``stop=n`` masks the padding without
        running its window programs."""
        from sonar_3d_reconstruction_tpu.parallel.shard_frames import (
            map_ping_sequence_sharded_frames,
        )

        eff: Dict[str, Any] = {}
        cap_before = self.state.local_capacity
        self.state, _stats = map_ping_sequence_sharded_frames(
            images, positions, quats, self.cfg, mesh=self.mesh,
            state=self.state, dtype=self.dtype,
            window=min(self.window, self.chunk_size),
            tables=self._tables, stop=n, effective=eff,
            box_min_bits=self._box_bits,
            **self._sharded_budgets,
        )
        # box-bit adoption is a recompile, not a budget grow (same
        # accounting as the single-chip compact engine)
        new_bits = eff.pop("box_min_bits", None)
        if new_bits is not None:
            if self._box_bits is not None and new_bits != self._box_bits:
                self.stats.box_bits_recompiles += 1
            self._box_bits = new_bits
        eff = {k: v for k, v in eff.items() if v is not None}
        if eff != self._sharded_budgets or self.state.local_capacity != cap_before:
            self.stats.grows += 1
            self._sharded_budgets = eff

    def _finish_chunk(self, t0: float, n: int) -> None:
        done = time.perf_counter()
        self.stats.device_time += done - t0
        self.stats.frames_mapped += n
        self.stats.chunks += 1
        # arrival -> state-committed latency per frame: the overflow check
        # above transferred per-frame stats, which synchronizes on the
        # chunk's final state — `done` is a real commit time, not a
        # dispatch time (BASELINE.md "p50 ping→map latency")
        self.stats.latencies.extend(done - a for a in self._chunk_arrivals)

        if self.incremental_publish and self._chunk_positions:
            # dirty region: every candidate of this chunk lies within
            # max_range of its ping's SONAR origin (the compact box-key
            # engine's own coverage guarantee) — record the pose-derived
            # voxel-key box for the next publish tick's selective pull
            T = batched_sonar_to_world(
                np.asarray(self._chunk_positions),
                np.asarray(self._chunk_quats), self.cfg,
            )
            p = T[:, :3, 3]
            res = self.cfg.voxel_resolution
            reach = self.cfg.max_range + 2 * res
            lo = np.floor((p.min(axis=0) - reach) / res).astype(np.int32)
            hi = np.floor((p.max(axis=0) + reach) / res).astype(np.int32)
            self._dirty_boxes.append(np.stack([lo, hi]))

        if self.publish is not None:
            self._maybe_publish(self._chunk_stamps[-1])

        self._chunk_images.clear()
        self._chunk_positions.clear()
        self._chunk_quats.clear()
        self._chunk_stamps.clear()
        self._chunk_arrivals.clear()

    def _maybe_publish(self, now: float) -> None:
        if self.stream_cfg.publish_rate_hz <= 0:
            return  # rate 0 disables the publish timer (never divide by it)
        period = 1.0 / self.stream_cfg.publish_rate_hz
        if self._next_publish_t is None:
            self._next_publish_t = now
        if now >= self._next_publish_t:
            self.publish(self.pointcloud_msg(stamp=now))
            # skip ahead (offline chunks can cover many publish periods)
            self._next_publish_t = now + period

    # -- extraction ------------------------------------------------------
    def _incremental_occupied(self):
        """O(changes)-per-tick extraction through the host view: first
        tick seeds with a full pull; later ticks pull only the dirty
        pose boxes accumulated since the previous one."""
        from sonar_3d_reconstruction_tpu.grid.brick import (
            BrickHostView,
            pull_all_touched_bricks,
            pull_bricks_in_boxes,
        )

        if self._host_view is None:
            self._host_view = BrickHostView()
            self._host_view.merge(*pull_all_touched_bricks(self.state))
            self._dirty_boxes.clear()  # the seed covers everything so far
        elif self._dirty_boxes:
            boxes = np.stack(self._dirty_boxes)
            self._dirty_boxes.clear()
            self._host_view.merge(
                *pull_bricks_in_boxes(self.state, boxes)
            )
        return self._host_view.extract_occupied(
            self.cfg, self.state.brick_bits
        )

    def pointcloud_msg(self, stamp: float = 0.0) -> Dict:
        if self.backend == "brick" and self.incremental_publish:
            points, probs = self._incremental_occupied()
        elif self.backend == "brick":
            from sonar_3d_reconstruction_tpu.grid.brick import (
                extract_occupied_brick,
            )

            points, probs = extract_occupied_brick(self.state, self.cfg)
        elif self.backend == "brick-sharded":
            from sonar_3d_reconstruction_tpu.parallel.shard_brick import (
                extract_occupied_sharded,
            )

            points, probs = extract_occupied_sharded(self.state, self.cfg)
        else:
            points, probs = extract_occupied_hash(self.state, self.cfg)
        sec = int(stamp)
        nanosec = int(round((stamp - sec) * 1e9))
        if nanosec >= 1_000_000_000:  # rounding carry: nanosec must be < 1e9
            sec += 1
            nanosec -= 1_000_000_000
        return serialize_pointcloud2(
            points,
            probs,
            frame_id=self.stream_cfg.map_frame_id,
            stamp=(sec, nanosec),
        )

    # -- drivers ----------------------------------------------------------
    def finish(self) -> StreamStats:
        self._sync.flush()
        self._flush_chunk()
        self.stats.dropped_unsynced = self._sync.dropped
        return self.stats

    def run_bag(self, bag_path: str) -> StreamStats:
        """Replay a rosbag2 recording (.db3 sqlite or .mcap, sniffed by
        magic) through the full streaming stack."""
        from sonar_3d_reconstruction_tpu.io.mcap import open_bag

        sc = self.stream_cfg
        with open_bag(bag_path) as bag:
            for topic, _bag_ts, msg in bag.messages(
                [sc.sonar_topic, sc.odometry_topic]
            ):
                if isinstance(msg, ImageMsg):
                    self.on_ping(msg)
                else:
                    self.on_pose(msg)
        return self.finish()
