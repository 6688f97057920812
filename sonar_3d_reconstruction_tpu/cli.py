"""Command-line interface.

Replaces the reference's launch-file orchestration (launch/3d_mapping.launch.py)
for the non-ROS workflow:

  python -m sonar_3d_reconstruction_tpu selftest
      The reference library self-test scenario (scripts/3d_mapper.py:653-683):
      synthetic two-rectangle image, 3 frames stepping x by 0.1 m.

  python -m sonar_3d_reconstruction_tpu map-bag BAG.db3 [--config YAML]
      [--save-map out.npz] [--save-cloud out.pc2] [--chunk N]
      Offline replay of a rosbag2 recording through the full streaming stack
      (time sync, decode, chunked device mapping).

  python -m sonar_3d_reconstruction_tpu make-bag OUT.db3 [--pings N]
      Generate a synthetic KIRO-style recording (test fixture; the real
      dataset is not distributable).

  python -m sonar_3d_reconstruction_tpu tune BAG.db3 --out plan.json
      Measure the bag once and emit a deployment budget plan; feed it back
      with map-bag --offline --budgets plan.json (snug budgets size every
      apply-side op, as the bench's own plan does).

  python -m sonar_3d_reconstruction_tpu query MAP.npz X,Y,Z [X,Y,Z ...]
      Occupancy probability at world points from a saved snapshot
      (reference SimpleOctree.get_probability semantics).

  python -m sonar_3d_reconstruction_tpu bench
      Run the headline benchmark (same as bench.py at the repo root).

Config layering matches the reference minus the launch level:
CLI --param overrides > --config YAML > library defaults (SURVEY.md 5.6).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Optional

import numpy as np


def _parse_overrides(pairs: List[str]) -> Dict:
    out: Dict = {}
    for p in pairs:
        if "=" not in p:
            raise SystemExit(f"--param expects key=value, got {p!r}")
        k, v = p.split("=", 1)
        try:
            out[k] = json.loads(v)
        except json.JSONDecodeError:
            out[k] = v
    return out


def cmd_selftest(args: argparse.Namespace) -> int:
    from sonar_3d_reconstruction_tpu.models import SonarMapper

    mapper = SonarMapper(
        {
            "voxel_resolution": 0.1,
            "min_probability": 0.6,
            "intensity_threshold": 30,
        }
    )
    img = np.zeros((500, 512), np.uint8)
    img[100:150, 200:300] = 100   # bright regions (reference :667-669)
    img[300:350, 100:150] = 150
    for i in range(3):
        stats = mapper.process_sonar_image(
            img, [i * 0.1, 0.0, 0.0], [0.0, 0.0, 0.0, 1.0]
        )
        print(
            f"frame {stats['frame_count']}: occupied={stats['num_occupied']} "
            f"free={stats['num_free']} voxels={stats['num_voxels']} "
            f"({stats['processing_time'] * 1e3:.1f} ms)"
        )
    cloud = mapper.get_point_cloud()
    print(
        f"final map: {cloud['num_occupied']} occupied of "
        f"{cloud['num_voxels']} voxels"
    )
    return 0


def cmd_map_bag(args: argparse.Namespace) -> int:
    import jax.numpy as jnp

    from sonar_3d_reconstruction_tpu.config import load_config
    from sonar_3d_reconstruction_tpu.stream import StreamingMapper

    overrides = _parse_overrides(args.param)
    cfg, stream_cfg = load_config(args.config, overrides)

    # --budgets plans carry the backend/window they were tuned for; adopt
    # them when the flags were not explicitly given so the documented
    # `tune` -> `map-bag --budgets` flow works without repeating flags
    plan = None
    if getattr(args, "budgets", None):
        with open(args.budgets) as f:
            plan = json.load(f)
    if args.backend is None:
        args.backend = plan.get("backend", "hash") if plan else "hash"
    if args.window is None:
        args.window = plan.get("window", 8) if plan else 8

    if args.offline:
        return _map_bag_offline(args, cfg, stream_cfg, plan)
    if plan is not None and args.backend == "brick-sharded":
        print(
            "warning: --budgets applies to hash/brick backends only; "
            "ignoring",
            file=sys.stderr,
        )
        plan = None
    if plan is not None and plan.get("window") is not None:
        # the streaming engine clamps window to the chunk size; a plan
        # tuned for window W needs chunk >= W to run as tuned
        args.chunk = max(args.chunk, int(plan["window"]))

    published = {"n": 0, "points": 0, "bytes": 0}
    pub_cb = None
    if getattr(args, "publish", False):
        def pub_cb(msg):
            published["n"] += 1
            published["points"] = msg["width"]
            published["bytes"] += len(msg["data"])

    mapper = StreamingMapper(
        cfg,
        stream_cfg,
        chunk_size=args.chunk,
        window=args.window,
        dtype=jnp.float32,
        backend=args.backend,
        budgets=plan,
        publish=pub_cb,
    )
    t0 = time.perf_counter()
    stats = mapper.run_bag(args.bag)
    wall = time.perf_counter() - t0
    s = stats.summary()
    s["wall_time"] = wall
    s["pings_per_sec"] = stats.frames_mapped / wall if wall else 0.0
    if pub_cb is not None:
        s["publishes"] = published["n"]
        s["last_publish_points"] = published["points"]
        s["publish_bytes"] = published["bytes"]
    print(json.dumps(s, default=float))

    if args.save_map:
        from sonar_3d_reconstruction_tpu.io.checkpoint import save_map

        save_map(args.save_map, mapper.state, cfg)
        print(f"map snapshot -> {args.save_map}", file=sys.stderr)
    if args.save_cloud:
        msg = mapper.pointcloud_msg()
        with open(args.save_cloud, "wb") as f:
            f.write(msg["data"])
        print(
            f"final cloud ({msg['width']} points, XYZI f32) -> {args.save_cloud}",
            file=sys.stderr,
        )
    return 0


def _map_bag_offline(args, cfg, stream_cfg, budgets=None) -> int:
    """Batch path: native batch decode + pairing, whole bag as windowed
    device dispatches (pipeline.map_ping_sequence)."""
    import jax.numpy as jnp

    if args.chunk != 32:
        print(
            "warning: --chunk applies only to the streaming path (ignored "
            "with --offline)",
            file=sys.stderr,
        )

    from sonar_3d_reconstruction_tpu.io.bag import load_bag_sequence
    from sonar_3d_reconstruction_tpu.pipeline import map_ping_sequence

    t0 = time.perf_counter()
    images, positions, quats, stamps = load_bag_sequence(
        args.bag,
        sonar_topic=stream_cfg.sonar_topic,
        odometry_topic=stream_cfg.odometry_topic,
        slop=stream_cfg.sync_slop,
    )
    t_load = time.perf_counter() - t0
    if budgets is not None:
        if args.backend == "brick-sharded":
            print("warning: --budgets applies to hash/brick backends only",
                  file=sys.stderr)
            budgets = None
        elif budgets.get("backend", args.backend) != args.backend:
            raise SystemExit(
                f"--budgets plan was tuned for backend="
                f"{budgets.get('backend')!r} but map-bag is running "
                f"{args.backend!r}; pass --backend {budgets.get('backend')} "
                "(or omit it — the plan's backend is adopted by default)"
            )
        elif budgets.get("window", args.window) != args.window:
            raise SystemExit(
                f"--budgets plan was tuned for window="
                f"{budgets.get('window')} but map-bag is running "
                f"--window {args.window} (omit --window to adopt the plan's)"
            )
    t0 = time.perf_counter()
    if args.backend == "brick-sharded":
        from sonar_3d_reconstruction_tpu.parallel.shard_frames import (
            map_ping_sequence_sharded_frames,
        )

        state, stats = map_ping_sequence_sharded_frames(
            images, positions, quats, cfg, dtype=jnp.float32,
            window=args.window,
        )
    else:
        state, stats = map_ping_sequence(
            images, positions, quats, cfg, dtype=jnp.float32,
            window=args.window, backend=args.backend, budgets=budgets,
        )
    t_map = time.perf_counter() - t0
    n = len(images)
    span = float(stamps[-1] - stamps[0]) if n > 1 else 0.0
    print(
        json.dumps(
            {
                "pairs": n,
                "num_voxels": int(np.asarray(state.used).sum()),
                "load_time": t_load,
                "map_time": t_map,
                "pings_per_sec": n / t_map if t_map else 0.0,
                "realtime_factor": span / t_map if t_map else 0.0,
            }
        )
    )
    if args.save_map:
        from sonar_3d_reconstruction_tpu.io.checkpoint import save_map

        save_map(args.save_map, state, cfg)
    if args.save_cloud:
        from sonar_3d_reconstruction_tpu.io.pointcloud import serialize_pointcloud2

        if args.backend == "brick-sharded":
            from sonar_3d_reconstruction_tpu.parallel.shard_brick import (
                extract_occupied_sharded,
            )

            pts, probs = extract_occupied_sharded(state, cfg)
        else:
            if args.backend == "brick":
                from sonar_3d_reconstruction_tpu.grid.brick import (
                    extract_occupied_brick as _extract,
                )
            else:
                from sonar_3d_reconstruction_tpu.grid.hash import (
                    extract_occupied_hash as _extract,
                )

            pts, probs = _extract(state, cfg)
        with open(args.save_cloud, "wb") as f:
            f.write(serialize_pointcloud2(pts, probs)["data"])
    return 0


def cmd_make_bag(args: argparse.Namespace) -> int:
    from sonar_3d_reconstruction_tpu.io.bag import write_synthetic_bag

    rng = np.random.default_rng(args.seed)
    n, R, B = args.pings, args.range_bins, args.bearing_bins
    images = rng.integers(0, 25, size=(n, R, B)).astype(np.uint8)
    for i in range(n):
        r0 = int(R * 0.3) + int(R * 0.08 * np.sin(i / 7.0))
        images[i, r0 : r0 + int(R * 0.08), :] = rng.integers(
            80, 220, size=(int(R * 0.08), B)
        ).astype(np.uint8)
    positions = np.stack(
        [0.08 * np.arange(n), np.zeros(n), np.zeros(n)], axis=-1
    )
    yaw = 0.02 * np.arange(n)
    quats = np.stack(
        [np.zeros(n), np.zeros(n), np.sin(yaw / 2), np.cos(yaw / 2)], axis=-1
    )
    write_synthetic_bag(args.out, images, positions, quats, rate_hz=args.rate)
    print(f"synthetic bag: {n} pings ({R}x{B}) -> {args.out}")
    return 0


def cmd_tune(args: argparse.Namespace) -> int:
    """One warmup mapping run over the bag -> a deployment budget plan
    (utils/autotune.tune_sequence).  Feed the plan back with
    ``map-bag --offline --budgets PLAN.json`` — snug budgets size every
    apply-side indexed op and sort."""
    import jax.numpy as jnp

    from sonar_3d_reconstruction_tpu.config import load_config
    from sonar_3d_reconstruction_tpu.io.bag import load_bag_sequence
    from sonar_3d_reconstruction_tpu.utils.autotune import tune_sequence

    overrides = _parse_overrides(args.param)
    cfg, stream_cfg = load_config(args.config, overrides)
    images, positions, quats, _ = load_bag_sequence(
        args.bag,
        sonar_topic=stream_cfg.sonar_topic,
        odometry_topic=stream_cfg.odometry_topic,
        slop=stream_cfg.sync_slop,
    )
    plan = tune_sequence(
        images, positions, quats, cfg, backend=args.backend,
        window=args.window, dense_mode=args.dense_mode, dtype=jnp.float32,
    )
    text = json.dumps(plan, indent=1, sort_keys=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
        print(f"budget plan ({len(images)} pings) -> {args.out}",
              file=sys.stderr)
    else:
        print(text)
    return 0


def cmd_query(args: argparse.Namespace) -> int:
    """Point-query a saved map snapshot (reference SimpleOctree
    get_probability semantics: never-updated voxels answer p=0.5)."""
    from sonar_3d_reconstruction_tpu.grid.hash import query_probability
    from sonar_3d_reconstruction_tpu.io.checkpoint import load_map

    state, cfg = load_map(args.map)
    rows = []
    for p in args.points:
        parts = p.split(",")
        if len(parts) != 3:
            print(f"point {p!r}: expected X,Y,Z", file=sys.stderr)
            return 2
        try:
            rows.append([float(v) for v in parts])
        except ValueError:
            print(f"point {p!r}: coordinates must be numbers",
                  file=sys.stderr)
            return 2
    pts = np.asarray(rows, np.float64)
    probs = query_probability(state, pts, cfg)
    for p, pr in zip(pts, probs):
        print(json.dumps({"point": list(p), "probability": float(pr)}))
    return 0


def cmd_bench(args: argparse.Namespace) -> int:
    import importlib.util

    # bench.py lives at the repo root (not inside the installed package)
    path = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "bench.py",
    )
    if not os.path.exists(path):
        raise SystemExit(
            f"bench.py not found at {path} — run from a source checkout"
        )
    spec = importlib.util.spec_from_file_location("bench", path)
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    bench.main()
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="sonar_3d_reconstruction_tpu", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument(
        "--platform", default=None, metavar="NAME",
        help="jax platform override (e.g. cpu, to rehearse on the host "
        "CPU).  Also honored from SONAR3D_PLATFORM.",
    )
    sub = parser.add_subparsers(dest="cmd", required=True)

    sub.add_parser("selftest", help="reference __main__ scenario")

    p = sub.add_parser("map-bag", help="offline rosbag2 replay -> map")
    p.add_argument("bag")
    p.add_argument("--config", default=None, help="reference-schema YAML")
    p.add_argument(
        "--param", action="append", default=[], metavar="KEY=VALUE",
        help="config override (highest priority), repeatable",
    )
    p.add_argument("--chunk", type=int, default=32)
    p.add_argument(
        "--backend", choices=("hash", "brick", "brick-sharded"),
        default=None,
        help="map backend (streaming and --offline): per-voxel hash table "
        "or sparse-of-dense brick table (grid/brick.py).  Default: hash, "
        "or the --budgets plan's backend when one is given",
    )
    p.add_argument(
        "--offline", action="store_true",
        help="batch path: native decode + whole-bag mapping "
        "(fastest; no streaming publish)",
    )
    p.add_argument(
        "--window", type=int, default=None,
        help="batched-apply engine window (both streaming and --offline): "
        "one set of table interactions per window of pings; 1 = per-ping. "
        "Default: 8, or the --budgets plan's window when one is given",
    )
    p.add_argument("--save-map", default=None, metavar="OUT.npz")
    p.add_argument("--save-cloud", default=None, metavar="OUT.pc2")
    p.add_argument(
        "--budgets", default=None, metavar="PLAN.json",
        help="deployment budget plan from `tune` (--offline path); snug "
        "budgets size every apply-side op — stale plans fall back safely",
    )
    p.add_argument(
        "--publish", action="store_true",
        help="streaming path: attach a counting publish sink at the "
        "config's publish_rate_hz (the reference node's 10 Hz tick, "
        "node:227-231) — the summary then reports publishes / "
        "last_publish_points / publish_bytes",
    )

    p = sub.add_parser(
        "tune", help="measure a bag once -> deployment budget plan (JSON)"
    )
    p.add_argument("bag")
    p.add_argument("--config", default=None, help="reference-schema YAML")
    p.add_argument(
        "--param", action="append", default=[], metavar="KEY=VALUE",
        help="config override (highest priority), repeatable",
    )
    p.add_argument("--backend", choices=("hash", "brick"), default="brick")
    p.add_argument("--window", type=int, default=8)
    p.add_argument(
        "--dense-mode", choices=("scalar", "bfv", "row"),
        default="bfv",
        help="brick dense-scatter structure the plan budgets for",
    )
    p.add_argument("--out", default=None, metavar="PLAN.json")

    p = sub.add_parser(
        "query", help="occupancy probability at world points from a saved map"
    )
    p.add_argument("map", help=".npz snapshot from map-bag --save-map")
    p.add_argument(
        "points", nargs="+", metavar="X,Y,Z", help="query points (repeatable)"
    )

    p = sub.add_parser("make-bag", help="generate a synthetic recording")
    p.add_argument("out")
    p.add_argument("--pings", type=int, default=60)
    p.add_argument("--range-bins", type=int, default=500)
    p.add_argument("--bearing-bins", type=int, default=512)
    p.add_argument("--rate", type=float, default=2.0)
    p.add_argument("--seed", type=int, default=0)

    sub.add_parser("bench", help="headline benchmark (one JSON line)")

    args = parser.parse_args(argv)
    platform = args.platform or os.environ.get("SONAR3D_PLATFORM")
    if platform:
        import jax

        jax.config.update("jax_platforms", platform)
    if args.cmd != "make-bag":  # the one command that never touches jax
        from sonar_3d_reconstruction_tpu.utils.compile_cache import enable

        enable()
    return {
        "selftest": cmd_selftest,
        "map-bag": cmd_map_bag,
        "make-bag": cmd_make_bag,
        "tune": cmd_tune,
        "query": cmd_query,
        "bench": cmd_bench,
    }[args.cmd](args)


if __name__ == "__main__":
    raise SystemExit(main())
