#!/usr/bin/env python3
"""Bring-up smoke test of the mapper on one NVIDIA GPU.

Drives the main path once through the entry points a user calls, at the
reference sensor's full width (500 x 512 pings, 0.05 m voxels, 130 deg
FOV — ``MapperConfig()`` defaults), and checks every result against the
repository's own references.  Everything runs in ONE process, because a JAX
process reserves most of the card's memory; ``nvidia-smi`` is the only
child process.

Phases (the first failure exits non-zero, and no result line is printed):

1. device — the default JAX device must be a GPU; prints the card's name
   and power limit and the compile-cache directory in use;
2. golden parity — a small survey through the hash, brick and dense
   backends against ``golden.GoldenMapper``, in float64 and float32;
3. full width, library — ``SonarMapper`` (hash) ping by ping and
   ``map_ping_sequence(backend="brick", window=16)``, the latter compared
   with the same program on the CPU backend of this process; bring-up
   timings of the ``bfv`` and ``scalar`` window steps;
4. full width, CLI — ``make-bag``, ``map-bag`` (streaming) and ``map-bag
   --backend brick --offline``, called in-process; both saved maps agree.

``--four-cards`` runs only the frame-parallel sharded engine
(parallel/shard_frames.py) over a 4-GPU mesh and what it is compared with:
a 1-device mesh and the single-card brick backend.

Usage::

    python chip_smoke.py [--seed N] [--four-cards]

The last line of stdout is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = "sonar_3d_reconstruction_tpu"

# Float32 bar of every map comparison: the project's 1e-5 parity bar.
F32_ATOL = 1e-5
# Float64 against the golden oracle (log-odds): equal to the last bits.
# The oracle sums emissions one by one, the device multiplies exact
# integer counts by the per-type log-odds, so the two may round apart.
F64_ATOL = 1e-12


class SmokeFailure(Exception):
    """A phase's check failed."""


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def import_package():
    """Import the package from beside this script and nowhere else."""
    import importlib

    pkg = importlib.import_module(PKG)
    where = os.path.dirname(os.path.abspath(pkg.__file__))
    check(
        where == os.path.join(HERE, PKG),
        f"{PKG} was imported from {where}, not from this checkout",
    )
    return pkg


# ---------------------------------------------------------------------------
# Map comparison
# ---------------------------------------------------------------------------

_BIAS = 1 << 20


def _coded(vox):
    """(keys (N, 3), log-odds (N,)) -> (int64 codes, float64 values)."""
    keys = np.asarray(vox[0], np.int64).reshape(-1, 3) + _BIAS
    codes = (keys[:, 0] << 42) | (keys[:, 1] << 21) | keys[:, 2]
    return codes, np.asarray(vox[1], np.float64).reshape(-1)


def compare_maps(a, b, *, atol: float, space: str = "log_odds"):
    """Compare two maps given as (keys (N, 3), log-odds (N,)).

    Returns ``(ok, summary)``: ok when the voxel key sets are identical,
    neither map repeats a key, every value is finite, and every pair of
    values (log-odds, or probabilities with ``space="probability"``)
    differs by at most ``atol``."""
    ca, va = _coded(a)
    cb, vb = _coded(b)
    dup = (ca.size - np.unique(ca).size) + (cb.size - np.unique(cb).size)
    only_a = int(np.setdiff1d(ca, cb).size)
    only_b = int(np.setdiff1d(cb, ca).size)
    _, ia, ib = np.intersect1d(ca, cb, return_indices=True)
    x, y = va[ia], vb[ib]
    if space == "probability":
        x, y = 1.0 / (1.0 + np.exp(-x)), 1.0 / (1.0 + np.exp(-y))
    diff = np.abs(x - y)
    n_over = int(np.sum(~(diff <= atol)))  # NaN counts as over
    finite = bool(np.isfinite(va).all() and np.isfinite(vb).all())
    summary = {
        "voxels": [int(ca.size), int(cb.size)],
        "only_first": only_a,
        "only_second": only_b,
        "duplicates": int(dup),
        "finite": finite,
        "max_abs_diff": float(diff.max()) if diff.size else 0.0,
        "over_tolerance": n_over,
        "space": space,
        "atol": atol,
    }
    ok = only_a == 0 and only_b == 0 and dup == 0 and finite and n_over == 0
    return ok, summary


def state_voxels(state):
    """(keys, log-odds) of every touched voxel of a hash, brick or sharded
    brick state."""
    from sonar_3d_reconstruction_tpu.grid.brick import (
        BrickGridState,
        touched_voxels_brick,
    )
    from sonar_3d_reconstruction_tpu.grid.hash import touched_voxels_hash
    from sonar_3d_reconstruction_tpu.parallel.shard_brick import (
        ShardedBrickState,
        gather_sharded_brick_state,
    )

    if isinstance(state, BrickGridState):
        return touched_voxels_brick(state)
    if isinstance(state, ShardedBrickState):
        return gather_sharded_brick_state(state)
    return touched_voxels_hash(state)


def mapper_voxels(mapper):
    """(keys, log-odds) of every touched voxel of a ``SonarMapper``."""
    if mapper.backend != "dense":
        return state_voxels(mapper.state)
    spec = mapper.dense_spec
    idx = np.flatnonzero(np.asarray(mapper.state.touched))
    keys = np.stack(np.unravel_index(idx, spec.shape), axis=-1)
    return keys + np.asarray(spec.origin_key), np.asarray(
        mapper.state.log_odds
    )[idx]


def golden_voxels(golden):
    items = list(golden.map.log_odds.items())
    keys = np.asarray([k for k, _ in items], np.int64).reshape(-1, 3)
    return keys, np.asarray([v for _, v in items], np.float64)


def require_same(name: str, a, b, *, atol: float, space: str = "log_odds"):
    ok, summary = compare_maps(a, b, atol=atol, space=space)
    log(f"  {name}: {json.dumps(summary)}")
    check(ok, f"{name}: maps differ ({summary})")


# ---------------------------------------------------------------------------
# Surveys
# ---------------------------------------------------------------------------

def small_survey(cfg, n_pings: int, seed: int):
    """Sparse bright blobs over low noise on a circular track — small
    enough for the pure-Python golden oracle."""
    rng = np.random.default_rng(seed)
    R, B = cfg.image_height, cfg.image_width
    images = rng.integers(0, 20, size=(n_pings, R, B)).astype(np.uint8)
    for img in images:
        for _ in range(max(1, R * B // 2500)):
            r0 = int(rng.integers(0, R - 10))
            b0 = int(rng.integers(0, B - 8))
            img[r0:r0 + int(rng.integers(2, 10)),
                b0:b0 + int(rng.integers(2, 8))] = int(rng.integers(80, 220))
    t = np.linspace(0.0, 2 * np.pi, n_pings, endpoint=False)
    positions = np.stack(
        [0.8 * np.cos(t), 0.8 * np.sin(t), np.zeros(n_pings)], axis=-1
    )
    yaw = t + np.pi / 2
    quats = np.stack(
        [np.zeros(n_pings), np.zeros(n_pings), np.sin(yaw / 2),
         np.cos(yaw / 2)], axis=-1,
    )
    return images, positions, quats


def full_survey(cfg, n_pings: int, seed: int):
    """The benchmark's synthetic survey (bench.make_inputs)."""
    from bench import make_inputs

    return make_inputs(cfg, n_pings, seed=seed)


def parity_config():
    from sonar_3d_reconstruction_tpu.config import MapperConfig

    return MapperConfig(
        image_width=64, image_height=100, max_range=5.0, min_range=0.5,
        voxel_resolution=0.1, intensity_threshold=30,
    )


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_device(min_count: int = 1):
    """Phase 1: a GPU or nothing.  Returns (device, card line)."""
    import jax

    from sonar_3d_reconstruction_tpu.io import native
    from sonar_3d_reconstruction_tpu.utils.compile_cache import enable
    from sonar_3d_reconstruction_tpu.utils.profiling import (
        gpu_name_and_power_limit,
    )

    enable()
    devs = jax.devices()
    check(
        devs[0].platform == "gpu",
        f"the default JAX device is {devs[0].platform!r}, not a GPU",
    )
    check(len(devs) >= min_count,
          f"{len(devs)} GPU(s) found, {min_count} needed")
    card = gpu_name_and_power_limit()
    check(card is not None, "nvidia-smi reported no card")
    log(f"[device] {devs[0].device_kind}, {len(devs)} device(s), "
        f"platform {devs[0].platform}")
    log(f"[device] card (name, power limit): {card}")
    log(f"[device] compile cache: {jax.config.jax_compilation_cache_dir}")
    log(f"[device] native io library loaded: {native.available()}")
    return devs[0], card


def golden_parity(cfg, images, positions, quats,
                  backends=("hash", "brick", "dense")):
    """Phase 2: every backend against the golden oracle, float64 (with x64
    on for this phase only) and float32.  Per-frame num_occupied/num_free
    must be equal; the voxel key sets identical."""
    import jax
    import jax.numpy as jnp

    from sonar_3d_reconstruction_tpu.golden import GoldenMapper
    from sonar_3d_reconstruction_tpu.models import SonarMapper

    g = GoldenMapper(cfg)
    gstats = [g.process_ping(img, p, q)
              for img, p, q in zip(images, positions, quats)]
    gold = golden_voxels(g)
    log(f"[parity] golden: {len(images)} pings "
        f"{cfg.image_height}x{cfg.image_width}, {len(gold[1])} voxels")
    failures = []  # every combination runs; the phase fails at its end
    for dtype_name in ("float64", "float32"):
        x64 = (jax.enable_x64(True) if dtype_name == "float64"
               else contextlib.nullcontext())
        with x64:
            dtype = getattr(jnp, dtype_name)
            for backend in backends:
                name = f"{backend}/{dtype_name} vs golden"
                m = SonarMapper(cfg, backend=backend, dtype=dtype,
                                initial_capacity=1 << 13)
                for i, (img, p, q) in enumerate(
                        zip(images, positions, quats)):
                    s = m.process_sonar_image(img, p, q)
                    for k in ("num_occupied", "num_free"):
                        if s[k] != gstats[i][k]:
                            failures.append(
                                f"{name} frame {i}: {k} {s[k]} != "
                                f"{gstats[i][k]}")
                if dtype_name == "float64":
                    ok, summary = compare_maps(mapper_voxels(m), gold,
                                               atol=F64_ATOL)
                else:
                    ok, summary = compare_maps(
                        mapper_voxels(m), gold, atol=F32_ATOL,
                        space="probability")
                log(f"  {name}: {json.dumps(summary)}")
                if not ok:
                    failures.append(f"{name}: maps differ")
    check(not failures, "; ".join(failures))


@contextlib.contextmanager
def no_cache_writes():
    """Keep this block's compiles out of the persistent cache (XLA:CPU
    executables are specific to the host that compiled them)."""
    import jax

    before = jax.config.jax_persistent_cache_min_compile_time_secs
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1e9)
    try:
        yield
    finally:
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          before)


def _sync(tree):
    import jax

    jax.block_until_ready(tree)
    return tree


def brick_sequence(cfg, images, positions, quats, window, effective=None):
    """The library's brick path, synced; returns (state, stats, seconds)."""
    from sonar_3d_reconstruction_tpu.pipeline import map_ping_sequence

    t0 = time.perf_counter()
    st, stats = map_ping_sequence(
        images, positions, quats, cfg, backend="brick", window=window,
        effective=effective,
    )
    _sync(st)
    return st, stats, time.perf_counter() - t0


def hash_pings(cfg, images, positions, quats):
    """``SonarMapper(cfg)`` (the default hash backend), ping by ping.
    Returns (per-ping stats, per-ping seconds)."""
    from sonar_3d_reconstruction_tpu.models import SonarMapper

    m = SonarMapper(cfg)
    stats, secs = [], []
    for img, p, q in zip(images, positions, quats):
        t0 = time.perf_counter()
        stats.append(m.process_sonar_image(img, p, q))  # syncs: int stats
        secs.append(time.perf_counter() - t0)
    return stats, secs


def window_step_timings(cfg, images, positions, quats, effective, window,
                        modes=("bfv", "scalar"), reps=3):
    """Compile and time the brick window step (records + apply in one
    program) for each dense mode, and the records-only program; the
    apply's share of the step is 1 - records/step.  Returns a dict."""
    import jax
    import jax.numpy as jnp

    from sonar_3d_reconstruction_tpu.grid.brick import (
        DEFAULT_BRICK_BITS,
        init_brick_grid,
    )
    from sonar_3d_reconstruction_tpu.ops.backproject import (
        resolve_capped_tables,
    )
    from sonar_3d_reconstruction_tpu.ops.packing import compute_window_boxes
    from sonar_3d_reconstruction_tpu.pipeline import (
        _records_window,
        _window_step_brick_compact,
        batched_sonar_to_world,
    )

    P, R, B = images.shape
    window = min(window, P)
    tables = resolve_capped_tables(images, cfg, R, B)
    T = batched_sonar_to_world(positions, quats, cfg)
    images_dev = jnp.asarray(images)
    T_dev = jnp.asarray(T, jnp.float32)
    boxes = compute_window_boxes(
        T[:, :3, 3], cfg.max_range, cfg.voxel_resolution, window,
        DEFAULT_BRICK_BITS, frame_bits=max(1, (window - 1).bit_length()),
    )
    check(boxes is not None, "the survey does not fit the compact box keys")
    box_mins = [jnp.asarray(b) for b in np.asarray(boxes[0], np.int32)]
    box_bits = tuple(boxes[1])
    starts = [jnp.int32(w) for w in range(0, P, window)]
    start, stop = jnp.int32(0), jnp.int32(P)
    rec_kw = dict(
        tables=tables, cfg=cfg, dtype=jnp.float32,
        unique_budget=effective["unique_budget"], window=window,
        dedup_lane_budget=0, brick_bits=DEFAULT_BRICK_BITS,
        box_bits=box_bits,
    )
    state0 = init_brick_grid(effective["capacity"], jnp.float32)

    def timed_windows(run):
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            out = run()
            _sync(out)
            best = min(best, time.perf_counter() - t0)
        return best

    t0 = time.perf_counter()
    rec_prog = _records_window.lower(
        images_dev, T_dev, starts[0], start, stop, box_mins[0], **rec_kw
    ).compile()
    out = {"records": {"compile_s": time.perf_counter() - t0}}

    def run_records():
        return [rec_prog(images_dev, T_dev, w, start, stop, bm)
                for w, bm in zip(starts, box_mins)]

    out["records"]["ms_per_ping"] = 1e3 * timed_windows(run_records) / P
    for mode in modes:
        t0 = time.perf_counter()
        step = _window_step_brick_compact.lower(
            state0, images_dev, T_dev, starts[0], start, stop, box_mins[0],
            brick_budget=effective["brick_budget"], lane_budget=None,
            insert_budget=None, vox_budget=None, dense_mode=mode,
            records_batch=1, **rec_kw,
        ).compile()
        compile_s = time.perf_counter() - t0

        def run_steps():
            st = state0
            flags = []
            for w, bm in zip(starts, box_mins):
                st, stats = step(st, images_dev, T_dev, w, start, stop, bm)
                flags.append(stats["overflowed"])
            return st, flags

        st, flags = _sync(run_steps())
        check(not any(bool(np.asarray(f).any()) for f in flags),
              f"{mode} window step overflowed at the settled budgets")
        ms = 1e3 * timed_windows(run_steps) / P
        mem = step.memory_analysis()
        out[mode] = {
            "compile_s": compile_s,
            "ms_per_ping": ms,
            "apply_share": 1.0 - out["records"]["ms_per_ping"] / ms,
            "memory_analysis": None if mem is None else {
                k: int(getattr(mem, k)) for k in (
                    "argument_size_in_bytes", "output_size_in_bytes",
                    "temp_size_in_bytes", "generated_code_size_in_bytes",
                ) if hasattr(mem, k)
            },
        }
    return out


def full_width_library(cfg, images, positions, quats, *, n_hash: int,
                       window: int, card: str):
    """Phase 3: the library entry points at full width."""
    import jax

    label = f"bring-up reading on {card}"
    hstats, hsecs = hash_pings(cfg, images[:n_hash], positions[:n_hash],
                               quats[:n_hash])
    check(all(s["num_occupied"] + s["num_free"] > 0 for s in hstats),
          "SonarMapper produced an empty frame")
    log(f"[library] SonarMapper(hash) {n_hash} pings: first call "
        f"{hsecs[0]:.2f} s, warm {1e3 * np.mean(hsecs[1:]):.2f} ms/ping "
        f"({label})")

    eff = {}
    st, stats, first = brick_sequence(cfg, images, positions, quats, window,
                                      effective=eff)
    check(eff.get("box_bits") is not None, "compact box-key path not taken")
    _, _, warm = brick_sequence(cfg, images, positions, quats, window)
    P = len(images)
    log(f"[library] map_ping_sequence(brick, window={window}) {P} pings: "
        f"first call {first:.2f} s, warm {1e3 * warm / P:.2f} ms/ping "
        f"({label})")
    for k in ("num_occupied", "num_free"):
        got = [s[k] for s in hstats]
        want = np.asarray(stats[k])[:n_hash].tolist()
        check(got == want, f"hash vs brick per-frame {k}: {got} != {want}")

    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu), no_cache_writes():
        st_c, stats_c, cpu_s = brick_sequence(cfg, images, positions, quats,
                                              window)
        ref = state_voxels(st_c)
    log(f"[library] CPU reference run: {cpu_s:.2f} s")
    for k in ("num_candidates", "num_occupied", "num_free"):
        a, b = np.asarray(stats[k]), np.asarray(stats_c[k])
        check(np.array_equal(a, b),
              f"brick {k} differs from the CPU backend: "
              f"{int(np.sum(a != b))} frames")
    log("[library] per-frame num_candidates/num_occupied/num_free equal "
        "the CPU backend's")
    require_same("brick GPU vs CPU", state_voxels(st), ref, atol=F32_ATOL)

    timings = window_step_timings(cfg, images, positions, quats, eff, window)
    log(f"[library] window steps ({label}): {json.dumps(timings)}")
    mem = jax.devices()[0].memory_stats() or {}
    log(f"[library] peak_bytes_in_use: {mem.get('peak_bytes_in_use')}")
    return timings


def load_saved_map(path: str):
    with np.load(path, allow_pickle=False) as z:
        return z["keys"], z["log_odds"]


def cli_user_path(workdir: str, *, n_pings: int, range_bins: int,
                  bearing_bins: int, seed: int, params=()):
    """Phase 4: the CLI commands a user runs, in this process (no YAML:
    PyYAML need not be installed)."""
    from sonar_3d_reconstruction_tpu.cli import main as cli_main

    bag = os.path.join(workdir, "survey.db3")
    check(cli_main(["make-bag", bag, "--pings", str(n_pings),
                    "--range-bins", str(range_bins),
                    "--bearing-bins", str(bearing_bins),
                    "--seed", str(seed)]) == 0, "make-bag failed")
    over = [a for p in params for a in ("--param", p)]
    maps = {}
    for name, extra in (("streaming", []),
                        ("offline-brick", ["--backend", "brick",
                                           "--offline"])):
        out = os.path.join(workdir, f"{name}.npz")
        t0 = time.perf_counter()
        check(cli_main(["map-bag", bag, "--save-map", out, *extra, *over])
              == 0, f"map-bag {name} failed")
        log(f"[cli] map-bag {name}: {time.perf_counter() - t0:.2f} s")
        maps[name] = load_saved_map(out)
    require_same("map-bag streaming vs offline brick", maps["streaming"],
                 maps["offline-brick"], atol=F32_ATOL)


def four_card_phase(cfg, images, positions, quats, devices, window: int):
    """The frame-parallel sharded engine over a mesh of ``devices``: its
    map must be bit-identical to a 1-device mesh and to the single-device
    brick backend, also after one exchange-budget grow-and-replay."""
    import jax

    from sonar_3d_reconstruction_tpu.parallel.shard import make_mesh
    from sonar_3d_reconstruction_tpu.parallel.shard_frames import (
        map_ping_sequence_sharded_frames,
    )

    def sharded(mesh, **kw):
        t0 = time.perf_counter()
        st, stats = map_ping_sequence_sharded_frames(
            images, positions, quats, cfg, mesh=mesh, window=window, **kw
        )
        _sync(st)
        return st, stats, time.perf_counter() - t0

    eff = {}
    st, stats, secs = sharded(make_mesh(devices), effective=eff)
    check(eff.get("box_min_bits") is not None, "compact path not taken")
    check(not bool(np.asarray(stats["overflowed"]).any()), "overflowed")
    log(f"[sharded] {len(devices)}-device mesh, {len(images)} pings, "
        f"window {window}: {secs:.2f} s (first call)")
    shard_devs = [str(s.device) for s in st.log_odds.addressable_shards]
    log(f"[sharded] state shards on: {shard_devs}")
    check(len(set(shard_devs)) == len(devices),
          "the state is not spread over every device of the mesh")
    got = state_voxels(st)

    st1, _, _ = sharded(make_mesh(devices[:1]))
    require_same("sharded vs 1-device mesh", got, state_voxels(st1), atol=0.0)
    with jax.default_device(devices[0]):
        single, _, _ = brick_sequence(cfg, images, positions, quats, window)
    require_same("sharded vs single-device brick", got,
                 state_voxels(single), atol=0.0)

    # an exchange budget a quarter of the measured need overflows and is
    # doubled a few times (growth stops after max_grow_retries doublings)
    need = int(np.asarray(stats["xchg_n_max"]).max())
    budget = max(1, need // 4)
    check(need > budget, f"xchg_budget={budget} cannot bind (need {need})")
    grown = {}
    g, _, _ = sharded(make_mesh(devices), xchg_budget=budget, effective=grown)
    check(grown["xchg_budget"] >= need,
          f"xchg_budget {budget} was not grown: {grown['xchg_budget']}")
    log(f"[sharded] xchg_budget {budget} grown to {grown['xchg_budget']} "
        f"(need {need})")
    require_same("sharded after xchg growth", state_voxels(g), got, atol=0.0)


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of every generated survey")
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-GPU frame-parallel phase")
    args = ap.parse_args(argv)

    phase = "import"
    try:
        import_package()
        import jax

        from sonar_3d_reconstruction_tpu.config import MapperConfig

        phase = "device"
        device, card = phase_device(4 if args.four_cards else 1)
        cfg = MapperConfig()
        count = len(jax.devices())
        if args.four_cards:
            phase = "four-cards"
            images, positions, quats = full_survey(cfg, 32, args.seed)
            four_card_phase(cfg, images, positions, quats,
                            jax.devices()[:4], window=16)
            count = 4
        else:
            phase = "golden-parity"
            golden_parity(parity_config(),
                          *small_survey(parity_config(), 6, args.seed))
            phase = "full-width-library"
            images, positions, quats = full_survey(cfg, 32, args.seed)
            full_width_library(cfg, images, positions, quats, n_hash=8,
                               window=16, card=card)
            phase = "cli"
            with tempfile.TemporaryDirectory() as tmp:
                cli_user_path(tmp, n_pings=40, range_bins=cfg.image_height,
                              bearing_bins=cfg.image_width, seed=args.seed)
    except Exception as e:  # every phase failure ends the run non-zero
        traceback.print_exc()
        print(f"chip_smoke: phase {phase!r} failed: {e}", file=sys.stderr)
        return 1
    print(f"[done] all phases passed on {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": device.platform, "kind": device.device_kind,
        "count": count,
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
