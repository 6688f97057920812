"""Capture-machinery regression tests for bench.py and the graft entry.

These tests pin the structural guarantees of the benchmark's output:

  * importing the whole library, bench, and __graft_entry__ initializes
    ZERO jax backends (importing must never choose or reserve a device);
  * bench.py emits exactly one parseable JSON line even when main() fails
    before any jax work (error + stage fields instead of silence), and a
    host without a GPU gets that error line unless the CPU is asked for;
  * the committed bench_plan.json matches the default capture
    configuration (a stale plan costs the capture an extra compiled
    program family);
  * the one-line emit is first-caller-wins.
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_no_backend_init_at_import():
    code = (
        "import sonar_3d_reconstruction_tpu, bench, __graft_entry__\n"
        "import sonar_3d_reconstruction_tpu.io.native\n"
        "import sonar_3d_reconstruction_tpu.grid.brick\n"
        "import sonar_3d_reconstruction_tpu.grid.hash\n"
        "import sonar_3d_reconstruction_tpu.pipeline\n"
        "import sonar_3d_reconstruction_tpu.stream\n"
        "import sonar_3d_reconstruction_tpu.models.mapper\n"
        "import sonar_3d_reconstruction_tpu.parallel.shard_frames\n"
        "import sonar_3d_reconstruction_tpu.io.mcap\n"
        "import sonar_3d_reconstruction_tpu.cli\n"
        "import jax._src.xla_bridge as xb\n"
        "assert not xb._backends, list(xb._backends)\n"
        "print('CLEAN')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "CLEAN" in out.stdout


def test_bench_emits_error_json_on_failure():
    """A pre-jax failure (bad env) must still produce the one JSON line."""
    # explicit CPU rehearsal, so the failure is the BENCH_PINGS parse at
    # stage "setup"
    env = dict(os.environ, BENCH_PINGS="not-a-number", BENCH_PLATFORM="cpu")
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench.py")],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    lines = [ln for ln in out.stdout.strip().splitlines()
             if ln.startswith("{")]
    assert len(lines) == 1, out.stdout
    payload = json.loads(lines[0])
    assert payload["metric"] == "voxel_log_odds_updates_per_sec"
    assert payload["value"] == 0.0
    assert "error" in payload and "stage" in payload
    assert out.returncode != 0  # failure is still signalled via rc


def test_emit_is_first_caller_wins(capsys):
    import bench

    # reset module state (other tests may have imported it)
    bench._EMITTED = False
    assert bench._emit({"a": 1}) is True
    assert bench._emit({"b": 2}) is False
    out = capsys.readouterr().out.strip().splitlines()
    assert out == ['{"a": 1}']
    bench._EMITTED = False


def test_failure_after_timed_run_salvages_partial(capsys):
    """An exception AFTER the timed run (e.g. in the latency stage) must
    emit the measured headline with an error note — not a value-0 error
    line that discards the capture number the run already earned."""
    import bench

    bench._EMITTED = False
    bench._PARTIAL = {"metric": "voxel_log_odds_updates_per_sec",
                      "value": 42.0, "detail": {"backend": "brick"}}
    try:
        bench._emit_failure(RuntimeError("latency stage exploded"))
        out = capsys.readouterr().out.strip().splitlines()
        assert len(out) == 1
        payload = json.loads(out[0])
        assert payload["value"] == 42.0
        assert "latency stage exploded" in payload["detail"]["error_note"]
    finally:
        bench._EMITTED = False
        bench._PARTIAL = None


def test_failure_before_any_result_emits_error_payload(capsys):
    import bench

    bench._EMITTED = False
    bench._PARTIAL = None
    try:
        bench._emit_failure(ValueError("no backend"))
        payload = json.loads(capsys.readouterr().out.strip())
        assert payload["value"] == 0.0
        assert "no backend" in payload["error"]
    finally:
        bench._EMITTED = False


def test_plan_bypassed_by_explicit_experiment_knobs(monkeypatch):
    """BENCH_BRICK_BUDGET / BENCH_UNIQUE_BUDGET / BENCH_TUNE_BUDGETS=0 are
    consumed inside the discovery path and are not part of the plan key —
    a plan hit would silently measure the tuned default configuration, so
    any of them must force a plan miss."""
    import bench

    with open(bench.PLAN_PATH) as f:
        key = next(iter(json.load(f)))

    for name in ("BENCH_BRICK_BUDGET", "BENCH_UNIQUE_BUDGET"):
        monkeypatch.setenv(name, "4096")
        assert bench._load_plan(key) is None, name
        monkeypatch.delenv(name)
    monkeypatch.setenv("BENCH_TUNE_BUDGETS", "0")
    assert bench._load_plan(key) is None
    monkeypatch.delenv("BENCH_TUNE_BUDGETS")
    assert bench._load_plan(key) is not None  # control: default env hits


def test_bench_without_gpu_emits_error_and_fails():
    """No GPU and no explicit BENCH_PLATFORM: one error line naming the
    missing GPU and a non-zero exit, never a CPU number."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("BENCH_PLATFORM", None)
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench.py")],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    lines = [ln for ln in out.stdout.strip().splitlines()
             if ln.startswith("{")]
    assert len(lines) == 1, out.stdout
    payload = json.loads(lines[0])
    assert payload["value"] == 0.0
    assert "no GPU" in payload["error"]
    assert payload["stage"] == "backend"
    assert out.returncode != 0


def test_committed_plan_matches_default_capture_config():
    """bench_plan.json must contain the key for the driver's default run
    (plain `python bench.py`: brick backend, 256 pings, the default
    window (bench.DEFAULT_WINDOW), the default dense mode
    (bench.DEFAULT_DENSE_MODE), default capacity/seed)."""
    import bench
    from sonar_3d_reconstruction_tpu.config import MapperConfig
    from sonar_3d_reconstruction_tpu.ops.backproject import (
        required_fan_cap,
        required_free_cap,
        required_window_cap,
    )

    cfg = MapperConfig()
    images, _, _ = bench.make_inputs(cfg, 256)
    caps = (
        required_fan_cap(images, cfg, cfg.image_height),
        required_window_cap(images, cfg, cfg.image_height),
        required_free_cap(images, cfg, cfg.image_height),
    )
    key = bench._plan_key(cfg, 256, bench.DEFAULT_WINDOW, "brick",
                          bench.DEFAULT_DENSE_MODE, caps, 1 << 16, 0)
    with open(bench.PLAN_PATH) as f:
        plans = json.load(f)
    assert key in plans, (
        "bench_plan.json is stale for the default capture config — "
        "regenerate with BENCH_WRITE_PLAN=1 python bench.py"
    )
    plan = plans[key]
    for field in ("capacity", "unique_budget", "brick_budget",
                  "safe_unique_budget"):
        assert field in plan, field
