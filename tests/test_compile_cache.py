"""Persistent compilation cache placement (utils/compile_cache.py): the
environment's JAX_COMPILATION_CACHE_DIR wins, an accelerator process
otherwise uses one fixed checkout directory, and a CPU process keeps no
persistent cache."""

import json
import os
import subprocess
import sys

from sonar_3d_reconstruction_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = (
    "import json, jax\n"
    "from sonar_3d_reconstruction_tpu.utils.compile_cache import (\n"
    "    cache_dir_for, enable)\n"
    "used = enable()\n"
    "print(json.dumps({'enable': used,\n"
    "                  'config': jax.config.jax_compilation_cache_dir,\n"
    "                  'gpu': cache_dir_for('gpu')}))\n"
)


def _probe(**env_over):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(JAX_PLATFORMS="cpu", **env_over)
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], env=env, cwd=REPO,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_env_dir_is_honoured(tmp_path):
    """With only JAX_COMPILATION_CACHE_DIR set, that directory is the cache
    of every process, CPU included, and enable() sets nothing else."""
    got = _probe(JAX_COMPILATION_CACHE_DIR=str(tmp_path))
    assert got == {"enable": str(tmp_path), "config": str(tmp_path),
                   "gpu": str(tmp_path)}


def test_default_dir_is_fixed_across_processes():
    """No fingerprint, pid or time in the path: two processes agree, and
    the directory is the checkout's .jax_cache."""
    a, b = _probe(), _probe()
    assert a["gpu"] == b["gpu"] == os.path.join(REPO, ".jax_cache")


def test_cpu_process_gets_no_cache():
    got = _probe()
    assert got["enable"] is None and got["config"] is None


def test_cache_dir_for_platforms(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert compile_cache.cache_dir_for("cpu") is None
    assert compile_cache.cache_dir_for("gpu") == compile_cache.DEFAULT_CACHE_DIR
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere")
    assert compile_cache.cache_dir_for("cpu") == "/elsewhere"
    assert compile_cache.cache_dir_for("gpu") == "/elsewhere"
