"""chip_smoke.py on the CPU: it refuses to run without a GPU, and its phase
functions hold at tiny sizes. Also the compile-cache placement and the
native library's per-host build key, which the smoke relies on."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

import chip_smoke
from zigbpe_tpu.models import oracle
from zigbpe_tpu.native import fastio
from zigbpe_tpu.parallel import train_dp as dp

REPO = pathlib.Path(__file__).resolve().parent.parent


def _run_smoke(cwd, env_extra=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **(env_extra or {}))
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=240,
    )


def _has_result_line(stdout: str) -> bool:
    for line in stdout.splitlines():
        try:
            if isinstance(json.loads(line), dict):
                return True
        except ValueError:
            pass
    return False


def test_smoke_refuses_cpu():
    r = _run_smoke(REPO)
    assert r.returncode != 0
    assert "needs an NVIDIA GPU" in r.stdout
    assert not _has_result_line(r.stdout)


def test_smoke_alone_fails(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run_smoke(tmp_path)
    assert r.returncode != 0
    assert not _has_result_line(r.stdout)


def test_phase_golden(corpus_bytes):
    chip_smoke.phase_golden(corpus_bytes, chip_smoke.DATA_DIR / "merges.txt")


def _corpus(n, seed=3):
    rng = np.random.default_rng(seed)
    return bytes(rng.integers(97, 103, n, dtype=np.uint8))


@pytest.mark.parametrize(
    "prefix_bytes,budget_s",
    [(1 << 20, 180.0), (1000, 1e9), (1000, 0.0)],
    ids=["whole_corpus", "native_within_budget", "prefix_fallback"],
)
def test_phase_train(prefix_bytes, budget_s, capsys):
    data = _corpus(3000)
    merges = chip_smoke.phase_train(
        data, 280, "cpu", prefix_bytes=prefix_bytes, native_budget_s=budget_s
    )
    assert merges == oracle.train(data, 280)
    out = capsys.readouterr().out
    assert ("prefix" in out) == (budget_s == 0.0)


def test_phase_encode(capsys):
    data = _corpus(4096)
    merges = oracle.train(data, 290)
    chip_smoke.phase_encode(merges, data, 256, "cpu", workers=2)
    assert "identical on all 16 rows" in capsys.readouterr().out


def test_phase_encode_detects_mismatch(monkeypatch):
    data = _corpus(1024)
    merges = oracle.train(data, 270)
    monkeypatch.setattr(fastio, "encode", lambda d, m: list(d))
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.phase_encode(merges, data, 256, "cpu", workers=2)


@pytest.mark.parametrize("table", ["replicated", "row_sharded"])
def test_phase_dp(table, monkeypatch, capsys):
    if table == "row_sharded":
        # the row-sharded table at a small vocab (as in test_parallel_scale)
        monkeypatch.setattr(dp, "LAZY_VOCAB_MAX", 257)
    chip_smoke.phase_dp(_corpus(4000), 300, jax.devices()[:4], "cpu")
    assert f"{table.replace('_', '-')} table" in capsys.readouterr().out


def _cache_config_in_subprocess(env_extra, before_import=""):
    """(cache dir, min compile secs) a fresh process ends up with after
    importing zigbpe_tpu and compiling one program."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("JAX_PERSISTENT_CACHE")
           and k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(JAX_PLATFORMS="cpu", **env_extra)
    code = (
        "import jax, jax.numpy as jnp\n"
        f"{before_import}\n"
        "import zigbpe_tpu\n"
        "jax.jit(lambda x: x * 2 + 1)(jnp.arange(8)).block_until_ready()\n"
        "print(jax.config.jax_compilation_cache_dir)\n"
        "print(jax.config.jax_persistent_cache_min_compile_time_secs)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120, check=True)
    cache_dir, floor = r.stdout.strip().splitlines()[-2:]
    return cache_dir, float(floor)


def test_compile_cache_follows_env(tmp_path):
    cache = tmp_path / "cache"
    got, floor = _cache_config_in_subprocess({
        "JAX_COMPILATION_CACHE_DIR": str(cache),
        "JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS": "0",
    })
    assert got == str(cache)
    assert floor == 0.0  # the environment's floor is left alone too
    assert any(cache.iterdir())  # the compiled program landed there


def test_compile_cache_defaults_into_checkout():
    import zigbpe_tpu

    got, floor = _cache_config_in_subprocess({})
    assert got == str(zigbpe_tpu.COMPILE_CACHE_DIR)
    assert zigbpe_tpu.COMPILE_CACHE_DIR == REPO / ".jax_cache"
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()
    assert floor == zigbpe_tpu.CACHE_MIN_COMPILE_SECS


def test_compile_cache_keeps_application_setting(tmp_path):
    import zigbpe_tpu

    cache = tmp_path / "app_cache"
    got, floor = _cache_config_in_subprocess(
        {}, before_import=f"jax.config.update('jax_compilation_cache_dir', {str(cache)!r})"
    )
    assert got == str(cache)
    assert floor == zigbpe_tpu.CACHE_MIN_COMPILE_SECS


needs_gxx = pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ toolchain")


@needs_gxx
def test_native_rebuilds_when_key_differs(monkeypatch, tmp_path):
    monkeypatch.setattr(fastio, "_HERE", tmp_path)
    # a library under another key (built on another host) is never used
    (tmp_path / "libzigbpe-otherhost.so").write_bytes(b"not a library")
    monkeypatch.setattr(fastio, "build_key", lambda: "k1")
    first = fastio.build()
    assert first == tmp_path / "libzigbpe-k1.so" and first.exists()
    stamp = first.stat().st_mtime_ns
    assert fastio.build() == first and first.stat().st_mtime_ns == stamp
    monkeypatch.setattr(fastio, "build_key", lambda: "k2")
    second = fastio.build()
    assert second == tmp_path / "libzigbpe-k2.so" and second.exists()


@needs_gxx
def test_native_key_covers_flags(monkeypatch):
    key = fastio.build_key()
    assert key == fastio.build_key()
    monkeypatch.setattr(fastio, "_FLAGS", [*fastio._FLAGS, "-DZBPE_OTHER"])
    assert fastio.build_key() != key
