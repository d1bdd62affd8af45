"""chip_smoke.py on the CPU: it refuses to run without a GPU, and its
phases, comparator and helpers work at tiny sizes. The GPU run itself is
`python chip_smoke.py` on the card."""

import math
from pathlib import Path

import jax
import numpy as np
import pytest

import bench
import chip_smoke
from quadruped_jax.robots import a1_params
from quadruped_jax.solvers import cone_qp
from quadruped_jax.utils import compile_cache

ROOT = Path(__file__).resolve().parent.parent


def test_main_exits_nonzero_without_gpu(capsys):
    assert chip_smoke.main([]) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out


@pytest.fixture
def restore_cache_config():
    saved = (jax.config.jax_compilation_cache_dir,
             jax.config.jax_persistent_cache_min_compile_time_secs)
    yield
    jax.config.update("jax_compilation_cache_dir", saved[0])
    jax.config.update("jax_persistent_cache_min_compile_time_secs", saved[1])


def test_compile_cache_honours_env(monkeypatch, tmp_path,
                                   restore_cache_config):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable() == str(tmp_path)
    # JAX reads the variable itself; the helper sets no other path.
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_into_checkout(monkeypatch,
                                              restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable(min_compile_secs=0.5)
    assert Path(path) == ROOT / ".jax_cache"
    assert jax.config.jax_compilation_cache_dir == path
    assert ".jax_cache/" in (ROOT / ".gitignore").read_text().split()


@pytest.mark.parametrize("perturb, ok", [
    (0.0, True), (0.5e-3, True), (2e-3, False), (math.nan, False)])
def test_parity_comparator(perturb, ok):
    a = np.linspace(-5.0, 5.0, 24).reshape(2, 12).astype(np.float32)
    b = a.copy()
    b[1, 3] += perturb
    assert (chip_smoke.max_abs_diff(a, b) <= 1e-3) is ok
    with pytest.raises(ValueError):
        chip_smoke.max_abs_diff(a, b[:1])


def test_phase_mpc_tiny():
    res = chip_smoke.phase_mpc(batch=16, n_ref=8, reps=1)
    assert res["ok"], res
    assert res["max_df_N"] == 0.0          # CPU against itself
    for name in chip_smoke.PRECISIONS:
        assert np.isfinite(res[f"ns_{name}"]["resid_max"])
    assert res["minv_bytes"] == 16 * 120 * 120 * 4


def test_phase_sweep_tiny():
    res = chip_smoke.phase_sweep(n=64, n_periods=2, n_ref=8, reps=1)
    assert res["alive_frac"] == 1.0
    assert res["max_dpos_m"] == 0.0 and res["max_dvel_ms"] == 0.0
    assert 0.2 < res["z_min"] <= res["z_max"] < 0.35
    assert np.isfinite(res["ticks_per_s"])


@pytest.mark.parametrize("polish, bound", [(1, 5e-3), (2, 1e-4)])
def test_ns_residual_on_bench_ensemble(polish, bound):
    """Residual of the Newton-Schulz inverse at POLISH_PRECISION on the
    bench ensemble: one polish step squares the bf16 phase's error once
    (max|I - M X| ~1.7e-3, relative inverse error ~2e-4); the production
    two (cone_qp.NS_F32_POLISH) reach < 1e-4."""
    b = 64
    cfg = bench.bench_config(10)
    rpy, feet, x0 = bench.make_states(b, 0.015, np.random.default_rng(0))
    table = bench.trot_table(b, 0.015, np.random.default_rng(1), 10)
    prob = jax.jit(lambda *a: bench.mpc_problem(cfg, a1_params(), *a))(
        rpy, feet, x0, table)
    m = cone_qp.setup(prob).m
    x = cone_qp.newton_schulz_inverse(m, cone_qp.NS_ITERS, polish)
    resid = chip_smoke.ns_residual(m, x)
    assert resid.max() < bound, resid.max()
    m64 = np.asarray(m, np.float64)
    rel = (np.linalg.norm(np.asarray(x, np.float64) - np.linalg.inv(m64),
                          axis=(1, 2))
           / np.linalg.norm(np.linalg.inv(m64), axis=(1, 2)))
    assert rel.max() < 1e-3


def test_sweep_health_flags_lagging_velocity():
    vx = np.array([0.0, 0.6])
    pos = np.array([[0.0, 0.0, 0.27], [0.3, 0.0, 0.27]])
    good = np.tile(vx[:, None], (1, 63))
    assert chip_smoke.sweep_health(vx, np.ones(2), pos, good, 8)["healthy"]
    slow = good * 0.5
    assert not chip_smoke.sweep_health(vx, np.ones(2), pos, slow,
                                       8)["healthy"]
    low = pos.copy()
    low[1, 2] = 0.2
    assert not chip_smoke.sweep_health(vx, np.ones(2), low, good,
                                       8)["healthy"]
