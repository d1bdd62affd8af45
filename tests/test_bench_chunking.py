"""Batch chunking equivalence (bench.py CHUNK / the chunked benches).

The bench.py headline runs the batch as sequential lax.map chunks
inside one jit — scheduling only. This pins the claim that licenses it:
chunked and monolithic graphs produce the same solutions to
reassociation-level roundoff (measured ~3e-4 N on forces, vs the ~3.8 N
golden-parity gates), so the oracle-parity suite covers the chunked
headline configuration too.
"""

import importlib
import os

import numpy as np
import pytest


def test_chunked_matches_monolithic(monkeypatch):
    monkeypatch.setenv("QTPU_BENCH_CHUNK", "16")
    import bench
    importlib.reload(bench)
    assert bench.CHUNK == 16

    fn_c, args_c, _ = bench.build_bench(64, "trot")
    out_c = fn_c(*args_c)
    bench.CHUNK = 0
    fn_m, args_m, _ = bench.build_bench(64, "trot")
    out_m = fn_m(*args_m)

    xc = np.asarray(out_c[0]).reshape(64, -1)
    xm = np.asarray(out_m[0]).reshape(64, -1)
    err = np.abs(xc - xm).max()
    # Reassociation roundoff only — orders of magnitude inside the 3% m*g
    # (~3.8 N) golden-parity gates.
    assert err < 0.01, f"chunked vs monolithic forces differ by {err} N"
