"""Structured run metrics: the engine's observability layer.

The reference's observability is printf + per-1000-tick loop-cost averages
(examples/example_a1_sim/example_a1_sim.cpp:226-231) and colored log macros
(include/quadruped/utils/qr_print.hpp). The batched engine replaces that
with (a) a device-side metrics pytree reduced across the batch/mesh (see
distributed/scaling.py) and (b) this host-side JSONL sink.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field


@dataclass
class MetricsLogger:
    path: str = "/tmp/quadruped_jax_metrics.jsonl"
    _t0: float = field(default_factory=time.perf_counter)

    def log(self, **metrics):
        rec = {"t": round(time.perf_counter() - self._t0, 4)}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = str(v)
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        return rec


def summarize_rollout(result) -> dict:
    """Aggregate a RolloutResult into scalar metrics (batched-safe)."""
    import numpy as np

    alive = np.asarray(result.alive)
    hs = np.asarray(result.base_height_trace)
    vs = np.asarray(result.vel_trace)
    return {
        "alive_fraction": float(np.mean(alive)),
        "mean_height": float(np.mean(hs[hs.shape[0] // 2:])),
        "final_speed": float(np.mean(np.linalg.norm(
            vs[-1].reshape(-1, 3)[:, :2], axis=-1))),
    }


def profile_trace(fn, args, logdir: str = "/tmp/qtpu_profile"):
    """Capture an XLA profiler trace of one call (view with
    TensorBoard's profile plugin or xprof). The engine's replacement for
    the reference's per-1000-iteration printf timing."""
    import jax

    with jax.profiler.trace(logdir):
        out = fn(*args)
        jax.block_until_ready(out)
    return logdir
