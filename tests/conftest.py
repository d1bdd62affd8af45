"""Test config: run everything on a virtual 8-device CPU mesh.

The tests run on the CPU; sharding correctness is validated on
host-platform virtual devices (same XLA partitioner, same collectives).
The program itself runs on the GPU (chip_smoke.py, bench.py).
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)

from quadruped_jax.utils import compile_cache  # noqa: E402

# Persistent compile cache: CPU test-suite compiles dominate wall time.
compile_cache.enable(min_compile_secs=0.5)
