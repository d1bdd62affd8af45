from quadruped_jax.runtime.bridge import (  # noqa: F401
    FleetBridge,
    RobotBridge,
    LoopTimer,
    build_native,
    native_available,
)
