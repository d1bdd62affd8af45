from quadruped_jax.robots.params import (  # noqa: F401
    RobotParams,
    a1_params,
    go1_params,
    aliengo_params,
    lite3_params,
    lite2_params,
    named_params,
    stack_params,
)
from quadruped_jax.robots import kinematics  # noqa: F401
