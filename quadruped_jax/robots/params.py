"""Robot parameter pytrees for all supported quadrupeds.

One typed, batchable schema replaces the reference's per-robot YAML trees
(quadruped/config/<robot>/<robot>.yaml) and per-robot C++ subclasses
(quadruped/src/robots/qr_robot_*.cpp). Because every robot shares the same
morphology (floating base + 4 x 3-DoF legs), a single `RobotParams` pytree
covers A1/Go1/Aliengo/Lite2/Lite3; `stack_params` stacks several robots along
a leading axis so whole fleets of heterogeneous robots batch through one
compiled control step.

Leg order follows the Unitree convention used throughout the reference:
0=FR, 1=FL, 2=RR, 3=RL. Frames: x forward, y left, z up.

Numeric values come from the reference config files (cited per factory).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from quadruped_jax.core import struct

# Side sign of the hip (abduction) link y-offset per leg: right legs -1.
SIDE_SIGN = np.array([-1.0, 1.0, -1.0, 1.0])
NUM_LEGS = 4
NUM_JOINTS = 12


@struct.dataclass
class RobotParams:
    """Static per-robot parameters (a pytree of f32 arrays; batchable)."""

    # --- single-rigid-body model ---
    total_mass: jnp.ndarray        # [] kg
    total_inertia: jnp.ndarray     # [3,3] body-frame rotational inertia
    body_mass: jnp.ndarray         # [] trunk-only mass (whole-body model)
    body_inertia: jnp.ndarray      # [3,3] trunk-only inertia
    body_size: jnp.ndarray         # [3] trunk box dims (collision/safety)
    body_height: jnp.ndarray       # [] nominal standing CoM height

    # --- leg geometry ---
    hip_offset: jnp.ndarray        # [4,3] trunk->abad joint, body frame
    hip_length: jnp.ndarray        # [] abad link length (unsigned)
    upper_length: jnp.ndarray      # [] thigh length
    lower_length: jnp.ndarray      # [] calf length
    default_hip_position: jnp.ndarray  # [4,3] nominal foot xy under hips
    com_offset: jnp.ndarray        # [3] CoM correction (mode 'velocity')

    # --- per-link chain properties (whole-body / Featherstone model) ---
    links_mass: jnp.ndarray        # [3] (abad, upper, lower) masses, one leg
    links_inertia: jnp.ndarray     # [3,3,3] link inertias about link CoM (FL leg)
    links_com_pos: jnp.ndarray     # [3,3] link CoM offsets in link frame (FL leg)

    # --- actuation ---
    motor_kp: jnp.ndarray          # [12] default position gains
    motor_kd: jnp.ndarray          # [12] default damping gains
    torque_limit: jnp.ndarray      # [] |tau| clip (reference: 23 N*m safety)
    stand_angles: jnp.ndarray      # [12] nominal stand joint angles
    standup_angles: jnp.ndarray    # [12] stand-up target angles
    sitdown_angles: jnp.ndarray    # [12] sit-down target angles

    # --- contact / friction ---
    friction_coef: jnp.ndarray     # [] ground mu used by MPC (0.45)

    @property
    def signed_hip_length(self) -> jnp.ndarray:
        """[4] abad link y-offset with per-leg side sign."""
        return self.hip_length * jnp.asarray(SIDE_SIGN, dtype=jnp.float32)

    @property
    def max_force(self) -> jnp.ndarray:
        """Per-leg vertical force cap fMax = m*g (reference convention)."""
        return self.total_mass * 9.81


def _params(
    *,
    total_mass, total_inertia_diag, body_mass, body_inertia, body_size,
    body_height, hip_offset, hip_length, upper_length, lower_length,
    default_hip_position, com_offset, links_mass, links_inertia,
    links_com_pos, stand_angles_leg, standup_leg=(0.0, 0.9, -1.8),
    sitdown_leg=(-0.167136, 0.934969, -2.54468),
    kp_leg=(100.0, 100.0, 100.0), kd_leg=(1.0, 2.0, 2.0),
    torque_limit=23.0, friction_coef=0.45,
) -> RobotParams:
    f = lambda x: jnp.asarray(x, dtype=jnp.float32)
    tile4 = lambda leg: jnp.tile(f(leg), (4,))
    return RobotParams(
        total_mass=f(total_mass),
        total_inertia=jnp.diag(f(total_inertia_diag)) if np.ndim(total_inertia_diag) == 1
        else f(total_inertia_diag),
        body_mass=f(body_mass),
        body_inertia=f(body_inertia).reshape(3, 3),
        body_size=f(body_size),
        body_height=f(body_height),
        hip_offset=f(hip_offset),
        hip_length=f(hip_length),
        upper_length=f(upper_length),
        lower_length=f(lower_length),
        default_hip_position=f(default_hip_position),
        com_offset=f(com_offset),
        links_mass=f(links_mass),
        links_inertia=f(links_inertia).reshape(3, 3, 3),
        links_com_pos=f(links_com_pos),
        motor_kp=tile4(kp_leg),
        motor_kd=tile4(kd_leg),
        torque_limit=f(torque_limit),
        stand_angles=tile4(stand_angles_leg),
        standup_angles=tile4(standup_leg),
        sitdown_angles=tile4(sitdown_leg),
        friction_coef=f(friction_coef),
    )


def a1_params() -> RobotParams:
    """Unitree A1 (reference: quadruped/config/a1_sim/a1_sim.yaml)."""
    return _params(
        total_mass=13.0,
        total_inertia_diag=[0.24, 0.80, 1.0],
        body_mass=6.0,
        body_inertia=[0.015853, 0, 0, 0, 0.037799, 0, 0, 0, 0.045654],
        body_size=[0.267, 0.194, 0.114],
        body_height=0.28,
        hip_offset=[[0.1805, -0.047, 0.0], [0.1805, 0.047, 0.0],
                    [-0.1805, -0.047, 0.0], [-0.1805, 0.047, 0.0]],
        hip_length=0.08505,
        upper_length=0.2,
        lower_length=0.2,
        default_hip_position=[[0.185, -0.135, 0], [0.185, 0.135, 0],
                              [-0.185, -0.135, 0], [-0.185, 0.135, 0]],
        com_offset=[0.005, 0.00145, 0.000515],
        links_mass=[0.696, 1.013, 0.166],
        links_inertia=[
            [0.000469246, -9.409e-06, -3.42e-07,
             -9.409e-06, 0.00080749, -4.66e-07,
             -3.42e-07, -4.66e-07, 0.000552929],
            [0.005529065, 4.825e-06, 0.000343869,
             4.825e-06, 0.005139339, 2.2448e-05,
             0.000343869, 2.2448e-05, 0.001367788],
            [0.002997972, 0.0, -0.000141163,
             0.0, 0.003014022, 0.0,
             -0.000141163, 0.0, 3.2426e-05],
        ],
        links_com_pos=[[-0.0033, 0, 0],
                       [-0.003237, -0.022327, -0.027326],
                       [0.006435, 0, -0.107]],
        stand_angles_leg=(0.0, 0.67, -1.25),
    )


def go1_params() -> RobotParams:
    """Unitree Go1 (reference: quadruped/config/go1/robot_go1.yaml)."""
    base = a1_params()
    return base.replace(
        body_height=jnp.float32(0.295),
        upper_length=jnp.float32(0.213),
        lower_length=jnp.float32(0.213),
        hip_offset=jnp.asarray([[0.17, -0.055, 0.0], [0.17, 0.055, 0.0],
                                [-0.21, -0.055, 0.0], [-0.21, 0.055, 0.0]],
                               dtype=jnp.float32),
        default_hip_position=jnp.asarray([[0.19, -0.14, 0], [0.19, 0.14, 0],
                                          [-0.19, -0.14, 0], [-0.19, 0.14, 0]],
                                         dtype=jnp.float32),
        com_offset=jnp.asarray([-0.038, -0.005, 0.0005], dtype=jnp.float32),
        body_inertia=jnp.diag(jnp.asarray([0.24, 0.80, 1.0], dtype=jnp.float32)),
    )


def aliengo_params() -> RobotParams:
    """Unitree Aliengo (reference: quadruped/config/aliengo_sim/aliengo_sim.yaml)."""
    return _params(
        total_mass=20.0,
        total_inertia_diag=[0.24, 0.80, 1.0],
        body_mass=9.041,
        body_inertia=[0.033260, -0.0004516, 0.0004876,
                      -0.0004516, 0.161172, 0.0000484,
                      0.0004876, 0.0000484, 0.174604],
        body_size=[0.647, 0.21, 0.13],
        body_height=0.37,
        hip_offset=[[0.2399, -0.051, 0.0], [0.2399, 0.051, 0.0],
                    [-0.2399, -0.051, 0.0], [-0.2399, 0.051, 0.0]],
        hip_length=0.083,
        upper_length=0.25,
        lower_length=0.25,
        default_hip_position=[[0.24, -0.135, 0], [0.24, 0.135, 0],
                              [-0.25, -0.135, 0], [-0.25, 0.135, 0]],
        com_offset=[-0.002, 0.004, 0.000515],
        links_mass=[1.993, 1.013, 0.166],
        links_inertia=[
            [0.002904, 7.185e-05, -1.262e-06,
             7.185e-05, 0.004908, 1.75e-06,
             -1.262e-06, 1.75e-06, 0.005587],
            [0.005667, 3.597e-06, 0.000491,
             3.597e-06, 0.005847, 1.0086e-05,
             0.000491, 1.0086e-05, 0.000370],
            [0.006341, 0, -8.7951e-05,
             0, 0.006355, -1.336e-06,
             -8.7951e-05, -1.336e-06, 3.9188e-05],
        ],
        links_com_pos=[[-0.0222, -0.0151, 0],
                       [-0.005607, -0.003877, -0.048199],
                       [0.002781, 0, -0.1425]],
        stand_angles_leg=(0.0, 0.67, -1.25),
        torque_limit=35.0,
    )


def lite3_params() -> RobotParams:
    """DeepRobotics Lite3 (reference: quadruped/config/lite3/lite3_robot.yaml)."""
    return _params(
        total_mass=12.72,
        total_inertia_diag=[0.24, 1.0, 1.0],
        body_mass=7.5,
        body_inertia=[0.24, 0, 0, 0, 1.0, 0, 0, 0, 1.0],
        body_size=[0.349, 0.124, 0.15],
        body_height=0.29,
        hip_offset=[[0.1745, -0.062, 0.0], [0.1745, 0.062, 0.0],
                    [-0.1745, -0.062, 0.0], [-0.1745, 0.062, 0.0]],
        hip_length=0.0985,
        upper_length=0.20,
        lower_length=0.21,
        default_hip_position=[[0.1745, -0.16, 0], [0.1745, 0.16, 0],
                              [-0.1745, -0.16, 0], [-0.1745, 0.16, 0]],
        com_offset=[0.005, 0.00145, 0.000515],
        links_mass=[0.428, 0.61, 0.145],
        links_inertia=[
            [0.00014538, 8.1579e-07, -1.264e-05,
             8.1579e-07, 0.00024024, 1.3443e-06,
             -1.264e-05, 1.3443e-06, 0.00013038],
            [0.001, -2.5e-06, -0.000112,
             -2.5e-06, 0.00116, 3.75e-07,
             -0.000112, 3.75e-07, 0.000268],
            [0.000668, -1.2e-08, 6.91e-06,
             -1.2e-08, 6.86e-04, 5.65e-09,
             6.91e-06, 5.65e-09, 3.155e-05],
        ],
        links_com_pos=[[-0.0047, -0.0091, -0.0018],
                       [-0.00523, -0.0216, -0.0273],
                       [0.00585, 0, -0.12]],
        stand_angles_leg=(0.0, 0.67, -1.25),
    )


def lite2_params() -> RobotParams:
    """DeepRobotics Lite2 — same family/geometry class as Lite3 with a lighter
    trunk (reference carries Lite2 via quadruped/src/robots/qr_robot_lite2*.cpp
    sharing the Lite3 config layout)."""
    base = lite3_params()
    return base.replace(
        total_mass=jnp.float32(12.0),
        body_mass=jnp.float32(7.0),
        body_height=jnp.float32(0.28),
    )


_FACTORIES = {
    "a1": a1_params,
    "go1": go1_params,
    "aliengo": aliengo_params,
    "lite3": lite3_params,
    "lite2": lite2_params,
}


def named_params(name: str) -> RobotParams:
    return _FACTORIES[name]()


def stack_params(names) -> RobotParams:
    """Stack several robots along a leading batch axis (heterogeneous fleet)."""
    import jax

    trees = [named_params(n) for n in names]
    return jax.tree.map(lambda *xs: jnp.stack(xs), *trees)
