"""3-D robot-state visualization: animated skeleton renders of rollouts.

The engine's replacement for the reference's xpp/RViz pipeline
(quadruped/src/ros/qr_control2gazebo_msg.cpp:30+ publishing
RobotStateCartesian into the xpp visualizers, /root/reference/xpp/ ~8k
LoC): instead of a live ROS viewer, batched rollouts are rendered
host-side with matplotlib's 3-D axes into PNG frames or an animated GIF —
trunk box, hip-knee-foot leg chains, foot-contact markers, ground/terrain
wireframe. Works on any scenario of a batched trace (pick with
`scenario=`), entirely offline, no display needed (Agg backend).

Inputs are plain arrays so both simulators feed it:
  * whole-body: (positions [T,3], rpy/quat [T,3|4], joint_angles [T,12])
  * SRB rollouts: record q from the command stream or use stand angles.
A `Viz3DTrace` capture helper stacks per-tick observations inside a scan.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np

from quadruped_jax.core import se3
from quadruped_jax.robots import kinematics
from quadruped_jax.robots.params import RobotParams


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


class Viz3DTrace(NamedTuple):
    """Per-tick pose trace ([T, ...]; leading batch axes allowed)."""

    position: np.ndarray       # [T, 3] base world position
    rpy: np.ndarray            # [T, 3]
    joint_angles: np.ndarray   # [T, 12]
    contact: np.ndarray | None = None   # [T, 4] optional


def skeleton_points(params: RobotParams, position, rpy, q):
    """World-frame skeleton for one frame.

    Returns (trunk [4, 3] corner loop, legs [4, 3, 3] hip/knee/foot).
    Knee position from the analytic leg chain (same FK the controllers
    use, robots/kinematics.py)."""
    import jax.numpy as jnp

    r = np.asarray(se3.rpy_to_rotmat(jnp.asarray(rpy, jnp.float32)))
    pos = np.asarray(position, np.float32)

    hips = np.asarray(params.hip_offset)                       # [4, 3]
    qj = jnp.asarray(q, jnp.float32)
    feet_b = np.asarray(
        kinematics.foot_positions_in_base_frame(params, qj))   # [4, 3]
    # Knee joints via the same FK with the shank zeroed — guaranteed to
    # match the controllers' leg conventions for any robot.
    knee_params = params.replace(lower_length=0.0 * params.lower_length)
    knees = np.asarray(
        kinematics.foot_positions_in_base_frame(knee_params, qj))

    to_world = lambda p: p @ r.T + pos
    trunk = to_world(hips[[0, 1, 3, 2, 0]])      # FR FL RL RR loop
    legs = np.stack([to_world(np.stack([hips[i], knees[i], feet_b[i]]))
                     for i in range(4)])
    return trunk, legs


def render_frame(ax, params: RobotParams, position, rpy, q,
                 contact=None, terrain: Callable | None = None,
                 trail: np.ndarray | None = None):
    """Draw one robot state onto a 3-D axis."""
    trunk, legs = skeleton_points(params, position, rpy, q)
    ax.plot(trunk[:, 0], trunk[:, 1], trunk[:, 2], "-", color="#334455",
            lw=3)
    for i in range(4):
        ax.plot(legs[i, :, 0], legs[i, :, 1], legs[i, :, 2], "-o",
                color="#2277cc", lw=2, ms=2)
        if contact is not None and contact[i] > 0.5:
            ax.scatter(*legs[i, 2], color="#cc3322", s=25)
    if trail is not None:
        ax.plot(trail[:, 0], trail[:, 1], trail[:, 2], "-",
                color="#88aa88", lw=1, alpha=0.7)

    cx, cy = float(position[0]), float(position[1])
    gx, gy = np.meshgrid(np.linspace(cx - 0.5, cx + 0.5, 9),
                         np.linspace(cy - 0.5, cy + 0.5, 9))
    if terrain is not None:
        import jax.numpy as jnp

        gz = np.asarray(terrain(jnp.asarray(gx.ravel()),
                                jnp.asarray(gy.ravel()))).reshape(gx.shape)
    else:
        gz = np.zeros_like(gx)
    ax.plot_wireframe(gx, gy, gz, color="#bbbbbb", lw=0.4)
    ax.set_xlim(cx - 0.5, cx + 0.5)
    ax.set_ylim(cy - 0.5, cy + 0.5)
    ax.set_zlim(-0.05, 0.55)
    ax.set_box_aspect((1, 1, 0.6))


def animate_rollout(params: RobotParams, trace: Viz3DTrace,
                    path: str = "/tmp/rollout3d.gif", *,
                    every: int = 25, fps: int = 15,
                    scenario: int | tuple | None = None,
                    terrain: Callable | None = None) -> str:
    """Render a rollout trace to an animated GIF (PillowWriter — no
    ffmpeg needed). `every` subsamples control ticks per frame;
    `scenario` indexes leading batch axes of a batched trace."""
    plt = _plt()
    from matplotlib.animation import FuncAnimation, PillowWriter

    def pick(x):
        if x is None:
            return None
        x = np.asarray(x)
        if scenario is not None:
            idx = (scenario,) if isinstance(scenario, int) else scenario
            # batch axes come AFTER time in stacked scan outputs.
            x = x[(slice(None),) + idx]
        return x

    pos = pick(trace.position)
    rpy = pick(trace.rpy)
    q = pick(trace.joint_angles)
    contact = pick(trace.contact)
    frames = range(0, pos.shape[0], every)

    fig = plt.figure(figsize=(6, 5))
    ax = fig.add_subplot(111, projection="3d")

    def draw(k):
        ax.cla()
        render_frame(ax, params, pos[k], rpy[k], q[k],
                     contact=None if contact is None else contact[k],
                     terrain=terrain, trail=pos[: k + 1])
        ax.set_title(f"t = {k * 0.002:.2f} s")

    anim = FuncAnimation(fig, draw, frames=frames)
    anim.save(path, writer=PillowWriter(fps=fps))
    plt.close(fig)
    return path


def snapshot(params: RobotParams, trace: Viz3DTrace,
             path: str = "/tmp/rollout3d.png", *, ticks=(0,),
             scenario: int | None = None,
             terrain: Callable | None = None) -> str:
    """Static multi-panel render (one subplot per requested tick)."""
    plt = _plt()
    pos, rpy, q = (np.asarray(x) for x in
                   (trace.position, trace.rpy, trace.joint_angles))
    if scenario is not None:
        pos, rpy, q = pos[:, scenario], rpy[:, scenario], q[:, scenario]
    contact = None if trace.contact is None else np.asarray(trace.contact)
    if contact is not None and scenario is not None:
        contact = contact[:, scenario]

    n = len(ticks)
    fig = plt.figure(figsize=(5 * n, 4.5))
    for j, k in enumerate(ticks):
        ax = fig.add_subplot(1, n, j + 1, projection="3d")
        render_frame(ax, params, pos[k], rpy[k], q[k],
                     contact=None if contact is None else contact[k],
                     terrain=terrain, trail=pos[: k + 1])
        ax.set_title(f"t = {k * 0.002:.2f} s")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path
