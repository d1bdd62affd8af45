"""Full-stack demo on the 18-DoF physics sim: sit -> FSM stand-up ->
estimator-in-the-loop advanced trot (the engine's `example_a1_real`
analogue — everything the hardware path runs, minus the UDP bridge).

    python examples/example_whole_body_standup.py
"""

import jax

from quadruped_jax.utils import compile_cache  # noqa: E402

compile_cache.enable()

import jax.numpy as jnp

import quadruped_jax.core.se3 as se3
from quadruped_jax.robots import a1_params
from quadruped_jax.gait import ADVANCED_TROT
from quadruped_jax.control import mpc, swing
from quadruped_jax.control.locomotion import LocomotionConfig
from quadruped_jax.control.desired_state import TwistCommand
from quadruped_jax.exec import RunnerConfig, runner_init, runner_step
from quadruped_jax.estimation.container import EstimatorConfig, RawSensors
from quadruped_jax.estimation.velocity import VelocityEstimatorConfig
from quadruped_jax.dynamics import floating_base as fb
from quadruped_jax.sim import whole_body as wb


def main(steps=3500, vx=0.2):
    params = a1_params()
    model = fb.build_model(params)
    contact_model = wb.ContactModel()
    config = RunnerConfig(
        locomotion=LocomotionConfig(
            mpc=mpc.MpcConfig(horizon=5, qp_iters=40),
            swing=swing.SwingConfig(), gait=ADVANCED_TROT()),
        estimator=EstimatorConfig(velocity=VelocityEstimatorConfig(
            window_size=20, acc_filter_window=5)),
        use_estimators=True)
    cmd = TwistCommand.constant(vx=vx, body_height=0.27)

    sim0 = wb.whole_body_init(params, body_height=0.15)
    sim0 = wb.WholeBodySimState(fb=sim0.fb.replace(q=params.sitdown_angles),
                                t=sim0.t)
    obs0 = wb.observe(params, model, sim0, contact_model)
    st0 = runner_init(config, params, obs0)

    def step(carry, i):
        sim, st, prev_v = carry
        truth = wb.observe(params, model, sim, contact_model)
        r = se3.quat_to_rotmat(truth.base_quat)
        acc_world = (truth.base_vel_world - prev_v) / 0.002 \
            + jnp.asarray([0.0, 0.0, 9.81])
        sensors = RawSensors(
            quat=truth.base_quat, acc_body=acc_world @ r,
            omega_body=truth.base_omega_body,
            joint_angles=truth.joint_angles,
            joint_velocities=truth.joint_velocities,
            foot_forces=truth.foot_forces)
        command, forces, st, _ = runner_step(config, params, st, cmd,
                                             sensors=sensors)
        sim, _ = wb.whole_body_step(params, model, sim, command,
                                    contact_model, 0.002)
        return (sim, st, truth.base_vel_world), (sim.fb.position,
                                                 st.fsm.state)

    (_, _, _), (pos, fsm) = jax.jit(lambda: jax.lax.scan(
        step, (sim0, st0, jnp.zeros(3)), jnp.arange(steps)))()
    jax.block_until_ready(pos)
    for k in range(0, steps, steps // 10):
        print(f"t={k * 0.002:5.2f}s fsm={int(fsm[k])} "
              f"pos=({float(pos[k, 0]):+.2f}, {float(pos[k, 1]):+.2f}, "
              f"{float(pos[k, 2]):.3f})")


if __name__ == "__main__":
    main()
