from quadruped_jax.planner import com_adjuster, pose_planner, foot_stepper  # noqa: F401
