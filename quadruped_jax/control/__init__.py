from quadruped_jax.control import desired_state, mpc, swing, stance_force_balance  # noqa: F401
