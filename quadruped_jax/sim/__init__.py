from quadruped_jax.sim import srb_sim  # noqa: F401
