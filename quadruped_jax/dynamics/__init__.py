from quadruped_jax.dynamics import srb  # noqa: F401
