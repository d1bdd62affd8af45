from quadruped_jax.estimation import velocity, pose, ground, contact, container, cmu_kf, zmp  # noqa: F401
