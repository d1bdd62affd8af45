from quadruped_jax.core import se3, filters, splines  # noqa: F401
