from quadruped_jax.utils import viz, logging  # noqa: F401
