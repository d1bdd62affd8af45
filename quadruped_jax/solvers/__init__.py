from quadruped_jax.solvers import qp, condense  # noqa: F401
