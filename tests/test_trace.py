import jax.numpy as jnp
import numpy as np

from quadruped_jax.utils.trace import save_trace, load_trace, compare_traces


def test_roundtrip(tmp_path):
    tree = {"a": jnp.arange(10.0), "b": {"c": jnp.ones((3, 4))}}
    p = save_trace(str(tmp_path / "t.npz"), tree, meta={"steps": 10})
    loaded, meta = load_trace(p, like=tree)
    assert meta["steps"] == 10
    np.testing.assert_allclose(loaded["a"], tree["a"])
    np.testing.assert_allclose(loaded["b"]["c"], tree["b"]["c"])
    diff = compare_traces(tree, loaded)
    assert diff["within_tol"]


def test_compare_detects_drift(tmp_path):
    tree = {"a": jnp.arange(5.0)}
    other = {"a": jnp.arange(5.0) + 0.1}
    diff = compare_traces(tree, other, atol=1e-3)
    assert not diff["within_tol"]
    np.testing.assert_allclose(diff["max"], 0.1, atol=1e-6)
