"""NQS model variants: shapes, bounds, phases, helper functions."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from flow_guided_krylov_tpu.models import (ComplexNQS, DenseNQS,
                                           RBMQuantumState, SignedDenseNQS,
                                           normalized_probability,
                                           probability, psi)


@pytest.fixture
def x():
    rng = np.random.default_rng(0)
    return jnp.asarray(rng.integers(0, 2, (16, 8)).astype(np.float32))


def test_dense_nqs_bounded(x):
    m = DenseNQS(num_sites=8, hidden_dims=(32, 32))
    params = m.init(jax.random.PRNGKey(0), x)
    la = m.apply(params, x)
    assert la.shape == (16,)
    scale = float(params["params"]["log_amp_scale"])
    assert np.all(np.abs(np.asarray(la)) <= abs(scale) + 1e-6)
    assert np.allclose(np.asarray(m.apply(params, x, method=m.phase)), 0.0)


def test_signed_dense_nqs_phase(x):
    m = SignedDenseNQS(num_sites=8, hidden_dims=(32, 32))
    params = m.init(jax.random.PRNGKey(1), x, method=m.phase)
    ph = np.asarray(m.apply(params, x, method=m.phase))
    assert set(np.unique(ph)) <= {0.0, np.float32(np.pi)}


def test_complex_nqs(x):
    m = ComplexNQS(num_sites=8, hidden_dims=(32, 32))
    params = m.init(jax.random.PRNGKey(2), x)
    la = m.apply(params, x)
    ph = m.apply(params, x, method=m.phase)
    assert la.shape == ph.shape == (16,)
    z = psi(la, ph)
    assert np.allclose(np.abs(np.asarray(z)), np.exp(np.asarray(la)),
                       rtol=1e-5)


@pytest.mark.parametrize("complex_weights", [False, True])
def test_rbm(x, complex_weights):
    m = RBMQuantumState(num_sites=8, n_hidden=12,
                        complex_weights=complex_weights)
    params = m.init(jax.random.PRNGKey(3), x)
    la = np.asarray(m.apply(params, x))
    assert la.shape == (16,) and np.isfinite(la).all()
    ph = np.asarray(m.apply(params, x, method=m.phase))
    if not complex_weights:
        assert np.allclose(ph, 0.0)


def test_probability_helpers():
    la = jnp.asarray([0.0, -1.0, 0.5])
    p = np.asarray(probability(la))
    np.testing.assert_allclose(p, np.exp(2 * np.asarray(la)), rtol=1e-6)
    pn = np.asarray(normalized_probability(la))
    assert pn.sum() == pytest.approx(1.0, abs=1e-6)
    mask = jnp.asarray([True, True, False])
    pn2 = np.asarray(normalized_probability(la, mask))
    assert pn2[2] == 0.0 and pn2.sum() == pytest.approx(1.0, abs=1e-6)


def test_module_dense_init_shapes_and_flax_initializers():
    """The in-repo module layer: {"params": ...} tree, kernel (in, out) +
    zero bias per layer, LeCun-normal kernel scale, explicit names."""
    m = DenseNQS(num_sites=8, hidden_dims=(32, 16))
    params = m.init(jax.random.PRNGKey(0), jnp.zeros((2, 8)))
    p = params["params"]
    assert sorted(p) == ["Dense_0", "Dense_1", "Dense_2", "log_amp_scale"]
    shapes = {k: (p[k]["kernel"].shape, p[k]["bias"].shape)
              for k in ("Dense_0", "Dense_1", "Dense_2")}
    assert shapes == {"Dense_0": ((8, 32), (32,)),
                      "Dense_1": ((32, 16), (16,)),
                      "Dense_2": ((16, 1), (1,))}
    assert not np.any(np.asarray(p["Dense_0"]["bias"]))
    # lecun_normal: std ~ 1/sqrt(fan_in) (truncated normal)
    std = float(np.std(np.asarray(p["Dense_1"]["kernel"])))
    assert 0.5 / np.sqrt(32) < std < 1.5 / np.sqrt(32)
    # same key -> same parameters; another key -> different ones
    again = m.init(jax.random.PRNGKey(0), jnp.zeros((2, 8)))["params"]
    other = m.init(jax.random.PRNGKey(1), jnp.zeros((2, 8)))["params"]
    np.testing.assert_array_equal(again["Dense_0"]["kernel"],
                                  p["Dense_0"]["kernel"])
    assert not np.array_equal(other["Dense_0"]["kernel"],
                              p["Dense_0"]["kernel"])


def test_module_method_dispatch(x):
    """init/apply run the method given by ``method=`` (a bound method),
    create only the parameters that method reads, and apply refuses
    parameters that init did not create."""
    m = DenseNQS(num_sites=8, hidden_dims=(16,), complex_output=True)
    p_call = m.init(jax.random.PRNGKey(0), x)["params"]
    p_phase = m.init(jax.random.PRNGKey(0), x, method=m.phase)["params"]
    assert "log_amp_scale" in p_call and "phase_Dense_0" not in p_call
    assert "phase_Dense_0" in p_phase and "log_amp_scale" not in p_phase
    ph = m.apply({"params": p_phase}, x, method=m.phase)
    assert ph.shape == (16,)
    with pytest.raises(KeyError):
        m.apply({"params": p_call}, x, method=m.phase)


def test_module_scoped_params_and_jit():
    """Nested scopes give nested parameter dicts, and apply traces under
    jit with the parameters as arguments."""
    from flow_guided_krylov_tpu.flows import DiscreteFlowSampler
    flow = DiscreteFlowSampler(n_sites=4, n_layers=2, hidden=8)
    key = jax.random.PRNGKey(0)
    p = flow.init(key, key, 3, method=flow.sample)["params"]
    assert sorted(p) == ["coupling_0", "coupling_1"]
    assert sorted(p["coupling_0"]) == ["Dense_0", "Dense_1", "Dense_2",
                                       "Dense_3"]
    y = jnp.asarray(np.random.default_rng(0).normal(size=(5, 4)),
                    jnp.float32)
    inv = jax.jit(lambda prm, y: flow.apply(prm, y, method=flow.inverse))
    z, ld = inv({"params": p}, y)
    y2, ld2 = flow.apply({"params": p}, z, method=flow.forward)
    np.testing.assert_allclose(np.asarray(y2), np.asarray(y), atol=1e-5)
    np.testing.assert_allclose(np.asarray(ld2), -np.asarray(ld), atol=1e-5)
