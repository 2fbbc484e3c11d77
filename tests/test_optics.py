"""Optics combination / sampling rules (utilities/src/optics.c:84-357)."""
import numpy as np
import jax.numpy as jnp

from grtcode_jax import Optics, SpectralGrid, combine


def test_combine_weighted_sums():
    # add_optics_objects math (optics.c:128-148): tau sums; omega is
    # tau-weighted; g is omega*tau-weighted.
    rng = np.random.default_rng(0)
    tau1 = rng.uniform(0.1, 2.0, (3, 8)).astype(np.float32)
    tau2 = rng.uniform(0.1, 2.0, (3, 8)).astype(np.float32)
    om1 = rng.uniform(0.0, 1.0, (3, 8)).astype(np.float32)
    om2 = rng.uniform(0.0, 1.0, (3, 8)).astype(np.float32)
    g1 = rng.uniform(-1.0, 1.0, (3, 8)).astype(np.float32)
    g2 = rng.uniform(-1.0, 1.0, (3, 8)).astype(np.float32)

    out = combine([Optics(jnp.asarray(tau1), jnp.asarray(om1), jnp.asarray(g1)),
                   Optics(jnp.asarray(tau2), jnp.asarray(om2), jnp.asarray(g2))])
    tau = tau1 + tau2
    omega = (om1 * tau1 + om2 * tau2) / tau
    g = (g1 * om1 * tau1 + g2 * om2 * tau2) / (om1 * tau1 + om2 * tau2)
    np.testing.assert_allclose(np.asarray(out.tau), tau, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(out.omega), omega, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(out.g), g, rtol=1e-4, atol=1e-6)


def test_combine_zero_tau_is_finite():
    z = Optics(jnp.zeros((2, 4)), jnp.zeros((2, 4)), jnp.zeros((2, 4)))
    out = combine([z, z])
    assert bool(jnp.all(jnp.isfinite(out.omega)))
    assert bool(jnp.all(jnp.isfinite(out.g)))


def test_add_operator():
    a = Optics(jnp.ones((2, 4)), jnp.zeros((2, 4)), jnp.zeros((2, 4)))
    b = Optics(2 * jnp.ones((2, 4)), jnp.zeros((2, 4)), jnp.zeros((2, 4)))
    out = a + b
    np.testing.assert_allclose(np.asarray(out.tau), 3.0)


def test_sample_strided_subgrid():
    # sample_optics_object picks every k-th point (optics.c:268-341).
    src = SpectralGrid(1.0, 101.0, 0.5)
    dst = SpectralGrid(1.0, 101.0, 2.5)
    tau = jnp.arange(src.n, dtype=jnp.float32)[None, :] * jnp.ones((2, 1))
    o = Optics(tau, jnp.zeros_like(tau), jnp.zeros_like(tau), grid=src)
    s = o.sample(dst)
    assert s.tau.shape == (2, dst.n)
    np.testing.assert_allclose(np.asarray(s.tau[0]),
                               np.arange(dst.n, dtype=np.float32) * 5.0)


def test_zeros_constructor_batched():
    g = SpectralGrid(1.0, 10.0, 1.0)
    o = Optics.zeros(4, g, batch_shape=(3,))
    assert o.tau.shape == (3, 4, g.n)
    assert o.num_layers == 4
