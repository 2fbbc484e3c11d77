"""Longwave solver parity and robustness.

Golden fixture tests/data/lw_golden.txt is produced by
tools/goldens/lw_harness.c, which compiles the unmodified reference
longwave/src/longwave.c (lw_flux, longwave.c:127-222) and dumps per-level
fluxes for four synthetic column configurations.

Robustness cases mirror longwave/test/test_longwave.c:102-209 (simple /
optically thick / optically thin / strong absorption).
"""
import os

import numpy as np
import jax.numpy as jnp
import pytest

from grtcode_jax.solvers.longwave import longwave_fluxes, stream_sum

HERE = os.path.dirname(__file__)

# Mirrors tools/goldens/lw_harness.c run_case calls:
# (nlevels, t_surf, emis, t_top, t_bottom, tau_scale, w0, dw, nw)
CASES = [
    (11, 294.2, 0.98, 210.0, 290.0, 1.7, 200.0, 250.0, 12),
    (8, 300.0, 1.0, 230.0, 299.0, 80.0, 500.0, 100.0, 8),
    (21, 288.0, 0.9, 200.0, 287.0, 1e-6, 900.0, 300.0, 6),
    (5, 265.0, 0.35, 215.0, 260.0, 0.6, 1200.0, 400.0, 5),
]


def _case_inputs(nlevels, t_top, t_bottom, tau_scale, w0, dw, nw):
    nlayers = nlevels - 1
    t_levels = t_top + (t_bottom - t_top) * np.arange(nlevels) / (nlevels - 1)
    t_layers = 0.5 * (t_levels[:-1] + t_levels[1:])
    w = w0 + dw * np.arange(nw)
    i = np.arange(nlayers)[:, None]
    tau = tau_scale * (0.5 + 0.5 * np.sin(0.01 * w[None, :] + i)) * \
        (i + 1) / nlayers
    tau = np.maximum(tau, 0.0)
    return t_layers, t_levels, tau, w


@pytest.fixture(scope="module")
def golden():
    return np.loadtxt(os.path.join(HERE, "data", "lw_golden.txt"))


@pytest.mark.parametrize("ci", range(len(CASES)))
def test_lw_matches_reference(golden, ci):
    offset = sum(c[0] * c[8] * 2 for c in CASES[:ci])
    nlevels, t_surf, emis, t_top, t_bot, tau_scale, w0, dw, nw = CASES[ci]
    t_layers, t_levels, tau, w = _case_inputs(
        nlevels, t_top, t_bot, tau_scale, w0, dw, nw)

    fu, fd = longwave_fluxes(
        jnp.asarray(tau, jnp.float32), jnp.zeros_like(jnp.asarray(tau, jnp.float32)),
        jnp.float32(t_surf), jnp.asarray(t_layers, jnp.float32),
        jnp.asarray(t_levels, jnp.float32),
        jnp.full((nw,), emis, jnp.float32), jnp.asarray(w, jnp.float32))

    # Harness layout: per wavenumber, per level: up then down.
    block = golden[offset:offset + nlevels * nw * 2].reshape(nw, nlevels, 2)
    ref_up = block[:, :, 0].T     # (nlevels, nw)
    ref_down = block[:, :, 1].T

    scale = max(ref_up.max(), ref_down.max())
    np.testing.assert_allclose(np.asarray(fu), ref_up, rtol=2e-4,
                               atol=2e-5 * scale)
    np.testing.assert_allclose(np.asarray(fd), ref_down, rtol=2e-4,
                               atol=2e-5 * scale)


@pytest.mark.parametrize("tau_val", [1.0, 1e12, 1e-12, 695.0])
def test_lw_robustness(tau_val):
    """Numerical-robustness cases of longwave/test/test_longwave.c: finite
    fluxes for simple / optically thick / thin / strong-absorption columns."""
    nlevels, nw = 5, 16
    t_levels = np.linspace(210.0, 288.0, nlevels)
    t_layers = 0.5 * (t_levels[:-1] + t_levels[1:])
    w = np.linspace(100.0, 2000.0, nw)
    tau = jnp.full((nlevels - 1, nw), tau_val, jnp.float32)
    fu, fd = longwave_fluxes(
        tau, jnp.zeros_like(tau), jnp.float32(288.0),
        jnp.asarray(t_layers, jnp.float32), jnp.asarray(t_levels, jnp.float32),
        jnp.ones((nw,), jnp.float32), jnp.asarray(w, jnp.float32))
    assert bool(jnp.all(jnp.isfinite(fu))) and bool(jnp.all(jnp.isfinite(fd)))
    assert bool(jnp.all(fu >= 0.0)) and bool(jnp.all(fd >= 0.0))


@pytest.mark.parametrize("shape", [(4, 33), (7, 4, 33)])
def test_stream_sum_matches_float64(shape):
    """The pinned stream quadrature equals a float64 numpy sum to float32
    rounding over six decades of intensity (a TF32 matmul would miss by
    ~1e-3)."""
    rng = np.random.default_rng(11)
    x = 10.0 ** rng.uniform(-3.0, 3.0, shape)
    c2 = np.array([0.1, 0.3, 0.4, 0.2]) * rng.uniform(0.5, 1.5, 4)
    got = np.asarray(stream_sum(jnp.asarray(c2, jnp.float32),
                                jnp.asarray(x, jnp.float32)))
    want = np.einsum("j,...jw->...w", c2.astype(np.float32).astype(
        np.float64), x.astype(np.float32).astype(np.float64))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6)
