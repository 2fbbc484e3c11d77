"""Voigt line-shape parity against reference goldens.

Fixture tests/data/voigt_golden.txt is generated by
tools/goldens/voigt_harness.c, which compiles the reference
rfm_voigt_line_shape (gas-optics/src/RFM_voigt.c:85-281) unmodified and dumps
profile values for six (lorentz, doppler, window) configurations covering the
pure-Lorentz limit and all four Humlicek regions.
"""
import os

import numpy as np
import jax.numpy as jnp
import pytest

from grtcode_jax.gas_optics.voigt import voigt_line_shape

HERE = os.path.dirname(__file__)

# Mirrors tools/goldens/voigt_harness.c configs:
# (line_center, lorentz_hwhm, doppler_hwhm, w_start, wres, npoints)
CONFIGS = [
    (1000.0, 0.08, 0.0015, 975.0, 0.1, 501),       # tropospheric strong line
    (1500.3, 0.002, 0.003, 1490.0, 0.01, 2001),    # doppler-dominated
    (500.0, 5.0, 0.0005, 480.0, 0.5, 81),          # pure-Lorentz limit y>=70.55
    (3000.7, 1.0e-7, 0.004, 2995.0, 0.05, 201),    # tiny y (region collapse)
    (2000.0, 0.03, 0.002, 1975.0, 0.05, 1001),     # mid y, all regions
    (20000.0, 0.06, 0.02, 19990.0, 1.0, 21),       # shortwave high wavenumber
]


@pytest.fixture(scope="module")
def golden():
    return np.loadtxt(os.path.join(HERE, "data", "voigt_golden.txt"))


@pytest.mark.parametrize("ci", range(len(CONFIGS)))
def test_voigt_matches_reference(golden, ci):
    offset = sum(int(c[5]) for c in CONFIGS[:ci])
    vc, lor, dop, w0, dw, n = CONFIGS[ci]
    n = int(n)
    w = w0 + dw * np.arange(n)
    dv = (w - vc).astype(np.float32)
    k = np.asarray(
        voigt_line_shape(jnp.asarray(dv), jnp.float32(lor), jnp.float32(dop)))
    g = golden[offset:offset + n]
    rel = np.abs(k - g) / np.maximum(np.abs(g), 1e-30)
    assert rel.max() < 5e-6, f"config {ci}: max rel err {rel.max():.3e}"


def test_voigt_vectorizes_over_lines():
    """Profile must broadcast over a (lines, window) plane."""
    dv = jnp.linspace(-25.0, 25.0, 101)[None, :] * jnp.ones((4, 1))
    lor = jnp.asarray([0.08, 0.002, 5.0, 0.03])[:, None]
    dop = jnp.asarray([0.0015, 0.003, 0.0005, 0.002])[:, None]
    k = voigt_line_shape(dv, lor, dop)
    assert k.shape == (4, 101)
    assert bool(jnp.all(jnp.isfinite(k)))
    assert bool(jnp.all(k >= 0.0))


def test_voigt_peak_normalization():
    """Integral of the profile over wavenumber approximates 1 (line shapes
    are normalized); checks the sqrt(ln2)/alpha scaling convention."""
    dw = 0.002
    dv = jnp.arange(-30.0, 30.0, dw)
    k = voigt_line_shape(dv, jnp.float32(0.05), jnp.float32(0.002))
    integral = float(jnp.sum(k) * dw)
    assert abs(integral - 1.0) < 5e-3
