"""SpectralGrid semantics (reference utilities/src/spectral_grid.c:32-112 and
utilities/test/test_spectral_grid.c)."""
import numpy as np
import pytest

from grtcode_jax import SpectralGrid


def test_point_count_matches_reference_rule():
    # n = ceil((wn - w0)/dw) + 1 (spectral_grid.c:50-67).
    g = SpectralGrid(1.0, 3250.0, 0.1)
    assert g.n == 32491
    g2 = SpectralGrid(1.0, 50000.0, 1.0)
    assert g2.n == 50000
    # Non-dividing range rounds up.
    g3 = SpectralGrid(1.0, 2.05, 0.1)
    assert g3.n == 12


def test_wavenumbers_are_uniform():
    g = SpectralGrid(500.0, 600.0, 0.5)
    w = g.wavenumbers_np()
    assert w.shape == (g.n,)
    np.testing.assert_allclose(np.diff(w), 0.5, rtol=1e-12)
    assert w[0] == 500.0


def test_point_index_tolerance():
    g = SpectralGrid(1.0, 100.0, 0.1)
    assert g.point_index(1.0) == 0
    assert g.point_index(50.0) == 490
    with pytest.raises(ValueError):
        g.point_index(50.04)  # off-grid
    with pytest.raises(ValueError):
        g.point_index(200.0)  # out of range


def test_validation_ranges():
    # grtcode_config.h:52-58 guards.
    with pytest.raises(ValueError):
        SpectralGrid(0.5, 100.0, 0.1)       # w0 < 1
    with pytest.raises(ValueError):
        SpectralGrid(1.0, 50001.0, 0.1)     # wn > 50000
    with pytest.raises(ValueError):
        SpectralGrid(1.0, 100.0, 0.0001)    # dw < 0.001
    with pytest.raises(ValueError):
        SpectralGrid(1.0, 100.0, 11.0)      # dw > 10


def test_equality_and_hash():
    a = SpectralGrid(1.0, 100.0, 0.1)
    b = SpectralGrid(1.0, 100.0, 0.1)
    c = SpectralGrid(1.0, 100.0, 0.5)
    assert a == b and hash(a) == hash(b)
    assert a != c
