"""Bin-interpolated optical-depth methods vs the reference C build.

Golden fixture tests/data/bins_golden.txt is produced by
tools/goldens/bins_harness.c, which compiles the unmodified reference
kernels and drives calc_optical_depth_bin_sweep (wavenumber_sweep) and
calc_optical_depth_line_sweep plus sort_lines and the final quadratic
wing interpolation (kernels.c:177-406, 514-581), with d = 0 so this
build's host-side bracketing is index-exact.
"""
import os

import numpy as np
import pytest

from grtcode_jax import constants
from grtcode_jax.gas_optics import bins as bins_mod
from grtcode_jax.gas_optics.gas_optics import GasOptics
from grtcode_jax.gas_optics.hitran import synthetic_catalog
from grtcode_jax.spectral import SpectralGrid

from test_gasoptics_pipeline import _lcg_params, NUM_LEVELS  # noqa: E402

HERE = os.path.dirname(__file__)
NUM_LAYERS, NW = 8, 3001


@pytest.fixture(scope="module")
def goldens():
    data = np.loadtxt(os.path.join(HERE, "data", "bins_golden.txt"))
    data = data.reshape(2, NUM_LAYERS, NW)
    return {"wavenumber_sweep": data[0], "line_sweep": data[1]}


def _tau(method):
    v0, s0, yair, yself, en, nexp, d, iso = _lcg_params()
    d = np.zeros_like(d)  # matches the harness: no pressure shift
    cat = synthetic_catalog(1, v0, s0, yair=yair, yself=yself, en=en,
                            n=nexp, d=d, iso=iso)
    grid = SpectralGrid(100.0, 400.0, 0.1)
    gas = GasOptics(grid, line_chunk=64, method=method)
    gas.add_catalog(cat)

    i = np.arange(NUM_LEVELS)
    p_atm = 1e-5 + (1.0 - 1e-5) * i / (NUM_LEVELS - 1.0)
    t = 215.0 + (288.0 - 215.0) * i / (NUM_LEVELS - 1.0)
    x = 1e-5 + 3e-3 * i / (NUM_LEVELS - 1.0)
    p_mb = p_atm / constants.MB_TO_ATM
    return np.asarray(gas.optical_depth(
        np.asarray(p_mb, np.float32), np.asarray(t, np.float32),
        {1: np.asarray(x, np.float32)}))


@pytest.mark.parametrize("method", ["wavenumber_sweep", "line_sweep"])
def test_bin_method_matches_reference(method, goldens):
    tau = _tau(method)
    golden = goldens[method]
    # f32 pipeline vs f64 reference; the quadratic wing interpolation
    # amplifies rounding slightly relative to direct sampling.
    np.testing.assert_allclose(tau, golden, rtol=2e-3, atol=1e-7)
    assert golden.max() > 100.0 and (golden > 0).sum() > 15000


def test_spectral_bins_structure():
    """create_spectral_bins invariants (spectral_bin.c:30-108)."""
    b = bins_mod.create_spectral_bins(3001, 100.0, 0.1, 1.0)
    assert b.ppb == 11 and b.do_interp
    assert b.n == 273 and b.last_ppb == 3001 - 272 * 11
    assert b.l[0] == 0 and b.r[0] == 10
    np.testing.assert_allclose(b.w[0], [100.0, 100.5, 101.0])
    # Every fine point is covered exactly once.
    assert b.r[-1] == 3000
    np.testing.assert_array_equal(b.l[1:], b.r[:-1] + 1)

    # ppb <= 3: no interpolation, NIP values are the fine points.
    b2 = bins_mod.create_spectral_bins(10, 0.0, 1.0, 2.0)
    assert b2.ppb == 3 and not b2.do_interp


def test_bin_methods_approximate_line_sample():
    """The binned wing approximation stays within a few percent of the
    exact per-point sampling away from line centers (the reference's
    design tradeoff)."""
    exact = _tau("scatter")
    for method in ("wavenumber_sweep", "line_sweep"):
        approx = _tau(method)
        # Integrated tau per layer agrees to ~1%.
        num = np.abs(approx.sum(-1) - exact.sum(-1))
        assert (num <= 0.02 * exact.sum(-1)).all(), method


@pytest.mark.parametrize("method", ["wavenumber_sweep", "line_sweep"])
def test_bin_method_spectral_blocks(method):
    """Bin-interpolated methods accept spectral blocks (the band-global
    bin pipeline runs per shard and the block slices out), so they work
    under a (columns x spectral) mesh like line_sample — block results
    equal the corresponding full-grid slice exactly."""
    v0, s0, yair, yself, en, nexp, d, iso = _lcg_params()
    cat = synthetic_catalog(1, v0, s0, yair=yair, yself=yself, en=en,
                            n=nexp, d=np.zeros_like(d), iso=iso)
    grid = SpectralGrid(100.0, 400.0, 0.1)
    gas = GasOptics(grid, line_chunk=64, method=method)
    gas.add_catalog(cat)

    i = np.arange(NUM_LEVELS)
    p_mb = (1e-5 + (1.0 - 1e-5) * i / (NUM_LEVELS - 1.0)) \
        / constants.MB_TO_ATM
    t = 215.0 + 73.0 * i / (NUM_LEVELS - 1.0)
    x = 1e-5 + 3e-3 * i / (NUM_LEVELS - 1.0)
    args = (np.asarray(p_mb, np.float32), np.asarray(t, np.float32),
            {1: np.asarray(x, np.float32)})
    full = np.asarray(gas.optical_depth(*args))
    # Tile-aligned blocks incl. a tail block padding past the grid end.
    for start, size in ((0, 1024), (1024, 1024), (2048, 1024)):
        block = np.asarray(gas.optical_depth(
            *args, block_start=start, block_size=size))
        want = full[:, start:start + size]
        np.testing.assert_allclose(block[:, :want.shape[1]], want,
                                   rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("method", ["wavenumber_sweep", "line_sweep"])
def test_bin_method_batched_block_equals_slice(method):
    """A batched (B=2) bin-method spectral block at tile-aligned starts
    that are not bin-group multiples equals the matching slice of the
    full band for every column."""
    v0, s0, yair, yself, en, nexp, d, iso = _lcg_params()
    cat = synthetic_catalog(1, v0, s0, yair=yair, yself=yself, en=en,
                            n=nexp, d=d, iso=iso)
    grid = SpectralGrid(100.0, 400.0, 0.1)
    gas = GasOptics(grid, line_chunk=64, method=method)
    gas.add_catalog(cat)
    i = np.arange(NUM_LEVELS)
    p_mb = (1e-5 + (1.0 - 1e-5) * i / (NUM_LEVELS - 1.0)) \
        / constants.MB_TO_ATM
    t = 215.0 + 73.0 * i / (NUM_LEVELS - 1.0)
    x = 1e-5 + 3e-3 * i / (NUM_LEVELS - 1.0)
    p2 = np.stack([p_mb, 0.8 * p_mb]).astype(np.float32)
    t2 = np.stack([t, t - 12.0]).astype(np.float32)
    x2 = np.stack([x, 2.0 * x]).astype(np.float32)
    full = np.asarray(gas.optical_depth(p2, t2, {1: x2}))
    assert full.shape == (2, NUM_LEVELS - 1, grid.n)
    q = gas.block_quantum
    for start in (5 * q, 23 * q, (grid.n // q) * q):
        block = np.asarray(gas.optical_depth(
            p2, t2, {1: x2}, block_start=start, block_size=8 * q))
        want = full[..., start:start + 8 * q]
        np.testing.assert_allclose(block[..., :want.shape[-1]], want,
                                   rtol=1e-6, atol=1e-8)
