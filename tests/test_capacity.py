"""Reference capacity ceilings: 600k lines/molecule, 200 layers.

The reference sizes its work arrays for up to 600 000 lines per molecule
(gas-optics/src/gas_optics.c:46) and validates up to 200 atmospheric
layers (utilities/src/grtcode_config.h MAX_NUM_LEVELS); this build has
no fixed arrays, but the HOST-side index machinery (tile/line/point range
tables) must stay integer-exact and in-bounds at that scale.
These tests pin exactly that — pure numpy, no device compute — so a
capacity regression (e.g. an int32 overflow in a range product) fails
here rather than in a production run.
"""
import numpy as np
import pytest

from grtcode_jax.gas_optics import lines as lines_mod
from grtcode_jax.gas_optics import pallas_kernels as pk
from grtcode_jax.gas_optics.hitran import synthetic_catalog
from grtcode_jax.spectral import SpectralGrid

L = 600_000          # gas_optics.c:46 MAX_NUM_LINES-equivalent
NLAYERS = 200        # grtcode_config.h level ceiling


@pytest.fixture(scope="module")
def bound():
    grid = SpectralGrid(1.0, 3250.0, 0.1)
    rng = np.random.default_rng(0)
    vnn = np.sort(rng.uniform(grid.w0, grid.last, L))
    cat = synthetic_catalog(
        1, vnn, 10.0 ** rng.uniform(-23.5, -19.5, L),
        yair=rng.uniform(0.02, 0.11, L), yself=rng.uniform(0.05, 0.4, L),
        en=rng.uniform(0.0, 2800.0, L), n=rng.uniform(0.35, 0.85, L),
        d=rng.uniform(-0.01, 0.01, L))
    return lines_mod.bind_to_grid(cat, SpectralGrid(1.0, 3250.0, 0.1))


def test_line_sample_tables_at_600k(bound):
    grid = SpectralGrid(1.0, 3250.0, 0.1)
    fsteps = 250
    margin = lines_mod.shift_margin(bound, grid.dw)
    tab = pk.build_line_ranges(
        bound.c0, grid.n, fsteps, tile=64, shift_margin=margin,
        near_hw=20,
        region0_hw=lines_mod.region0_halfwidth(bound, grid.dw)).table
    ntiles = -(-grid.n // 64)
    assert tab.shape == (pk.NTAB, ntiles)
    # Every range stays inside the catalog, zones are ordered, and the
    # index arithmetic did not wrap (int32 positivity at 600k lines).
    seg = tab[[pk.T_LO, pk.T_A, pk.T_B, pk.T_C, pk.T_D, pk.T_E, pk.T_F,
               pk.T_HI]].astype(np.int64)
    assert (seg >= 0).all() and (np.diff(seg, axis=0) >= 0).all()
    assert int(seg.max()) == L
    assert (tab[pk.T_NL] <= tab[pk.T_NH]).all()
    # The interior (unmasked) zone carries most of the far-wing work.
    interior = (seg[2] - seg[1]) + (seg[6] - seg[5])
    assert interior.sum() > 0.5 * (seg[7] - seg[0]).sum()

    near = lines_mod.near_core_halfwidth(bound, grid.dw)
    pr = lines_mod.build_point_ranges(bound, grid.n, min(near, fsteps),
                                      shift_margin=margin)
    assert (pr.hi >= pr.lo).all() and int(pr.hi.max()) <= L
    # Every line is reachable from some grid point's range.
    assert int(pr.lo.min()) == 0 and int(pr.hi.max()) == L


def test_prepare_200_layers(bound):
    """Line prep index math at the 200-layer ceiling: the (layers, L)
    plane at 600k lines is 120M entries — shapes and the shifted-center
    split must hold (device arrays on the test CPU backend)."""
    import jax.numpy as jnp

    grid = SpectralGrid(1.0, 3250.0, 0.1)
    sub = lines_mod.GridLines(
        bound.mol_id, bound.mass_g, bound.num_iso,
        bound.c0[:4096], bound.frac0[:4096], bound.vnn[:4096],
        bound.snn[:4096], bound.yair[:4096], bound.yself[:4096],
        bound.en[:4096], bound.n[:4096], bound.d[:4096],
        bound.iso0[:4096])
    pavg = jnp.linspace(1e-4, 1.0, NLAYERS)
    tavg = jnp.linspace(200.0, 310.0, NLAYERS)
    prep = lines_mod.prepare(sub, grid, pavg, tavg, 0.01 * pavg)
    assert prep.strength.shape == (NLAYERS, 4096)
    ci = np.asarray(prep.center_idx)
    cf = np.asarray(prep.center_frac)
    assert np.isfinite(np.asarray(prep.doppler)).all()
    assert (np.abs(cf) <= 0.5 + 1e-6).all()
    # Shift-margin contract: the rounded center never drifts farther
    # than the host margin used to size every range table.
    margin = lines_mod.shift_margin(sub, grid.dw)
    drift = np.abs(ci - np.asarray(sub.c0)[None, :])
    assert int(drift.max()) <= margin
