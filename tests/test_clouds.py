"""Cloud subsystem: beta functions, stochastic subcolumns, Pade optics,
band mapping, and the all-sky driver tier."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from grtcode_jax.clouds import (beta_value, beta_inverse, overlap_parameter,
                                cloudiness, sample_condensate,
                                PadeCloudOptics, CloudOpticsLib,
                                ice_particle_size)
from grtcode_jax.clouds.lib import band_to_grid
from grtcode_jax.clouds.pade import synthetic_pade_table
from grtcode_jax.spectral import SpectralGrid


def test_beta_inverse_roundtrip():
    y = jnp.linspace(0.01, 0.99, 25)
    x = beta_inverse(5, 5, y)
    np.testing.assert_allclose(np.asarray(beta_value(5, 5, x)),
                               np.asarray(y), atol=2e-5)


def test_beta_value_endpoints():
    assert float(beta_value(5, 5, 0.0)) == 0.0
    assert abs(float(beta_value(5, 5, 1.0)) - 1.0) < 1e-6
    assert abs(float(beta_value(5, 5, 0.5)) - 0.5) < 1e-6  # symmetric pdf


def test_overlap_parameter():
    z = jnp.asarray([10.0, 8.0, 7.0, 6.5])
    a = np.asarray(overlap_parameter(z, 2.0))
    np.testing.assert_allclose(a, np.exp(-np.asarray([2.0, 1.0, 0.5]) / 2.0),
                               rtol=1e-6)


def test_cloudiness_rank_correlation():
    """With overlap ~1 every layer copies layer 0; with overlap 0 layers
    are independent (stochastic_clouds.c:11-30)."""
    n = 20
    key = jax.random.PRNGKey(0)
    x1 = np.asarray(cloudiness(key, jnp.ones(n - 1) * 0.999999, n))
    assert np.allclose(x1, x1[0])
    x0 = np.asarray(cloudiness(key, jnp.zeros(n - 1), n))
    assert len(np.unique(np.round(x0, 8))) > n // 2


def test_sample_condensate_mean_preserved():
    """Subcolumn-mean condensate converges to the prescribed mean
    (the PDF is built so the conditional mean equals lwc+iwc)."""
    nlayers = 4
    cf = jnp.full((nlayers,), 0.6)
    lwc = jnp.full((nlayers,), 0.2)
    iwc = jnp.full((nlayers,), 0.1)
    ov = jnp.zeros((nlayers - 1,))
    keys = jax.random.split(jax.random.PRNGKey(1), 4000)
    ql, qi = jax.vmap(lambda k: sample_condensate(k, cf, lwc, iwc, ov))(keys)
    ql = np.asarray(ql)
    qi = np.asarray(qi)
    assert (ql >= 0).all() and (qi >= 0).all()
    # Cloudy fraction of samples ~ cf.
    cloudy = (ql + qi > 0).mean(axis=0)
    np.testing.assert_allclose(cloudy, 0.6, atol=0.05)
    # Mean total condensate over all subcolumns ~ lwc + iwc.
    np.testing.assert_allclose((ql + qi).mean(axis=0), 0.3, rtol=0.1)
    # Liquid fraction preserved exactly per sample.
    mask = ql + qi > 0
    np.testing.assert_allclose(
        (ql / np.maximum(ql + qi, 1e-30))[mask], 2.0 / 3.0, rtol=1e-5)


def test_ice_particle_size_steps():
    t = jnp.asarray([270.0, 246.0, 241.0, 236.0, 231.0, 226.0, 221.0, 216.0])
    got = np.asarray(ice_particle_size(t))
    np.testing.assert_allclose(
        got, [100.6, 80.8, 93.5, 63.9, 42.5, 39.9, 21.6, 20.2])


def test_pade_evaluate_and_band_map():
    table = synthetic_pade_table(nbnd=8, w0=100.0, wn=900.0)
    content = jnp.asarray([0.0, 0.3, 0.5])
    radius = jnp.asarray([10.0, 15.0, 500.0])   # last outside every regime
    ext, ssa, g = table.evaluate(content, radius)
    assert ext.shape == (3, 8)
    assert np.all(np.asarray(ext[0]) == 0.0)    # zero content
    assert np.all(np.asarray(ext[2]) == 0.0)    # radius out of range
    assert np.all(np.asarray(ext[1]) > 0.0)
    # Extinction scales linearly with content.
    ext2, _, _ = table.evaluate(content * 2, radius)
    np.testing.assert_allclose(np.asarray(ext2[1]), 2 * np.asarray(ext[1]),
                               rtol=1e-6)

    grid = SpectralGrid(50.0, 1000.0, 1.0)
    w = grid.wavenumbers()
    mapped = band_to_grid(ext[1], table.band_lims, w)
    assert mapped.shape == (grid.n,)
    # Points below band 0 and above the last band are zero.
    assert float(mapped[0]) == 0.0 and float(mapped[-1]) == 0.0
    # A point inside band 3 carries band 3's value.
    i = grid.point_index(450.0)
    np.testing.assert_allclose(float(mapped[i]), float(ext[1, 3]), rtol=1e-6)


def test_allsky_driver_tier():
    """All-sky tier through the framework: cloudy columns emit more LW
    down at the surface and reflect more SW than clear columns."""
    from grtcode_jax.apps import circ
    atm = circ.case1_atmosphere(clean=True, clear=False)
    # CIRC case 1 is a clear-sky case (all cloud fields zero); inject a
    # synthetic low liquid deck + cirrus layer to exercise the tier.
    atm.cloud_fraction[0, 44:48] = 0.999
    atm.liquid_water_content[0, 44:48] = 0.25   # g m-3
    atm.cloud_fraction[0, 20:23] = 0.999
    atm.ice_water_content[0, 20:23] = 0.02
    lw_grid = SpectralGrid(1.0, 3250.0, 2.0)
    sw_grid = SpectralGrid(1.0, 50000.0, 10.0)
    drv = circ.build_driver(lw_grid=lw_grid, sw_grid=sw_grid, line_chunk=64)
    drv.cloud_optics = CloudOpticsLib(
        liquid=synthetic_pade_table(nbnd=16, w0=1.0, wn=50000.0, seed=0),
        ice=synthetic_pade_table(nbnd=16, w0=1.0, wn=50000.0, seed=1),
    ).driver_callback()
    res = drv.run(atm, integrated=True)
    assert "af" in res.tiers
    rsus_csaf = float(res.variable("RSUSCSAF")[0])
    rsut_af = float(res.variable("RSUTAF")[0])
    rsut_csaf = float(res.variable("RSUTCSAF")[0])
    rlds_af = float(res.variable("RLDSAF")[0])
    rlds_csaf = float(res.variable("RLDSCSAF")[0])
    assert np.isfinite([rsut_af, rlds_af]).all()
    assert rsut_af > rsut_csaf            # clouds reflect SW
    assert rlds_af > rlds_csaf            # clouds emit LW downward
    assert rsus_csaf > 0


# -- Hu & Stamnes legacy liquid optics (liquid_cloud_optics.c:12-104) --------

def _hu_stamnes_fixture():
    from grtcode_jax.clouds import HuStamnesLiquidOptics
    rng = np.random.default_rng(7)
    nbins, nbands = 4, 3
    radii = np.array([2.5, 10.0, 20.0, 40.0, 60.0])
    band_lims = np.array([[1.0, 1000.0, 2000.0], [1000.0, 2000.0, 3000.0]])
    a = rng.uniform(0.1, 2.0, (3, nbins, nbands))
    b = rng.uniform(-1.5, -0.2, (3, nbins, nbands))
    c = rng.uniform(0.0, 0.1, (3, nbins, nbands))
    return HuStamnesLiquidOptics.from_arrays(radii, band_lims, a, b, c), \
        (radii, a, b, c)


def _hu_stamnes_scalar(radii, a, b, c, wc, r, band):
    """Direct transcription of the reference per-scalar loop semantics
    (liquid_cloud_optics.c:18-30) for golden comparison."""
    r = min(max(r, radii[0]), radii[-1])
    i = 1
    while i < len(radii) - 1:
        if radii[i] > r:
            break
        i += 1
    i -= 1
    ext = wc * 1e-3 * (a[0, i, band] * r ** b[0, i, band] + c[0, i, band])
    ssa = 1.0 - (a[1, i, band] * r ** b[1, i, band] + c[1, i, band])
    g = a[2, i, band] * r ** b[2, i, band] + c[2, i, band]
    return ext, ssa, g


def test_hu_stamnes_matches_reference_semantics():
    hs, (radii, a, b, c) = _hu_stamnes_fixture()
    wcs = np.array([0.05, 0.3, 1.2, 0.7])
    rads = np.array([1.0, 12.0, 35.0, 80.0])   # incl. out-of-range clamps
    ext, ssa, g = hs.evaluate(jnp.asarray(wcs), jnp.asarray(rads))
    for k in range(len(wcs)):
        for band in range(3):
            e0, s0, g0 = _hu_stamnes_scalar(radii, a, b, c, wcs[k], rads[k],
                                            band)
            np.testing.assert_allclose(float(ext[k, band]), e0, rtol=1e-5)
            np.testing.assert_allclose(float(ssa[k, band]), s0, rtol=1e-5)
            np.testing.assert_allclose(float(g[k, band]), g0, rtol=1e-5)


def test_hu_stamnes_plugs_into_cloud_lib():
    """HuStamnesLiquidOptics satisfies the CloudOpticsLib liquid contract."""
    hs, _ = _hu_stamnes_fixture()
    ice = synthetic_pade_table()
    lib = CloudOpticsLib(liquid=hs, ice=ice)
    grid = SpectralGrid(500.0, 1500.0, 10.0)
    key = jax.random.PRNGKey(0)
    nlay = 6
    out = lib.column_optics(
        key, cloud_fraction=jnp.full(nlay, 0.9),
        lwc=jnp.full(nlay, 0.2), iwc=jnp.full(nlay, 0.05),
        t_lay=jnp.linspace(220.0, 280.0, nlay),
        layer_pressure_mb=jnp.linspace(300.0, 900.0, nlay),
        layer_thickness=jnp.full(nlay, 500.0), grids=(grid,))
    (liq, ice_o), = out
    assert liq.tau.shape == (nlay, grid.n)
    assert np.all(np.asarray(liq.tau) >= 0.0)
    assert np.all(np.isfinite(np.asarray(liq.omega)))
