"""ERA5 application: hyperslab reorder, unit conversions, GHG annual
means, cloud content, LW-only default, and segment output + combining."""
import h5py
import numpy as np
import pytest

from grtcode_jax.apps import era5, circ
from grtcode_jax.gas_optics.molecules import CfcId, MoleculeId
from grtcode_jax.spectral import SpectralGrid

T, Z, Y, X = 2, 8, 3, 4
NLAY = Z - 1


@pytest.fixture(scope="module")
def era5_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("era5") / "era5.nc")
    rng = np.random.default_rng(9)
    with h5py.File(path, "w") as f:
        f.create_dataset("time", data=np.arange(T, dtype=np.float64))
        f.create_dataset("lat", data=np.array([-30.0, 0.0, 30.0]))
        f.create_dataset("lon", data=np.arange(X) * 90.0)
        p = np.linspace(1.0, 1000.0, Z)[None, :, None, None] * \
            np.ones((T, 1, Y, X))                       # [mb]
        f.create_dataset("p", data=p)
        f.create_dataset("t", data=np.linspace(220, 290, Z)[None, :, None,
                                                            None]
                         + rng.uniform(-3, 3, (T, Z, Y, X)))
        f.create_dataset("q", data=rng.uniform(1e-6, 1e-2, (T, Z, Y, X)))
        f.create_dataset("o3", data=rng.uniform(1e-8, 1e-5, (T, Z, Y, X)))
        f.create_dataset("skt", data=rng.uniform(280, 300, (T, Y, X)))
        f.create_dataset("fal", data=rng.uniform(0.05, 0.5, (T, Y, X)))
        f.create_dataset("tisr", data=rng.uniform(0, 3e7, (T, Y, X)))
        f.create_dataset("cc", data=rng.uniform(-0.1, 0.9, (T, Z, Y, X)))
        f.create_dataset("ciwc", data=rng.uniform(-1e-6, 1e-4,
                                                  (T, Z, Y, X)))
        f.create_dataset("clwc", data=rng.uniform(-1e-6, 5e-4,
                                                  (T, Z, Y, X)))
    return path


@pytest.fixture(scope="module")
def ghg_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ghg") / "ghg.nc")
    nyears = 5
    with h5py.File(path, "w") as f:
        f.create_dataset("co2", data=300.0 + np.arange(nyears))
        f.create_dataset("ch4", data=1.7 + 0.01 * np.arange(nyears))
        f.create_dataset("n2o", data=0.3 + 0.001 * np.arange(nyears))
        f.create_dataset("hfc134aeq", data=1e-4 * (1 + np.arange(nyears)))
        f.create_dataset("cfc12eq", data=5e-4 * (1 + np.arange(nyears)))
    return path


def test_load_and_reorder(era5_file, ghg_file):
    atm = era5.load_atmosphere(era5_file, ghg_file, year=3,
                               ghg_start_year=1, cfc_eq=(CfcId.CFC12,),
                               clear=False)
    assert atm.batch == T * Y * X
    assert atm.num_levels == Z
    # GHG year indexing: year 3, start 1 -> index 2 -> co2 = 302.
    np.testing.assert_allclose(atm.ppmv[int(MoleculeId.CO2)], 302.0)
    np.testing.assert_allclose(atm.cfc_ppmv[int(CfcId.CFC12)], 5e-4 * 3)
    # q -> vmr conversion with the dry-air mass ratio (era5.c:292-300).
    with h5py.File(era5_file, "r") as f:
        q0 = f["q"][0, :, 0, 0]
    np.testing.assert_allclose(
        atm.ppmv[int(MoleculeId.H2O)][0],
        q0 * 1e6 * (28.97 / 18.01528), rtol=1e-6)
    # Default reference behavior: zenith hardcoded to -1 -> LW only.
    assert np.all(atm.cos_zenith == -1.0)
    # Clouds: negatives clamped, content in g m-3 positive.
    assert (atm.cloud_fraction >= 0).all()
    assert (atm.liquid_water_content >= 0).all()
    assert atm.layer_thickness.shape == (T * Y * X, NLAY)
    assert (atm.layer_thickness > 0).all()


def test_lw_only_run_and_segments(era5_file, ghg_file, tmp_path):
    """Two lon segments run independently, write with merge attrs, and the
    combiner reproduces the full-domain run (the reference's SLURM
    sharding + combine-segments.py workflow) — including the
    (time, level, lat, lon) state profiles whose lon axis is NOT axis 2."""
    from tools.combine_segments import combine
    lw_grid = SpectralGrid(1.0, 500.0, 1.0)
    drv = era5.build_driver(lw_grid=lw_grid, line_chunk=64)

    def run(xsel):
        atm = era5.load_atmosphere(era5_file, ghg_file, year=1,
                                   x=xsel, clear=True)
        return atm, drv.run(atm, integrated=True)

    atm_full, full = run(slice(None))
    seg_paths = []
    for i, xs in enumerate((slice(0, 2), slice(2, 4))):
        atm, res = run(xs)
        path = str(tmp_path / f"seg{i}.nc")
        era5.write_fluxes(path, res, (T, Y, 2), lon_start=2 * i,
                          lon_stop=2 * i + 1, lon_global_size=X,
                          lw_grid=lw_grid, atm=atm, user_level=3)
        seg_paths.append(path)

    merged = str(tmp_path / "merged.nc")
    combine(seg_paths, merged)
    with h5py.File(merged, "r") as f:
        rlut = np.asarray(f["rlutcsaf"])
        rlds = np.asarray(f["rldscsaf"])
        rlu_user = np.asarray(f["rlucsaf_level"])
        p = np.asarray(f["p"])
    assert rlut.shape == (T, Y, X)
    np.testing.assert_allclose(
        rlut.reshape(-1), np.asarray(full.tiers["csaf"]["rlu"][:, 0]),
        rtol=1e-6)
    np.testing.assert_allclose(
        rlds.reshape(-1), np.asarray(full.tiers["csaf"]["rld"][:, -1]),
        rtol=1e-6)
    np.testing.assert_allclose(
        rlu_user.reshape(-1), np.asarray(full.tiers["csaf"]["rlu"][:, 3]),
        rtol=1e-6)
    # State profile: (time, level, lat, lon), stitched along axis 3.
    assert p.shape == (T, Z, Y, X)
    np.testing.assert_allclose(
        p.transpose(0, 2, 3, 1).reshape(-1, Z),
        atm_full.level_pressure, rtol=1e-6)
    # Variables unwritten in every segment (the LW-only run's SW set)
    # stay define-only in the merged file: fill values, zero storage —
    # the combiner must NOT densify them (a production spectral SW
    # variable would be hundreds of GB of fill).
    from grtcode_jax.utils.ncio import Writer
    with h5py.File(merged, "r") as f:
        assert f["rsutaf"].id.get_storage_size() == 0
        assert np.all(np.asarray(f["rsutaf"]) == Writer.FILL_VALUE)


def test_output_variable_surface(era5_file, ghg_file, tmp_path):
    """The flux file defines the reference's full variable set
    (era5.c:865-955) regardless of what the run computed: state vars,
    both tiers, both bands, user-level vars."""
    lw_grid = SpectralGrid(1.0, 500.0, 1.0)
    drv = era5.build_driver(lw_grid=lw_grid, line_chunk=64)
    atm = era5.load_atmosphere(era5_file, ghg_file, year=1, clear=True)
    res = drv.run(atm, integrated=True)
    path = str(tmp_path / "surface.nc")
    era5.write_fluxes(path, res, (T, Y, X), lon_start=0, lon_stop=X - 1,
                      lon_global_size=X, lw_grid=lw_grid, atm=atm)
    expected = {
        # era5.c:871-886 state variables
        "p", "t", "h2o_vmr", "o3_vmr", "ch4_vmr", "co2_vmr", "n2o_vmr",
        "ts", "t_layer",
        # era5.c:888-914 LW tier variables
        "rldsaf", "rlusaf", "rlutaf", "rldscsaf", "rluscsaf", "rlutcsaf",
        "rluaf_level", "rldaf_level", "rlucsaf_level", "rldcsaf_level",
        # era5.c:917-950 SW tier variables
        "rsdsaf", "rsusaf", "rsdtaf", "rsutaf", "rsdscsaf", "rsuscsaf",
        "rsdtcsaf", "rsutcsaf", "rsuaf_level", "rsdaf_level",
        "rsucsaf_level", "rsdcsaf_level",
    }
    dims = {"time", "lat", "lon", "level", "layer", "lw_wavenumber",
            "sw_wavenumber"}
    with h5py.File(path, "r") as f:
        names = set(f.keys())
        assert expected <= names
        assert names - expected == dims
        # ch4_vmr comes from the GHG annual mean; rlutcsaf has data;
        # the LW-only run leaves SW variables as netCDF fill values
        # (NC_FILL_FLOAT, exactly the reference's file behavior) so
        # "never computed" is distinguishable from a genuine zero flux.
        from grtcode_jax.utils.ncio import Writer
        assert np.asarray(f["ch4_vmr"]).max() > 0
        assert np.asarray(f["rlutcsaf"]).max() > 0
        assert np.all(np.asarray(f["rsutaf"]) == Writer.FILL_VALUE)
        assert f["rsutaf"].shape == (T, Y, X)


def test_derive_zenith(era5_file, ghg_file):
    """cos(zenith) = tisr / planetary-mean irradiance with the mean taken
    cos(lat)-weighted over the GLOBAL field x4 (the commented-out
    derivation at era5.c:352-415), and TSI = tisr/(86400 mu)
    (era5.c:429), zero on night columns."""
    atm = era5.load_atmosphere(era5_file, ghg_file, year=1,
                               derive_zenith=True)
    with h5py.File(era5_file, "r") as f:
        tisr = np.asarray(f["tisr"]) / 86400.0
        lat = np.asarray(f["lat"])
    w = np.cos(np.deg2rad(lat))
    mean_irr = np.zeros(T)
    for i in range(T):
        zonal = tisr[i].mean(axis=1)              # (Y,)
        mean_irr[i] = 4.0 * (zonal * w).sum() / w.sum()
    mu_expect = (tisr / mean_irr[:, None, None]).reshape(-1)
    np.testing.assert_allclose(atm.cos_zenith, mu_expect, rtol=1e-12)
    tsi_expect = np.where(mu_expect > 0,
                          tisr.reshape(-1) / np.maximum(mu_expect, 1e-6),
                          0.0)
    np.testing.assert_allclose(atm.total_solar_irradiance, tsi_expect,
                               rtol=1e-12)
    assert np.isfinite(atm.total_solar_irradiance).all()


def test_derive_zenith_global_mean_from_slab(era5_file, ghg_file):
    """A lon-slab run must use the same GLOBAL planetary mean as the
    full-domain run (era5.c reads weights/irradiance with start=0), so
    slab mu values are a subset of the full-domain mu values."""
    full = era5.load_atmosphere(era5_file, ghg_file, year=1,
                                derive_zenith=True)
    slab = era5.load_atmosphere(era5_file, ghg_file, year=1,
                                x=slice(1, 3), derive_zenith=True)
    mu_full = full.cos_zenith.reshape(T, Y, X)
    np.testing.assert_allclose(slab.cos_zenith.reshape(T, Y, 2),
                               mu_full[:, :, 1:3], rtol=1e-12)


def test_spectral_output(era5_file, ghg_file, tmp_path):
    """Spectrally-resolved ERA5 output: 4-D (time, lat, lon, wavenumber)
    TOA/surface variables on the lw_wavenumber dim (era5.c:880-955;
    LW-only like the shipped binary)."""
    lw_grid = SpectralGrid(1.0, 500.0, 1.0)
    drv = era5.build_driver(lw_grid=lw_grid, line_chunk=64)
    atm = era5.load_atmosphere(era5_file, ghg_file, year=1, clear=True)
    res = drv.run(atm, integrated=False)
    path = str(tmp_path / "spectral.nc")
    era5.write_fluxes(path, res, (T, Y, X), lon_start=0, lon_stop=X - 1,
                      lon_global_size=X, lw_grid=lw_grid)
    with h5py.File(path, "r") as f:
        assert f["lw_wavenumber"].shape == (lw_grid.n,)
        for name in ("rlutcsaf", "rluscsaf", "rldscsaf"):
            assert f[name].shape == (T, Y, X, lw_grid.n), name
        # LW-only configuration: SW variables defined, never written
        # (the reference's fill-value behavior, era5.c:406-415).
        from grtcode_jax.utils.ncio import Writer
        assert np.all(np.asarray(f["rsutcsaf"]) == Writer.FILL_VALUE)
        from grtcode_jax.utils.interp import trapezoid_uniform
        res_int = drv.run(atm, integrated=True)
        np.testing.assert_allclose(
            trapezoid_uniform(np.asarray(f["rlutcsaf"]), lw_grid.dw,
                              axis=-1).reshape(-1),
            np.asarray(res_int.tiers["csaf"]["rlu"][:, 0]),
            rtol=2e-5, atol=1e-4)
