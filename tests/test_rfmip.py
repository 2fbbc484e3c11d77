"""RFMIP-IRF application: schema parsing quirks + end-to-end run.

A synthetic netCDF4 input file (h5py) reproduces the UColorado RFMIP
layout the reference reads (rfmip-irf.c:110-466): dims (expt, site,
level/layer), *_GM scalars with numeric `units` attributes, -eq aliases,
x/X site slicing.
"""
import os

import h5py
import numpy as np
import pytest

from grtcode_jax.apps import rfmip, circ
from grtcode_jax.gas_optics.molecules import CfcId, CiaId, MoleculeId
from grtcode_jax.spectral import SpectralGrid

NSITE, NLAYER, NEXPT = 5, 10, 3
NLEVEL = NLAYER + 1


@pytest.fixture(scope="module")
def input_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("rfmip") / "rfmip.nc")
    rng = np.random.default_rng(5)
    with h5py.File(path, "w") as f:
        f.create_dataset("site", data=np.arange(NSITE, dtype=np.float64))
        f.create_dataset("level", data=np.arange(NLEVEL, dtype=np.float64))
        p_lev = np.linspace(1.0, 101325.0, NLEVEL)[None, :] * \
            rng.uniform(0.95, 1.05, (NSITE, 1))          # [Pa]
        p_lay = 0.5 * (p_lev[:, :-1] + p_lev[:, 1:])
        f.create_dataset("pres_level", data=p_lev)
        f.create_dataset("pres_layer", data=p_lay)
        t_lev = np.linspace(210.0, 290.0, NLEVEL)[None, None, :] + \
            rng.uniform(-3, 3, (NEXPT, NSITE, NLEVEL))
        f.create_dataset("temp_level", data=t_lev)
        f.create_dataset("temp_layer",
                         data=0.5 * (t_lev[..., :-1] + t_lev[..., 1:]))
        f.create_dataset("surface_temperature", data=t_lev[..., -1] + 1.0)
        f.create_dataset("solar_zenith_angle",
                         data=np.array([30.0, 60.0, 85.0, 95.0, 45.0]))
        f.create_dataset("total_solar_irradiance",
                         data=np.full(NSITE, 1361.0))
        f.create_dataset("surface_albedo",
                         data=rng.uniform(0.05, 0.3, NSITE))
        f.create_dataset("surface_emissivity",
                         data=rng.uniform(0.95, 1.0, NSITE))
        f.create_dataset("water_vapor",
                         data=rng.uniform(1e-6, 1e-2, (NEXPT, NSITE, NLAYER)))
        f.create_dataset("ozone",
                         data=rng.uniform(1e-8, 1e-5, (NEXPT, NSITE, NLAYER)))

        def gm(name, value, units):
            d = f.create_dataset(name, data=np.full(NEXPT, value))
            d.attrs["units"] = units
        gm("carbon_dioxide_GM", 397.55, "1e-06")
        gm("methane_GM", 1831.47, "1e-09")
        gm("nitrous_oxide_GM", 326.99, "1e-09")
        gm("carbon_monoxide_GM", 0.12, "1e-06")
        gm("oxygen_GM", 0.2095, "1")
        gm("nitrogen_GM", 0.781, "1")
        gm("cfc11_GM", 233.05, "1e-12")
        gm("cfc11eq_GM", 653.46, "1e-12")
        gm("cfc12_GM", 520.58, "1e-12")
        gm("hfc134aeq_GM", 300.0, "1e-12")
        gm("sf6_GM", 8.16, "1e-12")
    return path


def test_units_attr_scaling(input_file):
    atm = rfmip.load_atmosphere(input_file, experiment=1,
                                cfc_options=("CFC-11", "SF6"))
    # carbon_dioxide_GM 397.55 * 1e-06 * 1e6 = 397.55 ppmv everywhere.
    np.testing.assert_allclose(atm.ppmv[int(MoleculeId.CO2)], 397.55)
    # methane 1831.47 * 1e-09 * 1e6 = 1.83147 ppmv.
    np.testing.assert_allclose(atm.ppmv[int(MoleculeId.CH4)], 1.83147)
    # cfc11 233.05 * 1e-12 * 1e6.
    np.testing.assert_allclose(atm.cfc_ppmv[int(CfcId.CFC11)], 233.05e-6)
    np.testing.assert_allclose(atm.cfc_ppmv[int(CfcId.SF6)], 8.16e-6)


def test_eq_alias(input_file):
    atm = rfmip.load_atmosphere(input_file, experiment=0,
                                cfc_options=("CFC-11-eq", "HFC-134a-eq"))
    np.testing.assert_allclose(atm.cfc_ppmv[int(CfcId.CFC11)], 653.46e-6)
    np.testing.assert_allclose(atm.cfc_ppmv[int(CfcId.HFC134a)], 300.0e-6)


def test_site_slicing(input_file):
    full = rfmip.load_atmosphere(input_file, experiment=0)
    part = rfmip.load_atmosphere(input_file, experiment=0, x=1, X=3)
    assert full.batch == NSITE and part.batch == 3
    np.testing.assert_allclose(part.level_pressure,
                               full.level_pressure[1:4])
    np.testing.assert_allclose(part.ppmv[int(MoleculeId.H2O)],
                               full.ppmv[int(MoleculeId.H2O)][1:4])


def test_cia_pairs(input_file):
    atm = rfmip.load_atmosphere(input_file, experiment=0,
                                cia_pairs=("N2-N2", "O2-N2"))
    assert set(atm.cia_ppmv) == {int(CiaId.N2), int(CiaId.O2)}
    np.testing.assert_allclose(atm.cia_ppmv[int(CiaId.N2)], 0.781e6)


def test_end_to_end_run_and_output(input_file, tmp_path):
    atm = rfmip.load_atmosphere(input_file, experiment=2)
    drv = circ.build_driver(lw_grid=SpectralGrid(1.0, 3250.0, 2.0),
                            sw_grid=SpectralGrid(1.0, 50000.0, 10.0),
                            line_chunk=64)
    res = drv.run(atm, integrated=True)
    rsdt = res.variable("RSDTCSAF")
    mu = np.cos(np.deg2rad([30.0, 60.0, 85.0, 95.0, 45.0]))
    expect = np.where(mu > 0, 1361.0 * np.maximum(mu, 0), 0.0)
    np.testing.assert_allclose(rsdt, expect, rtol=1e-3, atol=1e-3)
    # Night site (sza > 90) has zero SW.
    assert rsdt[3] == 0.0

    out = str(tmp_path / "fluxes.nc")
    rfmip.write_fluxes(out, res, atm.level_pressure, user_level=5)
    with h5py.File(out, "r") as f:
        assert f["rlucsaf"].shape == (NSITE, NLEVEL)
        assert f["rsdcsaf_user_level"].shape == (NSITE,)
        np.testing.assert_allclose(np.asarray(f["rsdcsaf"])[:, 0], rsdt,
                                   rtol=1e-6)
        assert f.attrs["x_start"] == 0
        # Reference create_flux_file variable surface
        # (rfmip-irf.c:574-650): integrated -> (column,).
        for name in ("rlutcsaf", "rluscsaf", "rldscsaf", "rsutcsaf",
                     "rsuscsaf", "rsdtcsaf", "rsdscsaf", "rlucsaf_level",
                     "rldcsaf_level", "rsucsaf_level", "rsdcsaf_level"):
            assert f[name].shape == (NSITE,), name
        np.testing.assert_allclose(np.asarray(f["rsdtcsaf"]), rsdt,
                                   rtol=1e-6)
        assert f["rldcsaf_level"].attrs["level"] == 5


def test_spectral_output(input_file, tmp_path):
    """Spectrally-resolved flux file: lw_wavenumber/sw_wavenumber dims
    (rfmip-irf.c:494-501), trapezoid-consistent with integrated mode."""
    atm = rfmip.load_atmosphere(input_file, experiment=2)
    lw_grid = SpectralGrid(1.0, 500.0, 2.0)
    sw_grid = SpectralGrid(2000.0, 20000.0, 10.0)
    drv = circ.build_driver(lw_grid=lw_grid, sw_grid=sw_grid, line_chunk=64)
    res = drv.run(atm, integrated=False)
    out = str(tmp_path / "spectral.nc")
    rfmip.write_fluxes(out, res, atm.level_pressure, user_level=5,
                       lw_grid=lw_grid, sw_grid=sw_grid)
    with h5py.File(out, "r") as f:
        assert f["lw_wavenumber"].shape == (lw_grid.n,)
        assert f["rlutcsaf"].shape == (NSITE, lw_grid.n)
        assert f["rsdtcsaf"].shape == (NSITE, sw_grid.n)
        assert f["rsdcsaf_level"].shape == (NSITE, sw_grid.n)
        # The spectral variable trapezoid-integrates to the integrated
        # variable (output_fluxes, driver.c:306-312).
        from grtcode_jax.utils.interp import trapezoid_uniform
        spec = np.asarray(f["rlutcsaf"])
        res_int = drv.run(atm, integrated=True)
        np.testing.assert_allclose(
            trapezoid_uniform(spec, lw_grid.dw, axis=-1),
            np.asarray(res_int.tiers["csaf"]["rlu"][:, 0]),
            rtol=2e-5, atol=1e-4)
