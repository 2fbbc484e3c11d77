"""CIRC netCDF case loading (circ.c create_atmosphere, :103-436).

Fabricates a CIRC-format case file and checks every semantic the
reference binary applies on ingest: pressure-space layer->level
abundance interpolation, zenith-angle -> cosine conversion, the
TSI = horizontal-irradiance / cos(sza) split, spectral vs constant
(-a) albedo, the well-mixed N2 / O2_abundance CIA rule, level-window
slicing, aerosol/cloud field mapping, and the CLI round trip.
"""
import h5py
import numpy as np
import pytest

from grtcode_jax.apps import circ
from grtcode_jax.framework import pressure_interp_layers_to_levels
from grtcode_jax.gas_optics.molecules import CfcId, CiaId, MoleculeId
from grtcode_jax.utils import ncio

NLEV = 9
NLAY = NLEV - 1
NW = 16
SZA_DEG = 47.88
IRR = 912.79


@pytest.fixture(scope="module")
def case_file(tmp_path_factory):
    rng = np.random.default_rng(3)
    path = str(tmp_path_factory.mktemp("circ_case") / "case2.nc")
    p_lev = np.linspace(1.0, 1013.0, NLEV)
    p_lay = 0.5 * (p_lev[:-1] + p_lev[1:])
    with ncio.Writer(path) as w:
        w.create_dimension("levels", NLEV)
        w.create_dimension("layers", NLAY)
        w.create_dimension("wavenumber", NW,
                           values=np.linspace(100.0, 49000.0, NW))
        w.create_variable("level_pressure", ("levels",), p_lev, units="mb")
        w.create_variable("layer_pressure", ("layers",), p_lay, units="mb")
        w.create_variable("level_temperature", ("levels",),
                          np.linspace(210.0, 290.0, NLEV), units="K")
        w.create_variable("layer_temperature", ("layers",),
                          np.linspace(212.0, 288.0, NLAY), units="K")
        w.create_variable("surface_temperature", (), 294.2, units="K")
        w.create_variable("solar_zenith_angle", (), SZA_DEG, units="degree")
        w.create_variable("toa_solar_irradiance", (), IRR, units="W m-2")
        w.create_variable("surface_albedo", ("wavenumber",),
                          rng.uniform(0.05, 0.3, NW))
        for mol in ("H2O", "CO2", "O3", "N2O", "CO", "CH4", "O2"):
            w.create_variable(f"{mol}_abundance", ("layers",),
                              rng.uniform(1e-7, 1e-2, NLAY))
        for cfc in ("CFC11", "CFC12", "CCl4"):
            w.create_variable(f"{cfc}_abundance", ("layers",),
                              rng.uniform(1e-11, 1e-9, NLAY))
        w.create_variable("angstrom_exponent", (), 1.48)
        w.create_variable("aerosol_optical_depth_at_1_micron", ("layers",),
                          rng.uniform(0.0, 0.05, NLAY))
        w.create_variable("aerosol_single_scatter_albedo", ("layers",),
                          rng.uniform(0.8, 1.0, NLAY))
        w.create_variable("aerosol_asymmetry_factor", ("layers",),
                          rng.uniform(0.4, 0.8, NLAY))
        w.create_variable("liquid_water_path", ("layers",),
                          np.where(np.arange(NLAY) == 5, 40.0, 0.0))
        w.create_variable("liquid_water_effective_particle_size",
                          ("layers",), np.full(NLAY, 10.0))
        w.create_variable("height_above_sea_level", ("levels",),
                          np.linspace(20.0, 0.0, NLEV), units="km")
    return path


def test_abundance_interpolation_and_units(case_file):
    atm = circ.load_case_file(case_file)
    with h5py.File(case_file, "r") as f:
        ab = np.asarray(f["H2O_abundance"])
        p_lev = np.asarray(f["level_pressure"])
        p_lay = np.asarray(f["layer_pressure"])
    want = pressure_interp_layers_to_levels(
        ab[None, :], p_lay[None, :], p_lev[None, :]) * 1e6
    np.testing.assert_allclose(atm.ppmv[int(MoleculeId.H2O)], want)
    # Endpoints copy the nearest layer (basic-circ-test.c:55-56).
    assert atm.ppmv[int(MoleculeId.H2O)][0, 0] == pytest.approx(
        ab[0] * 1e6)
    assert atm.ppmv[int(MoleculeId.H2O)][0, -1] == pytest.approx(
        ab[-1] * 1e6)
    # Interior level i brackets layer midpoints (i-1, i) — the
    # basic-circ-test indexing, not circ.c's off-by-one.
    i = 3
    frac = (p_lev[i] - p_lay[i - 1]) / (p_lay[i] - p_lay[i - 1])
    assert atm.ppmv[int(MoleculeId.H2O)][0, i] == pytest.approx(
        (ab[i - 1] + (ab[i] - ab[i - 1]) * frac) * 1e6)
    assert int(CfcId.CFC11) in atm.cfc_ppmv


def test_zenith_tsi_albedo(case_file):
    atm = circ.load_case_file(case_file)
    mu = np.cos(np.deg2rad(SZA_DEG))
    assert atm.cos_zenith[0] == pytest.approx(mu)
    # The file stores the horizontal TOA irradiance; TSI = irr / mu
    # (circ.c:165-172).
    assert atm.total_solar_irradiance[0] == pytest.approx(IRR / mu)
    assert atm.albedo.shape == (1, NW)

    const = circ.load_case_file(case_file, albedo=0.2)
    np.testing.assert_array_equal(const.albedo, [[0.2, 0.2]])
    np.testing.assert_array_equal(const.albedo_grid, [-1.0, 0.0])


def test_cia_rule(case_file):
    atm = circ.load_case_file(case_file)
    np.testing.assert_allclose(atm.cia_ppmv[int(CiaId.N2)], 0.781e6)
    np.testing.assert_allclose(atm.cia_ppmv[int(CiaId.O2)],
                               atm.ppmv[int(MoleculeId.O2)])


def test_level_window(case_file):
    atm = circ.load_case_file(case_file, z=2, Z=6)
    full = circ.load_case_file(case_file)
    assert atm.num_levels == 5
    np.testing.assert_allclose(atm.level_pressure[0],
                               full.level_pressure[0, 2:7])


def test_aerosol_and_cloud_fields(case_file):
    atm = circ.load_case_file(case_file, clean=False, clear=False)
    assert atm.aerosol_optical_depth_1um.shape == (1, NLAY)
    assert atm.aerosol_angstrom_exponent == pytest.approx(1.48)
    assert atm.cloud_fraction[0, 5] == 1.0 and atm.cloud_fraction[0, 0] == 0
    # LWP [g m-2] / thickness [m] -> content [g m-3].
    thick = 2500.0  # 20 km over 8 layers
    assert atm.liquid_water_content[0, 5] == pytest.approx(40.0 / thick)


def test_circ_main_with_case_file(case_file, tmp_path):
    out = str(tmp_path / "circ_out.nc")
    res = circ.main(["none", "none", case_file, "-o", out,
                     "-r-lw", "4.0", "-r-sw", "10.0"])
    with h5py.File(out, "r") as f:
        for name in ("rlu", "rld", "rsu", "rsd"):
            v = np.asarray(f[name])
            assert v.shape == (NLEV,)
            assert np.isfinite(v).all()
        # Transparent gas optics: TOA downward SW == the file's
        # horizontal irradiance.
        assert abs(np.asarray(f["rsd"])[0] - IRR) < 1.0
    assert "csaf" in res.tiers
