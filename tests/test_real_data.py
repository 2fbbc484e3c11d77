"""Real-data validation against the reference's own regression goldens.

The reference's regression contract is per-level integrated fluxes on
REAL inputs — hitran2016.par lines, MT-CKD continuum tables, CFC/CIA
cross sections, and the CIRC / RFMIP-IRF case netCDFs — checked at 1%
per level (circ/test/check_results.c and rfmip-irf/test/check_results.c,
driven by circ/test/test_circ and rfmip-irf/test/test_rfmip_irf).

Those golden arrays are transcribed verbatim into tests/data/
(ref_circ_case1_fluxes.json, ref_rfmip_site0_fluxes.json,
ref_circ_integrated.json).  The dataset itself is external (Zenodo, see
the reference's download-test-data): fetch it with
``python tools/fetch_test_data.py`` (or set $GRTCODE_DATA); without it
these tests skip with a reason.
"""
import json
import os

import numpy as np
import pytest

HERE = os.path.dirname(__file__)
REPO = os.path.dirname(HERE)


def _data_dir():
    cand = os.environ.get("GRTCODE_DATA",
                          os.path.join(REPO, "grtcode-data"))
    if os.path.exists(os.path.join(cand, "HITRAN_files",
                                   "hitran2016.par")):
        return cand
    return None


DATA = _data_dir()
needs_data = pytest.mark.skipif(
    DATA is None,
    reason="grtcode-data not present (run tools/fetch_test_data.py or "
           "set $GRTCODE_DATA)")


def _golden(name):
    with open(os.path.join(HERE, "data", name)) as f:
        return json.load(f)


def _assert_per_level(actual, expected, tolerance_pct=1.0, label=""):
    """check_result semantics (circ/test/check_results.c:41-56): each
    level's percent error vs the golden must be within tolerance; levels
    with an exactly-zero golden are skipped (the C's 0/0 comparison
    never fails them)."""
    actual = np.asarray(actual, np.float64)
    expected = np.asarray(expected, np.float64)
    assert actual.shape == expected.shape, label
    mask = expected != 0.0
    err = 100.0 * np.abs(actual[mask] - expected[mask]) / expected[mask]
    worst = float(err.max()) if err.size else 0.0
    assert worst <= tolerance_pct, \
        f"{label}: worst per-level error {worst:.3f}% > {tolerance_pct}%"


def _ctm_args(d):
    return ["-h2o-ctm", os.path.join(d, "water_vapor_continuum"),
            "-o3-ctm", os.path.join(d, "ozone_continuum",
                                    "ozone_continuum.csv")]


def _cia_args(d):
    ciadir = os.path.join(d, "collision_induced_absorption")
    out = []
    for pair in ("N2-N2", "O2-N2", "O2-O2"):
        out += [f"-{pair}", os.path.join(ciadir, f"{pair}.csv")]
    return out


def _cfc_args(d, names):
    xdir = os.path.join(d, "cfc_cross_sections")
    out = []
    for opt, fname in names:
        out += [f"-{opt}",
                os.path.join(xdir, f"{fname}_absorption_cross_sections.csv")]
    return out


@needs_data
@pytest.mark.slow
def test_circ_case1_per_level_fluxes(tmp_path):
    """CIRC case 1 with real HITRAN lines: per-level rlu/rld/rsu/rsd
    within 1% of the reference build's goldens (test_circ:6-17 flags)."""
    from grtcode_jax.apps import circ
    from grtcode_jax.utils import ncio

    d = DATA
    out = str(tmp_path / "output.circ-case1.nc")
    argv = [os.path.join(d, "HITRAN_files", "hitran2016.par"),
            os.path.join(d, "solar_flux", "solar_flux.csv"),
            os.path.join(d, "circ", "circ-case1.nc"),
            "-H2O", "-CO2", "-O3", "-N2O", "-CH4", "-CO", "-O2",
            *_ctm_args(d),
            *_cfc_args(d, [("CFC-11", "CFC-11"), ("CFC-12", "CFC-12"),
                           ("CCl4", "CCl4")]),
            *_cia_args(d), "-o", out, "-integrated"]
    circ.main(argv)
    golden = _golden("ref_circ_case1_fluxes.json")
    with ncio.Reader(out) as r:
        for var in ("rlu", "rld", "rsu", "rsd"):
            _assert_per_level(r.read(var), golden[var],
                              tolerance_pct=1.0, label=f"circ case1 {var}")


@needs_data
@pytest.mark.slow
def test_circ_case1_integrated_vs_lblrtm():
    """Embedded CIRC case 1 integrated CSAF fluxes vs the LBLRTM
    line-by-line references the reference prints next to its own output
    (basic-circ-test.c:444-501) — within 2% (the reference's own values
    sit ~1% from LBLRTM)."""
    from grtcode_jax.apps import circ

    d = DATA
    argv = [os.path.join(d, "HITRAN_files", "hitran2016.par"),
            os.path.join(d, "solar_flux", "solar_flux.csv"),
            *_ctm_args(d), *_cia_args(d), "-integrated", "-o", ""]
    res = circ.main(argv)
    golden = _golden("ref_circ_integrated.json")
    for name, refs in golden.items():
        if name == "source" or not refs.get("lblrtm"):
            continue
        got = float(res.variable(name)[0])
        err = 100.0 * abs(got - refs["lblrtm"]) / refs["lblrtm"]
        assert err <= 2.0, f"{name}: {got:.2f} vs LBLRTM " \
            f"{refs['lblrtm']:.2f} ({err:.2f}%)"


@needs_data
@pytest.mark.slow
def test_rfmip_site0_per_level_fluxes(tmp_path):
    """RFMIP-IRF site 0, forcing index 1, real inputs: per-level fluxes
    within 1% of the reference goldens (test_rfmip_irf first block)."""
    from grtcode_jax.apps import rfmip
    from grtcode_jax.utils import ncio

    d = DATA
    out = str(tmp_path / "output.forcing_index1.nc")
    cfcs = [("CFC-11", "CFC-11"), ("CFC-12", "CFC-12"),
            ("CFC-113", "CFC-113"), ("CFC-114", "CFC-114"),
            ("CFC-115", "CFC-115"), ("HCFC-22", "HCFC-22"),
            ("HCFC-141b", "HCFC-141b"), ("HCFC-142b", "HCFC-142b"),
            ("HFC-23", "HFC-23"), ("HFC-125", "HFC-125"),
            ("HFC-134a", "HFC-134a"), ("HFC-143a", "HFC-143a"),
            ("HFC-152a", "HFC-152a"), ("HFC-227ea", "HFC-227ea"),
            ("HFC-245fa", "HFC-245fa"), ("CCl4", "CCl4"),
            ("C2F6", "C2F6"), ("CF4", "CF4"), ("CH2Cl2", "CH2Cl2"),
            ("NF3", "NF3"), ("SF6", "SF6")]
    argv = [os.path.join(d, "HITRAN_files", "hitran2016.par"),
            os.path.join(d, "solar_flux", "solar_flux.csv"),
            os.path.join(d, "rfmip-irf", "multiple_input4MIPs_radiation_"
                         "RFMIP_UColorado-RFMIP-1-2_none.nc"),
            "0", "-H2O", "-CO2", "-O3", "-N2O", "-CH4", "-CO", "-O2",
            *_ctm_args(d), *_cfc_args(d, cfcs), *_cia_args(d),
            "-x", "0", "-X", "0", "-integrated", "-o", out]
    rfmip.main(argv)
    golden = _golden("ref_rfmip_site0_fluxes.json")
    ours = {"rlu": "rlucsaf", "rld": "rldcsaf", "rsu": "rsucsaf",
            "rsd": "rsdcsaf"}
    with ncio.Reader(out) as r:
        for var, our in ours.items():
            _assert_per_level(np.asarray(r.read(our))[0], golden[var],
                              tolerance_pct=1.0, label=f"rfmip {var}")


def test_register_cross_sections_wires_both_bands(tmp_path):
    """The CLI cross-section loader (driver.c:193-210, 616-625 parity)
    registers CFC/CIA CSVs and continua on BOTH bands' gas optics —
    always runs (synthetic CSVs), guarding the path the data-gated tests
    exercise with real files."""
    import argparse

    from grtcode_jax.apps.rfmip import CIA_PAIRS
    from grtcode_jax.framework import cli
    from grtcode_jax.framework.driver import RadiationDriver
    from grtcode_jax.gas_optics.gas_optics import GasOptics
    from grtcode_jax.gas_optics.molecules import CfcId
    from grtcode_jax.spectral import SpectralGrid

    def csv(name, w0=50.0, w1=5000.0, val=1e-20):
        p = tmp_path / name
        p.write_text("wavenumber,xs\n" + "".join(
            f"{w},{val}\n" for w in np.linspace(w0, w1, 40)))
        return str(p)

    o3 = tmp_path / "o3.csv"
    o3.write_text("wavenumber,cross_section\n" + "".join(
        f"{w},{4e-22}\n" for w in np.linspace(1000.0, 45000.0, 50)))

    lw = GasOptics(SpectralGrid(100.0, 500.0, 1.0))
    sw = GasOptics(SpectralGrid(2000.0, 30000.0, 10.0))
    driver = RadiationDriver(lw_gas=lw, sw_gas=sw)
    args = argparse.Namespace(
        h2o_ctm=None, o3_ctm=str(o3),
        CFC_11=csv("cfc11.csv"), CFC_12=True, CCl4=False,
        N2_N2=csv("n2n2.csv"), O2_N2=False, O2_O2=False)
    cli.register_cross_sections(
        driver, args, cfc_options=("CFC-11", "CFC-12", "CCl4"),
        cia_pairs={k: v for k, v in CIA_PAIRS.items()})
    for g in (lw, sw):
        assert int(CfcId.CFC11) in g.cfcs          # path -> loaded
        assert int(CfcId.CFC12) not in g.cfcs      # bare flag -> no table
        assert len(g.cias) == 1 and g.cias[0][:2] == (0, 0)
        assert g.o3_ctm is not None
        assert g.cfcs[int(CfcId.CFC11)].cross_section.shape == (g.grid.n,)


def test_goldens_are_wellformed():
    """The transcribed goldens themselves (always runs): shapes, physical
    sanity, and the documented source lines."""
    circ = _golden("ref_circ_case1_fluxes.json")
    rfmip = _golden("ref_rfmip_site0_fluxes.json")
    for g, n in ((circ, 55), (rfmip, 61)):
        for var in ("rlu", "rld", "rsu", "rsd"):
            vals = np.asarray(g[var])
            assert vals.shape == (n,)
            assert np.all(vals >= 0.0) and np.all(vals < 1500.0)
        # Down fluxes start at ~0 at TOA; up fluxes increase toward the
        # surface (emission accumulates).
        assert g["rld"][0] == 0.0
        assert g["rlu"][-1] > g["rlu"][0]
    ints = _golden("ref_circ_integrated.json")
    assert ints["RLUTCSAF"]["lblrtm"] == 304.27
    assert ints["RSDSCSAF"]["circ_mean"] == 705.9
