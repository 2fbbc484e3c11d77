"""HITRAN parser, molecule registry, TIPS partition sums, cross sections.

Mirrors the reference's per-component unit tests
(gas-optics/test/test_parse_HITRAN_file.c, test_molecules.c,
test_tips2017.c, test_cfcs.c patterns).
"""
import numpy as np
import pytest

from grtcode_jax import constants
from grtcode_jax.gas_optics import molecules as mol_registry
from grtcode_jax.gas_optics import tips as tips_mod
from grtcode_jax.gas_optics.hitran import (LineCatalog, _iso_code,
                                           parse_par_file, STRENGTH_SCALE)
from grtcode_jax.gas_optics.molecules import CfcId, CiaId, MoleculeId


def _record(mol, iso_ch, vnn, snn, yair, yself, en, n, d):
    """One 160-char fixed-width HITRAN2012 record (parse_HITRAN_file.c
    HITRAN2012_fmt layout)."""
    rec = (f"{mol:2d}{iso_ch}{vnn:12.6f}{snn:10.3E}" + " " * 10 +
           f"{yair:5.4f}"[:5] + f"{yself:5.3f}"[:5] +
           f"{en:10.4f}" + f"{n:4.2f}" + f"{d:8.6f}"[:8])
    return rec + " " * (160 - len(rec))


def test_iso_code_hex_rule():
    """'0' -> 10, 'A' -> 11 ... (parse_HITRAN_file.c:176-194)."""
    assert _iso_code("1") == 1
    assert _iso_code("9") == 9
    assert _iso_code("0") == 10
    assert _iso_code("A") == 11
    assert _iso_code("Z") == 36


def test_parse_par_file(tmp_path):
    path = tmp_path / "test.par"
    lines = [
        _record(1, "1", 1000.123456, 1.5e-20, 0.06, 0.3, 100.0, 0.5,
                0.001),
        _record(2, "1", 1500.0, 2.0e-20, 0.07, 0.1, 50.0, 0.6, -0.002),
        _record(1, "A", 2000.5, 3.0e-21, 0.05, 0.2, 200.0, 0.7, 0.0),
        _record(1, "2", 3000.0, 4.0e-22, 0.04, 0.4, 300.0, 0.4, 0.003),
    ]
    path.write_text("\n".join(lines) + "\n")

    tips = tips_mod.PowerLawTips()
    cat = parse_par_file(str(path), 1, tips=tips)
    # Molecule filter: only the three mol=1 records.
    assert cat.num_lines == 3
    np.testing.assert_allclose(cat.vnn, [1000.123456, 2000.5, 3000.0])
    np.testing.assert_array_equal(cat.iso, [1, 11, 2])
    np.testing.assert_allclose(cat.yair, [0.06, 0.05, 0.04], rtol=1e-3)
    np.testing.assert_allclose(cat.en, [100.0, 200.0, 300.0])

    # Strength renormalization (parse_HITRAN_file.c:372-384): divide by
    # the 296 K Boltzmann/stimulated-emission factor times 1/Q(296).
    c2, tref = constants.LINE_STRENGTH_C2, constants.TREF
    want = 1.5e-20 * tips.q(1, tref, 1) / (
        np.exp(c2 * 100.0 / tref) *
        (1.0 - np.exp(c2 * 1000.123456 / tref)))
    np.testing.assert_allclose(cat.snn[0] / STRENGTH_SCALE, want,
                               rtol=1e-12)

    # Window filter keeps inclusive bounds (parse filter :345-352).
    cat_w = parse_par_file(str(path), 1, w0=1000.123456, wn=2500.0,
                           tips=tips)
    assert cat_w.num_lines == 2
    # LineCatalog.window does the same post-hoc.
    assert cat.window(1500.0, 3500.0).num_lines == 2

    # Truncated records are rejected.
    bad = tmp_path / "bad.par"
    bad.write_text("short line\n")
    with pytest.raises(ValueError):
        parse_par_file(str(bad), 1, tips=tips)


def test_molecule_registry():
    """53 HITRAN species with masses/isotopologue counts
    (molecules.c:30-337, molecules.h:31-104)."""
    assert int(MoleculeId.H2O) == 1
    assert int(MoleculeId.CS2) == 53
    assert len(MoleculeId) == 53
    h2o = mol_registry.get(MoleculeId.H2O)
    assert h2o.mass_g == pytest.approx(18.010565 / 6.023e23, rel=1e-3)
    assert h2o.num_isotopologues >= 6
    co2 = mol_registry.get(2)
    assert co2.linear
    assert not h2o.linear
    with pytest.raises((KeyError, ValueError)):
        mol_registry.get(99)


def test_cfc_cia_enums():
    """21 cross-section species (cfcs.h:32-67), 3 CIA pairs
    (collision_induced_absorption.h:36-53)."""
    assert len(CfcId) == 21
    assert int(CfcId.CFC11) == 0 and int(CfcId.SF6) == 20
    assert len(CiaId) >= 2  # N2, O2 partners


def test_power_law_tips():
    tips = tips_mod.PowerLawTips()
    # Uncalibrated molecules keep the rigid-rotor betas: linear (CO) = 1,
    # nonlinear (SO2) = 1.5; q296 defaults to 1 where unknown.
    assert tips.q(5, 2 * constants.TREF) == pytest.approx(2.0)
    assert tips.q(9, 2 * constants.TREF) == pytest.approx(2.0 ** 1.5)
    assert tips.q_ratio(1, constants.TREF) == pytest.approx(1.0)


def test_tips_reference_pins():
    """Q values the reference unit test pins at T=275.234324, iso 1
    (gas-optics/test/test_tips2017.c:34-65) — reproduced exactly by the
    calibrated power law at the pinned temperature."""
    tips = tips_mod.PowerLawTips()
    pins = {1: 156.6091754, 2: 261.25798746, 3: 3087.3115616,
            4: 4524.7762498, 6: 528.26422608}
    for mol, expect in pins.items():
        assert tips.q(mol, 275.234324, 1) == pytest.approx(expect, rel=1e-9)
    # Calibrated betas stay physically sensible (between rotational-only
    # and strongly vibrational regimes).
    for mol in pins:
        assert 1.0 < tips.beta(mol) < 2.0


def test_packaged_tips_tables_pin_reference_values():
    """The shipped data/tips2017.npz (tools/convert_tips.py generate) is the
    default provider and reproduces the reference-pinned Q values
    (gas-optics/test/test_tips2017.c:34-65) *through the tabulated path* —
    the same rel 1e-9 contract as the reference's check_floating_point."""
    tips = tips_mod.default_tips()
    assert isinstance(tips, tips_mod.TabulatedTips)
    pins = {1: 156.6091754, 2: 261.25798746, 3: 3087.3115616000005,
            4: 4524.7762498, 6: 528.2642260800001}
    for mol, expect in pins.items():
        assert float(tips.q(mol, 275.234324, 1)) == \
            pytest.approx(expect, rel=1e-9), mol
    # Absolute normalization tracks HITRAN molparam at 296 K.
    for mol, q296 in {1: 174.5813, 2: 286.09, 3: 3483.71, 4: 4984.90,
                      5: 107.42, 6: 590.48, 7: 215.73}.items():
        assert tips.q296(mol, 1) == pytest.approx(q296, rel=1e-4), mol
    # Vibrational curvature: tables deviate from any pure power law at
    # high T (the physics PowerLawTips cannot represent).
    beta_eff = (np.log(tips.q(2, 500.0, 1) / tips.q(2, 400.0, 1))
                / np.log(500.0 / 400.0))
    beta_low = (np.log(tips.q(2, 200.0, 1) / tips.q(2, 160.0, 1))
                / np.log(200.0 / 160.0))
    assert beta_eff - beta_low > 0.2     # CO2 bend modes activate


def test_packaged_tips_tables_cover_every_registry_isotopologue():
    """The reference contract is a full per-isotopologue table lookup for
    all 53 HITRAN species (tips2017.h:29-37, molecules.h:31-104): every
    (molecule, iso) pair in the registry must resolve through the
    tabulated path — no molecule in any pipeline silently hits the
    power-law fallback or the principal-iso substitution."""
    from grtcode_jax.gas_optics import molecules as mol_registry

    tips = tips_mod.default_tips()
    assert isinstance(tips, tips_mod.TabulatedTips)
    for mol in mol_registry.REGISTRY.values():
        assert tips.has_molecule(int(mol.id)), mol.name
        for iso in range(1, max(mol.num_isotopologues, 1) + 1):
            assert tips.has(int(mol.id), iso), (mol.name, iso)
    # Spot-check physical plausibility outside the big-8 set: partition
    # sums grow with T and Q(296) is the molparam-scale value.
    for mol_id, q296 in {9: 6340.30, 11: 1725.22, 12: 214000.0,
                         19: 1221.01, 30: 1620000.0}.items():
        assert tips.q296(mol_id, 1) == pytest.approx(q296, rel=1e-3)
        assert float(tips.q(mol_id, 320.0, 1)) > float(
            tips.q(mol_id, 250.0, 1))
    # An atom (O, id 34): no rotational/vibrational T-dependence.
    assert float(tips.q(34, 150.0, 1)) == pytest.approx(
        float(tips.q(34, 400.0, 1)), rel=1e-12)


def test_tabulated_tips(tmp_path):
    tgrid = np.linspace(100.0, 500.0, 81)
    q11 = 100.0 + tgrid          # linear-in-T fake tables
    q12 = 200.0 + 2.0 * tgrid
    path = tmp_path / "tips.npz"
    np.savez(path, T=tgrid, Q_1_1=q11, Q_1_2=q12)
    tips = tips_mod.TabulatedTips(str(path))
    assert tips.has(1, 1) and tips.has(1, 2) and not tips.has(2, 1)
    assert tips.q(1, 250.0, 1) == pytest.approx(350.0)
    assert tips.q(1, 255.0, 2) == pytest.approx(710.0)
    assert tips.q_ratio(1, 296.0, 1) == pytest.approx(1.0)

    # Device-side layers: 1/Q gathered per isotopologue; missing isos
    # fall back to the principal one (kernels.c:52-66 analogue).
    qi = np.asarray(tips_mod.q_inverse_layers(
        tips, 1, np.array([250.0, 300.0], np.float32), 3))
    assert qi.shape == (2, 3)
    np.testing.assert_allclose(qi[0, 0], 1.0 / 350.0, rtol=1e-6)
    np.testing.assert_allclose(qi[0, 1], 1.0 / 700.0, rtol=1e-6)
    np.testing.assert_allclose(qi[:, 2], qi[:, 0], rtol=1e-6)

    with pytest.raises(ValueError):
        empty = tmp_path / "empty.npz"
        np.savez(empty, T=tgrid)
        tips_mod.TabulatedTips(str(empty))


def test_catalog_roundtrip_through_gas_optics(tmp_path):
    """A parsed .par catalog flows through the full optical-depth path."""
    import jax.numpy as jnp
    from grtcode_jax.gas_optics.gas_optics import GasOptics
    from grtcode_jax.spectral import SpectralGrid

    path = tmp_path / "h2o.par"
    rng = np.random.default_rng(3)
    recs = [_record(1, "1", float(v), float(s), 0.06, 0.3, float(e), 0.5,
                    0.001)
            for v, s, e in zip(np.linspace(105, 195, 20),
                               rng.uniform(1e-22, 1e-20, 20),
                               rng.uniform(0, 500, 20))]
    path.write_text("\n".join(recs) + "\n")

    grid = SpectralGrid(100.0, 200.0, 0.1)
    gas = GasOptics(grid, hitran_path=str(path), line_chunk=16)
    gas.add_molecule(MoleculeId.H2O)
    nlev = 5
    p = jnp.asarray(np.linspace(1.0, 1000.0, nlev), jnp.float32)
    t = jnp.asarray(np.linspace(220.0, 290.0, nlev), jnp.float32)
    tau = np.asarray(gas.optical_depth(p, t, {1: jnp.full((nlev,), 1e-3)}))
    assert tau.shape == (nlev - 1, grid.n)
    assert np.isfinite(tau).all() and tau.max() > 0


def test_native_parser_matches_python(tmp_path):
    """The C++ record scanner (native/hitran_parser.cpp) produces the
    identical catalog to the pure-Python parser."""
    from grtcode_jax import native as native_mod
    if not native_mod.available(build_if_missing=True):
        pytest.skip("native hitran library not buildable here")

    path = tmp_path / "mix.par"
    rng = np.random.default_rng(11)
    recs = []
    for i in range(50):
        mol = int(rng.integers(1, 4))
        iso_ch = "1A2"[i % 3]
        recs.append(_record(mol, iso_ch, float(rng.uniform(100, 5000)),
                            float(rng.uniform(1e-25, 1e-20)),
                            float(rng.uniform(0.01, 0.09)),
                            float(rng.uniform(0.1, 0.4)),
                            float(rng.uniform(0, 3000)),
                            float(rng.uniform(0.3, 0.9)),
                            float(rng.uniform(-0.009, 0.009))))
    path.write_text("\n".join(recs) + "\n")

    tips = tips_mod.PowerLawTips()
    got = native_mod.parse_par_native(str(path), 1, 200.0, 4500.0)
    assert got is not None
    cat_n = parse_par_file(str(path), 1, w0=200.0, wn=4500.0, tips=tips)

    # Force the pure-Python path for comparison.
    import grtcode_jax.native as nm
    orig = nm.parse_par_native
    nm.parse_par_native = lambda *a, **k: None
    try:
        cat_p = parse_par_file(str(path), 1, w0=200.0, wn=4500.0,
                               tips=tips)
    finally:
        nm.parse_par_native = orig

    assert cat_n.num_lines == cat_p.num_lines > 0
    for f in ("iso", "vnn", "snn", "yair", "yself", "en", "n", "d"):
        np.testing.assert_array_equal(getattr(cat_n, f), getattr(cat_p, f),
                                      err_msg=f)


@pytest.mark.parametrize("name,value,want", [
    ("GRTCODE_OLDNAME_TIPS", "tables.npz", ValueError),
    (tips_mod.DEFAULT_TABLE_ENV, "no/such/tables.npz", FileNotFoundError),
    (tips_mod.DEFAULT_TABLE_ENV, None, tips_mod.TabulatedTips)])
def test_default_tips_honours_or_refuses_a_set_variable(monkeypatch, name,
                                                        value, want):
    """A set table variable is used or refused, never skipped: a missing
    file or a TIPS variable under another prefix raises instead of quietly
    falling back to the packaged tables."""
    if value is None:
        value = tips_mod._PACKAGED_TABLE
    monkeypatch.setenv(name, value)
    if issubclass(want, Exception):
        with pytest.raises(want, match=name):
            tips_mod.default_tips()
    else:
        assert isinstance(tips_mod.default_tips(), want)
