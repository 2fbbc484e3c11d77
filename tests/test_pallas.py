"""Fused Voigt kernel (Pallas, Triton route) == jnp ground truth.

Runs the kernel in interpreter mode on CPU against the jnp ground truth
(accumulate_tiled with far_kernel=True + accumulate_near_pointwise),
including spectral-block offsets and batched (rows = columns x layers)
inputs.  The compiled kernel is checked against the same ground truth on
the GPU by ``chip_smoke.py``.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from grtcode_jax.spectral import SpectralGrid
from grtcode_jax.gas_optics import lines as lines_mod
from grtcode_jax.gas_optics import pallas_kernels as pk
from grtcode_jax.gas_optics.gas_optics import GasOptics
from grtcode_jax.gas_optics.hitran import synthetic_catalog
from grtcode_jax.gas_optics.optical_depth import (accumulate_near_pointwise,
                                                  accumulate_tiled)
from grtcode_jax.utils import curtis_godson as cg
from grtcode_jax import constants

TILE = 32


def _catalog(rng, n, lo, hi, mol=1, dmax=0.02):
    return synthetic_catalog(
        mol, np.sort(rng.uniform(lo, hi, n)), rng.uniform(1e-22, 1e-19, n),
        yair=rng.uniform(0.02, 0.1, n), yself=rng.uniform(0.05, 0.4, n),
        en=rng.uniform(0.0, 2000.0, n), n=rng.uniform(0.4, 0.8, n),
        d=rng.uniform(-dmax, dmax, n))


@pytest.fixture(scope="module")
def setup():
    grid = SpectralGrid(100.0, 180.0, 0.1)
    rng = np.random.default_rng(5)
    bound = lines_mod.bind_to_grid(_catalog(rng, 120, 90.0, 190.0), grid)

    nlev = 7
    B = 3
    p = np.linspace(0.01, 1013.0, nlev)[None, :] * np.ones((B, 1))
    t = np.linspace(215.0, 288.0, nlev)[None, :] + \
        rng.uniform(-3, 3, (B, nlev))
    x = rng.uniform(1e-5, 1e-2, (B, nlev))

    p_atm = jnp.asarray(p, jnp.float32) * constants.MB_TO_ATM
    t = jnp.asarray(t, jnp.float32)
    n_air = cg.number_densities(p_atm)
    pavg, tavg = cg.layer_pressures_temperatures(p_atm, t)
    psavg, ns = cg.partial_pressures_and_densities(
        p_atm, jnp.asarray(x, jnp.float32), n_air)

    # Flatten (B, nlayers) -> rows; 18 rows is not a multiple of the row
    # block, so the padded rows are exercised everywhere.
    rows = B * (nlev - 1)
    prep = lines_mod.prepare(bound, grid, pavg.reshape(rows),
                             tavg.reshape(rows), psavg.reshape(rows))
    ns_rows = ns.reshape(rows)
    fsteps = 30
    near = 4
    return grid, bound, prep, ns_rows, fsteps, near


def _jnp_far(grid, bound, prep, ns, fsteps, near, num_wpoints, start):
    tiles = lines_mod.build_tiles(bound, grid.n, fsteps, tile=TILE,
                                  lane_multiple=8)
    return accumulate_tiled(
        prep.center_idx, prep.center_frac, prep.strength, prep.lorentz,
        prep.doppler, ns, jnp.asarray(tiles.tile_lines),
        num_wpoints=num_wpoints, dw=float(grid.dw), fsteps=fsteps,
        tile=TILE, lchunk=8, start=start, num_global=grid.n,
        exclude_within=near, far_kernel=True)


def _jnp_full(grid, bound, prep, ns, fsteps, near, num_wpoints, start=0):
    far = _jnp_far(grid, bound, prep, ns, fsteps, near, num_wpoints, start)
    ranges = lines_mod.build_point_ranges(bound, grid.n, near,
                                          shift_margin=2)
    return accumulate_near_pointwise(
        prep.center_idx, prep.center_frac, prep.strength, prep.lorentz,
        prep.doppler, ns, jnp.asarray(ranges.lo), jnp.asarray(ranges.hi),
        num_wpoints=num_wpoints, dw=float(grid.dw), near=near,
        kpad=ranges.kpad, tau0=far, start=start, num_global=grid.n)


def _pallas(grid, bound, prep, ns, fsteps, near, num_wpoints, start,
            include_near, region0_hw=None, tile=TILE, rblock=pk.RBLOCK):
    hw = near + 2
    ranges = pk.build_line_ranges(
        bound.c0, grid.n, fsteps, tile, shift_margin=2, near_hw=hw,
        region0_hw=region0_hw)
    return pk.accumulate_voigt_pallas(
        prep, bound.c0, ns, ranges,
        num_wpoints=num_wpoints, dw=float(grid.dw), fsteps=fsteps,
        near=near, hw=hw, tile=tile, num_global=grid.n,
        start=start, include_near=include_near, rblock=rblock,
        interpret=True)


def _pallas_far(grid, bound, prep, ns, fsteps, near, num_wpoints, start):
    return _pallas(grid, bound, prep, ns, fsteps, near, num_wpoints, start,
                   include_near=False)


def test_pallas_far_matches_jnp_full(setup):
    grid, bound, prep, ns, fsteps, near = setup
    nw = -(-grid.n // TILE) * TILE
    ref = np.asarray(_jnp_far(grid, bound, prep, ns, fsteps, near, nw, 0))
    got = np.asarray(_pallas_far(grid, bound, prep, ns, fsteps, near, nw, 0))
    np.testing.assert_allclose(got, ref, rtol=2e-6, atol=1e-12)
    assert np.isfinite(got).all()
    assert np.abs(ref).max() > 0


def test_pallas_far_blocks(setup):
    grid, bound, prep, ns, fsteps, near = setup
    n = -(-grid.n // TILE) * TILE
    block = 4 * TILE
    full = np.asarray(_pallas_far(grid, bound, prep, ns, fsteps, near, n, 0))
    for start in range(0, n, block):
        got = np.asarray(_pallas_far(grid, bound, prep, ns, fsteps, near,
                                     block, start))
        want = full[:, start:start + block]
        pad = block - want.shape[1]
        if pad:
            want = np.pad(want, ((0, 0), (0, pad)))
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-12)


def test_pallas_fused_near_matches_jnp(setup):
    """Fused near+far kernel == tiled far pass + pointwise near pass."""
    grid, bound, prep, ns, fsteps, near = setup
    nw = -(-grid.n // TILE) * TILE
    far = _jnp_far(grid, bound, prep, ns, fsteps, near, nw, 0)
    ref = _jnp_full(grid, bound, prep, ns, fsteps, near, nw)
    got = np.asarray(_pallas(grid, bound, prep, ns, fsteps, near, nw, 0,
                             include_near=True))
    np.testing.assert_allclose(got, np.asarray(ref), rtol=3e-6, atol=1e-12)
    assert np.isfinite(got).all()
    # The near core must actually contribute (it dominates peak tau).
    assert np.abs(got).max() > 1.5 * np.abs(np.asarray(far)).max()


def test_pallas_fused_blocks(setup):
    grid, bound, prep, ns, fsteps, near = setup
    n = -(-grid.n // TILE) * TILE
    block = 4 * TILE
    full = np.asarray(_pallas(grid, bound, prep, ns, fsteps, near, n, 0,
                              include_near=True))
    for start in range(0, n, block):
        got = np.asarray(_pallas(grid, bound, prep, ns, fsteps, near,
                                 block, start, include_near=True))
        want = full[:, start:start + block]
        pad = block - want.shape[1]
        if pad:
            want = np.pad(want, ((0, 0), (0, pad)))
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-12)


def test_zone_split_bit_identical(setup):
    """The three-zone far-wing specialization (interior pure-region-0 /
    edge / core-adjacent) computes the same arithmetic as the all-core
    kernel: it only skips selects whose outcome is host-provably
    constant.  Tolerance is a couple of f32 ulps, not the kernel-parity
    2e-6: the compiler may contract multiply-adds differently in the two
    expression graphs."""
    grid, bound, prep, ns, fsteps, near = setup
    nw = -(-grid.n // TILE) * TILE
    base = np.asarray(_pallas(grid, bound, prep, ns, fsteps, near, nw, 0,
                              include_near=True, region0_hw=None))
    for r0 in (8, 12, 20):
        zoned = np.asarray(_pallas(grid, bound, prep, ns, fsteps, near,
                                   nw, 0, include_near=True,
                                   region0_hw=r0))
        np.testing.assert_allclose(zoned, base, rtol=6e-7, atol=1e-12)

    # With fsteps=30 and TILE=32 the interior zone is legitimately empty
    # (the window never fully covers a tile beyond the core reach), so
    # also exercise the interior fast path: small tiles and a catalog
    # dense enough that many lines fall inside the interior span (as in
    # production: tile=64 vs fsteps=250 with ~30 lines per cm-1).
    rng = np.random.default_rng(17)
    dbound = lines_mod.bind_to_grid(
        _catalog(rng, 1200, grid.w0, grid.last), grid)
    nrows = prep.strength.shape[0]
    dprep = lines_mod.prepare(
        dbound, grid,
        np.full(nrows, 0.5, np.float32), np.full(nrows, 260.0, np.float32),
        np.full(nrows, 0.005, np.float32))
    nw8 = -(-grid.n // 8) * 8
    zone_lines = pk.build_line_ranges(dbound.c0, grid.n, fsteps, 8,
                                      shift_margin=2, near_hw=near + 2,
                                      region0_hw=8).table
    assert int(np.sum((zone_lines[pk.T_B] - zone_lines[pk.T_A])
                      + (zone_lines[pk.T_F] - zone_lines[pk.T_E]))) > 0
    zoned8, base8 = (np.asarray(_pallas(
        grid, dbound, dprep, ns, fsteps, near, nw8, 0, include_near=True,
        region0_hw=r0, tile=8)) for r0 in (8, None))
    np.testing.assert_allclose(zoned8, base8, rtol=6e-7, atol=1e-12)


def test_gas_optics_batched_matches_single():
    """Batched (B, nlev) optical_depth == per-column calls; and the full
    tiled+near pipeline with the fused kernel (interpret mode) == the jnp
    tiled path."""
    grid = SpectralGrid(100.0, 160.0, 0.1)
    rng = np.random.default_rng(9)
    cat = _catalog(rng, 60, 95.0, 165.0)

    nlev, B = 6, 3
    p = np.linspace(0.01, 1013.0, nlev)[None, :] * np.ones((B, 1))
    t = np.linspace(215.0, 288.0, nlev)[None, :] + \
        rng.uniform(-3, 3, (B, nlev))
    x = rng.uniform(1e-5, 1e-2, (B, nlev))
    p, t, x = (jnp.asarray(a, jnp.float32) for a in (p, t, x))

    gas = GasOptics(grid, line_chunk=32, pallas="off")
    gas.add_catalog(cat)
    tau_b = gas.optical_depth(p, t, {1: x})
    assert tau_b.shape == (B, nlev - 1, grid.n)
    for b in range(B):
        tau_1 = gas.optical_depth(p[b], t[b], {1: x[b]})
        np.testing.assert_allclose(np.asarray(tau_b[b]), np.asarray(tau_1),
                                   rtol=1e-6, atol=1e-12)

    gas_pl = GasOptics(grid, line_chunk=32, pallas="interpret")
    gas_pl.add_catalog(cat)
    tau_jnp = tau_b
    tau_pl = gas_pl.optical_depth(p, t, {1: x})
    np.testing.assert_allclose(np.asarray(tau_pl), np.asarray(tau_jnp),
                               rtol=2e-6, atol=1e-12)
    assert np.abs(np.asarray(tau_jnp)).max() > 0


@pytest.mark.parametrize("rblock", [8, 16])
def test_rows_not_multiple_of_row_block(setup, rblock):
    """18 rows over row blocks of 8 and 16: the padded rows of the last
    block are inert and sliced away."""
    grid, bound, prep, ns, fsteps, near = setup
    nw = -(-grid.n // TILE) * TILE
    ref = np.asarray(_jnp_full(grid, bound, prep, ns, fsteps, near, nw))
    got = np.asarray(_pallas(grid, bound, prep, ns, fsteps, near, nw, 0,
                             include_near=True, rblock=rblock))
    assert got.shape == ref.shape == (18, nw)
    np.testing.assert_allclose(got, ref, rtol=3e-6, atol=1e-12)


def test_tiles_past_grid_end_are_zero(setup):
    """A block that runs past the grid end: its tiles beyond the last
    real tile get empty line ranges and stay exactly zero, and the last
    real tile equals the matching slice of the full-grid result."""
    grid, bound, prep, ns, fsteps, near = setup
    ntiles = -(-grid.n // TILE)
    block = 4 * TILE
    start = (ntiles - 1) * TILE          # last real tile, then 3 past it
    got = np.asarray(_pallas(grid, bound, prep, ns, fsteps, near, block,
                             start, include_near=True))
    full = np.asarray(_pallas(grid, bound, prep, ns, fsteps, near,
                              ntiles * TILE, 0, include_near=True))
    assert got.shape == (prep.strength.shape[0], block)
    assert np.all(got[:, TILE:] == 0.0)
    np.testing.assert_allclose(got[:, :TILE], full[:, start:], rtol=2e-6,
                               atol=1e-12)
    assert np.abs(got[:, :TILE]).max() > 0


def test_catalog_shorter_than_one_chunk():
    """A 5-line catalog padded to a 64-line chunk through GasOptics: the
    sentinel lines never enter a tile range and the kernel matches jnp."""
    grid = SpectralGrid(500.0, 540.0, 0.1)
    rng = np.random.default_rng(3)
    cat = _catalog(rng, 5, 505.0, 535.0)
    p = jnp.linspace(1.0, 1000.0, 5)
    t = jnp.linspace(220.0, 290.0, 5)
    vmr = {1: jnp.full((5,), 3e-3)}
    taus = []
    for mode in ("off", "interpret"):
        gas = GasOptics(grid, line_chunk=64, pallas=mode)
        gas.add_catalog(cat)
        assert gas.molecules[1].num_lines == 64
        taus.append(np.asarray(gas.optical_depth(p, t, vmr)))
    np.testing.assert_allclose(taus[1], taus[0], rtol=2e-6, atol=1e-12)
    assert taus[0].max() > 0


def test_line_ranges_partition_reaching_lines(setup):
    """The seven zone segments of every tile are ordered and cover exactly
    the lines that reach it; the near-core range sits inside them."""
    grid, bound, _, _, fsteps, near = setup
    for r0 in (None, 8, 20):
        tab = pk.build_line_ranges(bound.c0, grid.n, fsteps, TILE,
                                   shift_margin=2, near_hw=near + 2,
                                   region0_hw=r0).table.astype(np.int64)
        seg = tab[[pk.T_LO, pk.T_A, pk.T_B, pk.T_C, pk.T_D, pk.T_E, pk.T_F,
                   pk.T_HI]]
        assert (np.diff(seg, axis=0) >= 0).all()
        assert (tab[pk.T_NL] >= tab[pk.T_LO]).all()
        assert (tab[pk.T_NH] <= tab[pk.T_HI]).all()
        assert (tab[pk.T_NL] <= tab[pk.T_NH]).all()


@pytest.mark.parametrize("mode,backend,want", [
    ("auto", "cpu", False), ("auto", "gpu", True), ("off", "gpu", False),
    ("interpret", "cpu", True), ("on", "gpu", True), ("on", "cpu", None)])
def test_backend_choice(monkeypatch, mode, backend, want):
    """'auto' takes the kernel on a GPU and jnp on the CPU; 'on' without
    a GPU raises instead of falling back."""
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    gas = GasOptics(SpectralGrid(100.0, 110.0, 0.1), pallas=mode)
    if want is None:
        with pytest.raises(ValueError, match="needs a GPU"):
            gas._use_kernel()
    else:
        assert gas._use_kernel() is want


@pytest.mark.parametrize("kw", [
    dict(pallas="fast"), dict(pallas="on", method="wavenumber_sweep"),
    dict(tile=48)])
def test_gas_optics_rejects_bad_kernel_options(kw):
    with pytest.raises(ValueError):
        GasOptics(SpectralGrid(100.0, 110.0, 0.1), **kw)


def test_bin_methods_never_take_the_kernel(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    gas = GasOptics(SpectralGrid(100.0, 110.0, 0.1),
                    method="wavenumber_sweep")
    assert gas._use_kernel() is False


def test_far_wing_sum_against_float64():
    """The kernel adds its far zones outside in (farthest lines first, the
    core-adjacent zone last), so the many small wing terms of a dense
    catalog are not rounded away in the float32 accumulator after the
    large core terms.  Against a float64 sum of the same line shapes its
    far-wing sum here is off by at most 1.1e-6 (p99 6.3e-7, mean -3.7e-8);
    adding the zones in sorted line order gave 3.0e-6 (p99 2.0e-6, mean
    -4.2e-7)."""
    from grtcode_jax.gas_optics.voigt import voigt_far_wing

    grid = SpectralGrid(1.0, 100.0, 0.1)
    rng = np.random.default_rng(2)
    n = 2000
    cat = synthetic_catalog(
        3, np.sort(rng.uniform(grid.w0, grid.last, n)),
        10.0 ** rng.uniform(-23.5, -19.5, n),
        yair=rng.uniform(0.02, 0.11, n), yself=rng.uniform(0.05, 0.4, n),
        en=rng.uniform(0.0, 2800.0, n), n=rng.uniform(0.35, 0.85, n),
        d=rng.uniform(-0.01, 0.01, n))
    gas = GasOptics(grid, line_chunk=1024)
    gas.add_catalog(cat)
    bound = gas.molecules[3]
    rows = 8
    prep = lines_mod.prepare(
        bound, grid, jnp.geomspace(1e-4, 1.0, rows, dtype=jnp.float32),
        jnp.linspace(200.0, 290.0, rows, dtype=jnp.float32),
        jnp.full((rows,), 1e-4, jnp.float32), tips=gas.tips)
    ns = jnp.full((rows,), 1e22, jnp.float32)
    near = gas.near_steps[3]
    got = np.asarray(pk.accumulate_voigt_pallas(
        prep, bound.c0, ns, gas.line_ranges[3], num_wpoints=grid.n,
        dw=float(grid.dw), fsteps=gas._fsteps, near=near,
        hw=gas.near_hw[3], tile=gas.tile, num_global=grid.n,
        include_near=False, interpret=True))

    cidx, cfrac, s, lor, dop = (np.asarray(a, np.float64) for a in (
        prep.center_idx, prep.center_frac, prep.strength, prep.lorentz,
        prep.doppler))
    nss = float(np.float32(1e22) / np.float32(1e20))
    delta = np.arange(grid.n)[None, :, None] - cidx[:, None, :]
    mask = (np.abs(delta) <= gas._fsteps) & (np.abs(delta) > near)
    dv = (delta - cfrac[:, None, :]) * float(np.float32(grid.dw))
    with jax.enable_x64(True):
        k = np.asarray(voigt_far_wing(jnp.asarray(dv),
                                      jnp.asarray(lor[:, None, :]),
                                      jnp.asarray(dop[:, None, :])))
    want = np.sum(np.where(mask, s[:, None, :] * nss * k, 0.0), axis=-1)
    rel = (got - want) / np.maximum(np.abs(want), 5e-7)
    assert np.abs(want).max() > 0
    assert np.abs(rel).max() < 1.5e-6, np.abs(rel).max()
    assert np.quantile(np.abs(rel), 0.99) < 1e-6
    assert abs(rel.mean()) < 1e-7, rel.mean()
