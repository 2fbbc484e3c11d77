#!/usr/bin/env python3
"""Smoke test of the main path on one GPU.

Phases, each through the entry points a user calls, at RFMIP-IRF width
(bench.build: 7 molecules, ~434k synthetic lines from a seed, continua,
3 CFCs, 3 CIA pairs, LW 1-3250 @ 0.1 cm-1 + SW 1-50000 @ 1.0 cm-1, 54
layers, B=32 columns, clear sky, integrated fluxes):

  1. device: JAX's devices, the card's name and power limit;
  2. kernel parity: the compiled fused Voigt kernel against the jnp ground
     truth (accumulate_tiled + accumulate_near_pointwise) on the largest LW
     molecule (120k lines) x 1,728 rows, over the full grid and three
     spectral blocks (bound: PARITY_RTOL), then both against a float64
     sum at the points where they differ most (bound: F64_RTOL);
  3. goldens: the three-tier driver golden and the LW/SW solver goldens at
     their tests' tolerances, and three physics invariants;
  4. main path: RadiationDriver.run unstreamed and with spectral_chunks=4
     (equal within 1e-5), timed, then the CIRC app's main() in-process on
     embedded case 1 with a synthetic .par.

``--multi`` (four cards) runs only the mesh phase: the same width sharded
over make_mesh 2x2 and 4x1, integrated and spectral output, each equal to
the one-card run within 1e-5.

The last line of standard output is {"ok": true, "device": {...}}; it is
printed only when every phase passed.  The script exits non-zero when a
phase fails or when JAX's platform is not a GPU.

Run:  python chip_smoke.py [--multi]
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# Kernel vs jnp ground truth on an H100.  Both float32 paths carry up to
# ~2e-5 rounding error in the Humlicek near core (regions 2-4 near
# top-layer line centres): at the worst points the kernel was up to
# 1.5e-5 and the jnp path up to 2.0e-5 from a float64 sum, with
# different signs, so the two differ by up to 2.3e-5.  IEEE division
# (div.rn.f32 instead of Triton's div.full.f32) did not narrow this, so
# the 2e-6 bound the interpreted kernel meets on the CPU is out of reach
# on the card.  PARITY_RTOL bounds the gap between the paths;
# F64_RTOL bounds the kernel's own error at the worst points, no looser
# than the jnp path's.
PARITY_RTOL = 3e-5
F64_RTOL = 2e-5
F64_POINTS = 8
# Denominator floor of the relative difference (tau below it compares
# absolutely): 1e-12 / 2e-6, the floor of the original 2e-6 check.
PARITY_FLOOR = 5e-7
STREAM_RTOL = 1e-5
MESH_RTOL = 1e-5
# Kernel-parity width: the full LW grid and B=32 x 54 layers = 1,728 rows.
PARITY_GRID = (1.0, 3250.0, 0.1)
PARITY_BATCH = 32


def card() -> str:
    """'name, power limit' of the card as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    return out.splitlines()[0]


def rel_diff(got, ref, floor):
    """max |got - ref| / max(|ref|, floor)."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref) / np.maximum(np.abs(ref), floor)))


def flux_rel_diff(a, b):
    """Worst per-level relative difference between two FluxResults, each
    variable's denominator floored at 1% of its largest magnitude (the
    reference's rel+abs contract, check_results.c:39-53; TOA downwelling
    is exactly zero)."""
    worst = 0.0
    for tier, fluxes in b.tiers.items():
        for k, ref in fluxes.items():
            ref = np.asarray(ref)
            got = np.asarray(a.tiers[tier][k])
            if got.shape != ref.shape:
                raise AssertionError(f"{tier}/{k}: shape {got.shape} vs "
                                     f"{ref.shape}")
            floor = max(0.01 * float(np.abs(ref).max()), 1e-30)
            worst = max(worst, rel_diff(got, ref, floor))
    return worst


def rfmip_width():
    """(driver, atmosphere, B, nlayers, nw_lw, nw_sw) at bench width."""
    import bench
    from grtcode_jax.framework import Atmosphere, RadiationDriver

    lw_gas, sw_gas, solar, batch, B, nlayers = bench.build()
    atm = Atmosphere(
        level_pressure=batch["p_lev"], level_temperature=batch["t_lev"],
        surface_temperature=batch["t_lev"][:, -1] + 1.5,
        ppmv=batch["vmr"], cfc_ppmv=batch["cfc_vmr"],
        cia_ppmv=batch["cia_vmr"], cos_zenith=batch["mu"],
        total_solar_irradiance=batch["tsi"])
    driver = RadiationDriver(lw_gas=lw_gas, sw_gas=sw_gas, solar=solar)
    return driver, atm, B, nlayers, lw_gas.grid.n, sw_gas.grid.n


def timed(fn, reps):
    """(result, first-call seconds, median of ``reps`` later calls or
    None).  ``fn`` returns device arrays (waited for here) or host data
    (the driver's FluxResults, already on the host)."""
    import jax

    def call():
        t0 = time.perf_counter()
        out = fn()
        if not hasattr(out, "tiers"):
            out = jax.block_until_ready(out)
        return out, time.perf_counter() - t0

    out, first = call()
    times = [call()[1] for _ in range(reps)]
    return out, first, statistics.median(times) if times else None


def phase_device(info):
    import jax

    devs = jax.devices()
    print(f"jax devices: {devs}")
    print(f"card: {info['card']}")
    if devs[0].platform != "gpu":
        raise RuntimeError(f"platform is {devs[0].platform!r}, not gpu")


def line_prep(gas, mol, batch):
    """(prep arrays, ns) of one molecule for a bench batch, materialized
    once so the kernel and the jnp path accumulate identical inputs."""
    import jax
    import jax.numpy as jnp

    from grtcode_jax import constants
    from grtcode_jax.gas_optics import lines as lines_mod
    from grtcode_jax.utils import curtis_godson as cg

    @jax.jit
    def prep_fn(p_lev, t_lev, x):
        p2 = p_lev * constants.MB_TO_ATM
        n2d = cg.number_densities(p2)
        pavg, tavg = cg.layer_pressures_temperatures(p2, t_lev)
        psavg, ns = cg.partial_pressures_and_densities(p2, x, n2d)
        rows = pavg.size
        prep = lines_mod.prepare(gas.molecules[mol], gas.grid,
                                 pavg.reshape(rows), tavg.reshape(rows),
                                 psavg.reshape(rows), tips=gas.tips)
        return (prep.center_idx, prep.center_frac, prep.strength,
                prep.lorentz, prep.doppler), ns.reshape(rows)

    arrays, ns = prep_fn(jnp.asarray(batch["p_lev"], jnp.float32),
                         jnp.asarray(batch["t_lev"], jnp.float32),
                         jnp.asarray(batch["vmr"][mol] * 1e-6, jnp.float32))
    return arrays, ns


def float64_tau(gas, mol, prep, ns, points):
    """Optical depth of molecule ``mol`` at (row, grid point) pairs, summed
    in float64 from the same prepared lines with the ground truth's line
    shapes: the far-wing form beyond the near core, the full Voigt within
    it."""
    import jax
    import jax.numpy as jnp

    from grtcode_jax.gas_optics.hitran import STRENGTH_SCALE
    from grtcode_jax.gas_optics.voigt import voigt_far_wing, voigt_line_shape

    cidx, cfrac, s, lor, dop = (np.asarray(a) for a in prep)
    rows = np.array([r for r, _ in points])
    delta = (np.array([g for _, g in points])[:, None]
             - cidx[rows].astype(np.int64))                # (points, L)
    ok = ((cidx[rows] >= 0) & (cidx[rows] < gas.grid.n)
          & (np.abs(delta) <= gas._fsteps))
    dw = float(np.float32(gas.grid.dw))
    with jax.enable_x64(True):
        args = (jnp.asarray((delta - cfrac[rows].astype(np.float64)) * dw),
                jnp.asarray(lor[rows], jnp.float64),
                jnp.asarray(dop[rows], jnp.float64))
        k = np.where(np.abs(delta) <= gas.near_steps[mol],
                     np.asarray(voigt_line_shape(*args)),
                     np.asarray(voigt_far_wing(*args)))
    nss = (np.asarray(ns)[rows].astype(np.float32)
           / np.float32(STRENGTH_SCALE)).astype(np.float64)
    return np.sum(np.where(ok, s[rows] * nss[:, None] * k, 0.0), axis=1)


def accumulators(gas, mol):
    """{"kernel": f, "jnp": f}, each f(prep arrays, ns, start, size) -> (rows,
    size) line_sample optical depth of molecule ``mol``: the fused kernel
    and the jnp ground truth (accumulate_tiled + accumulate_near_pointwise)
    over the same spectral block."""
    import jax.numpy as jnp

    from grtcode_jax.gas_optics import pallas_kernels as pk
    from grtcode_jax.gas_optics.lines import PreparedLines
    from grtcode_jax.gas_optics.optical_depth import (
        accumulate_near_pointwise, accumulate_tiled)

    bound = gas.molecules[mol]
    near = gas.near_steps[mol]
    dw = float(gas.grid.dw)
    n = gas.grid.n

    def kernel(arrays, ns, start, size):
        return pk.accumulate_voigt_pallas(
            PreparedLines(*arrays), bound.c0, ns, gas.line_ranges[mol],
            num_wpoints=size, dw=dw, fsteps=gas._fsteps, near=near,
            hw=gas.near_hw[mol], tile=gas.tile, num_global=n, start=start)

    def plain(arrays, ns, start, size):
        tiles = gas.tiles[mol]
        far = accumulate_tiled(
            *arrays, ns, jnp.asarray(tiles.tile_lines),
            num_wpoints=size, dw=dw, fsteps=tiles.fsteps, tile=tiles.tile,
            lchunk=gas.tile_lchunk, start=start, num_global=n,
            exclude_within=near, far_kernel=True)
        ranges = gas.point_ranges[mol]
        return accumulate_near_pointwise(
            *arrays, ns, jnp.asarray(ranges.lo), jnp.asarray(ranges.hi),
            num_wpoints=size, dw=dw, near=near, kpad=ranges.kpad, tau0=far,
            start=start, num_global=n)

    return {"kernel": kernel, "jnp": plain}


def phase_kernel_parity(info):
    """Compiled kernel vs jnp ground truth on the largest LW molecule."""
    import jax

    import bench
    from grtcode_jax.gas_optics.gas_optics import GasOptics
    from grtcode_jax.spectral import SpectralGrid

    grid = SpectralGrid(*PARITY_GRID)
    mol = max(bench.LW_LINES, key=bench.LW_LINES.get)
    seed = list(bench.LW_LINES).index(mol)
    gas = GasOptics(grid, line_chunk=1024)
    gas.add_catalog(bench.synthetic_lines(mol, grid, bench.LW_LINES[mol],
                                          seed))
    *_, batch, B, nlayers = bench.build(smoke=True,
                                        batch_size=PARITY_BATCH)
    prep, ns = line_prep(gas, mol, batch)
    paths = accumulators(gas, mol)
    block = 64 * gas.tile
    nblocks = -(-grid.n // block)
    cases = [(0, grid.n), (0, block), (nblocks // 2 * block, block),
             ((nblocks - 1) * block, block)]
    print(f"  molecule {mol}, {gas.molecules[mol].num_lines} lines x "
          f"{B * nlayers} rows, grid {grid.n} points")
    worst = 0.0
    for start, size in cases:
        out = {}
        for name, fn in paths.items():
            f = jax.jit(lambda p_, n_, fn=fn: fn(p_, n_, start, size))
            out[name], first, steady = timed(lambda: f(prep, ns),
                                             reps=3 if size == grid.n else 1)
            print(f"  [{start}, {start + size}) {name:6s}: compile+first "
                  f"{first:.2f} s, steady {steady * 1e3:.2f} ms "
                  f"({info['card']})")
        got, ref = np.asarray(out["kernel"]), np.asarray(out["jnp"])
        if not np.isfinite(got).all():
            raise AssertionError("kernel output not finite")
        rel = rel_diff(got, ref, PARITY_FLOOR)
        worst = max(worst, rel)
        print(f"  [{start}, {start + size}) max rel diff {rel:.3e}")
        if size == grid.n:
            full = (got, ref)
    info["parity_max_rel"] = worst
    if worst > PARITY_RTOL:
        raise AssertionError(f"kernel parity {worst:.3e} > {PARITY_RTOL}")

    # Both paths against float64 where they differ most.
    got, ref = full
    gap = np.abs(got.astype(np.float64) - ref) / np.maximum(np.abs(ref),
                                                            PARITY_FLOOR)
    points = [np.unravel_index(i, gap.shape)
              for i in np.argsort(gap, axis=None)[-F64_POINTS:]]
    exact = float64_tau(gas, mol, prep, ns, points)
    den = np.maximum(np.abs(exact), PARITY_FLOOR)
    errs = {name: np.array([a[p] for p in points]) / den - exact / den
            for name, a in (("kernel", got), ("jnp", ref))}
    for name, e in errs.items():
        print(f"  {name:6s} vs float64 at the {F64_POINTS} worst points: "
              f"max |rel| {np.abs(e).max():.3e}, signs +{int((e > 0).sum())}"
              f"/-{int((e < 0).sum())}")
    info["kernel_f64_max_rel"] = float(np.abs(errs["kernel"]).max())
    if info["kernel_f64_max_rel"] > F64_RTOL:
        raise AssertionError(f"kernel vs float64 "
                             f"{info['kernel_f64_max_rel']:.3e} > {F64_RTOL}")


def test_module(name):
    """A module of this repository's tests/, loaded by path (an installed
    package named ``tests`` may shadow the directory)."""
    spec = importlib.util.spec_from_file_location(
        f"chip_smoke_{name}", os.path.join(ROOT, "tests", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def phase_goldens(info):
    import jax.numpy as jnp

    tdg = test_module("test_driver_golden")
    tlw = test_module("test_longwave")
    tsw = test_module("test_shortwave")
    from grtcode_jax.solvers.longwave import longwave_fluxes
    from grtcode_jax.solvers.shortwave import shortwave_fluxes
    from grtcode_jax.spectral import SpectralGrid
    from grtcode_jax.utils.interp import trapezoid_uniform

    with tempfile.TemporaryDirectory() as d:
        res = tdg.run_golden_driver(d)
    for label, tier, var in tdg._TIER_CASES:
        tdg.test_driver_matches_reference_stack(res, label, tier, var)
    print(f"  driver golden: {len(tdg._TIER_CASES)} tier/variable cases "
          "pass")
    data = os.path.join(ROOT, "tests", "data")
    lw = np.loadtxt(os.path.join(data, "lw_golden.txt"))
    for ci in range(len(tlw.CASES)):
        tlw.test_lw_matches_reference(lw, ci)
    sw = np.loadtxt(os.path.join(data, "sw_golden.txt"))
    for ci in range(len(tsw.CASES)):
        tsw.test_sw_matches_reference(sw, ci)
    print(f"  solver goldens: {len(tlw.CASES)} LW + {len(tsw.CASES)} SW "
          "cases pass")

    # Physics invariants 1-3 (level 0 = TOA, last = surface).
    sigma = 5.670374419e-8
    grid = SpectralGrid(1.0, 3250.0, 0.5)
    nlev = 12
    w = jnp.asarray(grid.wavenumbers())
    t = jnp.linspace(220.0, 288.0, nlev)
    tl = 0.5 * (t[:-1] + t[1:])
    ts = 290.0
    emis = jnp.ones((grid.n,))
    zeros = jnp.zeros((nlev - 1, grid.n))
    up, dn = longwave_fluxes(zeros, zeros, jnp.asarray(ts), tl, t, emis, w)
    olr = float(trapezoid_uniform(up[0], grid.dw))
    sfc_dn = float(trapezoid_uniform(dn[-1], grid.dw))
    assert abs(olr - sigma * ts ** 4) / (sigma * ts ** 4) < 0.02, olr
    assert sfc_dn < 1e-3, sfc_dn
    opaque = jnp.full((nlev - 1, grid.n), 50.0)
    _, dn2 = longwave_fluxes(opaque, zeros, jnp.asarray(ts), tl, t, emis, w)
    bb = sigma * float(t[-1]) ** 4
    sfc_dn2 = float(trapezoid_uniform(dn2[-1], grid.dw))
    assert abs(sfc_dn2 - bb) / bb < 0.03, (sfc_dn2, bb)
    swg = SpectralGrid(2000.0, 4000.0, 1.0)
    z = jnp.zeros((nlev - 1, swg.n))
    sflux = jnp.full((swg.n,), 1.0 / (swg.dw * (swg.n - 1)))
    alb = jnp.full((swg.n,), 0.2)
    swup, swdn = shortwave_fluxes(z, z, z, jnp.asarray(0.6),
                                  jnp.asarray(0.5), alb, alb,
                                  jnp.asarray(1361.0), sflux)
    toa_dn = float(trapezoid_uniform(swdn[0], swg.dw))
    toa_up = float(trapezoid_uniform(swup[0], swg.dw))
    assert abs(toa_dn - 1361.0 * 0.6) / (1361.0 * 0.6) < 0.02, toa_dn
    assert abs(toa_up - 1361.0 * 0.6 * 0.2) / (1361.0 * 0.6 * 0.2) < 0.05
    print("  physics invariants 1-3 pass")


def phase_main_path(info):
    import jax

    from grtcode_jax.apps import circ
    from tools.goldens import driver_inputs

    driver, atm, B, nlayers, nw_lw, nw_sw = rfmip_width()
    res, first, steady = timed(lambda: driver.run(atm), reps=3)
    for tier in res.tiers.values():
        for k, v in tier.items():
            if not np.isfinite(v).all():
                raise AssertionError(f"non-finite {k}")
    points = B * nlayers * (nw_lw + nw_sw)
    stats = jax.devices()[0].memory_stats()     # None off a GPU
    peak = None if stats is None else stats["peak_bytes_in_use"]
    info["main_path"] = {
        "compile_first_s": first, "steady_step_ms": steady * 1e3,
        "points_per_s": points / steady, "peak_bytes_in_use": peak}
    print(f"  RFMIP width B={B} x {nlayers} layers x ({nw_lw} + {nw_sw}) "
          f"points ({info['card']}):")
    print(f"  compile+first step {first:.2f} s, steady step "
          f"{steady * 1e3:.2f} ms, {points / steady:.4e} points/s, "
          f"peak {peak} bytes in use")

    res4, first4, steady4 = timed(
        lambda: driver.run(atm, spectral_chunks=4), reps=1)
    rel = flux_rel_diff(res4, res)
    print(f"  spectral_chunks=4: compile+first {first4:.2f} s, steady "
          f"{steady4 * 1e3:.2f} ms, max rel diff vs unstreamed {rel:.3e}")
    info["stream_max_rel"] = rel
    if rel > STREAM_RTOL:
        raise AssertionError(f"streamed fluxes differ by {rel:.3e}")

    with tempfile.TemporaryDirectory() as d:
        driver_inputs.write_inputs(d)
        t0 = time.perf_counter()
        cres = circ.main([os.path.join(d, "synthetic.par"), "none",
                          "-o", ""])
        print(f"  circ main() case 1: {time.perf_counter() - t0:.2f} s")
    for k, v in cres.tiers["csaf"].items():
        if not np.isfinite(v).all():
            raise AssertionError(f"circ: non-finite {k}")
    rsdt = float(cres.variable("RSDTCSAF")[0])
    if abs(rsdt - 912.80) > 1.0:
        raise AssertionError(f"circ: RSDTCSAF {rsdt} != TSI*mu 912.80")


def phase_multi(info):
    import concurrent.futures

    import jax

    from grtcode_jax.parallel import make_mesh

    if len(jax.devices()) != 4:
        raise RuntimeError(f"--multi needs 4 devices, found "
                           f"{len(jax.devices())}")
    driver, atm, B, nlayers, nw_lw, nw_sw = rfmip_width()
    runs = [(integrated, shape) for integrated in (True, False)
            for shape in (None, (2, 2), (4, 1))]

    def run(integrated, shape):
        mesh = None if shape is None else make_mesh(*shape)
        return driver.run(atm, integrated=integrated, mesh=mesh)

    # Compile every configuration at once (XLA compiles off the
    # interpreter lock), then time each one alone.
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(runs)) as pool:
        for f in [pool.submit(run, *r) for r in runs]:
            f.result()
    print(f"  compile + first run of {len(runs)} configurations: "
          f"{time.perf_counter() - t0:.2f} s")
    for integrated in (True, False):
        label = "integrated" if integrated else "spectral"
        ref, _, steady = timed(lambda: run(integrated, None), reps=1)
        print(f"  one card {label}: steady {steady * 1e3:.2f} ms "
              f"({info['card']})")
        for shape in ((2, 2), (4, 1)):
            out, _, steady = timed(lambda: run(integrated, shape), reps=1)
            rel = flux_rel_diff(out, ref)
            print(f"  mesh {shape[0]}x{shape[1]} {label}: steady "
                  f"{steady * 1e3:.2f} ms, max rel diff vs one card "
                  f"{rel:.3e} ({info['card']})")
            if rel > MESH_RTOL:
                raise AssertionError(f"mesh {shape} {label}: {rel:.3e}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="four cards: only the mesh phase")
    opts = ap.parse_args()

    import jax

    sys.path.insert(0, ROOT)
    from grtcode_jax.compile_cache import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: JAX found no GPU (platform {dev.platform!r})",
              file=sys.stderr)
        return 2
    info = {"card": card()}
    phases = [("device", phase_device)]
    if opts.multi:
        phases.append(("mesh", phase_multi))
    else:
        phases += [("kernel parity", phase_kernel_parity),
                   ("goldens", phase_goldens),
                   ("main path", phase_main_path)]
    failed = []
    for name, fn in phases:
        print(f"== phase {name}", flush=True)
        t0 = time.perf_counter()
        try:
            fn(info)
        except Exception:
            traceback.print_exc()
            failed.append(name)
            print(f"== phase {name}: FAILED", flush=True)
            continue
        print(f"== phase {name}: ok ({time.perf_counter() - t0:.1f} s)",
              flush=True)
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    print(f"card: {card()}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
