"""Headline benchmark: production-scale line-by-line throughput on one GPU.

Workload mirrors the reference's RFMIP-IRF production configuration
(GRTworkflow/run-rfmip-irf.sh:104-125): 7 molecules (H2O CO2 O3 N2O CH4 CO
O2) at HITRAN2016-scale line counts (~434k lines total, synthetic from a
seed), H2O + O3 continua, 3 CFC cross-section species, 3 CIA pairs, LW
band 1-3250 cm-1 @ 0.1 (32 491 points) + SW band 1-50 000 cm-1 @ 1.0
(50 000 points), 54 layers, full Voigt gas optics, both solvers,
trapezoid-integrated fluxes (the ``-integrated`` flag).  B=32 columns per
step, 10 timed iterations.

Metric: column x layer x wavenumber grid-points per second over BOTH bands
(north star, BASELINE.json), on the device the result names.

vs_baseline rests on an inferred denominator: the reference processes 1800
columns (100 sites x 18 experiments) through the same two-band
configuration on 10 GAEA C5 nodes (128-core AMD) within the 15-minute
SLURM budget (run-rfmip-irf.sh:18-28,104-125) => 1800 x (32491 + 50000) x
60 points / 9000 s ~= 9.9e5 grid-points/s per node.  That is the budget,
not a measured reference time.

Also reported: an analytic estimate of the fused Voigt kernel's
arithmetic (XLA's cost analysis cannot see inside the Pallas call) as
TFLOP/s and, where the device is in PEAK_F32_FLOPS, as a share of its
float32 peak outside the tensor cores (the Voigt path is elementwise
work, not matmuls).  Model, per molecule with L lines and rows = B x
layers: every line is evaluated at every grid point within +-(fsteps +
shift margin) of a tile it reaches, costing ~7 ops in the unmasked
interior zone, ~10 at the masked edge and ~18 next to the core; the near
core adds, per line, 2*hw+1 offsets of the cheap region-0/1 value (~25
ops) plus a one-hot add over the tile (tile ops), and the ~300-op full
Humlicek at about two offsets.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline",
"device", ...}.  Timing refuses any platform but a GPU unless --smoke.
"""
import json
import os
import sys
import time

import numpy as np

REF_POINTS_PER_S = 9.9e5   # per 128-core GAEA C5 node (see module docstring)

# float32 peak outside the tensor cores, keyed by jax device_kind (NVIDIA
# H100 and H200 data sheets: SXM parts at their full 700 W limit, 67
# TFLOP/s; the H100 PCIe card, 51 TFLOP/s).  A device missing from the
# table gets no share.
PEAK_F32_FLOPS = {
    "NVIDIA H100 80GB HBM3": 67e12,
    "NVIDIA H100 PCIe": 51e12,
    "NVIDIA H200": 67e12,
}

# HITRAN2016-scale line counts per band (order-of-magnitude per molecule in
# each window; the reference sizes its work arrays for up to 600k/molecule,
# gas_optics.c:46).
LW_LINES = {1: 60000, 2: 100000, 3: 120000, 4: 30000, 6: 50000,
            5: 4000, 7: 2000}
SW_LINES = {1: 40000, 2: 10000, 3: 10000, 7: 4000}


def synthetic_lines(mol_id, grid, L, seed):
    """A seeded synthetic HITRAN-like catalog of L lines over the grid."""
    from grtcode_jax.gas_optics.hitran import synthetic_catalog

    rng = np.random.default_rng(seed)
    vnn = np.sort(rng.uniform(grid.w0, grid.last, L))
    return synthetic_catalog(
        mol_id, vnn, 10.0 ** rng.uniform(-23.5, -19.5, L),
        yair=rng.uniform(0.02, 0.11, L), yself=rng.uniform(0.05, 0.4, L),
        en=rng.uniform(0.0, 2800.0, L), n=rng.uniform(0.35, 0.85, L),
        d=rng.uniform(-0.01, 0.01, L))


def build(smoke: bool = False, batch_size: int | None = None,
          lw_method: str = "line_sample", lw_res: float = 0.1):
    """The benchmark model + batch; ``smoke`` shrinks everything for CI.

    ``lw_method`` selects the LW gas-optics method (line_sample is the
    exact per-point reference method; wavenumber_sweep is the 3-point
    bin-wing method, ~3x fewer wing evaluations at 0.1 cm-1 and ~30x at
    0.01).  SW stays line_sample: at its 1 cm-1 resolution a bin holds
    only 2 fine points, so binned wings would do MORE work, not less —
    the same asymmetry the reference exploits by choosing -w per run.
    ``lw_res`` sets the LW grid resolution [cm-1] (north-star production
    is 0.01: 324 901 points over 1-3250)."""
    import jax.numpy as jnp
    from grtcode_jax.spectral import SpectralGrid
    from grtcode_jax.gas_optics.continua import (OzoneContinuum,
                                                 WaterVaporContinuum)
    from grtcode_jax.gas_optics.gas_optics import GasOptics
    from grtcode_jax.gas_optics.xsec import CrossSectionTable
    from grtcode_jax.solvers.solar_flux import SolarFlux
    from grtcode_jax import constants

    shrink = 64 if smoke else 1
    lw_grid = SpectralGrid(1.0, 3250.0, lw_res * (8 if smoke else 1))
    sw_grid = SpectralGrid(1.0, 50000.0, 1.0 * (8 if smoke else 1))
    B = batch_size if batch_size else (4 if smoke else 32)
    nlayers = 54

    def continua(grid):
        w = np.asarray(grid.wavenumbers_np())
        h2o = WaterVaporContinuum(
            cs=jnp.asarray(2.5e-22 * np.exp(-w / 900.0) + 4e-25,
                           jnp.float32),
            cf=jnp.asarray(6.0e-25 * np.exp(-w / 1500.0) + 1e-27,
                           jnp.float32),
            t0s=jnp.asarray(0.012 + 0.004 * np.sin(w / 800.0), jnp.float32),
            t0f=jnp.asarray(0.006 + 0.002 * np.cos(w / 1100.0), jnp.float32))
        o3 = OzoneContinuum(cross_section=jnp.asarray(
            4e-22 * np.exp(-0.5 * ((w - 17500.0) / 2600.0) ** 2),
            jnp.float32))
        return h2o, o3

    def xsec_tables(gas, grid):
        w = np.asarray(grid.wavenumbers_np())
        # 3 CFC species (run-rfmip-irf.sh uses CFC-11-eq + CFC-12; circ adds
        # CCl4) + 3 CIA pairs (N2-N2, O2-N2, O2-O2).
        for cfc_id, center in ((0, 850.0), (1, 920.0), (3, 790.0)):
            sig = 8e-19 * np.exp(-0.5 * ((w - center) / 40.0) ** 2)
            gas.cfcs[cfc_id] = CrossSectionTable(
                id=cfc_id, name=f"cfc{cfc_id}",
                cross_section=jnp.asarray(sig, jnp.float32))
        for k, (s1, s2, center, width) in enumerate(
                ((0, 0, 95.0, 70.0), (1, 0, 150.0, 90.0),
                 (1, 1, 1550.0, 120.0))):
            sig = 4e-44 * np.exp(-0.5 * ((w - center) / width) ** 2)
            gas.cias.append((s1, s2, CrossSectionTable(
                id=s1, name=f"cia{k}", cross_section=jnp.asarray(
                    np.float64(sig) * constants.CIA_COLUMN_FACTOR,
                    jnp.float32))))

    lw_h2o, lw_o3 = continua(lw_grid)
    lw_gas = GasOptics(lw_grid, line_chunk=1024, h2o_ctm=lw_h2o,
                       o3_ctm=lw_o3, method=lw_method)
    for seed, (mol, L) in enumerate(LW_LINES.items()):
        lw_gas.add_catalog(
            synthetic_lines(mol, lw_grid, max(64, L // shrink), seed))
    xsec_tables(lw_gas, lw_grid)

    sw_h2o, sw_o3 = continua(sw_grid)
    sw_gas = GasOptics(sw_grid, line_chunk=1024, h2o_ctm=sw_h2o,
                       o3_ctm=sw_o3)
    for seed, (mol, L) in enumerate(SW_LINES.items()):
        sw_gas.add_catalog(
            synthetic_lines(mol, sw_grid, max(64, L // shrink), 100 + seed))
    xsec_tables(sw_gas, sw_grid)

    solar = SolarFlux.from_samples(
        np.linspace(1.0, 50100.0, 256),
        np.exp(-0.5 * ((np.linspace(1.0, 50100.0, 256) - 18000.0)
                       / 9000.0) ** 2) + 1e-3, sw_grid)

    rng = np.random.default_rng(7)
    nlev = nlayers + 1
    batch = {
        "p_lev": np.linspace(0.01, 1013.0, nlev)[None, :] * np.ones((B, 1)),
        "t_lev": np.linspace(210.0, 290.0, nlev)[None, :]
        + rng.uniform(-5, 5, (B, nlev)),
        "vmr": {1: 2.0 + 19000.0 * (np.arange(nlev) / nlev)[None, :] ** 3
                * np.ones((B, 1)),
                2: np.full((B, nlev), 400.0), 3: np.full((B, nlev), 1.0),
                4: np.full((B, nlev), 0.33), 5: np.full((B, nlev), 0.1),
                6: np.full((B, nlev), 1.85),
                7: np.full((B, nlev), 209000.0)},
        "cfc_vmr": {0: np.full((B, nlev), 2.6e-4),
                    1: np.full((B, nlev), 5.2e-4),
                    3: np.full((B, nlev), 1.0e-4)},
        "cia_vmr": {0: np.full((B, nlev), 781000.0),
                    1: np.full((B, nlev), 209000.0)},
        "mu": rng.uniform(0.1, 0.95, B),
        "tsi": np.full(B, 1361.0),
    }
    return lw_gas, sw_gas, solar, batch, B, nlayers


def make_step(lw_gas, sw_gas, solar, lw_blocks: int = 1):
    import jax
    import jax.numpy as jnp
    from grtcode_jax import constants
    from grtcode_jax.solvers.longwave import longwave_fluxes
    from grtcode_jax.solvers.rayleigh import rayleigh_tau
    from grtcode_jax.solvers.shortwave import shortwave_fluxes
    from grtcode_jax.utils import curtis_godson as cg
    from grtcode_jax.utils.interp import (block_trapezoid_weights,
                                          trapezoid_uniform)

    w_lw = lw_gas.grid.wavenumbers()
    w_sw = sw_gas.grid.wavenumbers()
    f32 = jnp.float32
    # Spectral streaming (SURVEY hard-part #4: never materialize the full
    # band tau at production resolution): process the LW band in
    # lw_blocks quantum-aligned spectral blocks inside ONE compiled step,
    # accumulating exact per-block trapezoid-weighted integrals.
    q = lw_gas.block_quantum
    nw_lw = lw_gas.grid.n
    blk_lw = -(-(-(-nw_lw // lw_blocks)) // q) * q
    nblk = -(-nw_lw // blk_lw)

    @jax.jit
    def step(p_lev, t_lev, vmr, cfc_vmr, cia_vmr, mu, tsi):
        p_lev = jnp.asarray(p_lev, f32)
        t_lev = jnp.asarray(t_lev, f32)
        vmrf = {k: jnp.asarray(v, f32) * 1e-6 for k, v in vmr.items()}
        cfcf = {k: jnp.asarray(v, f32) * 1e-6 for k, v in cfc_vmr.items()}
        ciaf = {k: jnp.asarray(v, f32) * 1e-6 for k, v in cia_vmr.items()}
        t_layers = 0.5 * (t_lev[:, :-1] + t_lev[:, 1:])
        t_surf = t_lev[:, -1] + 1.5
        B_ = p_lev.shape[0]

        if nblk == 1:
            tau_lw = lw_gas.optical_depth(p_lev, t_lev, vmrf, cfc_vmr=cfcf,
                                          cia_vmr=ciaf)
            flu, fld = longwave_fluxes(
                tau_lw, jnp.zeros_like(tau_lw), t_surf, t_layers, t_lev,
                jnp.ones((B_, w_lw.shape[0]), f32), w_lw)
            rlu = trapezoid_uniform(flu, lw_gas.grid.dw)
            rld = trapezoid_uniform(fld, lw_gas.grid.dw)
        else:
            def body(i, acc):
                start = i * blk_lw
                tau_b = lw_gas.optical_depth(
                    p_lev, t_lev, vmrf, cfc_vmr=cfcf, cia_vmr=ciaf,
                    block_start=start, block_size=blk_lw)
                wb = jnp.float32(lw_gas.grid.w0) + \
                    jnp.float32(lw_gas.grid.dw) * (
                        start + jnp.arange(blk_lw, dtype=jnp.int32)
                    ).astype(f32)
                flu, fld = longwave_fluxes(
                    tau_b, jnp.zeros_like(tau_b), t_surf, t_layers, t_lev,
                    jnp.ones((B_, blk_lw), f32), wb)
                wts = block_trapezoid_weights(start, blk_lw, nw_lw,
                                              lw_gas.grid.dw)
                return (acc[0] + (flu * wts).sum(-1),
                        acc[1] + (fld * wts).sum(-1))

            nlev_ = p_lev.shape[1]
            rlu, rld = jax.lax.fori_loop(
                0, nblk, body, (jnp.zeros((B_, nlev_), f32),
                                jnp.zeros((B_, nlev_), f32)))

        sw_vmr = {k: v for k, v in vmrf.items() if k in sw_gas.molecules}
        tau_sw = sw_gas.optical_depth(p_lev, t_lev, sw_vmr, cfc_vmr=cfcf,
                                      cia_vmr=ciaf)
        ray = rayleigh_tau(
            cg.number_densities(p_lev * constants.MB_TO_ATM), w_sw)
        tau_tot = tau_sw + ray
        omega = ray / jnp.maximum(tau_tot, 1e-30)
        alb = jnp.full((p_lev.shape[0], w_sw.shape[0]), 0.15, f32)
        fsu, fsd = shortwave_fluxes(
            tau_tot, omega, jnp.zeros_like(tau_tot), jnp.asarray(mu, f32),
            jnp.full_like(jnp.asarray(mu, f32), 0.5), alb, alb,
            jnp.asarray(tsi, f32), solar.incident_flux)
        rsu = trapezoid_uniform(fsu, sw_gas.grid.dw)
        rsd = trapezoid_uniform(fsd, sw_gas.grid.dw)
        return rlu, rld, rsu, rsd
    return step


def sweep_batch():
    """Run the bench at B in {16, 32, 64}, one subprocess at a time (so
    only one process holds the card), falling back to --chunk 16 column
    chunking (one B=16 compile, slices concatenated) when a launch fails.
    Prints ONE JSON line whose headline value is the best
    configuration's throughput."""
    import subprocess

    results = {}
    device = None
    for B in (16, 32, 64):
        # The chunked fallback only differs from the native run when the
        # chunk is smaller than the batch.
        variants = [[]] if B <= 16 else [[], ["--chunk", "16"]]
        for extra in variants:
            cmd = [sys.executable, os.path.abspath(__file__),
                   "--batch", str(B)] + extra
            label = f"B={B}" + ("+chunk16" if extra else "")
            print(f"sweep: {' '.join(cmd[1:])}", file=sys.stderr)
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True,
                                      timeout=3600)
            except subprocess.TimeoutExpired:
                print(f"sweep: {label} timed out", file=sys.stderr)
                continue
            if proc.returncode == 0 and proc.stdout.strip():
                try:
                    data = json.loads(proc.stdout.strip().splitlines()[-1])
                    results[label] = data["value"]
                    device = data["device"]
                except (ValueError, KeyError) as e:
                    print(f"sweep: {label}: unparseable output ({e})",
                          file=sys.stderr)
                    continue
                print(f"sweep: {label}: {data['value'] / 1e6:.1f} M pts/s",
                      file=sys.stderr)
                break
            print(f"sweep: {label} failed (rc={proc.returncode}): "
                  f"{proc.stderr.strip().splitlines()[-1:]}",
                  file=sys.stderr)
    if not results:
        raise SystemExit("sweep: every configuration failed")
    best = max(results, key=results.get)
    print(json.dumps({
        "metric": "gridpoints_per_s",
        "value": results[best],
        "unit": "column*layer*wavenumber points/s (LW+SW)",
        "vs_baseline": results[best] / REF_POINTS_PER_S,
        "device": device,
        "best_config": best,
        "sweep": {k: round(v) for k, v in results.items()},
    }))


def _profile_kernels(step, args, iters: int = 2):
    """Trace ``iters`` steps on the device and return (voigt-kernel
    ms/step, summed device-op ms/step, top ops).  Raises when the trace
    holds no file, no GPU device track or no operation on it."""
    import glob
    import gzip
    import tempfile

    import jax

    with tempfile.TemporaryDirectory() as td:
        with jax.profiler.trace(td, create_perfetto_trace=True):
            for _ in range(iters):
                out = step(*args)
            jax.block_until_ready(out)
        files = sorted(glob.glob(os.path.join(td, "**", "*.trace.json.gz"),
                                 recursive=True))
        if not files:
            raise RuntimeError(f"profiler wrote no trace file under {td}")
        with gzip.open(files[-1], "rt") as f:
            trace = json.load(f)
    events = trace.get("traceEvents", [])
    name_by_pid = {}
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            name_by_pid[e["pid"]] = e["args"].get("name", "")
    device_pids = {p for p, n in name_by_pid.items()
                   if "/device:gpu" in n.lower()}
    if not device_pids:
        raise RuntimeError("trace has no GPU device track; processes: "
                           f"{sorted(name_by_pid.values())}")
    tot = {}
    for e in events:
        if e.get("ph") == "X" and e.get("pid") in device_pids:
            tot[e["name"]] = tot.get(e["name"], 0.0) + e.get("dur", 0.0)
    if not tot:
        raise RuntimeError("trace has no operation on the GPU device tracks")
    per_step = {n: us / 1e3 / iters for n, us in tot.items()}
    kernel_ms = sum(v for n, v in per_step.items() if "voigt" in n.lower())
    total_ms = sum(per_step.values())
    top = sorted(per_step.items(), key=lambda kv: -kv[1])[:6]
    return kernel_ms, total_ms, top


def voigt_flop_estimate(lw_gas, sw_gas, rows: int) -> float:
    """Analytic operation count of one step's line-by-line work (module
    docstring); bin methods count their host range tables."""
    from grtcode_jax.gas_optics import lines as lines_mod

    flops = 0.0
    for gas in (lw_gas, sw_gas):
        fsteps = gas._fsteps
        if gas.method in ("wavenumber_sweep", "line_sweep"):
            # Every remote (line, bin) pair evaluates NIP coarse points
            # (~10 ops each) and every local (line, bin) pair ppb fine
            # points (~22 ops), plus ~1 full evaluation per local line.
            import grtcode_jax.gas_optics.bins as bins_mod
            for mol_id in gas.molecules:
                br = gas._get_bin_ranges(mol_id)
                remote = float((br.rem_cnt_l + br.rem_cnt_r).sum()) \
                    * bins_mod.NIP
                local = float(br.local_cnt.sum()) * gas.bins.ppb
                flops += rows * (remote * 10 + local * 22
                                 + float(br.local_cnt.sum()) * 300)
            continue
        for mol_id, bound in gas.molecules.items():
            L = int(bound.num_lines)
            hw = gas.near_hw[mol_id]
            margin = hw - gas.near_steps[mol_id]
            reach0 = max(lines_mod.region0_halfwidth(bound, gas.grid.dw),
                         hw) + margin
            total = 2 * (fsteps + margin) + gas.tile
            core = min(2 * reach0 + gas.tile, total)
            interior = 2 * max(fsteps - margin - gas.tile - reach0 + 1, 0)
            edge = max(total - core - interior, 0)
            far = core * 18 + interior * 7 + edge * 10
            near = (2 * hw + 1) * (25 + gas.tile) + 2 * 300
            flops += float(L) * rows * (far + near)
    # Continua/CFC/CIA + solver work: ~a few e9, negligible next to the
    # line kernels; omitted rather than padded.
    return flops


def main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="tiny shapes; the only mode allowed off a GPU")
    ap.add_argument("--batch", type=int, default=None,
                    help="columns per step (default 32; smoke 4)")
    ap.add_argument("--chunk", type=int, default=None,
                    help="process the batch in column slices of this size "
                         "through one compiled step (memory-bounded large "
                         "B)")
    ap.add_argument("--sweep-batch", action="store_true",
                    help="benchmark B in {16,32,64} (subprocesses, one at "
                         "a time), report the best")
    ap.add_argument("--method", default="line_sample",
                    choices=["line_sample", "wavenumber_sweep",
                             "line_sweep"],
                    help="LW gas-optics method (SW stays line_sample: "
                         "binned wings lose at 1 cm-1 resolution)")
    ap.add_argument("--lw-res", type=float, default=0.1,
                    help="LW grid resolution [cm-1] (production north "
                         "star: 0.01)")
    ap.add_argument("--profile", action="store_true",
                    help="capture a jax.profiler device trace of 2 steps "
                         "and report the measured Voigt-kernel time")
    ap.add_argument("--lw-blocks", type=int, default=None,
                    help="stream the LW band in this many spectral "
                         "blocks inside one step (default: 1 at 0.1 "
                         "cm-1, sized for ~32k-point blocks below)")
    opts = ap.parse_args()
    if opts.sweep_batch:
        sweep_batch()
        return

    import jax
    from grtcode_jax.compile_cache import enable_compile_cache

    enable_compile_cache()

    smoke = opts.smoke
    dev = jax.devices()[0]
    if dev.platform != "gpu" and not smoke:
        raise SystemExit(f"bench: refusing to time platform {dev.platform!r}"
                         " (a GPU is required; --smoke runs anywhere)")
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    print(f"bench device: {device}", file=sys.stderr)

    lw_gas, sw_gas, solar, batch, B, nlayers = build(
        smoke, opts.batch, lw_method=opts.method, lw_res=opts.lw_res)
    chunk = opts.chunk if opts.chunk and opts.chunk < B else None
    lw_blocks = opts.lw_blocks
    if lw_blocks is None:
        # Stream once the band outgrows ~40k points (0.01 cm-1 regime);
        # the default 0.1 config keeps a single-block step.
        lw_blocks = max(1, -(-lw_gas.grid.n // 32768)) \
            if lw_gas.grid.n > 40000 else 1
    n_lines = sum(int(m.num_lines) for m in lw_gas.molecules.values()) + \
        sum(int(m.num_lines) for m in sw_gas.molecules.values())
    print(f"catalog: {n_lines} lines, B={B}, layers={nlayers}, "
          f"lw n={lw_gas.grid.n} ({opts.method}"
          + (f", {lw_blocks} blocks" if lw_blocks > 1 else "")
          + f"), sw n={sw_gas.grid.n}"
          + (f", chunk={chunk}" if chunk else ""), file=sys.stderr)
    step_fn = make_step(lw_gas, sw_gas, solar, lw_blocks=lw_blocks)

    def slice_args(lo, hi):
        def cut(a):
            return a[lo:hi]
        return (cut(batch["p_lev"]), cut(batch["t_lev"]),
                {k: cut(v) for k, v in batch["vmr"].items()},
                {k: cut(v) for k, v in batch["cfc_vmr"].items()},
                {k: cut(v) for k, v in batch["cia_vmr"].items()},
                cut(batch["mu"]), cut(batch["tsi"]))

    if chunk:
        slices = [slice_args(lo, lo + chunk) for lo in range(0, B, chunk)]

        def step():
            return [step_fn(*s) for s in slices]
        args = ()
    else:
        step = step_fn
        args = slice_args(0, B)

    t0 = time.perf_counter()
    jax.block_until_ready(step(*args))
    compile_first_s = time.perf_counter() - t0
    print(f"compile+first step: {compile_first_s:.1f}s", file=sys.stderr)

    flops = voigt_flop_estimate(lw_gas, sw_gas, B * nlayers)
    peak = PEAK_F32_FLOPS.get(dev.device_kind)

    iters = 2 if smoke else 10
    t0 = time.perf_counter()
    for _ in range(iters):
        out = step(*args)
    jax.block_until_ready(out)
    elapsed = time.perf_counter() - t0

    points = B * nlayers * (lw_gas.grid.n + sw_gas.grid.n) * iters
    value = points / elapsed
    result = {
        "metric": "gridpoints_per_s",
        "value": value,
        "unit": "column*layer*wavenumber points/s (LW+SW)",
        "vs_baseline": value / REF_POINTS_PER_S,
        "device": device,
    }
    if opts.profile:
        k_ms, total_ms, top = _profile_kernels(step, args)
        result["profiled_kernel_ms_per_step"] = k_ms
        result["profiled_device_ms_per_step"] = total_ms
        if flops > 0 and k_ms > 0:
            meas = flops / (k_ms * 1e-3)
            result["profiled_tflops"] = meas / 1e12
            if peak:
                result["profiled_share_of_f32_peak"] = meas / peak
        print("profiled top device ops (ms/step): "
              + ", ".join(f"{n[:60]}={v:.1f}" for n, v in top),
              file=sys.stderr)
    result["compile_first_s"] = compile_first_s
    stats = dev.memory_stats()
    if stats is not None:
        result["peak_bytes_in_use"] = stats["peak_bytes_in_use"]
    if opts.method != "line_sample":
        result["lw_method"] = opts.method
    if opts.lw_res != 0.1:
        # vs_baseline compares against the reference's 0.1+1.0 cm-1
        # production config; at other resolutions it is indicative only.
        result["lw_res"] = opts.lw_res
        result["lw_points"] = lw_gas.grid.n
    print(f"{iters} steps in {elapsed:.3f}s "
          f"({elapsed / iters * 1e3:.0f} ms/step)", file=sys.stderr)
    if flops > 0:
        tflops = flops * iters / elapsed / 1e12
        result["est_tflops"] = tflops
        if peak:
            result["est_share_of_f32_peak"] = tflops * 1e12 / peak
    print(json.dumps(result))


if __name__ == "__main__":
    main()
