"""Simulated multi-host dryrun: 2 CPU processes x 4 virtual devices.

Validates the production multi-host flow (grtcode_jax/parallel/
distributed.py) without pod hardware: an orchestrator spawns two worker
processes that join one jax.distributed process group, each builds a
(2 columns x 2 spectral) mesh over its *local* devices, computes its
column slice of the flagship two-band step, and writes a combinable
segment + done-marker.  The orchestrator then merges the segments and
compares byte-identically against the same step on a single-process
(4 x 2) mesh — the analogue of the reference's SLURM-sharded run
vs single-node run producing identical netCDF contents
(GRTworkflow/run-rfmip-irf.sh:102-125 + combiner).

Worker mode:    python tools/dryrun_distributed.py --worker --process-id I \
                    --num-processes N --coordinator HOST:PORT --out-dir D
Orchestrator:   python tools/dryrun_distributed.py  (or call orchestrate())
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEVICES_PER_PROC = 4
NUM_PROCESSES = 2
N_SPECTRAL = 2
BATCH_COLUMNS = 8


def _build_model_and_batch():
    sys.path.insert(0, REPO_ROOT)
    import __graft_entry__ as ge

    model, batch = ge._build(lw_points=256, sw_points=128, nlines=96,
                             chunk=32)
    return model, batch(B=BATCH_COLUMNS, nlev=9)


def build_driver_case(B: int = BATCH_COLUMNS):
    """A small but COMPLETE three-tier case: both bands, synthetic lines,
    aerosols (CS tier) and stochastic Pade clouds (AF tier) — the full
    RadiationDriver surface the reference's per-node binaries run
    (GRTworkflow/run-rfmip-irf.sh:102-125), sized for the virtual-CPU
    dryrun.  Deterministic: every process builds the identical case."""
    import numpy as np

    sys.path.insert(0, REPO_ROOT)
    from grtcode_jax.clouds.lib import CloudOpticsLib
    from grtcode_jax.clouds.pade import synthetic_pade_table
    from grtcode_jax.framework import Atmosphere, RadiationDriver
    from grtcode_jax.gas_optics.gas_optics import GasOptics
    from grtcode_jax.gas_optics.hitran import synthetic_catalog
    from grtcode_jax.solvers.solar_flux import SolarFlux
    from grtcode_jax.spectral import SpectralGrid

    lw_grid = SpectralGrid(100.0, 150.0, 0.2)
    sw_grid = SpectralGrid(2000.0, 20000.0, 10.0)

    def cat(grid, seed, L=64):
        r = np.random.default_rng(seed)
        vnn = np.sort(r.uniform(grid.w0, grid.last, L))
        return synthetic_catalog(
            1, vnn, r.uniform(1e-22, 1e-19, L),
            yair=r.uniform(0.02, 0.1, L), yself=r.uniform(0.05, 0.4, L),
            en=r.uniform(0.0, 2000.0, L), n=r.uniform(0.4, 0.8, L),
            d=r.uniform(-0.01, 0.01, L))

    lw_gas = GasOptics(lw_grid, line_chunk=32)
    lw_gas.add_catalog(cat(lw_grid, 0))
    sw_gas = GasOptics(sw_grid, line_chunk=32)
    sw_gas.add_catalog(cat(sw_grid, 1))
    w = np.linspace(1900.0, 20100.0, 64)
    solar = SolarFlux.from_samples(w, 1.0 + 0.3 * np.sin(w / 3000.0),
                                   sw_grid)
    clouds = CloudOpticsLib(
        liquid=synthetic_pade_table(nbnd=8, w0=100.0, wn=20000.0, seed=0),
        ice=synthetic_pade_table(nbnd=8, w0=100.0, wn=20000.0, seed=1))
    driver = RadiationDriver(lw_gas=lw_gas, sw_gas=sw_gas, solar=solar,
                             cloud_optics=clouds.driver_callback(),
                             cloud_seed=7)

    nlev = 9
    nlay = nlev - 1
    rng = np.random.default_rng(23)
    atm = Atmosphere(
        level_pressure=np.linspace(1.0, 1013.0, nlev)[None]
        * np.ones((B, 1)),
        level_temperature=np.linspace(220.0, 290.0, nlev)[None]
        + rng.uniform(-4, 4, (B, nlev)),
        surface_temperature=rng.uniform(285.0, 300.0, B),
        ppmv={1: rng.uniform(100.0, 3000.0, (B, nlev))},
        cos_zenith=rng.uniform(0.2, 0.9, B),
        total_solar_irradiance=np.full(B, 1361.0),
        aerosol_optical_depth_1um=rng.uniform(0.0, 0.3, (B, nlay)),
        aerosol_angstrom_exponent=np.full(B, 1.3),
        aerosol_single_scatter_albedo=rng.uniform(0.85, 0.99, (B, nlay)),
        aerosol_asymmetry_factor=rng.uniform(0.3, 0.8, (B, nlay)),
        cloud_fraction=rng.uniform(0.2, 0.9, (B, nlay)),
        liquid_water_content=rng.uniform(0.0, 0.3, (B, nlay)),
        ice_water_content=rng.uniform(0.0, 0.02, (B, nlay)),
        layer_thickness=np.full((B, nlay), 500.0),
        clean=False, clear=False)
    return driver, atm


def run_worker(process_id: int, num_processes: int, coordinator: str,
               out_dir: str) -> None:
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={DEVICES_PER_PROC}")
    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, REPO_ROOT)
    from grtcode_jax.parallel import distributed

    distributed.initialize(coordinator_address=coordinator,
                           num_processes=num_processes,
                           process_id=process_id)
    assert jax.process_count() == num_processes
    assert len(jax.local_devices()) == DEVICES_PER_PROC

    model, batch = _build_model_and_batch()
    path = distributed.run_process_segment(
        model, batch, out_dir, "dryrun", n_spectral=N_SPECTRAL)
    # Spectrally-resolved segment: exercises the cross-process tiled
    # all_gather along the wavenumber axis (the spectral-output path).
    path_s = distributed.run_process_segment(
        model, batch, out_dir, "dryrun_spec", n_spectral=N_SPECTRAL,
        integrated=False)
    # FULL three-tier driver (aerosols + stochastic clouds) under the
    # same process group — the real production object, not the adapter.
    drv, atm = build_driver_case()
    path_d = distributed.run_driver_segment(
        drv, atm, out_dir, "dryrun_driver", n_spectral=N_SPECTRAL)
    print(f"worker {process_id}: wrote {path}, {path_s} and {path_d}",
          flush=True)


def orchestrate(out_dir: str, timeout: float = 600.0) -> None:
    """Spawn the workers, combine their segments, check vs single-process."""
    import numpy as np

    coordinator = "127.0.0.1:29753"
    procs = []
    for pid in range(NUM_PROCESSES):
        env = dict(os.environ)
        env.pop("XLA_FLAGS", None)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker",
             "--process-id", str(pid),
             "--num-processes", str(NUM_PROCESSES),
             "--coordinator", coordinator, "--out-dir", out_dir],
            env=env, cwd=REPO_ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for pid, proc in enumerate(procs):
        out, _ = proc.communicate(timeout=timeout)
        if proc.returncode != 0:
            raise RuntimeError(
                f"distributed worker {pid} failed:\n{out[-4000:]}")

    sys.path.insert(0, REPO_ROOT)
    from grtcode_jax.parallel import distributed
    from grtcode_jax.parallel.mesh import make_mesh
    import jax

    # Reference: the same steps on this process's own devices (the driver
    # runs us under --xla_force_host_platform_device_count=8).
    model, batch = _build_model_and_batch()
    devices = jax.devices()
    n_cols = max(len(devices) // N_SPECTRAL, 1)
    mesh = make_mesh(n_cols, N_SPECTRAL, devices=devices[:n_cols * N_SPECTRAL])
    for name, integ in (("dryrun", True), ("dryrun_spec", False)):
        combined = distributed.combine_column_segments(out_dir, name)
        single = {k: np.asarray(v) for k, v in
                  model.step(mesh=mesh, integrated=integ)(batch).items()}
        for key, ref in single.items():
            got = combined[key]
            if got.shape != ref.shape:
                raise AssertionError(
                    f"{name}/{key}: shape {got.shape} != {ref.shape}")
            if not np.array_equal(got, ref):
                worst = np.abs(got - ref).max()
                raise AssertionError(
                    f"{name}/{key}: combined segments differ from "
                    f"single-process run (max abs diff {worst:.3e})")
    # Three-tier driver case: combined per-process segments must equal the
    # same driver on a single-process mesh, tier for tier, byte for byte
    # (cloud realizations are keyed on global column ids, so the process
    # layout cannot change them).
    drv, atm = build_driver_case()
    res = drv.run(atm, integrated=True, mesh=mesh)
    combined = distributed.combine_column_segments(out_dir, "dryrun_driver")
    tiers = sorted(res.tiers)
    if tiers != ["af", "cs", "csaf"]:
        raise AssertionError(f"expected three sky tiers, got {tiers}")
    for tier, d in res.tiers.items():
        for var, ref in d.items():
            got = combined[f"{tier}_{var}"]
            if not np.array_equal(got, np.asarray(ref)):
                worst = np.abs(got - np.asarray(ref)).max()
                raise AssertionError(
                    f"driver {tier}/{var}: combined segments differ from "
                    f"single-process run (max abs diff {worst:.3e})")
    print(f"distributed dryrun ok: {NUM_PROCESSES} processes x "
          f"{DEVICES_PER_PROC} devices, integrated AND spectral segments "
          f"byte-identical ({', '.join(sorted(single))}); three-tier "
          f"cloudy driver segments byte-identical "
          f"({', '.join(tiers)})", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--num-processes", type=int, default=NUM_PROCESSES)
    ap.add_argument("--coordinator", default="127.0.0.1:29753")
    ap.add_argument("--out-dir", default="/tmp/grtcode_dryrun_distributed")
    args = ap.parse_args()
    if args.worker:
        run_worker(args.process_id, args.num_processes, args.coordinator,
                   args.out_dir)
    else:
        import tempfile
        with tempfile.TemporaryDirectory() as d:
            orchestrate(d)


if __name__ == "__main__":
    main()
