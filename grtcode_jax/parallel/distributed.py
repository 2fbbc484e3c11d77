"""Multi-host execution: process-sliced columns + per-host segment output.

The reference scales across nodes embarrassingly: SLURM launches one
process per node with a `-x/-X` column slice, each writes its own netCDF
segment, and a combiner merges them afterwards
(GRTworkflow/run-rfmip-irf.sh:102-125, rfmip-irf/src/rfmip-irf.c:121-139,
era5/src/era5.c:156-159 lon_start/lon_stop attrs).  The
equivalent (SURVEY §2 P2/P5):

  * `jax.distributed.initialize` forms the process group (device links
    within a host, the network across hosts); process_index/process_count replace the SLURM
    array index.
  * Each process ingests only its column slice (`column_slice`) and runs
    the sharded ClearSkyRT step on a mesh over its *local* devices —
    columns are embarrassingly parallel, so the production layout keeps
    collectives (spectral `psum`) inside a host and sends nothing
    over the network, exactly mirroring the reference's "filesystem is the
    collective" structure but with first-class process coordination.
  * Output is one segment file per process with explicit [col_start,
    col_stop) attributes (the era5 lon_start/lon_stop contract) plus an
    idempotent done-marker via utils.segments.SegmentManifest, so a failed
    host is recovered by rerunning only its slice.
  * `combine_column_segments` replaces the reference's combiner tools
    (extra-tools/grtcode-results-combiner.c, GRTworkflow/combiner.py).
"""
from __future__ import annotations

import os
import re

import numpy as np

from ..utils.segments import SegmentManifest


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Join the jax process group (idempotent).

    With no arguments, defers to the environment (cluster metadata or the
    JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID
    variables), which is how real multi-host clusters come up; explicit arguments
    support the simulated multi-process tests.
    """
    import jax

    # NOTE: do not query jax.process_count() (or any backend state) before
    # initializing — that would instantiate the single-process backend and
    # make the real initialization a silent no-op.
    kwargs = {}
    if coordinator_address is not None:
        kwargs = dict(coordinator_address=coordinator_address,
                      num_processes=num_processes, process_id=process_id)
    try:
        jax.distributed.initialize(**kwargs)
    except RuntimeError as e:
        if "already initialized" not in str(e).lower():
            raise


def column_slice(num_columns: int, process_index: int, num_processes: int,
                 x: int = 0, X: int | None = None) -> tuple[int, int]:
    """This process's [start, stop) column range.

    ``x``/``X`` are the reference's inclusive global column bounds
    (rfmip-irf.c:121-139: -x defaults to 0, -X to num_columns-1); the
    selected range then splits near-evenly across processes with the
    remainder going to the lowest process indices (so every process gets
    within one column of the mean — the reference's fixed nodes-sized
    stripes leave the tail node underfilled instead).
    """
    X = num_columns - 1 if X is None else X
    if not (0 <= x <= X < num_columns):
        raise ValueError(f"column slice [{x}, {X}] outside [0, {num_columns})")
    total = X - x + 1
    base, rem = divmod(total, num_processes)
    start = x + process_index * base + min(process_index, rem)
    stop = start + base + (1 if process_index < rem else 0)
    return start, stop


def local_mesh(n_spectral: int = 1):
    """(columns x spectral) mesh over THIS process's addressable devices."""
    import jax

    from .mesh import make_mesh

    devices = jax.local_devices()
    return make_mesh(len(devices) // n_spectral, n_spectral, devices=devices)


def segment_path(out_dir: str, name: str, process_index: int) -> str:
    return os.path.join(out_dir, f"{name}.seg{process_index:05d}.npz")


def write_segment(out_dir: str, name: str, process_index: int,
                  col_start: int, col_stop: int, arrays: dict,
                  manifest: SegmentManifest | None = None) -> str:
    """One per-process segment file: arrays with a leading column axis plus
    the [col_start, col_stop) coverage attrs (era5.c:156-159 contract)."""
    os.makedirs(out_dir, exist_ok=True)
    path = segment_path(out_dir, name, process_index)
    np.savez(path, __col_start=np.int64(col_start),
             __col_stop=np.int64(col_stop),
             **{k: np.asarray(v) for k, v in arrays.items()})
    if manifest is not None:
        manifest.mark_done(f"{name}.seg{process_index:05d}", path,
                           col_start=int(col_start), col_stop=int(col_stop))
    return path


def combine_column_segments(out_dir: str, name: str) -> dict:
    """Merge every segment of ``name`` along the column axis.

    Validates that the segments tile [0, N) without gaps or overlaps
    (the reference combiner trusts the lon_start/lon_stop attrs the same
    way, era5/test/combine-segments.py:26-36).
    """
    pat = re.compile(re.escape(name) + r"\.seg(\d+)\.npz$")
    segs = []
    for fname in sorted(os.listdir(out_dir)):
        if pat.search(fname):
            with np.load(os.path.join(out_dir, fname)) as z:
                segs.append((int(z["__col_start"]), int(z["__col_stop"]),
                             {k: z[k] for k in z.files
                              if not k.startswith("__col_")}))
    if not segs:
        raise FileNotFoundError(f"no segments named {name} in {out_dir}")
    segs.sort(key=lambda s: s[0])
    expect = segs[0][0]
    for start, stop, _ in segs:
        if start != expect:
            raise ValueError(f"segment gap/overlap at column {start} "
                             f"(expected {expect})")
        expect = stop
    keys = segs[0][2].keys()
    return {k: np.concatenate([s[2][k] for s in segs], axis=0)
            for k in keys}


def run_driver_segment(driver, atm, out_dir: str, name: str,
                       n_spectral: int = 1,
                       process_index: int | None = None,
                       num_processes: int | None = None,
                       x: int = 0, X: int | None = None,
                       integrated: bool = True,
                       column_chunk: int | None = None) -> str:
    """The per-host production flow for the FULL radiation driver: slice
    the Atmosphere -> three-tier run on a local (columns x spectral)
    mesh -> one segment per process.

    This is the Equivalent of the reference running the *actual
    binaries* per SLURM node with -x/-X column bounds
    (GRTworkflow/run-rfmip-irf.sh:102-125): every capability of
    :class:`grtcode_jax.framework.RadiationDriver` — all sky tiers,
    stochastic clouds (keyed on GLOBAL column ids, so realizations are
    process-layout-invariant), spectral surfaces, spectral or integrated
    output — runs under the process slice.  The segment holds one array
    per (tier, flux) pair; ``combine_column_segments`` merges them
    byte-identically to a single-process run.

    Column counts that don't divide the local mesh's column axis are
    padded by repeating the slice's first column and trimmed from the
    outputs (the same device-shape discipline as run(column_chunk=)).
    """
    import jax

    pid = jax.process_index() if process_index is None else process_index
    nproc = jax.process_count() if num_processes is None else num_processes
    start, stop = column_slice(atm.batch, pid, nproc, x=x, X=X)

    manifest = SegmentManifest(out_dir)
    seg_id = f"{name}.seg{pid:05d}"
    if manifest.is_done(seg_id):
        return manifest.record(seg_id)["output"]

    mesh = local_mesh(n_spectral=n_spectral)
    from .mesh import COLUMNS_AXIS

    n_cols_axis = mesh.shape[COLUMNS_AXIS]
    idx = np.arange(start, stop)
    n_pad = (-idx.size) % n_cols_axis
    if n_pad:
        idx = np.concatenate([idx, np.repeat(idx[:1], n_pad)])
    res = driver.run(atm.subset(idx), integrated=integrated, mesh=mesh,
                     column_chunk=column_chunk, col_index=idx)
    keep = stop - start
    arrays = {f"{tier}_{var}": np.asarray(d[var])[:keep]
              for tier, d in res.tiers.items() for var in d}
    return write_segment(out_dir, name, pid, start, stop, arrays,
                        manifest=manifest)


def run_process_segment(model, batch: dict, out_dir: str, name: str,
                        n_spectral: int = 1,
                        process_index: int | None = None,
                        num_processes: int | None = None,
                        x: int = 0, X: int | None = None,
                        integrated: bool = True) -> str:
    """The per-host production flow: slice -> local-mesh step -> segment.

    ``model`` is a ClearSkyRT (or anything with ``.step(mesh)``); ``batch``
    holds the GLOBAL arrays (leading column axis) — in production each host
    ingests only its slice from disk, and this helper slices equivalently.
    Skips (idempotently) if the segment's done-marker already exists.
    """
    import jax

    pid = jax.process_index() if process_index is None else process_index
    nproc = jax.process_count() if num_processes is None else num_processes
    num_columns = next(iter(batch.values())).shape[0]
    start, stop = column_slice(num_columns, pid, nproc, x=x, X=X)

    manifest = SegmentManifest(out_dir)
    seg_id = f"{name}.seg{pid:05d}"
    if manifest.is_done(seg_id):
        return manifest.record(seg_id)["output"]

    local = {k: (v[start:stop] if hasattr(v, "shape") and v.shape
                 and v.shape[0] == num_columns else v)
             for k, v in batch.items()}
    mesh = local_mesh(n_spectral=n_spectral)
    out = model.step(mesh=mesh, integrated=integrated)(local)
    out = {k: np.asarray(v) for k, v in out.items()}
    return write_segment(out_dir, name, pid, start, stop, out,
                         manifest=manifest)
