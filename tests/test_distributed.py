"""Multi-host execution: column slicing, segments, 2-process dryrun.

The reference's multi-node story is SLURM `-x/-X` column slices + per-node
netCDF segments + a combiner (GRTworkflow/run-rfmip-irf.sh:102-125,
era5/test/combine-segments.py); grtcode_jax/parallel/distributed.py is the
jax.distributed re-design with the same segment/recovery contract.
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

from grtcode_jax.parallel import distributed  # noqa: E402
from grtcode_jax.utils.segments import SegmentManifest  # noqa: E402


def test_column_slice_partitions_exactly():
    for n, nproc in ((100, 10), (101, 10), (7, 3), (8, 8), (5, 1)):
        covered = []
        for pid in range(nproc):
            start, stop = distributed.column_slice(n, pid, nproc)
            covered.extend(range(start, stop))
            # near-even: within one column of the mean
            assert abs((stop - start) - n / nproc) < 1.0 + 1e-9
        assert covered == list(range(n))


def test_column_slice_x_X_bounds():
    """-x/-X inclusive global bounds (rfmip-irf.c:121-139) compose with the
    process split."""
    start, stop = distributed.column_slice(100, 0, 2, x=10, X=29)
    assert (start, stop) == (10, 20)
    start, stop = distributed.column_slice(100, 1, 2, x=10, X=29)
    assert (start, stop) == (20, 30)
    with pytest.raises(ValueError):
        distributed.column_slice(100, 0, 2, x=50, X=100)


def test_segment_roundtrip_and_combine(tmp_path):
    d = str(tmp_path)
    rng = np.random.default_rng(0)
    full = {"rlu": rng.normal(size=(10, 5)).astype(np.float32),
            "rld": rng.normal(size=(10, 5)).astype(np.float32)}
    manifest = SegmentManifest(d)
    for pid, nproc in ((0, 3), (1, 3), (2, 3)):
        s, e = distributed.column_slice(10, pid, nproc)
        distributed.write_segment(
            d, "fluxes", pid, s, e, {k: v[s:e] for k, v in full.items()},
            manifest=manifest)
        assert manifest.is_done(f"fluxes.seg{pid:05d}")
    combined = distributed.combine_column_segments(d, "fluxes")
    for k in full:
        np.testing.assert_array_equal(combined[k], full[k])


def test_combine_rejects_gaps(tmp_path):
    d = str(tmp_path)
    distributed.write_segment(d, "x", 0, 0, 3, {"a": np.zeros(3)})
    distributed.write_segment(d, "x", 1, 4, 6, {"a": np.zeros(2)})
    with pytest.raises(ValueError, match="gap"):
        distributed.combine_column_segments(d, "x")


def test_run_process_segment_idempotent(tmp_path, monkeypatch):
    """Re-running a completed segment is a no-op (failure recovery: a
    crashed host reruns only its slice; finished slices are skipped)."""
    calls = []

    class FakeModel:
        def step(self, mesh, integrated=True):
            def fn(batch):
                calls.append(1)
                return {"out": batch["x"] * 2.0}
            return fn

    batch = {"x": np.arange(8, dtype=np.float32)[:, None]}
    d = str(tmp_path)
    p1 = distributed.run_process_segment(
        FakeModel(), batch, d, "seg", process_index=0, num_processes=2)
    p2 = distributed.run_process_segment(
        FakeModel(), batch, d, "seg", process_index=0, num_processes=2)
    assert p1 == p2 and len(calls) == 1
    distributed.run_process_segment(
        FakeModel(), batch, d, "seg", process_index=1, num_processes=2)
    combined = distributed.combine_column_segments(d, "seg")
    np.testing.assert_array_equal(combined["out"], batch["x"] * 2.0)


@pytest.mark.slow
def test_two_process_dryrun(tmp_path):
    """Full simulated multi-host flow: 2 subprocesses x 4 devices, one
    jax.distributed group, segments byte-identical to single-process."""
    from tools import dryrun_distributed

    dryrun_distributed.orchestrate(str(tmp_path))


def test_run_driver_segment_three_tiers_uneven(tmp_path):
    """The FULL RadiationDriver (aerosols + stochastic clouds, both
    bands) under process slices — including a column count that does NOT
    divide the local mesh's column axis (pad + trim path).  Combined
    segments must match the plain unmeshed run: cloud realizations are
    keyed on global column ids, so the process layout cannot change
    them (run_driver_segment, the per-node-binary equivalent of
    GRTworkflow/run-rfmip-irf.sh:102-125)."""
    from tools.dryrun_distributed import build_driver_case

    drv, atm = build_driver_case(B=5)
    for pid in range(2):
        distributed.run_driver_segment(
            drv, atm, str(tmp_path), "drv", n_spectral=2,
            process_index=pid, num_processes=2)
    combined = distributed.combine_column_segments(str(tmp_path), "drv")
    ref = drv.run(atm, integrated=True)
    assert sorted(ref.tiers) == ["af", "cs", "csaf"]
    for tier, d in ref.tiers.items():
        for var in d:
            np.testing.assert_allclose(
                combined[f"{tier}_{var}"], np.asarray(d[var]),
                rtol=2e-5, atol=1e-5, err_msg=f"{tier}/{var}")
    # Idempotent recovery: a second call reuses the done-marker.
    p = distributed.run_driver_segment(
        drv, atm, str(tmp_path), "drv", n_spectral=2,
        process_index=0, num_processes=2)
    assert os.path.exists(p)


def test_rfmip_app_column_segments_equal_full_run(tmp_path):
    """The rfmip APP run twice with -x/-X column slices produces
    segments whose column-concatenation equals the single full run —
    the reference's actual per-node execution contract
    (run-rfmip-irf.sh:102-125 runs the real binary per node)."""
    import h5py

    from grtcode_jax.apps import rfmip
    from tests.test_rfmip import input_file as _input_fixture  # noqa
    import tests.test_rfmip as tr

    # Build the synthetic RFMIP input directly (fixture body).
    import pytest as _pytest
    tmpdir = tmp_path

    class _F:
        def mktemp(self, name):
            d = tmpdir / name
            d.mkdir(exist_ok=True)
            return d

    input_nc = tr.input_file.__wrapped__(_F())

    def run(x, X, out):
        rfmip.main(["none", "none", input_nc, "2", "-integrated",
                    "-x", str(x)] + (["-X", str(X)] if X is not None
                                     else []) + ["-o", out])

    full = str(tmp_path / "full.nc")
    run(0, None, full)
    seg0 = str(tmp_path / "seg0.nc")
    seg1 = str(tmp_path / "seg1.nc")
    run(0, 2, seg0)
    run(3, 4, seg1)

    with h5py.File(full, "r") as f_full, h5py.File(seg0, "r") as f0, \
            h5py.File(seg1, "r") as f1:
        assert f0.attrs["x_start"] == 0 and f0.attrs["x_stop"] == 2
        assert f1.attrs["x_start"] == 3 and f1.attrs["x_stop"] == 4
        for name in ("rlucsaf", "rldcsaf", "rsucsaf", "rsdcsaf",
                     "rlutcsaf", "rsdscsaf"):
            merged = np.concatenate([np.asarray(f0[name]),
                                     np.asarray(f1[name])], axis=0)
            np.testing.assert_array_equal(merged, np.asarray(f_full[name]),
                                          err_msg=name)
