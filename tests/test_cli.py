"""CLI smoke tests: the three app main()s parse flags and run end-to-end.

The reference's binaries are exercised by its shell-script integration
tests (circ/test/test_circ, rfmip-irf/test/test_rfmip_irf); these are the
equivalent for the Python entry points — an argparse typo or broken
wiring in main() fails here, not in production.
"""
import os

import h5py
import numpy as np
import pytest

from grtcode_jax.apps import circ, era5, rfmip

# Reuse the app test fixtures (synthetic netCDF inputs).
from tests.test_rfmip import input_file  # noqa: F401
from tests.test_era5 import era5_file, ghg_file  # noqa: F401
from tests.test_era5 import T as ERA5_T, Y as ERA5_Y, X as ERA5_X

COARSE = ["-r-lw", "4.0", "-r-sw", "10.0"]


def test_circ_main(capsys, tmp_path):
    circ.main(["none", "none", "-o", str(tmp_path / "circ1_out.nc")]
              + COARSE)
    out = capsys.readouterr().out
    assert "RLUTCSAF" in out and "LBLRTM" in out
    # Transparent-gas run still produces the exact TSI*mu SW TOA value.
    for line in out.splitlines():
        if line.startswith("RSDTCSAF"):
            assert abs(float(line.split()[1]) - 912.80) < 1.0


def test_rfmip_main(input_file, tmp_path):  # noqa: F811
    out = str(tmp_path / "rfmip_out.nc")
    rfmip.main(["none", "none", input_file, "2", "-integrated",
                "-flux-at-level", "3", "-x", "1", "-X", "3",
                "-o", out] + COARSE)
    with h5py.File(out, "r") as f:
        assert f["rlutcsaf"].shape == (3,)
        assert f.attrs["x_start"] == 1 and f.attrs["x_stop"] == 3
        assert np.isfinite(np.asarray(f["rlucsaf"])).all()


def test_era5_main(era5_file, ghg_file, tmp_path):  # noqa: F811
    out = str(tmp_path / "era5_out.nc")
    era5.main(["none", "none", era5_file, ghg_file, "-year", "1",
               "-clear", "-integrated", "-o", out] + COARSE)
    with h5py.File(out, "r") as f:
        rlut = np.asarray(f["rlutcsaf"])
        assert rlut.shape == (ERA5_T, ERA5_Y, ERA5_X)
        assert np.isfinite(rlut).all() and rlut.max() > 0
        # State profiles ride along (era5.c:865-886).
        assert np.asarray(f["p"]).shape[1] > 1
        assert f.attrs["lon_global_size"] == ERA5_X


def test_era5_main_mesh(era5_file, ghg_file, tmp_path):  # noqa: F811
    """-mesh CxS shards the app run over a (columns x spectral) device
    mesh from the command line (the counterpart of the
    reference's per-node -x/-X SLURM slices); results match the
    unsharded run."""
    out_m = str(tmp_path / "era5_mesh.nc")
    out_1 = str(tmp_path / "era5_flat.nc")
    base = ["none", "none", era5_file, ghg_file, "-year", "1", "-clear",
            "-integrated"] + COARSE
    era5.main(base + ["-o", out_1])
    era5.main(base + ["-o", out_m, "-mesh", "4x2"])
    with h5py.File(out_1, "r") as f1, h5py.File(out_m, "r") as fm:
        np.testing.assert_allclose(
            np.asarray(fm["rlutcsaf"]), np.asarray(f1["rlutcsaf"]),
            rtol=2e-5, atol=1e-4)


def test_mesh_flag_rejects_bad_spec():
    from grtcode_jax.framework import cli

    p = cli.shared_parser("t")
    args = p.parse_args(["none", "none", "-mesh", "nonsense"])
    with pytest.raises(SystemExit):
        cli.mesh_from_args(args)


def test_circ_main_spectral_chunks(capsys, tmp_path):
    """-spectral-chunks N streams each band serially inside one compiled
    step through the CLI (the single-chip production-resolution mode):
    the embedded case-1 integrated fluxes match the unchunked run."""
    circ.main(["none", "none", "-o", "", "-spectral-chunks", "3"]
              + COARSE)
    out = capsys.readouterr().out
    assert "RLUTCSAF" in out
    for line in out.splitlines():
        if line.startswith("RSDTCSAF"):
            assert abs(float(line.split()[1]) - 912.80) < 1.0
