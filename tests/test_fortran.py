"""Fortran binding compile test (fortran-bindings/grtcode_fortran.F90).

The reference ships `module grtcode` for GFDL climate models; this build's
equivalent is native/grtcode_jax.F90 over the C ABI.  gfortran compiles
the module and a small program exercising the public surface (constants +
f_* interfaces); skipped when no Fortran compiler is installed (this
container has none — the test runs in environments that do).
"""
import os
import shutil
import subprocess

import pytest

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
F90 = os.path.join(ROOT, "native", "grtcode_jax.F90")

PROGRAM = """
program smoke
use grtcode_jax
use, intrinsic :: iso_c_binding, only: c_double, c_int
implicit none
integer(kind=grt_handle_kind) :: grid
integer(kind=c_int) :: rc
! Interface check only: reference the binding surface the way a GFDL
! model would (grtcode_fortran.F90:585-893 pattern).
if (H2O /= 1 .or. CS2 /= 53) stop 1
if (CFC11 /= 0 .or. SF6 /= 20) stop 2
if (grtcode_success /= 0) stop 3
if (.false.) then
  rc = f_create_spectral_grid(1.0_c_double, 3250.0_c_double, &
                              0.1_c_double, grid)
end if
end program smoke
"""


@pytest.mark.skipif(shutil.which("gfortran") is None,
                    reason="no gfortran in this environment")
def test_f90_module_compiles(tmp_path):
    mod = subprocess.run(
        ["gfortran", "-c", "-Wall", "-Werror", F90, "-J", str(tmp_path),
         "-o", str(tmp_path / "grtcode_jax.o")],
        capture_output=True, text=True)
    assert mod.returncode == 0, mod.stderr
    src = tmp_path / "smoke.F90"
    src.write_text(PROGRAM)
    prog = subprocess.run(
        ["gfortran", "-c", "-Wall", "-Werror", str(src), "-I",
         str(tmp_path), "-o", str(tmp_path / "smoke.o")],
        capture_output=True, text=True)
    assert prog.returncode == 0, prog.stderr
