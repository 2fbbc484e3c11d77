"""C ABI tests: load native/libgrtcode_jax_c.so via ctypes in-process.

The shim embeds CPython; loaded inside an already-running interpreter,
grt_initialize is a no-op boot (Py_IsInitialized() is true) and all calls
dispatch into grtcode_jax.bindings.capi_impl through the registry.  Mirrors
the role of the reference's fortran-bindings tests (none exist upstream —
this is stricter than parity).
"""
import ctypes
import pathlib
import subprocess

import numpy as np
import pytest

NATIVE = pathlib.Path(__file__).resolve().parents[1] / "native"


@pytest.fixture(scope="module")
def lib():
    so = NATIVE / "libgrtcode_jax_c.so"
    if not so.exists():
        rc = subprocess.run(["make", "-C", str(NATIVE)],
                            capture_output=True).returncode
        if rc != 0 or not so.exists():
            pytest.skip("native shim not buildable")
    lib = ctypes.CDLL(str(so), mode=ctypes.RTLD_GLOBAL)
    lib.grt_errstr.restype = ctypes.c_char_p
    assert lib.grt_initialize() == 0
    return lib


def _dptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def test_spectral_grid_roundtrip(lib):
    h = ctypes.c_int64()
    assert lib.grt_create_spectral_grid(
        ctypes.c_double(1.0), ctypes.c_double(500.0), ctypes.c_double(1.0),
        ctypes.byref(h)) == 0
    props = np.zeros(3)
    assert lib.grt_spectral_grid_properties(h, _dptr(props)) == 0
    assert props[0] == 1.0 and props[1] == 500.0 and props[2] == 1.0
    assert lib.grt_destroy(h) == 0


def test_device_selection(lib):
    """grt_create_device resolves a real jax device; use_device rebinds the
    default (ADVICE round 1: the handle must be honored, not a no-op)."""
    h = ctypes.c_int64()
    assert lib.grt_create_device(ctypes.c_int(-1), ctypes.byref(h)) == 0
    assert lib.grt_use_device(h) == 0
    from grtcode_jax.bindings import capi_impl
    assert capi_impl._default_device is not None
    assert capi_impl._default_device.platform == "cpu"
    # Out-of-range id fails with the reference's range code
    # (GRTCODE_RANGE_ERR == 8, return_codes.h:25-40) and a message.
    bad = ctypes.c_int64()
    assert lib.grt_create_device(ctypes.c_int(512), ctypes.byref(bad)) == 8
    assert b"out of range" in lib.grt_errstr()


def test_longwave_fluxes_t_layers(lib):
    """grt_longwave_fluxes takes explicit layer temperatures (reference
    calculate_lw_fluxes signature, longwave/src/longwave.c:312); NULL falls
    back to level midpoints."""
    nlayers, nw = 4, 8
    grid = ctypes.c_int64()
    assert lib.grt_create_spectral_grid(
        ctypes.c_double(500.0), ctypes.c_double(507.0), ctypes.c_double(1.0),
        ctypes.byref(grid)) == 0
    opt = ctypes.c_int64()
    assert lib.grt_create_optics(ctypes.c_int(nlayers), grid,
                                 ctypes.byref(opt)) == 0
    from grtcode_jax.bindings import capi_impl
    capi_impl._get(opt.value)["tau"][:] = 0.3

    tlev = np.linspace(220.0, 290.0, nlayers + 1)
    emis = np.ones(nw)
    up = np.zeros((nlayers + 1) * nw)
    down = np.zeros_like(up)
    ts = ctypes.c_double(294.0)

    # Explicit layer temps == midpoints -> identical to the NULL fallback.
    tlay_mid = 0.5 * (tlev[:-1] + tlev[1:])
    assert lib.grt_longwave_fluxes(opt, ts, _dptr(tlev), _dptr(tlay_mid),
                                   _dptr(emis), _dptr(up), _dptr(down)) == 0
    up_null = np.zeros_like(up)
    down_null = np.zeros_like(down)
    assert lib.grt_longwave_fluxes(
        opt, ts, _dptr(tlev), None, _dptr(emis), _dptr(up_null),
        _dptr(down_null)) == 0
    np.testing.assert_allclose(up, up_null, rtol=1e-12)
    np.testing.assert_allclose(down, down_null, rtol=1e-12)
    assert np.all(up > 0)

    # Perturbed layer temps change the fluxes (the argument is live).
    tlay_hot = tlay_mid + 5.0
    up_hot = np.zeros_like(up)
    down_hot = np.zeros_like(down)
    assert lib.grt_longwave_fluxes(opt, ts, _dptr(tlev), _dptr(tlay_hot),
                                   _dptr(emis), _dptr(up_hot),
                                   _dptr(down_hot)) == 0
    assert not np.allclose(down_hot, down)
    lib.grt_destroy(opt)
    lib.grt_destroy(grid)


def test_optics_add_and_properties(lib):
    grid = ctypes.c_int64()
    lib.grt_create_spectral_grid(ctypes.c_double(1.0), ctypes.c_double(4.0),
                                 ctypes.c_double(1.0), ctypes.byref(grid))
    a = ctypes.c_int64()
    b = ctypes.c_int64()
    res = ctypes.c_int64()
    for h in (a, b, res):
        assert lib.grt_create_optics(ctypes.c_int(2), grid,
                                     ctypes.byref(h)) == 0
    from grtcode_jax.bindings import capi_impl
    capi_impl._get(a.value)["tau"][:] = 1.0
    capi_impl._get(b.value)["tau"][:] = 2.0
    parts = np.array([a.value, b.value], dtype=np.int64)
    assert lib.grt_add_optics(
        res, parts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int(2)) == 0
    n = 2 * 4
    tau = np.zeros(n)
    omega = np.zeros(n)
    g = np.zeros(n)
    assert lib.grt_optics_properties(res, _dptr(tau), _dptr(omega),
                                     _dptr(g)) == 0
    np.testing.assert_allclose(tau, 3.0, rtol=1e-6)
    for h in (a, b, res, grid):
        lib.grt_destroy(h)
