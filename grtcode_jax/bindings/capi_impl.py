"""Python half of the C ABI (Equivalent of fortran-bindings/).

The C++ shim (native/grtcode_jax_c.cpp) embeds CPython and calls the
functions in this module.  Opaque reference structs (Device_t, SpectralGrid_t,
Optics_t, GasOptics_t, SolarFlux_t — fortran-bindings/malloc_structs.c:40-67)
become integer handles into a process-global registry; buffers cross the
boundary as writable memoryviews wrapped with ``np.frombuffer``.

API surface mirrors the reference F90 wrappers
(fortran-bindings/grtcode_fortran.F90:585-893): device / spectral grid /
optics / solar flux / gas optics / rayleigh, plus LW/SW flux entry points the
reference only exposes from C.

Everything here is host-side orchestration; the compute stays the jit-compiled
JAX/Pallas pipeline.
"""
from __future__ import annotations

import itertools
import threading

import numpy as np

# Heavyweight imports happen lazily so `import capi_impl` inside the embedded
# interpreter is fast; jax loads on first compute call.

_registry: dict[int, object] = {}
_next_handle = itertools.count(1)
_lock = threading.Lock()
_default_device = None  # jax.Device chosen via use_device(), or None

GRTCODE_SUCCESS = 0


def _register(obj) -> int:
    with _lock:
        h = next(_next_handle)
        _registry[h] = obj
    return h


def _get(handle: int):
    return _registry[int(handle)]


def destroy(handle: int) -> int:
    """Generic destroy_* (grtcode_fortran.F90:634,704,765)."""
    _registry.pop(int(handle), None)
    return GRTCODE_SUCCESS


def set_verbosity(level: int) -> int:
    """grt_set_verbosity (grtcode_set_verbosity, verbosity.c:28-44)."""
    from ..utils import verbosity as vb
    vb.set_verbosity(int(level))
    return GRTCODE_SUCCESS


def _f64(buf, n=None):
    a = np.frombuffer(buf, dtype=np.float64)
    return a if n is None else a[: int(n)]


# -- device (utilities/src/device.c:26-75) ---------------------------------

def _resolve_device(device_id: int):
    """id >= 0 -> jax.devices()[id]; -1 -> host CPU (HOST_ONLY,
    utilities/src/device.h:26-34)."""
    import jax

    if device_id < 0:
        return jax.devices("cpu")[0]
    devs = jax.devices()
    if device_id >= len(devs):
        raise IndexError(
            f"device id {device_id} out of range ({len(devs)} devices)")
    return devs[device_id]


def create_device(device_id: int) -> int:
    """Device_t equivalent: resolves to a concrete jax.Device at creation
    time (create_device, utilities/src/device.c:53-75).  The first device
    created becomes the process default for all compute entry points, like
    the reference where the Device_t passed to create_gas_optics governs
    placement; use_device() switches it explicitly."""
    dev = _resolve_device(int(device_id))
    h = _register({"kind": "device", "id": int(device_id), "device": dev})
    global _default_device
    if _default_device is None:
        _default_device = dev
    return h


def use_device(handle: int) -> int:
    """Makes the device behind ``handle`` the default for subsequent compute
    calls (grt_use_device)."""
    global _default_device
    _default_device = _get(handle)["device"]
    return GRTCODE_SUCCESS


def _device_scope():
    """Context manager placing jit dispatch on the selected device."""
    import contextlib

    import jax

    if _default_device is None:
        return contextlib.nullcontext()
    return jax.default_device(_default_device)


def num_devices() -> int:
    import jax

    return len(jax.devices())


# -- spectral grid (utilities/src/spectral_grid.c:32-112) -------------------

def create_spectral_grid(w0: float, wn: float, dw: float) -> int:
    from ..spectral import SpectralGrid

    return _register(SpectralGrid(float(w0), float(wn), float(dw)))


def spectral_grid_properties(handle: int, out) -> int:
    """Writes [w0, n, dw] into a 3-double buffer (f_spectral_grid_properties,
    grtcode_fortran.F90:657-665)."""
    g = _get(handle)
    o = _f64(out, 3)
    o[0], o[1], o[2] = g.w0, float(g.n), g.dw
    return GRTCODE_SUCCESS


# -- optics container (utilities/src/optics.c:84-357) -----------------------

def create_optics(num_layers: int, grid_handle: int) -> int:
    grid = _get(grid_handle)
    return _register({
        "kind": "optics", "grid": grid, "nlayers": int(num_layers),
        "tau": np.zeros((int(num_layers), grid.n)),
        "omega": np.zeros((int(num_layers), grid.n)),
        "g": np.zeros((int(num_layers), grid.n)),
    })


def optics_size(handle: int) -> int:
    """Element count of each optics array (layers x wavenumbers) — lets the
    C shim size memoryviews without duplicating shape logic."""
    return int(_get(handle)["tau"].size)


def optics_levels_size(handle: int) -> int:
    """Element count of a per-level flux array ((layers+1) x wavenumbers)."""
    o = _get(handle)
    return int((o["nlayers"] + 1) * o["grid"].n)


def optics_num_wavenumbers(handle: int) -> int:
    return int(_get(handle)["grid"].n)


def optics_properties(handle: int, tau_out, omega_out, g_out) -> int:
    o = _get(handle)
    n = o["tau"].size
    _f64(tau_out, n)[:] = o["tau"].ravel()
    _f64(omega_out, n)[:] = o["omega"].ravel()
    _f64(g_out, n)[:] = o["g"].ravel()
    return GRTCODE_SUCCESS


def add_optics(result_handle: int, handles) -> int:
    """Weighted combine (add_optics_objects, optics.c:128-148) of the optics
    objects named by ``handles`` (int64 buffer) into ``result_handle``."""
    import jax.numpy as jnp

    from ..optics import Optics, combine

    hs = np.frombuffer(handles, dtype=np.int64)
    parts = [_get(int(h)) for h in hs]
    with _device_scope():
        combined = combine([
            Optics(jnp.asarray(p["tau"]), jnp.asarray(p["omega"]),
                   jnp.asarray(p["g"])) for p in parts])
    res = _get(result_handle)
    res["tau"] = np.asarray(combined.tau, np.float64)
    res["omega"] = np.asarray(combined.omega, np.float64)
    res["g"] = np.asarray(combined.g, np.float64)
    return GRTCODE_SUCCESS


# -- solar flux (shortwave/src/solar_flux.c:27-99) ---------------------------

def create_solar_flux(grid_handle: int, path: str) -> int:
    from ..solvers.solar_flux import SolarFlux

    return _register(SolarFlux.from_csv(path, _get(grid_handle)))


def solar_flux_size(handle: int) -> int:
    return int(_get(handle).grid.n)


def solar_flux_properties(handle: int, out) -> int:
    sf = _get(handle)
    flux = np.asarray(sf.incident_flux, np.float64)
    _f64(out, flux.size)[:] = flux
    return GRTCODE_SUCCESS


# -- gas optics (gas-optics/src/gas_optics.c:51-464) -------------------------

def create_gas_optics(grid_handle: int, num_levels: int, hitran_path: str,
                      h2o_ctm_dir: str, o3_ctm_file: str) -> int:
    from ..gas_optics.continua import OzoneContinuum, WaterVaporContinuum
    from ..gas_optics.gas_optics import GasOptics

    grid = _get(grid_handle)
    h2o = (WaterVaporContinuum.from_directory(h2o_ctm_dir, grid)
           if h2o_ctm_dir else None)
    o3 = (OzoneContinuum.from_file(o3_ctm_file, grid) if o3_ctm_file else None)
    go = GasOptics(grid, hitran_path=hitran_path or None, h2o_ctm=h2o,
                   o3_ctm=o3)
    return _register({"kind": "gas_optics", "go": go,
                      "nlev": int(num_levels), "ppmv": {}, "cfc_ppmv": {},
                      "cia_ppmv": {}, "cia_ids": {}, "step": None})


def gas_optics_num_levels(handle: int) -> int:
    return int(_get(handle)["nlev"])


def add_molecule(handle: int, mol_id: int, min_line_center: float,
                 max_line_center: float) -> int:
    """min/max <= 0 mean 'use grid bounds' (f_add_molecule passes huge
    defaults, grtcode_fortran.F90:777-785)."""
    st = _get(handle)
    st["go"].add_molecule(
        int(mol_id),
        None if min_line_center <= 0 else float(min_line_center),
        None if max_line_center <= 0 else float(max_line_center))
    st["step"] = None
    return GRTCODE_SUCCESS


def num_molecules(handle: int) -> int:
    return len(_get(handle)["go"].molecules)


def set_molecule_ppmv(handle: int, mol_id: int, ppmv) -> int:
    st = _get(handle)
    st["ppmv"][int(mol_id)] = _f64(ppmv, st["nlev"]).copy()
    return GRTCODE_SUCCESS


def add_cfc(handle: int, cfc_id: int, path: str) -> int:
    st = _get(handle)
    st["go"].add_cfc(int(cfc_id), path)
    st["step"] = None
    return GRTCODE_SUCCESS


def set_cfc_ppmv(handle: int, cfc_id: int, ppmv) -> int:
    st = _get(handle)
    st["cfc_ppmv"][int(cfc_id)] = _f64(ppmv, st["nlev"]).copy()
    return GRTCODE_SUCCESS


def add_cia(handle: int, species1: int, species2: int, path: str) -> int:
    st = _get(handle)
    st["go"].add_cia(int(species1), int(species2), path)
    st["step"] = None
    return GRTCODE_SUCCESS


def set_cia_ppmv(handle: int, species_id: int, ppmv) -> int:
    st = _get(handle)
    st["cia_ppmv"][int(species_id)] = _f64(ppmv, st["nlev"]).copy()
    return GRTCODE_SUCCESS


def calculate_optical_depth(handle: int, p_mb, t, optics_handle: int) -> int:
    """f_calculate_optics (grtcode_fortran.F90:845-853) -> fills the optics
    object with absorption-only gas tau.  jit-cached per GasOptics."""
    import jax

    st = _get(handle)
    go = st["go"]
    nlev = st["nlev"]
    p = _f64(p_mb, nlev)
    temp = _f64(t, nlev)
    if st["step"] is None:
        mol_ids = sorted(go.molecules)
        cfc_ids = sorted(go.cfcs)
        cia_ids = sorted({s for s1, s2, _ in go.cias for s in (s1, s2)})

        @jax.jit
        def step(p, t, vmr, cfc_vmr, cia_vmr):
            return go.optical_depth(
                p, t, dict(zip(mol_ids, vmr)),
                cfc_vmr=dict(zip(cfc_ids, cfc_vmr)),
                cia_vmr=dict(zip(cia_ids, cia_vmr)))

        st["step"] = (step, mol_ids, cfc_ids, cia_ids)
    step, mol_ids, cfc_ids, cia_ids = st["step"]
    to_vmr = lambda d, ids: [d[i] * 1e-6 for i in ids]  # noqa: E731
    with _device_scope():
        tau = step(p.astype(np.float32), temp.astype(np.float32),
                   to_vmr(st["ppmv"], mol_ids),
                   to_vmr(st["cfc_ppmv"], cfc_ids),
                   to_vmr(st["cia_ppmv"], cia_ids))
    out = _get(optics_handle)
    out["tau"] = np.asarray(tau, np.float64)
    out["omega"][:] = 0.0
    out["g"][:] = 0.0
    return GRTCODE_SUCCESS


# -- rayleigh (shortwave/src/rayleigh.c:100-144) -----------------------------

def rayleigh_scattering(optics_handle: int, p_mb) -> int:
    from ..solvers.rayleigh import rayleigh_optics

    o = _get(optics_handle)
    nlev = o["nlayers"] + 1
    with _device_scope():
        opt = rayleigh_optics(_f64(p_mb, nlev), o["grid"])
    o["tau"] = np.asarray(opt.tau, np.float64)
    o["omega"] = np.asarray(opt.omega, np.float64)
    o["g"] = np.asarray(opt.g, np.float64)
    return GRTCODE_SUCCESS


# -- solvers (C-only in the reference; longwave.c:312, shortwave.c:506) ------

def longwave_fluxes(optics_handle: int, t_surf: float, t_levels, t_layers,
                    emis, flux_up_out, flux_down_out) -> int:
    """Mirrors calculate_lw_fluxes (longwave/src/longwave.c:312-353): layer
    temperatures are an explicit argument; an empty/None ``t_layers`` falls
    back to level midpoints (documented approximation, not silent)."""
    import jax.numpy as jnp

    from ..solvers.longwave import longwave_fluxes as lw

    o = _get(optics_handle)
    nlev = o["nlayers"] + 1
    tl = _f64(t_levels, nlev)
    grid = o["grid"]
    em = _f64(emis, grid.n)
    tlay = (0.5 * (tl[:-1] + tl[1:]) if t_layers is None
            else _f64(t_layers, o["nlayers"]).copy())
    with _device_scope():
        up, down = lw(jnp.asarray(o["tau"], jnp.float32),
                      jnp.asarray(o["omega"], jnp.float32),
                      jnp.float32(t_surf), jnp.asarray(tlay, jnp.float32),
                      jnp.asarray(tl, jnp.float32),
                      jnp.asarray(em, jnp.float32), grid.wavenumbers())
    _f64(flux_up_out, up.size)[:] = np.asarray(up, np.float64).ravel()
    _f64(flux_down_out, down.size)[:] = np.asarray(down, np.float64).ravel()
    return GRTCODE_SUCCESS


def shortwave_fluxes(optics_handle: int, mu_dir: float, mu_dif: float,
                     albedo_dir, albedo_dif, tsi: float, solar_handle: int,
                     flux_up_out, flux_down_out) -> int:
    import jax.numpy as jnp

    from ..solvers.shortwave import shortwave_fluxes as sw

    o = _get(optics_handle)
    grid = o["grid"]
    sf = _get(solar_handle)
    with _device_scope():
        up, down = sw(jnp.asarray(o["tau"], jnp.float32),
                      jnp.asarray(o["omega"], jnp.float32),
                      jnp.asarray(o["g"], jnp.float32),
                      jnp.float32(mu_dir), jnp.float32(mu_dif),
                      jnp.asarray(_f64(albedo_dir, grid.n), jnp.float32),
                      jnp.asarray(_f64(albedo_dif, grid.n), jnp.float32),
                      jnp.float32(tsi),
                      jnp.asarray(sf.incident_flux, jnp.float32))
    _f64(flux_up_out, up.size)[:] = np.asarray(up, np.float64).ravel()
    _f64(flux_down_out, down.size)[:] = np.asarray(down, np.float64).ravel()
    return GRTCODE_SUCCESS
