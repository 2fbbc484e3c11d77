"""Numerical-safety debug mode: NaN trapping + range guards.

Equivalent of the reference's FP-exception macros and range guards
(utilities/src/debug.h:186-248 wraps every solver expression in
fetestexcept checks; grtcode_config.h:60-99 defines in_range guards),
which are compiled out with -DFAST and unavailable on the GPU.  Here the
equivalents are:

  * ``debug_mode()`` — context manager enabling jax_debug_nans, so any
    NaN/Inf produced inside jitted code raises at the producing op
    (SURVEY.md §5: the debug-mode analogue of trap-all-FP-exceptions);
  * ``validate_atmosphere()`` — host-side range guards over driver inputs
    mirroring the reference's temperature/probability/zenith limits,
    raising ValueError (GRTCODE_RANGE_ERR across the C ABI);
  * ``checked()`` — jax.experimental.checkify wrapper that turns a jitted
    function into one returning (error, value), for in-graph guards that
    must survive jit (the reference's device-side `sentinel` macro has no
    other equivalent).

Production runs skip all of this, exactly like the reference's -DFAST.
"""
from __future__ import annotations

import contextlib

import numpy as np

from .. import constants


@contextlib.contextmanager
def debug_mode(nans: bool = True, infs: bool = True):
    """Trap NaN/Inf production inside jit (debug.h:186-248 equivalent).

    Note: under debug_nans jax re-runs failing computations un-jitted to
    locate the op — expect a large slowdown, like the reference without
    -DFAST.
    """
    import jax

    old_nans = jax.config.jax_debug_nans
    old_infs = jax.config.jax_debug_infs
    jax.config.update("jax_debug_nans", nans)
    jax.config.update("jax_debug_infs", infs)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", old_nans)
        jax.config.update("jax_debug_infs", old_infs)


def _in_range(name, value, lo, hi):
    a = np.asarray(value)
    if a.size and (np.any(a < lo) | np.any(a > hi)):
        bad = float(a.min()) if np.any(a < lo) else float(a.max())
        raise ValueError(
            f"{name} value {bad} outside allowed range [{lo}, {hi}]")


def validate_atmosphere(atm) -> None:
    """Host-side range guards over an Atmosphere, mirroring the
    reference's config limits (grtcode_config.h:52-99): layer count,
    temperatures, pressures, probabilities, zenith cosines, solar flux.
    """
    nlayers = atm.level_pressure.shape[-1] - 1
    if not (1 <= nlayers <= constants.MAX_NUM_LAYERS):
        raise ValueError(
            f"number of layers {nlayers} outside [1, "
            f"{constants.MAX_NUM_LAYERS}]")
    for name in ("level_temperature", "layer_temperature",
                 "surface_temperature"):
        _in_range(name, getattr(atm, name), constants.MIN_TEMPERATURE,
                  constants.MAX_TEMPERATURE)
    _in_range("level_pressure", atm.level_pressure, 0.0, np.inf)
    if atm.cos_zenith is not None:
        _in_range("cos_zenith", atm.cos_zenith, -np.inf, 1.0)
    if atm.total_solar_irradiance is not None:
        _in_range("total_solar_irradiance", atm.total_solar_irradiance,
                  0.0, np.inf)
    if atm.cloud_fraction is not None:
        _in_range("cloud_fraction", atm.cloud_fraction, 0.0, 1.0)
    for vmr_dict in (atm.ppmv, atm.cfc_ppmv, atm.cia_ppmv):
        for k, v in (vmr_dict or {}).items():
            _in_range(f"ppmv[{k}]", v, 0.0, 1e6)


def checked(fn):
    """checkify a jittable function: returns ``(error, value)``; call
    ``error.throw()`` on the host to surface in-graph guard failures
    (jax.experimental.checkify docs; the in-jit analogue of the
    reference's catch/raise chain)."""
    from jax.experimental import checkify

    return checkify.checkify(
        fn, errors=checkify.float_checks | checkify.user_checks)
