"""Sharded two-band clear-sky radiative transfer step.

The flagship forward pass: per column, gas optical depth on the LW and SW
grids (line-by-line Voigt + continua/CFC/CIA), the four-stream longwave
solver, Rayleigh scattering + delta-Eddington/adding shortwave solver, and
trapezoid-integrated per-level fluxes — the same per-column computation as
the reference driver's clear-clean-sky tier
(framework/src/driver.c:360-599).

Since round 3 this is a thin adapter over
:meth:`grtcode_jax.framework.driver.RadiationDriver._step` — ONE step
implementation serves the unsharded driver, all three sky tiers, and the
(columns x spectral) mesh decomposition (the columns axis is the
reference's SLURM `-x/-X` slices; spectral shards psum exact per-block
trapezoid partial integrals).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from ..framework.driver import RadiationDriver
from ..gas_optics.gas_optics import GasOptics
from ..solvers.solar_flux import SolarFlux

DIFFUSE_MU = 0.5


def stack_vmr(gas: GasOptics, vmr: dict, group: str = "molecules"):
    """Stack a {species id -> (..., nlevels)} dict into (..., M, nlevels)
    following the gas-optics registration order (so the array form is stable
    under jit/shard_map)."""
    if group == "molecules":
        ids = list(gas.molecules)
    elif group == "cfcs":
        ids = list(gas.cfcs)
    elif group == "cias":
        ids = sorted({s for s1, s2, _ in gas.cias for s in (s1, s2)})
    else:
        raise ValueError(group)
    if not ids:
        return None
    return jnp.stack([jnp.asarray(vmr[i], jnp.float32) for i in ids],
                     axis=-2)


def _unstack(gas: GasOptics, rows, group: str):
    """(..., M, nlevels) stacked vmr -> {species id: (..., nlevels)}."""
    if group == "molecules":
        ids = list(gas.molecules)
    elif group == "cfcs":
        ids = list(gas.cfcs)
    else:
        ids = sorted({s for s1, s2, _ in gas.cias for s in (s1, s2)})
    return {i: rows[..., k, :] for k, i in enumerate(ids)}


@dataclasses.dataclass
class ClearSkyRT:
    """Two-band clear(-clean)-sky radiative transfer over a device mesh.

    Attributes:
      lw_gas: GasOptics bound to the longwave grid.
      sw_gas: GasOptics bound to the shortwave grid (None = LW only, like
        the shipped ERA5 binary, era5/src/era5.c:406-415).
      solar: normalized incident solar spectrum on the SW grid.
    """

    lw_gas: GasOptics
    sw_gas: GasOptics | None = None
    solar: SolarFlux | None = None

    def step(self, mesh: Mesh | None = None, integrated: bool = True):
        """Build the jitted batched step function.

        The returned fn takes a dict batch with arrays:
          p_lev, t_lev: (B, nlevels) [mb], [K]
          t_surf, emis, mu_dir, albedo_dir, albedo_dif, tsi: (B,)
          vmr_lw: (B, M_lw, nlevels); vmr_sw: (B, M_sw, nlevels)
          optional cfc_vmr_lw / cia_vmr_lw: (B, C, nlevels)
        and returns {"rlu", "rld", "rsu", "rsd"}: (B, nlevels) integrated
        fluxes [W m-2], or (B, nlevels, nw_band) spectra when
        ``integrated=False`` (under a mesh each shard computes its
        wavenumber block and a tiled all_gather reassembles the band).

        With a mesh, the batch axis shards over "columns" and each band's
        spectral grid splits into contiguous blocks over "spectral".
        """
        if self.sw_gas is not None and self.solar is None:
            raise ValueError("sw_gas set but no solar flux")
        driver = RadiationDriver(lw_gas=self.lw_gas, sw_gas=self.sw_gas,
                                 solar=self.solar)
        inner = driver._step(clean=True, clear=True, integrated=integrated,
                             mesh=mesh)
        has_sw = self.sw_gas is not None
        nw_lw = self.lw_gas.grid.n
        nw_sw = self.sw_gas.grid.n if has_sw else nw_lw

        def fn(batch):
            t_lev = jnp.asarray(batch["t_lev"], jnp.float32)
            col = {
                "p_lev": jnp.asarray(batch["p_lev"], jnp.float32),
                "t_lev": t_lev,
                "t_lay": 0.5 * (t_lev[:, :-1] + t_lev[:, 1:]),
                "t_surf": jnp.asarray(batch["t_surf"], jnp.float32),
                "emis": jnp.asarray(batch["emis"], jnp.float32),
                "vmr_lw": _unstack(self.lw_gas, batch["vmr_lw"],
                                   "molecules"),
                "cfc_vmr": (_unstack(self.lw_gas, batch["cfc_vmr_lw"],
                                     "cfcs")
                            if "cfc_vmr_lw" in batch else {}),
                "cia_vmr": (_unstack(self.lw_gas, batch["cia_vmr_lw"],
                                     "cias")
                            if "cia_vmr_lw" in batch else {}),
            }
            if has_sw:
                col.update({
                    "mu": jnp.asarray(batch["mu_dir"], jnp.float32),
                    "tsi": jnp.asarray(batch["tsi"], jnp.float32),
                    "albedo_dir": jnp.asarray(batch["albedo_dir"],
                                              jnp.float32),
                    "albedo_dif": jnp.asarray(batch["albedo_dif"],
                                              jnp.float32),
                    "vmr_sw": _unstack(self.sw_gas, batch["vmr_sw"],
                                       "molecules"),
                })
            out = inner(col, None)["csaf"]
            if not integrated and mesh is not None:
                # Gathered spectral blocks are tile-padded per shard;
                # trim each band back to its grid length.
                out = {k: v[..., :nw_lw if k in ("rlu", "rld") else nw_sw]
                       for k, v in out.items()}
            return out

        return jax.jit(fn)
