"""The shared radiation driver: batched sky-tier flux computation.

Re-design of driver()/column_calculation (framework/src/driver.c:360-713):
the serial per-(time, column) loop becomes one jitted batched computation.
Sky tiers mirror the reference:

  CSAF  clear-sky aerosol-free: gas + Rayleigh          (driver.c:380-424)
  CS    clear-sky with aerosols                         (driver.c:426-473)
  AF    all-sky aerosol-free: + stochastic clouds       (driver.c:475-599)

The LW pass always runs; the SW pass only contributes where cos(zenith) > 0
(driver.c:706).  Gas optical depth per band is computed once and shared by
every tier (as in column_calculation, where optics_gas is reused).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from .. import constants
from ..gas_optics.gas_optics import GasOptics, _pad_table
from ..optics import Optics, combine
from ..solvers.longwave import longwave_fluxes
from ..solvers.rayleigh import rayleigh_tau
from ..solvers.shortwave import shortwave_fluxes
from ..solvers.solar_flux import SolarFlux
from ..utils import curtis_godson as cg
from ..utils.interp import (block_trapezoid_weights, interpolate_to_grid_np,
                            trapezoid_uniform)
from .atmosphere import Atmosphere

DIFFUSE_MU = 0.5  # cosine_diffuse_angle (driver.c:109)


@dataclasses.dataclass
class FluxResults:
    """Per-tier fluxes: {"csaf"|"cs"|"af" -> {"rlu"|"rld"|"rsu"|"rsd" ->
    (B, nlevels) integrated [W m-2] or (B, nlevels, nw) spectral}}."""

    tiers: dict
    integrated: bool

    _TIER_SUFFIX = {"CSAF": "csaf", "CS": "cs", "AF": "af"}

    def variable(self, name: str) -> np.ndarray:
        """Extract a reference-named variable (driver.h:17-92), e.g.
        RLUTCSAF -> TOA upwelling LW clear-sky aerosol-free, shape (B,)."""
        m = name.upper()
        band = {"L": "l", "S": "s"}[m[1]]
        direction = {"U": "u", "D": "d"}[m[2]]
        rest = m[3:]
        level = None
        if rest.startswith("T"):
            level, rest = 0, rest[1:]
        elif rest.startswith("S") and rest not in ("CS", "CSAF"):
            level, rest = -1, rest[1:]
        if rest not in self._TIER_SUFFIX:
            # Unsuffixed names (RLU, RSDT, ...) are driver.h's full-sky
            # (aerosols + clouds) slots; column_calculation never fills
            # them (driver.c computes CSAF/CS/AF only) and neither do we.
            raise KeyError(
                f"{name}: no '{rest}' sky tier — the driver produces "
                "CSAF/CS/AF variables only (driver.c:380-599)")
        tier = self._TIER_SUFFIX[rest]
        data = self.tiers[tier][f"r{band}{direction}"]
        return np.asarray(data[:, level] if level is not None else data)


@dataclasses.dataclass
class RadiationDriver:
    """Holds the per-band gas optics + solar spectrum and runs sky tiers.

    cloud_optics: optional callable implementing the all-sky tier's band
    cloud optics (clouds/clouds_lib.c:80-150 equivalent); signature
    ``(cloud_args: dict, grid) -> (Optics_liquid, Optics_ice)`` operating on
    batched arrays.
    """

    lw_gas: GasOptics
    sw_gas: GasOptics | None = None
    solar: SolarFlux | None = None
    cloud_optics: Callable | None = None
    num_subcolumns: int = 1   # driver.c:503 (reference uses 1)
    cloud_seed: int = 0
    # SW solver choice: "two_stream" (delta-Eddington + Meador-Weaver +
    # adding, the default) or "disort" (16-stream discrete ordinates —
    # the reference's optional --enable-disort build).
    sw_solver: str = "two_stream"
    disort_streams: int = 16
    # jitted-step memo: run() is called once per batch; without this every
    # call would rebuild the closures and re-trace.  init=False so
    # dataclasses.replace() never shares a populated cache between driver
    # variants; the solver configuration is ALSO part of the memo key.
    _step_cache: dict = dataclasses.field(default_factory=dict, init=False,
                                          repr=False)

    # -- host-side spectral surface prep (atmospheric_column,
    #    driver.c:100-115: linear interp, constant extrapolation) ----------
    def _surface_spectra(self, atm: Atmosphere):
        B = atm.batch
        nw_lw = self.lw_gas.grid.n
        if atm.emissivity is not None:
            emis = np.stack([
                interpolate_to_grid_np(self.lw_gas.grid, atm.emissivity_grid,
                                       atm.emissivity[b],
                                       extrapolate="constant")
                for b in range(B)])
        else:
            emis = np.ones((B, nw_lw))
        albedo = None
        if self.sw_gas is not None:
            nw_sw = self.sw_gas.grid.n
            if atm.albedo is not None:
                albedo = np.stack([
                    interpolate_to_grid_np(self.sw_gas.grid, atm.albedo_grid,
                                           atm.albedo[b],
                                           extrapolate="constant")
                    for b in range(B)])
            else:
                albedo = np.zeros((B, nw_sw))
        return emis, albedo

    def run(self, atm: Atmosphere, integrated: bool = True,
            mesh=None, column_chunk: int | None = None,
            col_index=None,
            spectral_chunks: int | None = None) -> FluxResults:
        """Compute all applicable sky tiers for the batch.

        With ``mesh`` (a (columns x spectral) jax Mesh, parallel.make_mesh),
        the batch shards over the "columns" axis and each band's spectral
        grid splits into contiguous blocks over "spectral"; integrated
        fluxes reduce with psum using exact per-block trapezoid weights.
        All three sky tiers run under the same sharded step.

        ``column_chunk`` bounds device memory for ERA5-scale batches (the
        channel stack is ~6 x lines x rows x 4 B of device memory): the batch is
        processed in chunks of that many columns through ONE memoized
        jitted step (the tail chunk pads by repeating its first column,
        so no extra compile), and results concatenate on the host —
        the equivalent of the reference looping columns serially
        (driver.c:680-713) with a device-sized stride.

        ``col_index`` carries each column's GLOBAL id into the stochastic
        cloud keys (defaults to arange(batch)); the chunk recursion
        passes slices of it down so a chunked cloudy run reproduces the
        unchunked run's subcolumn realizations exactly.

        ``spectral_chunks`` streams each band through that many
        quantum-aligned spectral blocks SERIALLY inside one compiled
        step (single device, integrated output): production resolutions
        like 0.01 cm-1 then never materialize a band-global tau — the
        single-chip analogue of the mesh's spectral axis.
        """
        sc = 1 if spectral_chunks is None else int(spectral_chunks)
        ids = (np.arange(atm.batch) if col_index is None
               else np.asarray(col_index))
        if column_chunk is not None and atm.batch > column_chunk:
            parts = []
            for lo in range(0, atm.batch, column_chunk):
                idx = np.arange(lo, min(lo + column_chunk, atm.batch))
                n_pad = column_chunk - idx.size
                if n_pad:
                    idx = np.concatenate([idx, np.repeat(idx[:1], n_pad)])
                r = self.run(atm.subset(idx), integrated=integrated,
                             mesh=mesh, col_index=ids[idx],
                             spectral_chunks=spectral_chunks)
                parts.append((r, column_chunk - n_pad))
            tiers = {
                t: {k: np.concatenate(
                    [np.asarray(r.tiers[t][k])[:keep]
                     for r, keep in parts])
                    for k in parts[0][0].tiers[t]}
                for t in parts[0][0].tiers}
            return FluxResults(tiers=tiers, integrated=integrated)
        emis_np, albedo_np = self._surface_spectra(atm)
        f32 = jnp.float32

        dev = {
            "p_lev": jnp.asarray(atm.level_pressure, f32),
            "t_lev": jnp.asarray(atm.level_temperature, f32),
            "t_lay": jnp.asarray(atm.layer_temperature, f32),
            "t_surf": jnp.asarray(atm.surface_temperature, f32),
            "emis": jnp.asarray(emis_np, f32),
            "vmr_lw": {k: jnp.asarray(np.asarray(v, np.float64) * 1e-6,
                                      f32)
                       for k, v in atm.ppmv.items()
                       if k in self.lw_gas.molecules},
            "cfc_vmr": {k: jnp.asarray(np.asarray(v, np.float64) * 1e-6, f32)
                        for k, v in atm.cfc_ppmv.items()},
            "cia_vmr": {k: jnp.asarray(np.asarray(v, np.float64) * 1e-6, f32)
                        for k, v in atm.cia_ppmv.items()},
        }
        if self.sw_gas is not None:
            dev.update({
                "mu": jnp.asarray(
                    atm.cos_zenith if atm.cos_zenith is not None
                    else -np.ones(atm.batch), f32),
                "tsi": jnp.asarray(
                    atm.total_solar_irradiance
                    if atm.total_solar_irradiance is not None
                    else np.zeros(atm.batch), f32),
                "albedo_dir": jnp.asarray(albedo_np, f32),
                "albedo_dif": jnp.asarray(albedo_np, f32),
                "vmr_sw": {
                    k: jnp.asarray(np.asarray(v, np.float64) * 1e-6, f32)
                    for k, v in atm.ppmv.items()
                    if k in self.sw_gas.molecules},
            })
        if not atm.clean:
            dev.update({
                "aero_tau1um": jnp.asarray(
                    atm.aerosol_optical_depth_1um, f32),
                "aero_alpha": jnp.asarray(
                    np.broadcast_to(
                        np.asarray(atm.aerosol_angstrom_exponent,
                                   np.float64), (atm.batch,)), f32),
                "aero_omega": jnp.asarray(
                    atm.aerosol_single_scatter_albedo, f32),
                "aero_g": jnp.asarray(atm.aerosol_asymmetry_factor, f32),
            })
        cloud_args = None
        if not atm.clear:
            if self.cloud_optics is None:
                raise ValueError("cloudy atmosphere but no cloud_optics")
            cloud_args = {
                # Global column ids: subcolumn RNG keys fold these in, so
                # each column's cloud realization is independent of how
                # the batch is sharded over the mesh OR chunked.
                "col_index": jnp.asarray(ids, jnp.int32),
                "cloud_fraction": jnp.asarray(atm.cloud_fraction, f32),
                "liquid_water_content": jnp.asarray(
                    atm.liquid_water_content, f32),
                "ice_water_content": jnp.asarray(atm.ice_water_content, f32),
                "layer_thickness": jnp.asarray(atm.layer_thickness, f32),
                "layer_pressure": jnp.asarray(
                    0.5 * (atm.level_pressure[:, :-1]
                           + atm.level_pressure[:, 1:]), f32),
                "t_lay": jnp.asarray(atm.layer_temperature, f32),
            }

        # Night handling (the reference skips the SW pass per column iff
        # cos(zenith) <= 0, driver.c:706-713).  Three regimes:
        #   * no lit column -> dispatch the LW-only step (SW pipeline
        #     never computed; rsu/rsd are zeros);
        #   * a mixed batch -> DAY COMPACTION: gather lit columns into
        #     one bucket-padded sub-batch that runs LW+SW, the night
        #     columns into another that runs LW-only, and scatter both
        #     back — the SW gas optics + solver cost scales with the lit
        #     fraction instead of the batch (for ERA5, half the globe is
        #     night -> ~2x SW-phase saving).  Works sharded too: both
        #     sub-batches run under the SAME mesh (buckets round up to a
        #     multiple of the mesh's column axis), and spectral output
        #     gets SW-band-shaped zeros for the night bucket.
        #   * otherwise -> full batch with the post-hoc day mask.
        # Bucketing pads each sub-batch up to a power of two so the jit
        # step compiles per bucket size, not per lit count.
        from ..parallel.mesh import COLUMNS_AXIS

        n_cols_axis = 1 if mesh is None else mesh.shape[COLUMNS_AXIS]
        with_sw = self.sw_gas is not None
        lit = night = None
        if with_sw:
            mu_host = atm.cos_zenith
            if mu_host is None or not np.any(np.asarray(mu_host) > 0.0):
                with_sw = False
            else:
                mu_np = np.asarray(mu_host)
                lit = np.flatnonzero(mu_np > 0.0)
                night = np.flatnonzero(~(mu_np > 0.0))
                if not (0 < lit.size < atm.batch):
                    lit = night = None

        def bucket_pad(idx):
            b = 1
            while b < idx.size:
                b *= 2
            b = min(max(b, n_cols_axis), atm.batch)
            b = -(-b // n_cols_axis) * n_cols_axis
            return np.concatenate(
                [idx, np.repeat(idx[:1], b - idx.size)])

        if lit is not None and bucket_pad(lit).size >= atm.batch:
            # The lit bucket rounds up to the whole batch (> half the
            # columns are lit): compaction would save no SW work while
            # ADDING a night LW-only step — use the masked full-batch
            # path instead.
            lit = night = None

        if lit is not None:

            def gather(tree, idx):
                i = jnp.asarray(idx)
                return jax.tree.map(lambda a: a[i], tree)

            lit_p, night_p = bucket_pad(lit), bucket_pad(night)
            out_lit = self._step(atm.clean, atm.clear, integrated, mesh,
                                 with_sw=True, spectral_chunks=sc)(
                gather(dev, lit_p), gather(cloud_args, lit_p))
            out_night = self._step(atm.clean, atm.clear, integrated, mesh,
                                   with_sw=False, spectral_chunks=sc)(
                gather(dev, night_p), gather(cloud_args, night_p))

            def scatter(a_lit, a_night):
                full = np.zeros((atm.batch,) + a_lit.shape[1:],
                                a_lit.dtype)
                full[lit] = np.asarray(a_lit)[:lit.size]
                full[night] = np.asarray(a_night)[:night.size]
                return full

            out = jax.tree.map(scatter, jax.tree.map(np.asarray, out_lit),
                               jax.tree.map(np.asarray, out_night))
        else:
            out = self._step(atm.clean, atm.clear, integrated, mesh,
                             with_sw=with_sw,
                             spectral_chunks=sc)(dev, cloud_args)
        if not integrated and mesh is not None:
            # Sharded spectral blocks are tile-padded; trim each band
            # back to its grid length.
            nw_lw = self.lw_gas.grid.n
            nw_sw = (self.sw_gas.grid.n if self.sw_gas is not None
                     else nw_lw)
            out = {t: {k: v[..., :nw_lw if k in ("rlu", "rld") else nw_sw]
                       for k, v in d.items()}
                   for t, d in out.items()}
        return FluxResults(tiers=jax.tree.map(np.asarray, out),
                           integrated=integrated)

    # -- the jitted batched computation ------------------------------------
    def _step(self, clean: bool, clear: bool, integrated: bool, mesh=None,
              with_sw: bool = True, spectral_chunks: int = 1):
        """ONE step implementation for every sky tier, unsharded or over a
        (columns x spectral) mesh.  Under a mesh each shard computes its
        contiguous wavenumber block of gas/Rayleigh/aerosol/cloud optics
        and both solvers, and integrated fluxes psum over the spectral
        axis with exact per-block trapezoid weights.

        ``spectral_chunks > 1`` (single device, integrated) streams the
        SAME per-block computation SERIALLY inside one compiled step —
        a fori_loop over quantum-aligned spectral blocks accumulating
        the exactly-weighted integrals — so production resolutions
        (e.g. 0.01 cm-1, 324 901 LW points) never materialize a
        band-global tau (SURVEY hard-part #4) even without a mesh.

        ``with_sw=False`` builds the LW-only variant (night batches /
        the shipped-ERA5 configuration): SW fluxes are integrated zeros.
        """
        # The cloud_optics OBJECT itself is part of the key (not its id):
        # holding it in the memo dict keeps it alive, so a later rebind
        # can never alias a recycled address to a stale compiled step.
        key = (clean, clear, integrated, mesh, with_sw, spectral_chunks,
               self.sw_solver,
               self.disort_streams, self.num_subcolumns, self.cloud_seed,
               self.cloud_optics)
        try:
            return self._step_cache[key]
        except (KeyError, TypeError):   # TypeError: unhashable mesh
            pass
        fn = self._build_step(clean, clear, integrated, mesh, with_sw,
                              spectral_chunks)
        try:
            self._step_cache[key] = fn
        except TypeError:
            pass
        return fn

    def _build_step(self, clean: bool, clear: bool, integrated: bool,
                    mesh, with_sw: bool, spectral_chunks: int = 1):
        from ..parallel.mesh import COLUMNS_AXIS, SPECTRAL_AXIS

        if spectral_chunks > 1 and (mesh is not None or not integrated):
            raise ValueError("spectral_chunks streams serially on one "
                             "device with integrated output (use a mesh "
                             "for sharded or spectrally-resolved runs)")
        lwg = self.lw_gas.grid
        swg = (self.sw_gas.grid
               if self.sw_gas is not None and with_sw else None)
        sol_full = (self.solar.incident_flux if self.solar is not None
                    else jnp.zeros((1,), jnp.float32))
        S = spectral_chunks if mesh is None else mesh.shape[SPECTRAL_AXIS]

        def _block(n, quantum):
            """ceil(n / S) rounded up to the gas-optics block quantum
            (tile for the sampling methods, a whole bin group for the
            Pallas bin methods — block starts must stay aligned)."""
            return -(-(-(-n // S)) // quantum) * quantum

        chunked = mesh is not None or S > 1
        block_lw = (_block(lwg.n, self.lw_gas.block_quantum) if chunked
                    else lwg.n)
        block_sw = None
        if swg is not None:
            block_sw = (_block(swg.n, self.sw_gas.block_quantum)
                        if chunked else swg.n)
        # SW zero width for LW-only steps' placeholder outputs: spectral
        # mode needs SW-band-shaped zeros so a day-compacted night bucket
        # scatters consistently against the lit bucket's results.
        sw_zero_n = None
        if swg is None and self.sw_gas is not None and not integrated:
            g = self.sw_gas.grid
            sw_zero_n = (g.n if mesh is None
                         else _block(g.n, self.sw_gas.block_quantum))
        sol_padded = (_pad_table(sol_full, block_sw)
                      if swg is not None and chunked else sol_full)

        def core(col, cloud_args, start_lw, start_sw):
            """The whole tier set on one spectral block [start, start+block)
            of each band (the full band when unchunked)."""
            full = not chunked
            w_lw = jnp.float32(lwg.w0) + jnp.float32(lwg.dw) * (
                start_lw + jnp.arange(block_lw, dtype=jnp.int32)
            ).astype(jnp.float32)
            w_sw = None
            if swg is not None:
                w_sw = jnp.float32(swg.w0) + jnp.float32(swg.dw) * (
                    start_sw + jnp.arange(block_sw, dtype=jnp.int32)
                ).astype(jnp.float32)

            def reduce_lw(fx):
                if not integrated:
                    return fx
                if full:
                    return trapezoid_uniform(fx, lwg.dw)
                return (fx * block_trapezoid_weights(
                    start_lw, block_lw, lwg.n, lwg.dw)).sum(-1)

            def reduce_sw(fx):
                if not integrated:
                    return fx
                if full:
                    return trapezoid_uniform(fx, swg.dw)
                return (fx * block_trapezoid_weights(
                    start_sw, block_sw, swg.n, swg.dw)).sum(-1)

            def surface(val, block):
                """Spectral surface quantity: accepts a full/per-shard
                (B, nw) spectrum OR a (B,) grey value broadcast on the fly
                (the ClearSkyRT adapter's cheap form — no (B, nw)
                materialization outside the shard)."""
                val = jnp.asarray(val, jnp.float32)
                if val.ndim == 1:
                    return jnp.broadcast_to(val[:, None],
                                            (val.shape[0], block))
                return val

            def lw_tier(optics, c):
                flu, fld = longwave_fluxes(optics.tau, optics.omega,
                                           c["t_surf"], c["t_lay"],
                                           c["t_lev"],
                                           surface(c["emis"], block_lw),
                                           w_lw)
                return reduce_lw(flu), reduce_lw(fld)

            def sw_tier(optics, c):
                mu = jnp.maximum(c["mu"], 1e-6)
                sol = (sol_padded if full else jax.lax.dynamic_slice_in_dim(
                    sol_padded, jnp.asarray(start_sw, jnp.int32), block_sw))
                if self.sw_solver == "disort":
                    # Runtime equivalent of the reference's compile-time
                    # --enable-disort swap (configure.ac:97-106,
                    # disort_shortwave.c:18-86): the 16-stream
                    # discrete-ordinates solver replaces the two-stream
                    # delta-Eddington + adding path per column.
                    from ..solvers.disort import disort_shortwave

                    fsu, fsd = jax.vmap(
                        lambda t, o, gg, m, ad, ts: disort_shortwave(
                            t, o, gg, m, ad, ts, sol,
                            nstr=self.disort_streams))(
                        optics.tau, optics.omega, optics.g, mu,
                        surface(c["albedo_dir"], block_sw), c["tsi"])
                else:
                    fsu, fsd = shortwave_fluxes(
                        optics.tau, optics.omega, optics.g, mu,
                        jnp.full_like(mu, DIFFUSE_MU),
                        surface(c["albedo_dir"], block_sw),
                        surface(c["albedo_dif"], block_sw),
                        c["tsi"], sol)
                day = (c["mu"] > 0.0).astype(jnp.float32)[:, None]
                shp = day if integrated else day[..., None]
                return reduce_sw(fsu) * shp, reduce_sw(fsd) * shp

            def aerosol_optics(c, w):
                """Angstrom-exponent spectral aerosol optical depth
                (tau(lambda) = tau_1um * lambda_um^-alpha,
                utilities.c:45-74)."""
                lam_um = 1e4 / w                             # (nw,)
                tau = c["aero_tau1um"][:, :, None] * \
                    lam_um[None, None, :] ** (-c["aero_alpha"][:, None, None])
                omega = jnp.broadcast_to(c["aero_omega"][:, :, None],
                                         tau.shape)
                g = jnp.broadcast_to(c["aero_g"][:, :, None], tau.shape)
                return Optics(tau, omega, g)

            # optical_depth is batch-NATIVE: the (B, nlev) leading axis
            # flattens into the kernel's rows so the whole batch densifies
            # one fused kernel launch.  Do NOT wrap it in jax.vmap — that
            # replays the kernel per column.
            block_kw_lw = ({} if full else
                           dict(block_start=start_lw, block_size=block_lw))
            tau_lw = self.lw_gas.optical_depth(
                col["p_lev"], col["t_lev"], col["vmr_lw"],
                cfc_vmr=col["cfc_vmr"], cia_vmr=col["cia_vmr"],
                **block_kw_lw)
            gas_lw = Optics.from_tau(tau_lw)

            if swg is not None:
                block_kw_sw = ({} if full else
                               dict(block_start=start_sw,
                                    block_size=block_sw))
                tau_sw = self.sw_gas.optical_depth(
                    col["p_lev"], col["t_lev"], col["vmr_sw"],
                    cfc_vmr=col["cfc_vmr"], cia_vmr=col["cia_vmr"],
                    **block_kw_sw)
                p_atm = col["p_lev"] * constants.MB_TO_ATM
                ray = rayleigh_tau(cg.number_densities(p_atm), w_sw)
                gasray_sw = combine([
                    Optics.from_tau(tau_sw),
                    Optics(ray, jnp.ones_like(ray), jnp.zeros_like(ray))])

            tiers = {}

            def both(opt_lw, opt_sw, c):
                rlu, rld = lw_tier(opt_lw, c)
                if swg is not None:
                    rsu, rsd = sw_tier(opt_sw, c)
                else:
                    z = (jnp.zeros_like(rlu) if sw_zero_n is None else
                         jnp.zeros(rlu.shape[:-1] + (sw_zero_n,),
                                   rlu.dtype))
                    rsu = rsd = z
                return {"rlu": rlu, "rld": rld, "rsu": rsu, "rsd": rsd}

            tiers["csaf"] = both(gas_lw, gasray_sw if swg is not None
                                 else None, col)

            if not clean:
                aero_lw = aerosol_optics(col, w_lw)
                opt_lw = combine([gas_lw, aero_lw])
                opt_sw = None
                if swg is not None:
                    aero_sw = aerosol_optics(col, w_sw)
                    opt_sw = combine([gasray_sw, aero_sw])
                tiers["cs"] = both(opt_lw, opt_sw, col)

            if not clear:
                # All-sky aerosol-free: per-subcolumn stochastic cloud
                # optics, fluxes averaged over subcolumns
                # (driver.c:503-574).  The subcolumn sample depends only
                # on the key + cloud state, so every spectral shard sees
                # the same cloud realization.
                def one_subcolumn(key):
                    liq_lw, ice_lw, liq_sw, ice_sw = self.cloud_optics(
                        cloud_args, key, w_lw, w_sw)
                    opt_lw = combine([gas_lw, liq_lw, ice_lw])
                    opt_sw = None
                    if swg is not None:
                        opt_sw = combine([gasray_sw, liq_sw, ice_sw])
                    return both(opt_lw, opt_sw, col)

                keys = jax.random.split(
                    jax.random.PRNGKey(self.cloud_seed),
                    self.num_subcolumns)
                if self.num_subcolumns == 1:
                    tiers["af"] = one_subcolumn(keys[0])
                else:
                    subs = jax.lax.map(one_subcolumn, keys)
                    tiers["af"] = jax.tree.map(
                        lambda a: a.mean(axis=0), subs)

            return tiers

        # LW-only steps (night buckets / LW-only apps) never touch the
        # SW-only inputs: prune them so the mesh padding/sharding logic
        # below doesn't have to handle SW spectra without an SW block.
        sw_keys = ("mu", "tsi", "albedo_dir", "albedo_dif", "vmr_sw")

        def prune(col):
            if swg is not None:
                return col
            return {k: v for k, v in col.items() if k not in sw_keys}

        if mesh is None and S == 1:
            return jax.jit(lambda col, cloud_args: core(prune(col),
                                                        cloud_args, 0, 0))

        if mesh is None:
            # Serial spectral streaming: fori over S quantum-aligned
            # blocks, summing the exactly-weighted per-block integrals
            # (the single-chip analogue of the mesh path's psum).  The
            # per-column surface spectra pad to S x block and each
            # iteration slices its own window, exactly like the mesh
            # wrapper shards them.
            spec_pads = {"emis": block_lw, "albedo_dir": block_sw,
                         "albedo_dif": block_sw}

            def streamed(col, cloud_args):
                col = dict(prune(col))
                for key, blk in spec_pads.items():
                    if key in col and blk is not None and \
                            col[key].ndim == 2:
                        pad = S * blk - col[key].shape[-1]
                        col[key] = jnp.pad(col[key], ((0, 0), (0, pad)))

                def at_block(s):
                    c = dict(col)
                    for key, blk in spec_pads.items():
                        if key in c and blk is not None and \
                                c[key].ndim == 2:
                            c[key] = jax.lax.dynamic_slice_in_dim(
                                c[key], s * blk, blk, axis=1)
                    return c

                def body(s, acc):
                    t = core(at_block(s), cloud_args, s * block_lw,
                             s * (block_sw if block_sw is not None
                                  else 0))
                    return jax.tree.map(jnp.add, acc, t)

                shapes = jax.eval_shape(
                    lambda: core(at_block(jnp.int32(0)), cloud_args, 0, 0))
                acc0 = jax.tree.map(
                    lambda sd: jnp.zeros(sd.shape, sd.dtype), shapes)
                return jax.lax.fori_loop(0, S, body, acc0)

            return jax.jit(streamed)

        spectral_keys = ("emis", "albedo_dir", "albedo_dif")

        def local(col, cloud_args):
            s = jax.lax.axis_index(SPECTRAL_AXIS)
            tiers = core(col, cloud_args, s * block_lw,
                         s * (block_sw if block_sw is not None else 0))
            if integrated:
                # Exact per-block trapezoid weights were applied inside
                # core; the band integral is the sum over shards.
                return jax.lax.psum(tiers, SPECTRAL_AXIS)
            # Spectrally-resolved output: each shard holds one contiguous
            # block [s*block, (s+1)*block) of the band (tail shard
            # tile-padded), so a tiled all_gather along the wavenumber
            # axis reassembles the full spectrum on every shard; run()
            # trims the tail padding.  The reference always writes full
            # spectra whatever its rank layout (rfmip-irf.c:574-650).
            return jax.tree.map(
                lambda a: jax.lax.all_gather(
                    a, SPECTRAL_AXIS, axis=a.ndim - 1, tiled=True),
                tiers)

        def run(col, cloud_args):
            # Pad (B, nw) per-column spectra to S x block so they shard
            # evenly over the spectral axis; (B,) grey surfaces replicate
            # and broadcast inside the shard instead.
            col = dict(prune(col))
            for key, blk in (("emis", block_lw), ("albedo_dir", block_sw),
                             ("albedo_dif", block_sw)):
                if key in col and blk is not None and col[key].ndim == 2:
                    pad = S * blk - col[key].shape[-1]
                    col[key] = jnp.pad(col[key], ((0, 0), (0, pad)))
            in_specs = (
                {k: (P(COLUMNS_AXIS, SPECTRAL_AXIS)
                     if k in spectral_keys and v.ndim == 2 else
                     jax.tree.map(lambda _: P(COLUMNS_AXIS), v))
                 for k, v in col.items()},
                jax.tree.map(lambda _: P(COLUMNS_AXIS), cloud_args),
            )
            tier_names = ["csaf"] + ([] if clean else ["cs"]) + \
                ([] if clear else ["af"])
            out_specs = {t: {k: P(COLUMNS_AXIS)
                             for k in ("rlu", "rld", "rsu", "rsd")}
                         for t in tier_names}
            mapped = jax.shard_map(local, mesh=mesh, in_specs=in_specs,
                                   out_specs=out_specs, check_vma=False)
            return mapped(col, cloud_args)

        return jax.jit(run)
