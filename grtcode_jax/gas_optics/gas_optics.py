"""High-level gas-optics engine.

Equivalent of GasOptics_t + launch()
(gas-optics/src/gas_optics.c:51-464, launch.c:40-226): absorbers are
registered once (host-side data loading, grid binding); the forward pass
:meth:`GasOptics.optical_depth` is pure, jit-compilable device math
(Curtis-Godson prep -> per-molecule line pipeline -> continua -> CFC -> CIA).

Unlike the reference's mutate-then-launch API (set_molecule_ppmv ...), the
forward pass takes the full atmospheric state as arguments, so columns batch
with vmap and shard with pjit — and, better, it accepts a leading batch axis
natively: the (batch, layer) plane flattens into one "rows" axis so the whole
batch densifies a single fused kernel launch instead of replaying the kernel
under vmap.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants
from ..spectral import SpectralGrid
from ..utils import curtis_godson as cg
from . import lines as lines_mod
from . import pallas_kernels as pk
from . import tips as tips_mod
from . import bins as bins_mod
from .continua import OzoneContinuum, WaterVaporContinuum
from .hitran import LineCatalog, parse_par_file
from .molecules import MoleculeId
from .optical_depth import (accumulate_near_pointwise, accumulate_tiled,
                            optical_depth_line_sample)
from .xsec import CrossSectionTable


@dataclasses.dataclass
class GasOptics:
    """Registered absorbers bound to one spectral grid."""

    grid: SpectralGrid
    wcutoff: float = constants.DEFAULT_LINE_CUTOFF
    hitran_path: str | None = None
    h2o_ctm: WaterVaporContinuum | None = None
    o3_ctm: OzoneContinuum | None = None
    tips: object = None
    line_chunk: int = 1024
    # Optical-depth method (gas_optics.h:88-94 OpticalDepthMethod_t):
    #   "tiled" / "line_sample": exact per-point sampling over the +-cutoff
    #     window — the reference driver's production method
    #     (framework/src/driver.c:618), here as the fused Pallas kernel
    #     (GPU) or the jnp tile-gather (CPU).
    #   "scatter": line_sample via scan + scatter-add (portable ground
    #     truth).
    #   "wavenumber_sweep": bin sweep — wings at 3 points/bin,
    #     quadratically interpolated (kernels.c:177-304).
    #   "line_sweep": per-line local window + binned wings
    #     (kernels.c:306-406).
    method: str = "tiled"
    bin_width: float = 1.0     # [cm-1] for the bin-interpolated methods
    tile: int = 64             # spectral tile width (power of two)
    tile_lchunk: int = 128     # lines per jnp tiled reduction step
    # Fused line_sample kernel: "auto" (on a GPU, jnp elsewhere), "on"
    # (GPU only), "off" (jnp ground truth), "interpret" (the kernel on
    # the Pallas interpreter, for tests).
    pallas: str = "auto"
    molecules: dict = dataclasses.field(default_factory=dict)  # id -> GridLines
    tiles: dict = dataclasses.field(default_factory=dict)      # id -> LineTiles
    near_steps: dict = dataclasses.field(default_factory=dict)  # id -> int
    near_hw: dict = dataclasses.field(default_factory=dict)    # id -> int
    point_ranges: dict = dataclasses.field(default_factory=dict)  # id -> PointRanges
    line_ranges: dict = dataclasses.field(default_factory=dict)  # id -> pk.LineRanges
    cfcs: dict = dataclasses.field(default_factory=dict)       # id -> table
    cias: list = dataclasses.field(default_factory=list)       # (id1, id2, table)

    def __post_init__(self):
        if self.tips is None:
            self.tips = tips_mod.default_tips()
        if self.pallas not in ("auto", "on", "off", "interpret"):
            raise ValueError(f"pallas {self.pallas!r}: expected 'auto', "
                             "'on', 'off' or 'interpret'")
        if self.pallas in ("on", "interpret") and \
                self.method not in ("tiled", "line_sample"):
            raise ValueError(f"pallas={self.pallas!r}: method "
                             f"{self.method!r} has no fused kernel")
        if self.tile < 8 or self.tile & (self.tile - 1):
            raise ValueError(f"tile {self.tile}: expected a power of two "
                             ">= 8")
        if not (constants.MIN_LINE_CUTOFF <= self.wcutoff
                <= constants.MAX_LINE_CUTOFF):
            raise ValueError(f"cutoff {self.wcutoff} outside allowed range")
        # Cap the tile so even small grids split into >= ~8 tiles (keeps
        # spectral sharding meaningful in tests; production grids are far
        # larger than the default tile anyway).
        eighth = -(-self.grid.n // 8)
        self.tile = min(self.tile, max(8, 1 << (eighth.bit_length() - 1)))
        # ~1 cm-1 spectral bins for the bin-interpolated methods
        # (gas_optics.c:73-81).
        self.bins = bins_mod.create_spectral_bins(
            self.grid.n, self.grid.w0, self.grid.dw, self.bin_width)
        self._bin_ranges_cache = {}
        self._raw_bounds = {}

    @property
    def block_quantum(self) -> int:
        """Spectral-block alignment unit (block starts are tile-aligned)."""
        return self.tile

    @property
    def _fsteps(self) -> int:
        return int(math.ceil(self.wcutoff / self.grid.dw))

    def _use_kernel(self) -> bool:
        """Whether line_sample runs the fused kernel.  Decided from the
        backend at trace time; no path falls back quietly."""
        if self.method not in ("tiled", "line_sample") or \
                self.pallas == "off":
            return False
        if self.pallas == "interpret":
            return True
        backend = jax.default_backend()
        if self.pallas == "on" and backend != "gpu":
            raise ValueError(f"pallas='on': the fused kernel needs a GPU "
                             f"(backend is {backend!r})")
        return backend == "gpu"

    def _get_bin_ranges(self, mol_id: int) -> bins_mod.BinRanges:
        key = (mol_id, self.method)
        if key not in self._bin_ranges_cache:
            mode = ("bin_sweep" if self.method == "wavenumber_sweep"
                    else "line_sweep")
            self._bin_ranges_cache[key] = bins_mod.build_bin_ranges(
                self._raw_bounds[mol_id], self.bins, mode=mode,
                remote_cutoff=self.wcutoff)
        return self._bin_ranges_cache[key]

    # -- registration (host side, mirrors add_molecule/add_cfc/add_cia) ----
    def add_molecule(self, mol_id, min_line_center: float | None = None,
                     max_line_center: float | None = None):
        """Parse HITRAN lines for a molecule (gas_optics.c:228-290)."""
        mol_id = int(MoleculeId(mol_id))
        w0 = self.grid.w0 if min_line_center is None else min_line_center
        wn = self.grid.wn if max_line_center is None else max_line_center
        catalog = parse_par_file(self.hitran_path, mol_id, w0, wn,
                                 tips=self.tips)
        self.add_catalog(catalog)

    def add_catalog(self, catalog: LineCatalog):
        """Register a pre-built line catalog (tests / custom line lists)."""
        if catalog.mol_id in self.molecules:
            raise ValueError(f"molecule {catalog.mol_id} already added")
        bound = lines_mod.bind_to_grid(catalog, self.grid)
        self._raw_bounds[catalog.mol_id] = bound
        # Pad to the scan chunk so recompilation doesn't depend on the exact
        # line count modulo chunk.
        padded = bound.pad_to(
            max(self.line_chunk,
                -(-bound.num_lines // self.line_chunk) * self.line_chunk))
        self.molecules[catalog.mol_id] = padded
        fsteps = self._fsteps
        margin = lines_mod.shift_margin(padded, self.grid.dw)
        self.tiles[catalog.mol_id] = lines_mod.build_tiles(
            padded, self.grid.n, fsteps, tile=self.tile,
            shift_margin=margin, lane_multiple=self.tile_lchunk)
        near = min(lines_mod.near_core_halfwidth(padded, self.grid.dw),
                   fsteps)
        self.near_steps[catalog.mol_id] = near
        self.near_hw[catalog.mol_id] = near + margin
        self.point_ranges[catalog.mol_id] = lines_mod.build_point_ranges(
            padded, self.grid.n, near, shift_margin=margin)
        self.line_ranges[catalog.mol_id] = pk.build_line_ranges(
            padded.c0, self.grid.n, fsteps, self.tile, shift_margin=margin,
            near_hw=near + margin,
            region0_hw=lines_mod.region0_halfwidth(padded, self.grid.dw))

    def add_cfc(self, cfc_id, path: str):
        table = CrossSectionTable.from_file(int(cfc_id), path, self.grid)
        self.cfcs[int(cfc_id)] = table

    def add_cia(self, species1, species2, path: str):
        # The pressure-squared column factor (~7.9e46 [K atm-2 cm-5],
        # kernels.c:611-615) is folded into the stored table in f64: neither
        # it nor real CIA sigma (~1e-44 cm^5) fits f32, but the product does.
        table = CrossSectionTable.from_file(
            int(species1), path, self.grid,
            name=f"cia_{int(species1)}_{int(species2)}",
            scale=constants.CIA_COLUMN_FACTOR)
        self.cias.append((int(species1), int(species2), table))

    # -- forward pass ------------------------------------------------------
    def optical_depth(self, level_pressure_mb, level_temperature,
                      vmr: Mapping[int, jnp.ndarray],
                      cfc_vmr: Mapping[int, jnp.ndarray] | None = None,
                      cia_vmr: Mapping[int, jnp.ndarray] | None = None,
                      block_start=None, block_size: int | None = None):
        """Gas optical depth (..., nlayers, n_w).

        Args:
          level_pressure_mb: (nlevels,) or (B, nlevels) pressure [mb].
          level_temperature: same shape, temperature [K].
          vmr: molecule id -> level mole fraction (NOT ppmv; multiply
            ppmv by 1e-6, gas_optics.c:308-312), matching shape.
          cfc_vmr / cia_vmr: same for cross-section species / CIA species.
          block_start / block_size: when set, compute only the spectral
            window [block_start, block_start + block_size) — ``block_start``
            may be traced (spectral-shard index * block), ``block_size`` is
            static.  Result shape becomes (..., nlayers, block_size).

        Pure function of its array arguments — jit / vmap / pjit freely.
        A leading batch axis is handled natively (and preferred over vmap:
        the batch densifies one kernel launch).
        """
        cfc_vmr = cfc_vmr or {}
        cia_vmr = cia_vmr or {}
        p_in = jnp.asarray(level_pressure_mb, jnp.float32)
        batched = p_in.ndim == 2
        p2 = jnp.atleast_2d(p_in) * constants.MB_TO_ATM    # (B, nlev) [atm]
        t2 = jnp.atleast_2d(jnp.asarray(level_temperature, jnp.float32))
        B, nlev = p2.shape
        nlayers = nlev - 1
        rows = B * nlayers

        n2d = cg.number_densities(p2)
        pavg2, tavg2 = cg.layer_pressures_temperatures(p2, t2)
        pavg, tavg = pavg2.reshape(rows), tavg2.reshape(rows)

        start = 0 if block_start is None else block_start
        nw = self.grid.n if block_size is None else block_size

        def spectral(table):
            """Slice a (n_w,) grid table to the active window."""
            if block_start is None and block_size is None:
                return table
            return jax.lax.dynamic_slice_in_dim(
                _pad_table(table, nw), jnp.asarray(start, jnp.int32), nw)

        def lev(x):
            """Level-quantity input -> (B, nlev)."""
            return jnp.atleast_2d(jnp.asarray(x, jnp.float32))

        tau = jnp.zeros((rows, nw), jnp.float32)

        bin_method = self.method in ("wavenumber_sweep", "line_sweep")
        use_kernel = self._use_kernel()
        if bin_method:
            # Bins span the whole band, so under a spectral block the
            # full-band bin pipeline runs and the block slices out at the
            # end.
            bins_tau = jnp.zeros((rows, self.bins.n, bins_mod.NIP),
                                 jnp.float32)
            tau_bins = jnp.zeros((rows, self.grid.n), jnp.float32)
            bin_w_rel = ((self.bins.w - self.grid.w0)
                         / self.grid.dw).astype(np.float32)

        for mol_id, bound in self.molecules.items():
            x = lev(vmr[mol_id])
            psavg2, ns2 = cg.partial_pressures_and_densities(p2, x, n2d)
            psavg, ns = psavg2.reshape(rows), ns2.reshape(rows)
            prep = lines_mod.prepare(bound, self.grid, pavg, tavg, psavg,
                                     tips=self.tips)
            if not use_kernel:
                # Materialize the (rows, L) prep arrays: without a barrier
                # XLA fuses the prep math (exp/pow per line) into the
                # near-core pass's gathers and recomputes it per (grid
                # point, k).  The fused kernel consumes prep only through
                # the elementwise channel-stack build, where fusing prep in
                # saves the (rows, L) round trip instead.
                prep = lines_mod.PreparedLines(
                    *jax.lax.optimization_barrier(
                        (prep.center_idx, prep.center_frac, prep.strength,
                         prep.lorentz, prep.doppler)))
            if bin_method:
                br = self._get_bin_ranges(mol_id)
                tau_bins, bins_tau = bins_mod.accumulate_bins(
                    prep.center_idx, prep.center_frac, prep.strength,
                    prep.lorentz, prep.doppler, ns,
                    jnp.asarray(br.local_lo), jnp.asarray(br.local_cnt),
                    jnp.asarray(br.rem_lo), jnp.asarray(br.rem_cnt_l),
                    jnp.asarray(br.rem_hi_start), jnp.asarray(br.rem_cnt_r),
                    jnp.asarray(self.bins.l, jnp.int32), bin_w_rel,
                    ppb=self.bins.ppb, nbins=self.bins.n,
                    lmax_local=br.lmax_local, lmax_remote=br.lmax_remote,
                    dw=float(self.grid.dw), num_wpoints=self.grid.n,
                    tau0=tau_bins, bins_tau0=bins_tau)
            elif self.method in ("tiled", "line_sample"):
                near = self.near_steps[mol_id]
                # Split accumulation: cheap far-wing pass (regions 0/1
                # Voigt) + a small-window near-core pass with the full
                # region evaluation.  Exact: the passes partition the
                # window at |grid offset| == near, chosen so the far side
                # always satisfies |x| >= 12.81.
                # NOTE: block_start must be a multiple of self.tile.
                if use_kernel:
                    # One fused kernel covers both sides of the split.
                    # near is a dynamic scalar; hw stays static per
                    # molecule (it sets the near-core unroll length).
                    tau = pk.accumulate_voigt_pallas(
                        prep, bound.c0, ns, self.line_ranges[mol_id],
                        num_wpoints=nw, dw=float(self.grid.dw),
                        fsteps=self._fsteps, near=near,
                        hw=self.near_hw[mol_id], tile=self.tile,
                        num_global=self.grid.n, tau0=tau, start=start,
                        interpret=self.pallas == "interpret")
                else:
                    tiles = self.tiles[mol_id]
                    tau = accumulate_tiled(
                        prep.center_idx, prep.center_frac, prep.strength,
                        prep.lorentz, prep.doppler, ns,
                        jnp.asarray(tiles.tile_lines),
                        num_wpoints=nw, dw=float(self.grid.dw),
                        fsteps=tiles.fsteps, tile=tiles.tile,
                        lchunk=self.tile_lchunk, tau0=tau, start=start,
                        num_global=self.grid.n, exclude_within=near,
                        far_kernel=True)
                    ranges = self.point_ranges[mol_id]
                    tau = accumulate_near_pointwise(
                        prep.center_idx, prep.center_frac, prep.strength,
                        prep.lorentz, prep.doppler, ns,
                        jnp.asarray(ranges.lo), jnp.asarray(ranges.hi),
                        num_wpoints=nw, dw=float(self.grid.dw), near=near,
                        kpad=ranges.kpad, tau0=tau, start=start,
                        num_global=self.grid.n)
            else:
                tau = optical_depth_line_sample(
                    prep, ns, self.grid, cutoff=self.wcutoff,
                    chunk=self.line_chunk, tau0=tau, start=start,
                    block=None if block_size is None else nw)
            if mol_id == int(MoleculeId.H2O) and self.h2o_ctm is not None:
                ctm = self.h2o_ctm
                tau = tau + ctm.optical_depth(ns, pavg, tavg, psavg,
                                              cs=spectral(ctm.cs),
                                              cf=spectral(ctm.cf),
                                              t0s=spectral(ctm.t0s),
                                              t0f=spectral(ctm.t0f))
            elif mol_id == int(MoleculeId.O3) and self.o3_ctm is not None:
                tau = tau + jnp.asarray(ns, jnp.float32)[:, None] * \
                    spectral(self.o3_ctm.cross_section)[None, :]

        for cfc_id, table in self.cfcs.items():
            x = lev(cfc_vmr[cfc_id])
            xavg = 0.5 * (x[:, :-1] + x[:, 1:])
            tau = tau + (n2d * xavg).reshape(rows)[:, None] * \
                spectral(table.cross_section)[None, :]

        for s1, s2, table in self.cias:
            x1 = lev(cia_vmr[s1])
            x2 = lev(cia_vmr[s2])
            # Column factor pre-folded into the table (see add_cia).
            n_sq = ((p2[:, :-1] ** 2 - p2[:, 1:] ** 2) / tavg2) * 0.25 * \
                (x1[:, :-1] + x1[:, 1:]) * (x2[:, :-1] + x2[:, 1:])
            n_sq = jnp.abs(n_sq)
            tau = tau + n_sq.reshape(rows)[:, None] * \
                spectral(table.cross_section)[None, :]

        if bin_method:
            # Interpolate the accumulated line wings onto the fine grid
            # after ALL absorbers (launch.c:211-218), then slice the
            # active spectral block out of the band-global result.
            tau_bins = bins_mod.interpolate_bins(
                bins_tau, jnp.asarray(self.bins.l, jnp.int32), bin_w_rel,
                ppb=self.bins.ppb, last_ppb=self.bins.last_ppb,
                do_interp=self.bins.do_interp,
                do_last_interp=self.bins.do_last_interp,
                num_wpoints=self.grid.n, tau=tau_bins)
            if block_start is None and block_size is None:
                tau = tau + tau_bins
            else:
                # Pad by one block so any tile-aligned start stays in
                # bounds (start < grid.n, see driver block construction).
                tau = tau + jax.lax.dynamic_slice_in_dim(
                    jnp.pad(tau_bins, ((0, 0), (0, nw))),
                    jnp.asarray(start, jnp.int32), nw, axis=1)

        tau = tau.reshape(B, nlayers, nw)
        return tau if batched else tau[0]


def _pad_table(table, block: int):
    """Zero-pad a (n_w,) table so any block-aligned dynamic slice is in
    bounds (the last spectral shard may extend past the grid end)."""
    n = table.shape[-1]
    padded = -(-n // block) * block
    if padded == n:
        return table
    return jnp.pad(table, (0, padded - n))
