"""Shared command-line interface for the front-end applications.

Mirrors the reference's shared flag set (framework/src/driver.c:872-935)
plus per-app flags; built on stdlib argparse instead of the bespoke
linked-list parser (utilities/src/argparse.c) — same surface, standard
tooling.
"""
from __future__ import annotations

import argparse
import logging

from ..spectral import SpectralGrid

log = logging.getLogger("grtcode_jax")


def shared_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("hitran_file", help="HITRAN database file (.par).")
    p.add_argument("solar_flux", help="Solar flux CSV file.")
    p.add_argument("-beta-path", dest="beta_path",
                   help="(accepted for parity; this build computes the "
                        "incomplete beta analytically)")
    p.add_argument("-c", "--line-cutoff", type=float, default=25.0,
                   help="Cutoff [1/cm] from line center.")
    p.add_argument("-d", "--device", type=int, default=None,
                   help="Device index (jax.devices() ordinal).")
    p.add_argument("-flux-at-level", dest="flux_at_level", type=int,
                   default=None, help="Interior level to output fluxes at.")
    p.add_argument("-ice-path", dest="ice_path",
                   help="Ice cloud Pade parameterization netCDF.")
    p.add_argument("-integrated", action="store_true",
                   help="Output integrated instead of spectral fluxes.")
    p.add_argument("-liquid-path", dest="liquid_path",
                   help="Liquid cloud Pade parameterization netCDF.")
    p.add_argument("-o", dest="output", default="output.nc",
                   help="Name of output file.")
    p.add_argument("-r-lw", dest="r_lw", type=float, default=0.1)
    p.add_argument("-r-sw", dest="r_sw", type=float, default=1.0)
    p.add_argument("-w-lw", dest="w_lw", type=float, default=1.0)
    p.add_argument("-w-sw", dest="w_sw", type=float, default=1.0)
    p.add_argument("-W-lw", dest="W_lw", type=float, default=3250.0)
    p.add_argument("-W-sw", dest="W_sw", type=float, default=50000.0)
    p.add_argument("-h2o-ctm", dest="h2o_ctm",
                   help="MT-CKD water-vapor continuum directory.")
    p.add_argument("-o3-ctm", dest="o3_ctm",
                   help="Ozone continuum CSV file.")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("-spectral-chunks", dest="spectral_chunks", type=int,
                   default=None, metavar="N",
                   help="Stream each band through N spectral blocks "
                        "serially inside one compiled step (single "
                        "device, integrated output) — bounds memory at "
                        "fine resolutions like -r-lw 0.01.")
    p.add_argument("-mesh", default=None, metavar="CxS",
                   help="Shard over a (columns x spectral) device mesh, "
                        "e.g. '4x2' (the Equivalent of the "
                        "reference's per-node -x/-X SLURM slices; the "
                        "batch must divide by C).")
    return p


def mesh_from_args(args):
    """The device mesh requested via ``-mesh CxS`` (None when absent)."""
    if not getattr(args, "mesh", None):
        return None
    from ..parallel import make_mesh

    try:
        c, s = (int(v) for v in args.mesh.lower().split("x"))
    except ValueError:
        raise SystemExit(f"-mesh {args.mesh!r}: expected CxS, e.g. 4x2")
    return make_mesh(c, s)


def grids_from_args(args) -> tuple[SpectralGrid, SpectralGrid]:
    return (SpectralGrid(args.w_lw, args.W_lw, args.r_lw),
            SpectralGrid(args.w_sw, args.W_sw, args.r_sw))


def configure(args) -> None:
    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.WARNING,
        format="%(levelname)s %(name)s: %(message)s")
    # -v maps to GRTCODE_INFO like the reference binaries
    # (framework/src/driver.c:901-902).
    from ..utils import verbosity as vb
    vb.set_verbosity(vb.GRTCODE_INFO if args.verbose else vb.GRTCODE_WARN)
    if args.device is not None:
        import jax
        jax.config.update("jax_default_device",
                          jax.devices()[args.device])


def add_gas_flags(p: argparse.ArgumentParser, molecules, cfcs=(), cias=()):
    for name in molecules:
        p.add_argument(f"-{name}", action="store_true",
                       help=f"Include {name}.")
    for name in cfcs:
        p.add_argument(f"-{name}", dest=name.replace("-", "_"),
                       nargs="?", const=True, default=False,
                       help=f"Include {name} (cross-section CSV path).")
    for name in cias:
        p.add_argument(f"-{name}", dest=name.replace("-", "_"),
                       nargs="?", const=True, default=False,
                       help=f"Include {name} collision-induced absorption.")


def register_cross_sections(driver, args, cfc_options=(),
                            cia_pairs=None) -> None:
    """Load the continuum / cross-section data files named on the command
    line into BOTH bands' gas optics, mirroring the reference's
    create_gas_optics + add_molecules wiring (framework/src/driver.c:
    616-625 passes h2o_ctm/o3_ctm to both bands; :193-210 adds every
    -<CFC> CSV and -<CIA> CSV to each GasOptics_t).

    ``cfc_options``: iterable of CLI option names (e.g. "CFC-11",
    "CFC-11-eq"); a flag whose value is a path loads that CSV (a bare
    flag just enables the species' abundance, table-less).
    ``cia_pairs``: {option name -> (CiaId, CiaId)}.
    """
    from ..gas_optics.molecules import CfcId

    gases = [g for g in (driver.lw_gas, driver.sw_gas) if g is not None]
    if getattr(args, "h2o_ctm", None):
        from ..gas_optics.continua import WaterVaporContinuum

        for g in gases:
            g.h2o_ctm = WaterVaporContinuum.from_directory(
                args.h2o_ctm, g.grid)
    if getattr(args, "o3_ctm", None):
        from ..gas_optics.continua import OzoneContinuum

        for g in gases:
            g.o3_ctm = OzoneContinuum.from_file(args.o3_ctm, g.grid)
    for opt in cfc_options:
        val = getattr(args, opt.replace("-", "_"), False)
        if not isinstance(val, str):
            continue
        base = opt[:-3] if opt.endswith("-eq") else opt
        cfc_id = CfcId[base.replace("-", "")]
        for g in gases:
            g.add_cfc(cfc_id, val)
    for opt, pair in (cia_pairs or {}).items():
        val = getattr(args, opt.replace("-", "_"), False)
        if not isinstance(val, str):
            continue
        for g in gases:
            g.add_cia(pair[0], pair[1], val)
