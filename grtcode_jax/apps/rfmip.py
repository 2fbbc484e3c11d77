"""RFMIP-IRF application (rfmip-irf/src/rfmip-irf.c).

Reads the UColorado RFMIP netCDF input (site x level x experiment), builds
a batched Atmosphere for one experiment and a site slice, runs the
driver, and writes CF-style flux output.  Reference quirks reproduced:

  * global-mean (`*_GM`) scalars are multiplied by the numeric value of
    their netCDF `units` attribute and 1e6 (rfmip-irf.c:317-321, 388-392);
  * `-eq` equivalent-species options map CFC-11/CFC-12/HFC-134a to the
    `cfc11eq_GM/cfc12eq_GM/hfc134aeq_GM` variables (rfmip-irf.c:343-370);
  * per-layer H2O/O3 profiles interpolate to levels in pressure space
    (rfmip-irf.c:290-305);
  * `x/X` select an inclusive site slice for multi-host sharding
    (rfmip-irf.c:121-139);
  * flat surface albedo/emissivity spectra (rfmip-irf.c:223-256).
"""
from __future__ import annotations

import numpy as np

from ..framework import Atmosphere
from ..gas_optics.molecules import CfcId, CiaId, MoleculeId
from ..utils.ncio import Dataset, Writer

# Molecule name table (rfmip-irf.c:261-275).
MOLECULE_VARS = {
    MoleculeId.CH4: ("methane_GM", True),
    MoleculeId.CO: ("carbon_monoxide_GM", True),
    MoleculeId.CO2: ("carbon_dioxide_GM", True),
    MoleculeId.H2O: ("water_vapor", False),
    MoleculeId.N2O: ("nitrous_oxide_GM", True),
    MoleculeId.O2: ("oxygen_GM", True),
    MoleculeId.O3: ("ozone", False),
}

# CFC option table incl. -eq aliases (rfmip-irf.c:343-370): option name ->
# (CfcId, netCDF variable).
CFC_VARS = {
    "CCl4": (CfcId.CCl4, "carbon_tetrachloride_GM"),
    "C2F6": (CfcId.C2F6, "c2f6_GM"),
    "CF4": (CfcId.CF4, "cf4_GM"),
    "CFC-11": (CfcId.CFC11, "cfc11_GM"),
    "CFC-11-eq": (CfcId.CFC11, "cfc11eq_GM"),
    "CFC-12": (CfcId.CFC12, "cfc12_GM"),
    "CFC-12-eq": (CfcId.CFC12, "cfc12eq_GM"),
    "CFC-113": (CfcId.CFC113, "cfc113_GM"),
    "CFC-114": (CfcId.CFC114, "cfc114_GM"),
    "CFC-115": (CfcId.CFC115, "cfc115_GM"),
    "CH2Cl2": (CfcId.CH2Cl2, "ch2cl2_GM"),
    "HCFC-22": (CfcId.HCFC22, "hcfc22_GM"),
    "HCFC-141b": (CfcId.HCFC141b, "hcfc141b_GM"),
    "HCFC-142b": (CfcId.HCFC142b, "hcfc142b_GM"),
    "HFC-23": (CfcId.HFC23, "hfc23_GM"),
    "HFC-125": (CfcId.HFC125, "hfc125_GM"),
    "HFC-134a": (CfcId.HFC134a, "hfc134a_GM"),
    "HFC-134a-eq": (CfcId.HFC134a, "hfc134aeq_GM"),
    "HFC-143a": (CfcId.HFC143a, "hfc143a_GM"),
    "HFC-152a": (CfcId.HFC152a, "hfc152a_GM"),
    "HFC-227ea": (CfcId.HFC227ea, "hfc227ea_GM"),
    "HFC-245fa": (CfcId.HFC245fa, "hfc245fa_GM"),
    "NF3": (CfcId.NF3, "nf3_GM"),
    "SF6": (CfcId.SF6, "sf6_GM"),
}

CIA_VARS = {CiaId.N2: "nitrogen_GM", CiaId.O2: "oxygen_GM"}
# CIA pair options (rfmip-irf.c:407-410).
CIA_PAIRS = {"N2-N2": (CiaId.N2, CiaId.N2), "O2-N2": (CiaId.O2, CiaId.N2),
             "O2-O2": (CiaId.O2, CiaId.O2)}

PA_TO_MB = 0.01


def _gm_scalar(nc: Dataset, var: str, experiment: int) -> float:
    """Global-mean scalar * units-attribute * 1e6 -> ppmv
    (rfmip-irf.c:317-321)."""
    gm = float(nc.var(var, (experiment,)))
    units = float(nc.attr(var, "units"))
    return gm * units * 1e6


def _layers_to_levels(abund, layer_p, level_p):
    """Pressure-space layer -> level interpolation (rfmip-irf.c:290-305).

    abund: (B, nlayers); layer_p/level_p: (B, nlayers)/(B, nlevels) [mb].
    """
    B, nlayers = abund.shape
    out = np.empty((B, nlayers + 1))
    out[:, 0] = abund[:, 0]
    out[:, -1] = abund[:, -1]
    for k in range(1, nlayers):
        out[:, k] = abund[:, k - 1] + (abund[:, k] - abund[:, k - 1]) * (
            (level_p[:, k] - layer_p[:, k - 1])
            / (layer_p[:, k] - layer_p[:, k - 1]))
    return out


def load_atmosphere(path: str, experiment: int, x: int = 0,
                    X: int | None = None,
                    molecules=tuple(MOLECULE_VARS),
                    cfc_options=(), cia_pairs=()) -> Atmosphere:
    """Build the batched Atmosphere for one experiment and site slice
    [x, X] inclusive (create_atmosphere, rfmip-irf.c:59-466)."""
    with Dataset(path) as nc:
        if X is None:
            X = nc.dim_size("site") - 1
        ncol = X - x + 1
        sl = slice(x, X + 1)

        level_p = nc.var("pres_level", (sl,)) * PA_TO_MB      # (B, nlev)
        layer_p = nc.var("pres_layer", (sl,)) * PA_TO_MB
        level_t = nc.var("temp_level", (experiment, sl))
        layer_t = nc.var("temp_layer", (experiment, sl))
        t_surf = nc.var("surface_temperature", (experiment, sl))
        sza = nc.var("solar_zenith_angle", (sl,))
        tsi = nc.var("total_solar_irradiance", (sl,))
        albedo = nc.var("surface_albedo", (sl,))
        emis = nc.var("surface_emissivity", (sl,))

        nlev = level_p.shape[1]
        ppmv = {}
        for mol in molecules:
            var, is_gm = MOLECULE_VARS[MoleculeId(mol)]
            if is_gm:
                val = _gm_scalar(nc, var, experiment)
                ppmv[int(mol)] = np.full((ncol, nlev), val)
            else:
                ab = nc.var(var, (experiment, sl)) * 1e6
                ppmv[int(mol)] = _layers_to_levels(ab, layer_p, level_p)

        cfc_ppmv = {}
        for opt in cfc_options:
            cfc_id, var = CFC_VARS[opt]
            cfc_ppmv[int(cfc_id)] = np.full(
                (ncol, nlev), _gm_scalar(nc, var, experiment))

        cia_ppmv = {}
        for pair in cia_pairs:
            for species in CIA_PAIRS[pair]:
                if int(species) not in cia_ppmv:
                    cia_ppmv[int(species)] = np.full(
                        (ncol, nlev),
                        _gm_scalar(nc, CIA_VARS[species], experiment))

    # Flat spectra on a 2-pt grid + constant extrapolation == constant
    # albedo/emissivity (rfmip-irf.c:223-256).
    spec_grid = np.array([1.0, 2.0])
    return Atmosphere(
        level_pressure=level_p, level_temperature=level_t,
        layer_temperature=layer_t, surface_temperature=t_surf,
        ppmv=ppmv, cfc_ppmv=cfc_ppmv, cia_ppmv=cia_ppmv,
        emissivity_grid=spec_grid,
        emissivity=np.repeat(emis[:, None], 2, axis=1),
        cos_zenith=np.cos(np.deg2rad(sza)),
        total_solar_irradiance=tsi,
        albedo_grid=spec_grid,
        albedo=np.repeat(albedo[:, None], 2, axis=1),
        clean=True, clear=True,
    )


# (output name, band, direction, level index, standard_name) — the
# reference's create_flux_file variable surface (rfmip-irf.c:574-650).
_REF_VARS = (
    ("rlutcsaf", "rlu", 0, "upwelling_toa_longwave_flux_in_air"),
    ("rluscsaf", "rlu", -1, "upwelling_surface_longwave_flux_in_air"),
    ("rldscsaf", "rld", -1, "downwelling_surface_longwave_flux_in_air"),
    ("rsutcsaf", "rsu", 0, "upwelling_toa_shortwave_flux_in_air"),
    ("rsuscsaf", "rsu", -1, "upwelling_surface_shortwave_flux_in_air"),
    ("rsdtcsaf", "rsd", 0, "downwelling_toa_shortwave_flux_in_air"),
    ("rsdscsaf", "rsd", -1, "downwelling_surface_shortwave_flux_in_air"),
)
_USER_VARS = (
    ("rlucsaf_level", "rlu", "upwelling_longwave_flux_in_air"),
    ("rldcsaf_level", "rld", "downwelling_longwave_flux_in_air"),
    ("rsucsaf_level", "rsu", "upwelling_shortwave_flux_in_air"),
    ("rsdcsaf_level", "rsd", "downwelling_shortwave_flux_in_air"),
)


def write_fluxes(path: str, results, level_pressure, x: int = 0,
                 user_level: int | None = None, lw_grid=None, sw_grid=None):
    """Write the clear-sky-aerosol-free flux file.

    Mirrors the reference's create_flux_file (rfmip-irf.c:574-650): the 7
    TOA/surface variables + 4 user-level variables, each either (column,)
    integrated or (column, lw_wavenumber|sw_wavenumber) spectrally
    resolved (results.integrated selects, the reference's -integrated
    flag), plus the x_start/x_stop segment attributes.  Full (col, level)
    profiles are written additionally in integrated mode (the per-level
    regression contract of rfmip-irf/test/check_results.c).
    """
    tiers = results.tiers["csaf"]
    ncol, nlev = tiers["rlu"].shape[:2]
    integrated = results.integrated
    with Writer(path) as w:
        w.create_dimension("column", ncol, values=np.arange(x, x + ncol))
        w.create_dimension("level", nlev)
        if not integrated:
            if lw_grid is None or sw_grid is None:
                raise ValueError("spectral output needs lw_grid/sw_grid")
            w.create_dimension("lw_wavenumber", lw_grid.n,
                               values=lw_grid.wavenumbers_np())
            w.create_dimension("sw_wavenumber", sw_grid.n,
                               values=sw_grid.wavenumbers_np())

        def spectral_dim(key):
            return "lw_wavenumber" if key[1] == "l" else "sw_wavenumber"

        for out_name, key, lev, std in _REF_VARS:
            data = np.asarray(tiers[key])[:, lev]
            dims = ("column",) if integrated \
                else ("column", spectral_dim(key))
            w.create_variable(out_name, dims, data, units="W m-2",
                              standard_name=std)
        if user_level is not None:
            for out_name, key, std in _USER_VARS:
                data = np.asarray(tiers[key])[:, user_level]
                dims = ("column",) if integrated \
                    else ("column", spectral_dim(key))
                w.create_variable(out_name, dims, data, units="W m-2",
                                  standard_name=std, level=user_level)
        if integrated:
            names = {"rlu": "rlucsaf", "rld": "rldcsaf",
                     "rsu": "rsucsaf", "rsd": "rsdcsaf"}
            for key, out_name in names.items():
                w.create_variable(out_name, ("column", "level"), tiers[key],
                                  units="W m-2")
            w.create_variable("level_pressure", ("column", "level"),
                              level_pressure, units="mb")
            if user_level is not None:
                for key, out_name in names.items():
                    w.create_variable(out_name + "_user_level", ("column",),
                                      tiers[key][:, user_level],
                                      units="W m-2")
        w.set_global(x_start=x, x_stop=x + ncol - 1)


def main(argv=None):
    """RFMIP-IRF runner (rfmip-irf.c:59-106 flag surface)."""
    from ..framework import cli
    from .circ import build_driver  # same grid/gas wiring

    p = cli.shared_parser("RFMIP-IRF offline forcing benchmark.")
    p.add_argument("input_file", help="RFMIP netCDF input.")
    p.add_argument("experiment", type=int, help="Experiment (forcing) index.")
    p.add_argument("-x", type=int, default=0, help="First site index.")
    p.add_argument("-X", type=int, default=None, help="Last site index.")
    cli.add_gas_flags(p, [m.name for m in MOLECULE_VARS],
                      cfcs=list(CFC_VARS), cias=list(CIA_PAIRS))
    args = p.parse_args(argv)
    cli.configure(args)

    molecules = [m for m in MOLECULE_VARS if getattr(args, m.name, False)]
    cfc_opts = [o for o in CFC_VARS
                if getattr(args, o.replace("-", "_"), False)]
    cia = [o for o in CIA_PAIRS
           if getattr(args, o.replace("-", "_"), False)]
    atm = load_atmosphere(args.input_file, args.experiment, x=args.x,
                          X=args.X, molecules=molecules or
                          tuple(MOLECULE_VARS), cfc_options=cfc_opts,
                          cia_pairs=cia)
    lw_grid, sw_grid = cli.grids_from_args(args)
    hitran = None if args.hitran_file in ("none", "-") else args.hitran_file
    driver = build_driver(hitran_path=hitran, lw_grid=lw_grid,
                          sw_grid=sw_grid, wcutoff=args.line_cutoff)
    if hitran:
        # Continua + CFC/CIA cross-section CSVs on both bands
        # (driver.c:193-210, 616-625); -eq aliases load the same table
        # under the equivalent species id (rfmip-irf.c:343-370).
        cli.register_cross_sections(driver, args,
                                    cfc_options=tuple(CFC_VARS),
                                    cia_pairs=CIA_PAIRS)
    res = driver.run(atm, integrated=args.integrated,
                     mesh=cli.mesh_from_args(args),
                     spectral_chunks=args.spectral_chunks)
    write_fluxes(args.output, res, atm.level_pressure, x=args.x,
                 user_level=args.flux_at_level, lw_grid=lw_grid,
                 sw_grid=sw_grid)
    print(f"wrote {args.output}")


if __name__ == "__main__":
    from ..compile_cache import enable_compile_cache

    enable_compile_cache()
    main()
