"""CIRC benchmark application (circ/src/circ.c, basic-circ-test.c).

Case 1 ships embedded (grtcode_jax/data/circ1.npz, ported from the public
NASA CIRC data embedded in circ/src/circ1.h); other cases load from the
CIRC netCDF inputs when available.  Reference integrated-flux values for
case 1 (LBLRTM and the CIRC multi-model mean) are pinned from
basic-circ-test.c:444-501.
"""
from __future__ import annotations

import os

import numpy as np

from ..framework import Atmosphere, RadiationDriver, \
    pressure_interp_layers_to_levels
from ..gas_optics.gas_optics import GasOptics
from ..gas_optics.molecules import MoleculeId, CfcId, CiaId
from ..solvers.solar_flux import SolarFlux
from ..spectral import SpectralGrid

DATA = os.path.join(os.path.dirname(__file__), "..", "data", "circ1.npz")

# basic-circ-test.c:444-501 (W m-2).
CASE1_REFERENCE = {
    "RLUTCSAF": {"lblrtm": 304.27, "circ_mean": 301.7},
    "RLUSCSAF": {"lblrtm": 445.12, "circ_mean": None},
    "RLDSCSAF": {"lblrtm": 288.2, "circ_mean": 289.7},
    "RSDTCSAF": {"lblrtm": 912.79, "circ_mean": None},
    "RSUTCSAF": {"lblrtm": 175.0, "circ_mean": 169.8},
    "RSDSCSAF": {"lblrtm": 701.2, "circ_mean": 705.9},
    "RSUSCSAF": {"lblrtm": 137.40, "circ_mean": None},
}

# Gases the CIRC binary registers (circ.c:234-268 / basic-circ-test.c:170-233).
CASE1_MOLECULES = (MoleculeId.H2O, MoleculeId.CO2, MoleculeId.O3,
                   MoleculeId.N2O, MoleculeId.CO, MoleculeId.CH4,
                   MoleculeId.O2)
CASE1_CFCS = (CfcId.CFC11, CfcId.CFC12, CfcId.CCl4)


def case1_atmosphere(clean: bool = True, clear: bool = True) -> Atmosphere:
    """Build the embedded CIRC case-1 atmosphere (basic-circ-test.c:71-272).

    Per-layer abundances interpolate to levels in pressure space
    (basic-circ-test.c:50-64); the spectral surface albedo and TOA solar
    function come on the case's native 49 180-point grid.
    """
    d = np.load(DATA)
    lp = d["layer_pressure"][None, :]
    pl = d["level_pressure"][None, :]

    def to_ppmv(name):
        return pressure_interp_layers_to_levels(
            d[name][None, :], lp, pl) * 1e6

    ppmv = {int(m): to_ppmv(f"{m.name}_abundance") for m in CASE1_MOLECULES}
    cfc_names = {CfcId.CFC11: "CFC11", CfcId.CFC12: "CFC12",
                 CfcId.CCl4: "CCl4"}
    cfc_ppmv = {int(c): to_ppmv(f"{cfc_names[c]}_abundance")
                for c in CASE1_CFCS}
    # CIA uses the O2 and (implied well-mixed) N2 abundances
    # (circ.c:321-332: N2-N2, O2-N2, O2-O2 with N2 = 0.781).
    n2 = np.full_like(pl, 0.781e6)
    cia_ppmv = {int(CiaId.N2): n2,
                int(CiaId.O2): ppmv[int(MoleculeId.O2)]}

    return Atmosphere(
        level_pressure=pl,
        level_temperature=d["level_temperature"][None, :],
        layer_temperature=d["layer_temperature"][None, :],
        surface_temperature=[float(d["surface_temperature"])],
        ppmv=ppmv, cfc_ppmv=cfc_ppmv, cia_ppmv=cia_ppmv,
        # Emissivity == 1 everywhere (circ.c:71 callback; emissivity array
        # defaults to ones).
        cos_zenith=[np.cos(np.deg2rad(float(d["solar_zenith_angle"])))],
        # The case datum is the *horizontal* TOA irradiance; the solver's
        # TSI is that divided by cos(sza) (basic-circ-test.c:118-124).
        total_solar_irradiance=[
            float(d["toa_solar_irradiance"])
            / np.cos(np.deg2rad(float(d["solar_zenith_angle"])))],
        albedo_grid=d["wavenumber"],
        albedo=d["surface_albedo"][None, :],
        aerosol_optical_depth_1um=d["aerosol_optical_depth_at_1_micron"][None, :],
        aerosol_angstrom_exponent=float(d["angstrom_exponent_value"]),
        aerosol_single_scatter_albedo=d["aerosol_single_scatter_albedo"][None, :],
        aerosol_asymmetry_factor=d["aerosol_asymmetry_factor"][None, :],
        cloud_fraction=d["cloud_fraction"][None, :],
        # LWP/IWP [g m-2] -> content [g m-3] via the layer thickness from
        # the case's level heights (circ.c builds cloud content the same
        # way from lwp and layer depth).
        liquid_water_content=(d["liquid_water_path"] / _thickness_m(d))[None, :],
        ice_water_content=(d["ice_water_path"] / _thickness_m(d))[None, :],
        layer_thickness=_thickness_m(d)[None, :],
        clean=clean, clear=clear,
    )


def _thickness_m(d) -> np.ndarray:
    """Layer geometric thickness [m] from level heights [km]."""
    z = d["height_above_sea_level"] * 1000.0
    return np.abs(z[:-1] - z[1:])


# CIA pair -> CLI flag (circ.c:300-302).
CIA_PAIRS = {(CiaId.N2, CiaId.N2): "N2-N2", (CiaId.O2, CiaId.N2): "O2-N2",
             (CiaId.O2, CiaId.O2): "O2-O2"}

_CFC_VAR = {CfcId.CFC11: "CFC11_abundance", CfcId.CFC12: "CFC12_abundance",
            CfcId.CCl4: "CCl4_abundance"}


def load_case_file(path: str, *, molecules=CASE1_MOLECULES,
                   cfcs=CASE1_CFCS, cias=tuple(CIA_PAIRS),
                   clean: bool = True, clear: bool = True,
                   albedo: float | None = None,
                   z: int = 0, Z: int | None = None) -> Atmosphere:
    """Read a CIRC case netCDF input (circ.c create_atmosphere, :103-436).

    Contract mirrored from the reference binary:
      * ``levels`` dimension, optional [z, Z] level-index window;
      * per-layer gas/CFC abundances (mole fraction) interpolate to
        levels in pressure space and scale to ppmv.  The interpolation
        uses basic-circ-test.c:50-64's (i-1, i) bracketing — level i
        lies between layer midpoints i-1 and i; circ.c:243-248 shifts
        the same formula by one index, reading one element past its
        abundance buffer at the top interior level (a reference bug this
        build does not reproduce);
      * ``solar_zenith_angle`` [degrees] -> cosine; the file's
        ``toa_solar_irradiance`` is the horizontal TOA flux, so TSI =
        irradiance / cos(sza) (circ.c:165-172);
      * surface albedo: the (wavenumber, surface_albedo) spectrum, or a
        constant when ``albedo`` is given (the ``-a`` flag,
        circ.c:175-198); emissivity is 1 (circ.c:200-207);
      * CIA: N2 is well-mixed at 0.781 mole fraction, O2 reuses
        ``O2_abundance`` (circ.c:308-355);
      * aerosols (unless ``clean``): per-layer tau at 1 um + a scalar
        Angstrom exponent, grey omega/g (circ.c:358-416);
      * clouds (unless ``clear``): ``liquid_water_path`` [g m-2] and
        droplet size; content [g m-3] needs the layer thickness from
        the case level heights when present.
    """
    from ..utils import ncio

    with ncio.Dataset(path) as ds:
        nlev_file = ds.dim_size("levels")
        Zi = nlev_file - 1 if Z is None else Z
        nlev = Zi - z + 1
        nlay = nlev - 1
        ls = (slice(z, z + nlev),)
        ys = (slice(z, z + nlay),)

        p_lev = ds.var("level_pressure", ls)[None, :]
        p_lay = ds.var("layer_pressure", ys)[None, :]
        t_lev = ds.var("level_temperature", ls)[None, :]
        t_lay = ds.var("layer_temperature", ys)[None, :]
        t_sfc = np.atleast_1d(ds.var("surface_temperature"))[:1]

        mu = np.cos(np.deg2rad(np.atleast_1d(
            ds.var("solar_zenith_angle"))[:1]))
        # circ.c:171 divides unguarded; a night column (mu <= 0) would
        # produce inf/negative TSI that can leak NaNs through the spectral
        # day mask (0 * inf), so zero it — SW is skipped/masked anyway.
        tsi = np.where(
            mu > 0.0,
            np.atleast_1d(ds.var("toa_solar_irradiance"))[:1]
            / np.where(mu > 0.0, mu, 1.0),
            0.0)

        if albedo is not None:
            albedo_grid = np.array([-1.0, 0.0])
            albedo_arr = np.full((1, 2), float(albedo))
        else:
            albedo_grid = ds.var("wavenumber")
            albedo_arr = ds.var("surface_albedo")[None, :]

        def to_ppmv(name):
            ab = ds.var(name, ys)[None, :]
            return pressure_interp_layers_to_levels(ab, p_lay, p_lev) * 1e6

        ppmv = {int(m): to_ppmv(f"{MoleculeId(m).name}_abundance")
                for m in molecules}
        cfc_ppmv = {int(c): to_ppmv(_CFC_VAR[CfcId(c)]) for c in cfcs}

        cia_ppmv = {}
        for s1, s2 in cias:
            for s in (s1, s2):
                if int(s) in cia_ppmv:
                    continue
                if s == CiaId.N2:
                    cia_ppmv[int(s)] = np.full_like(p_lev, 0.781e6)
                elif s == CiaId.O2:
                    cia_ppmv[int(s)] = to_ppmv("O2_abundance")

        kw = {}
        if not clean:
            kw.update(
                aerosol_optical_depth_1um=ds.var(
                    "aerosol_optical_depth_at_1_micron", ys)[None, :],
                aerosol_angstrom_exponent=float(
                    np.atleast_1d(ds.var("angstrom_exponent"))[0]),
                aerosol_single_scatter_albedo=ds.var(
                    "aerosol_single_scatter_albedo", ys)[None, :],
                aerosol_asymmetry_factor=ds.var(
                    "aerosol_asymmetry_factor", ys)[None, :])
        if not clear:
            lwp = ds.var("liquid_water_path", ys)[None, :]
            if ds.has("height_above_sea_level"):
                zm = ds.var("height_above_sea_level", ls) * 1000.0
                thick = np.abs(zm[:-1] - zm[1:])[None, :]
            else:
                thick = np.ones_like(lwp)
            kw.update(
                cloud_fraction=(lwp > 0.0).astype(np.float64),
                liquid_water_content=lwp / thick,
                ice_water_content=(ds.var("ice_water_path", ys)[None, :]
                                   / thick
                                   if ds.has("ice_water_path")
                                   else np.zeros_like(lwp)),
                layer_thickness=thick)

    return Atmosphere(
        level_pressure=p_lev, level_temperature=t_lev,
        layer_temperature=t_lay, surface_temperature=t_sfc,
        ppmv=ppmv, cfc_ppmv=cfc_ppmv, cia_ppmv=cia_ppmv,
        cos_zenith=mu, total_solar_irradiance=tsi,
        albedo_grid=albedo_grid, albedo=albedo_arr,
        clean=clean, clear=clear, **kw)


def case1_solar_flux(grid: SpectralGrid) -> SolarFlux:
    """Normalized incident solar spectrum from the embedded TOA solar
    function (basic-circ-test.c uses toa_solar_function with the case TSI)."""
    d = np.load(DATA)
    return SolarFlux.from_samples(d["wavenumber"], d["toa_solar_function"],
                                  grid)


def build_driver(hitran_path: str | None = None,
                 lw_grid: SpectralGrid | None = None,
                 sw_grid: SpectralGrid | None = None,
                 h2o_ctm_dir: str | None = None,
                 o3_ctm_file: str | None = None,
                 cfc_dir: str | None = None,
                 **gas_kwargs) -> RadiationDriver:
    """CIRC driver with the default grids (driver.c:912-921: LW 1-3250 at
    0.1 cm-1, SW 1-50000 at 1.0 cm-1).  With a HITRAN .par path the full
    case gas set is registered; without one the gas optics start empty
    (add synthetic catalogs for testing)."""
    lw_grid = lw_grid or SpectralGrid(1.0, 3250.0, 0.1)
    sw_grid = sw_grid or SpectralGrid(1.0, 50000.0, 1.0)
    lw_gas = GasOptics(lw_grid, hitran_path=hitran_path, **gas_kwargs)
    sw_gas = GasOptics(sw_grid, hitran_path=hitran_path, **gas_kwargs)
    if hitran_path:
        for m in CASE1_MOLECULES:
            lw_gas.add_molecule(m)
            sw_gas.add_molecule(m)
    solar = case1_solar_flux(sw_grid)
    return RadiationDriver(lw_gas=lw_gas, sw_gas=sw_gas, solar=solar)


def main(argv=None):
    """CIRC runner (circ.c:76-101 flag surface): with an input file, run
    that case's netCDF column; without one, run embedded case 1 and print
    the integrated fluxes next to the LBLRTM / CIRC-mean references
    (basic-circ-test.c:444-501)."""
    from ..framework import cli

    p = cli.shared_parser("CIRC case benchmark (embedded case 1).")
    p.add_argument("input_file", nargs="?", default=None,
                   help="CIRC case netCDF input; omit for embedded case 1.")
    p.add_argument("-a", type=float, default=None, dest="albedo",
                   help="Constant surface albedo override (circ.c:175).")
    p.add_argument("-z", type=int, default=0,
                   help="Starting level index (circ.c:105).")
    p.add_argument("-Z", type=int, default=None,
                   help="Ending level index (circ.c:106).")
    cli.add_gas_flags(p, [m.name for m in CASE1_MOLECULES],
                      cfcs=["CFC-11", "CFC-12", "CCl4"],
                      cias=["N2-N2", "O2-N2", "O2-O2"])
    p.add_argument("-clean", action="store_true",
                   help="Run without aerosols (circ.c:92; aerosols are ON "
                        "by default for case files).")
    p.add_argument("-clouds", action="store_true",
                   help="Enable the all-sky tier (needs -liquid-path/"
                        "-ice-path Pade files).")
    args = p.parse_args(argv)
    cli.configure(args)

    lw_grid, sw_grid = cli.grids_from_args(args)
    if args.input_file:
        mols = tuple(m for m in CASE1_MOLECULES
                     if getattr(args, m.name, False)) or CASE1_MOLECULES
        atm = load_case_file(args.input_file, molecules=mols,
                             clean=args.clean, clear=not args.clouds,
                             albedo=args.albedo, z=args.z, Z=args.Z)
    else:
        atm = case1_atmosphere(clean=True, clear=not args.clouds)
    hitran = None if args.hitran_file in ("none", "-") else args.hitran_file
    driver = build_driver(hitran_path=hitran, lw_grid=lw_grid,
                          sw_grid=sw_grid, wcutoff=args.line_cutoff)
    if hitran:
        # Continua + any CFC/CIA cross-section CSVs named on the command
        # line, on both bands (driver.c:193-210, 616-625).
        cli.register_cross_sections(
            driver, args, cfc_options=("CFC-11", "CFC-12", "CCl4"),
            cia_pairs={name: pair for pair, name in CIA_PAIRS.items()})
    if args.clouds:
        from ..clouds import CloudOpticsLib, PadeCloudOptics
        driver.cloud_optics = CloudOpticsLib(
            liquid=PadeCloudOptics.from_netcdf(args.liquid_path),
            ice=PadeCloudOptics.from_netcdf(args.ice_path)).driver_callback()

    res = driver.run(atm, integrated=True,
                     mesh=cli.mesh_from_args(args),
                     spectral_chunks=args.spectral_chunks)

    # Per-level flux output file (circ.c create_flux_file/write_output,
    # :527-560: rlu/rld/rsu/rsd over the level dimension).
    if args.output:
        from ..utils import ncio

        tier = ("af" if "af" in res.tiers
                else "cs" if "cs" in res.tiers else "csaf")
        std = {"rlu": "upwelling_longwave_flux_in_air",
               "rld": "downwelling_longwave_flux_in_air",
               "rsu": "upwelling_shortwave_flux_in_air",
               "rsd": "downwelling_shortwave_flux_in_air"}
        with ncio.Writer(args.output) as w:
            w.create_dimension("level", atm.num_levels)
            for name, sname in std.items():
                w.create_variable(name, ("level",),
                                  res.tiers[tier][name][0],
                                  units="W m-2", standard_name=sname)

    if args.input_file is None:
        print(f"{'Variable':<12}{'GRTCODE-JAX':>14}{'LBLRTM':>10}"
              f"{'CIRC mean':>11}")
        for name, refs in CASE1_REFERENCE.items():
            got = float(res.variable(name)[0])
            lbl = refs["lblrtm"]
            mean = refs["circ_mean"]
            print(f"{name:<12}{got:>14.4f}{lbl:>10.2f}"
                  f"{mean if mean is not None else '':>11}")
    return res


if __name__ == "__main__":
    from ..compile_cache import enable_compile_cache

    enable_compile_cache()
    main()
