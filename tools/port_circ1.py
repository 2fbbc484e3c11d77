"""Port the embedded CIRC case-1 dataset (circ/src/circ1.h) to .npz.

The header embeds the public NASA CIRC benchmark case-1 inputs (atmospheric
profiles, gas abundances, spectral surface albedo, TOA solar function,
aerosol and cloud columns) as C array literals; this extracts the *data*
into grtcode_jax/data/circ1.npz for this build's CIRC driver and
regression tests (mirrors basic-circ-test.c's use of the same arrays).

Usage: python tools/port_circ1.py [path-to-circ1.h]
"""
import re
import sys
import os

import numpy as np

DEFAULT_SRC = "/root/reference/circ/src/circ1.h"
OUT = os.path.join(os.path.dirname(__file__), "..", "grtcode_jax", "data",
                   "circ1.npz")


def main():
    src = sys.argv[1] if len(sys.argv) > 1 else DEFAULT_SRC
    text = open(src).read()

    arrays = {}
    for m in re.finditer(
            r"double\s+(\w+)\s*\[[^\]]*\]\s*=\s*\{(.*?)\}\s*;", text, re.S):
        name, body = m.group(1), m.group(2)
        body = re.sub(r"/\*.*?\*/", "", body, flags=re.S)
        arrays[name] = np.array(
            [float(v) for v in body.replace("\n", " ").split(",")
             if v.strip()], dtype=np.float64)

    for m in re.finditer(r"double\s+(\w+)\s*=\s*([0-9.eE+-]+)\s*;", text):
        arrays[m.group(1)] = np.float64(m.group(2))

    checks = {
        "level_pressure": 55, "level_temperature": 55,
        "layer_pressure": 54, "layer_temperature": 54,
        "H2O_abundance": 54, "CO2_abundance": 54, "O3_abundance": 54,
        "N2O_abundance": 54, "CO_abundance": 54, "CH4_abundance": 54,
        "O2_abundance": 54, "CCl4_abundance": 54, "CFC11_abundance": 54,
        "CFC12_abundance": 54, "wavenumber": 49180,
        "surface_albedo": 49180, "weighted_surface_albedo": 49180,
        "toa_solar_function": 49180,
        "aerosol_optical_depth_at_1_micron": 54,
        "aerosol_single_scatter_albedo": 54,
        "aerosol_asymmetry_factor": 54, "cloud_fraction": 54,
        "liquid_water_path": 54, "ice_water_path": 54,
        "liquid_water_effective_particle_size": 54,
        "ice_effective_particle_size": 54,
        "height_above_sea_level": 55,
    }
    for name, n in checks.items():
        assert name in arrays, f"missing {name}"
        assert arrays[name].size == n, (name, arrays[name].size, n)
    for name in ("solar_zenith_angle", "surface_temperature",
                 "toa_solar_irradiance", "angstrom_exponent_value"):
        assert name in arrays, f"missing scalar {name}"

    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(OUT, **arrays)
    print(f"wrote {os.path.normpath(OUT)}: {len(arrays)} arrays")


if __name__ == "__main__":
    main()
