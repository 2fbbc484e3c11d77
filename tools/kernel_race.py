"""Race the fused Voigt kernel against XLA's plain version on one GPU.

Per molecule of the RFMIP-width configuration (bench.build, B=32 x 54
layers = 1,728 rows): the kernel and the jnp ground truth
(accumulate_tiled + accumulate_near_pointwise) over the full band, on the
same line prep.  Then the whole step, RadiationDriver.run, with the kernel
and with the plain version.  Each time is the median of repeated calls
after a first (compiling) call, taken in turns (kernel, plain, kernel,
plain) and printed beside the card's name and power limit.

Run:  python tools/kernel_race.py
      (also writes chiprun_out/kernel_race.json)
"""
from __future__ import annotations

import json
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import jax

    import bench
    import chip_smoke
    from grtcode_jax.compile_cache import enable_compile_cache
    from grtcode_jax.framework import RadiationDriver

    enable_compile_cache()
    if jax.devices()[0].platform != "gpu":
        print("kernel_race: needs a GPU", file=sys.stderr)
        return 2
    card = chip_smoke.card()
    print(f"card: {card}", flush=True)
    driver, atm, B, nlayers, nw_lw, nw_sw = chip_smoke.rfmip_width()
    *_, batch, _, _ = bench.build(smoke=True, batch_size=B)
    result = {"card": card, "rows": B * nlayers, "molecules": {}}
    for band, gas in (("lw", driver.lw_gas), ("sw", driver.sw_gas)):
        for mol in gas.molecules:
            arrays, ns = chip_smoke.line_prep(gas, mol, batch)
            fns = {name: jax.jit(lambda a, s, f=f: f(a, s, 0, gas.grid.n))
                   for name, f in chip_smoke.accumulators(gas, mol).items()}
            ms = {name: [] for name in fns}
            for _ in range(2):
                for name, f in fns.items():
                    ms[name].append(
                        chip_smoke.timed(lambda: f(arrays, ns), 2)[2])
            row = {name: 1e3 * statistics.median(v) for name, v in ms.items()}
            row["lines"] = gas.molecules[mol].num_lines
            result["molecules"][f"{band}{mol}"] = row
            print(f"{band} molecule {mol} ({row['lines']} lines): kernel "
                  f"{row['kernel']:.2f} ms, jnp {row['jnp']:.2f} ms "
                  f"({card})", flush=True)
            del arrays, ns

    steps = {}
    for name, mode in (("kernel", "auto"), ("jnp", "off")):
        driver.lw_gas.pallas = driver.sw_gas.pallas = mode
        d = RadiationDriver(lw_gas=driver.lw_gas, sw_gas=driver.sw_gas,
                            solar=driver.solar)
        _, first, _ = chip_smoke.timed(lambda: d.run(atm), 0)
        steps[name] = (d, first)
        print(f"step {name}: compile+first {first:.2f} s", flush=True)
    ms = {name: [] for name in steps}
    for _ in range(2):
        for name, (d, _) in steps.items():
            ms[name].append(chip_smoke.timed(lambda: d.run(atm), 2)[2])
    points = B * nlayers * (nw_lw + nw_sw)
    for name, v in ms.items():
        step_s = statistics.median(v)
        result[f"step_{name}"] = {
            "compile_first_s": steps[name][1], "step_ms": 1e3 * step_s,
            "points_per_s": points / step_s}
        print(f"step {name}: {1e3 * step_s:.2f} ms, "
              f"{points / step_s:.4e} points/s ({card})", flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "kernel_race.json"),
              "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
