/* Golden-value generator for the reference's bin-interpolated optical-depth
 * methods: calc_optical_depth_bin_sweep (wavenumber_sweep) and
 * calc_optical_depth_line_sweep, including sort_lines, the coarse bins.tau
 * accumulation, and the final quadratic wing interpolation
 * (launch.c:135-218 dispatch; kernels.c:177-406, 514-581).
 *
 * Same synthetic column/line list as gasoptics_harness.c but with d = 0
 * (no pressure shift) so this build's host-side bracketing on unshifted
 * centers is index-exact against the reference's device-side bracketing on
 * shifted centers.
 *
 * Output: for each method (bin_sweep then line_sweep), tau values,
 * "%.9e" one per line, layers-major.
 *
 * Build:
 *   gcc -O2 -I/root/reference/utilities/src -I/root/reference/gas-optics/src \
 *       -o bins_harness bins_harness.c \
 *       /root/reference/gas-optics/src/kernels.c \
 *       /root/reference/gas-optics/src/RFM_voigt.c \
 *       /root/reference/gas-optics/src/kernel_utils.c \
 *       /root/reference/gas-optics/src/spectral_bin.c \
 *       /root/reference/utilities/src/curtis_godson.c \
 *       /root/reference/utilities/src/verbosity.c \
 *       /root/reference/utilities/src/utilities.c -lm
 */
#include <math.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include "curtis_godson.h"
#include "floating_point_type.h"
#include "kernels.h"
#include "spectral_bin.h"
#include "spectral_bin-internal.h"

/* Q() comes from the generated TIPS table header (regenerate
 * with: python tools/convert_tips.py emit-c) so the harness
 * and the framework share one partition function. */
#include "tips_table.h"

#define NUM_LEVELS 9
#define NUM_LAYERS 8
#define NUM_LINES 40
#define NW 3001

int main(void)
{
    fp_t level_pressure[NUM_LEVELS];
    fp_t level_temperature[NUM_LEVELS];
    fp_t level_x[NUM_LEVELS];
    int i;
    for (i = 0; i < NUM_LEVELS; ++i)
    {
        level_pressure[i] = 1e-5 + (1.0 - 1e-5) * i / (NUM_LEVELS - 1.0);
        level_temperature[i] = 215.0 + (288.0 - 215.0) * i / (NUM_LEVELS - 1.0);
        level_x[i] = 1e-5 + 3e-3 * i / (NUM_LEVELS - 1.0);
    }

    fp_t n[NUM_LAYERS], pavg[NUM_LAYERS], tavg[NUM_LAYERS];
    fp_t psavg[NUM_LAYERS], ns[NUM_LAYERS];
    calc_number_densities(NUM_LAYERS, level_pressure, n);
    calc_pressures_and_temperatures(NUM_LAYERS, level_pressure,
                                    level_temperature, pavg, tavg);
    calc_partial_pressures_and_number_densities(NUM_LAYERS, level_pressure,
                                                level_x, n, psavg, ns);

    int const mol_id = 1;
    int const num_iso = 9;
    fp_t v0[NUM_LINES], s0[NUM_LINES], yair[NUM_LINES], yself[NUM_LINES];
    fp_t en[NUM_LINES], nexp[NUM_LINES], d[NUM_LINES];
    int iso[NUM_LINES];
    unsigned s = 12345u;
    for (i = 0; i < NUM_LINES; ++i)
    {
        s = s * 1103515245u + 12345u;
        double r1 = (s >> 8) / 16777216.0;
        s = s * 1103515245u + 12345u;
        double r2 = (s >> 8) / 16777216.0;
        s = s * 1103515245u + 12345u;
        double r3 = (s >> 8) / 16777216.0;
        v0[i] = 150.0 + 200.0 * i / (NUM_LINES - 1.0) + 2.0 * (r1 - 0.5);
        s0[i] = 1e-23 * pow(10.0, 3.0 * r2);
        yair[i] = 0.02 + 0.08 * r3;
        yself[i] = 0.1 + 0.3 * r1;
        en[i] = 2000.0 * r2;
        nexp[i] = 0.4 + 0.4 * r3;
        d[i] = 0.0; /* no pressure shift: host bracketing is index-exact */
        iso[i] = 1 + (i % 3);
    }

    {
        fp_t const tref = 296.f;
        fp_t const c2 = -1.4387686f;
        for (i = 0; i < NUM_LINES; ++i)
        {
            s0[i] *= Q(mol_id, tref, iso[i]) /
                     (exp(c2 * en[i] / tref) * (1.f - exp(c2 * v0[i] / tref)));
        }
    }

    static fp_t vnn[NUM_LAYERS * NUM_LINES];
    static fp_t snn[NUM_LAYERS * NUM_LINES];
    static fp_t gamma_[NUM_LAYERS * NUM_LINES];
    static fp_t alpha[NUM_LAYERS * NUM_LINES];
    fp_t q[NUM_LAYERS * 16];

    int method;
    for (method = 0; method < 2; ++method)
    {
        calc_line_centers(NUM_LINES, NUM_LAYERS, v0, d, pavg, vnn);
        calc_partition_functions(NUM_LAYERS, mol_id, num_iso, tavg, q);
        calc_line_strengths(NUM_LINES, NUM_LAYERS, num_iso, iso, s0, v0, en,
                            tavg, q, snn);
        calc_lorentz_hw(NUM_LINES, NUM_LAYERS, nexp, yair, yself, tavg, pavg,
                        psavg, gamma_);
        calc_doppler_hw(NUM_LINES, NUM_LAYERS, 18.010565 / 6.023e23, vnn,
                        tavg, alpha);
        sort_lines(NUM_LINES, NUM_LAYERS, vnn, snn, gamma_, alpha);

        SpectralBins_t bins;
        create_spectral_bins(&bins, NUM_LAYERS, 100.0, NW, 0.1, 1.0,
                             HOST_ONLY);
        static fp_t tau[NUM_LAYERS * NW];
        uint64_t k;
        for (k = 0; k < NUM_LAYERS * (uint64_t)NW; ++k)
        {
            tau[k] = 0.f;
        }
        memset(bins.tau, 0, bins.isize * NUM_LAYERS * sizeof(fp_t));

        if (method == 0)
        {
            calc_optical_depth_bin_sweep(NUM_LINES, NUM_LAYERS, vnn, snn,
                                         gamma_, alpha, ns, bins, tau);
        }
        else
        {
            calc_optical_depth_line_sweep(NUM_LINES, NUM_LAYERS, vnn, snn,
                                          gamma_, alpha, ns, bins, tau);
        }
        interpolate(bins, tau);
        interpolate_last_bin(bins, tau);

        for (k = 0; k < NUM_LAYERS * (uint64_t)NW; ++k)
        {
            printf("%.9e\n", tau[k]);
        }
        destroy_spectral_bins(&bins);
    }
    return 0;
}
