/* End-to-end golden generator: the reference's FULL production flux stack.
 *
 * Compiles the unmodified reference sources and reproduces the clear-clean
 * tier of column_calculation (framework/src/driver.c:360-444): HITRAN
 * parse -> line prep -> Voigt line_sample -> H2O/O3 continua -> CFC ->
 * CIA -> gas+Rayleigh optics combine -> LW 4-stream + SW
 * delta-Eddington/adding solvers -> per-level trapezoid-integrated fluxes
 * (output_fluxes, driver.c:295-312).  Q() comes from the shared generated
 * TIPS table (tools/convert_tips.py emit-c), so the reference stack and
 * grtcode_jax use identical partition functions.
 *
 * Inputs: a directory produced by tools/goldens/driver_inputs.py.
 * Output: "nlev <N>" then four labeled blocks (rlu rld rsu rsd), one
 * "%.9e" per level, TOA first — the contract checked by
 * tests/test_driver_golden.py at the reference's own 1% tolerance
 * (circ/test/check_results.c:39-53).
 *
 * Build (from tools/goldens; first run `python ../convert_tips.py emit-c`):
 *   gcc -O2 -fopenmp \
 *       -I/root/reference/utilities/src -I/root/reference/gas-optics/src \
 *       -I/root/reference/longwave/src -I/root/reference/shortwave/src \
 *       -Incstub -I/root/reference/clouds \
 *       -o driver_harness driver_harness.c \
 *       /root/reference/clouds/cloud_pade_optics.c \
 *       /root/reference/clouds/optics_utils.c \
 *       /root/reference/gas-optics/src/gas_optics.c \
 *       /root/reference/gas-optics/src/launch.c \
 *       /root/reference/gas-optics/src/kernels.c \
 *       /root/reference/gas-optics/src/RFM_voigt.c \
 *       /root/reference/gas-optics/src/kernel_utils.c \
 *       /root/reference/gas-optics/src/spectral_bin.c \
 *       /root/reference/gas-optics/src/parse_HITRAN_file.c \
 *       /root/reference/gas-optics/src/molecules.c \
 *       /root/reference/gas-optics/src/water_vapor_continuum.c \
 *       /root/reference/gas-optics/src/ozone_continuum.c \
 *       /root/reference/gas-optics/src/cfcs.c \
 *       /root/reference/gas-optics/src/collision_induced_absorption.c \
 *       /root/reference/longwave/src/longwave.c \
 *       /root/reference/shortwave/src/shortwave.c \
 *       /root/reference/shortwave/src/rayleigh.c \
 *       /root/reference/shortwave/src/solar_flux.c \
 *       /root/reference/utilities/src/spectral_grid.c \
 *       /root/reference/utilities/src/optics.c \
 *       /root/reference/utilities/src/utilities.c \
 *       /root/reference/utilities/src/curtis_godson.c \
 *       /root/reference/utilities/src/parse_csv.c \
 *       /root/reference/utilities/src/device.c \
 *       /root/reference/utilities/src/verbosity.c -lm
 *
 * Run:  ./driver_harness <input_dir> ../../tests/data/driver_golden.txt
 */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include "grtcode_utilities.h"
#include "gas_optics.h"
#include "cfcs.h"
#include "collision_induced_absorption.h"
#include "longwave.h"
#include "shortwave.h"
#include "rayleigh.h"
#include "solar_flux.h"

#include "tips_table.h"
/* Reference cloud optics (compiled unmodified; the netCDF loader inside
 * is never called — see ncstub/netcdf.h): compute_all_from_pade +
 * map_band_wave + construct_optics. */
#include "cloud_pade_optics.h"

/* tips2017.c is stripped in the reference checkout; the GPU table upload
 * is a no-op on HOST_ONLY but the symbol must link. */
int inittips_d(void) { return GRTCODE_SUCCESS; }

#define MAXLEV 200
#define MAXSPEC 64
#define CHECK(x) do { int rc_ = (x); if (rc_ != GRTCODE_SUCCESS) { \
    fprintf(stderr, "FAILED rc=%d at %s:%d\n", rc_, __FILE__, __LINE__); \
    exit(1); } } while (0)

static FILE *out;
static char path_buf[4096];
static const char *join(const char *dir, const char *name)
{
    snprintf(path_buf, sizeof(path_buf), "%s/%s", dir, name);
    return path_buf;
}

/* ---- CS (aerosol) + AF (cloud) tier inputs --------------------------- */
static int have_aero = 0, have_cloud = 0;
static double alpha_a;
static double aero_tau1um[MAXLEV], aero_omega[MAXLEV], aero_gf[MAXLEV];
static double cld_ql[MAXLEV], cld_qi[MAXLEV], cld_thick[MAXLEV];
static ty_cloud_optics liquid_tbl, ice_tbl;

static fp_t ***alloc3(int a, int b, int c)
{
    fp_t ***p = (fp_t ***)malloc(a * sizeof(*p));
    int i, j;
    for (i = 0; i < a; ++i)
    {
        p[i] = (fp_t **)malloc(b * sizeof(**p));
        for (j = 0; j < b; ++j)
        {
            p[i][j] = (fp_t *)malloc(c * sizeof(***p));
        }
    }
    return p;
}

static void read3(FILE *f, fp_t ***p, int a, int b, int c)
{
    int i, j, k;
    for (i = 0; i < a; ++i)
        for (j = 0; j < b; ++j)
            for (k = 0; k < c; ++k)
            {
                double v;
                if (fscanf(f, "%lf", &v) != 1) { exit(1); }
                p[i][j][k] = v;
            }
}

static int read_pade(const char *dir, const char *name,
                     ty_cloud_optics *tb)
{
    char path[4096];
    snprintf(path, sizeof(path), "%s/%s", dir, name);
    FILE *f = fopen(path, "r");
    if (f == NULL) { return 0; }
    int nbnd, nreg, n, m, i;
    if (fscanf(f, "%d %d %d %d", &nbnd, &nreg, &n, &m) != 4) { exit(1); }
    tb->nbnd = nbnd; tb->nsizereg = nreg; tb->n = n; tb->m = m;
    tb->band_lims_wvn = (fp_t **)malloc(2 * sizeof(fp_t *));
    tb->band_lims_wvn[0] = (fp_t *)malloc(nbnd * sizeof(fp_t));
    tb->band_lims_wvn[1] = (fp_t *)malloc(nbnd * sizeof(fp_t));
    tb->pade_sizereg = (fp_t **)malloc(2 * sizeof(fp_t *));
    tb->pade_sizereg[0] = (fp_t *)malloc(nreg * sizeof(fp_t));
    tb->pade_sizereg[1] = (fp_t *)malloc(nreg * sizeof(fp_t));
    tb->pade_sizeref = (fp_t *)malloc(nreg * sizeof(fp_t));
    for (i = 0; i < nbnd; ++i)
    { if (fscanf(f, "%lf", &(tb->band_lims_wvn[0][i])) != 1) exit(1); }
    for (i = 0; i < nbnd; ++i)
    { if (fscanf(f, "%lf", &(tb->band_lims_wvn[1][i])) != 1) exit(1); }
    for (i = 0; i < nreg; ++i)
    { if (fscanf(f, "%lf", &(tb->pade_sizereg[0][i])) != 1) exit(1); }
    for (i = 0; i < nreg; ++i)
    { if (fscanf(f, "%lf", &(tb->pade_sizereg[1][i])) != 1) exit(1); }
    for (i = 0; i < nreg; ++i)
    { if (fscanf(f, "%lf", &(tb->pade_sizeref[i])) != 1) exit(1); }
    tb->pade_ext_p = alloc3(nbnd, nreg, n);
    tb->pade_ext_q = alloc3(nbnd, nreg, m);
    tb->pade_ssa_p = alloc3(nbnd, nreg, n);
    tb->pade_ssa_q = alloc3(nbnd, nreg, m);
    tb->pade_asy_p = alloc3(nbnd, nreg, n);
    tb->pade_asy_q = alloc3(nbnd, nreg, m);
    read3(f, tb->pade_ext_p, nbnd, nreg, n);
    read3(f, tb->pade_ext_q, nbnd, nreg, m);
    read3(f, tb->pade_ssa_p, nbnd, nreg, n);
    read3(f, tb->pade_ssa_q, nbnd, nreg, m);
    read3(f, tb->pade_asy_p, nbnd, nreg, n);
    read3(f, tb->pade_asy_q, nbnd, nreg, m);
    fclose(f);
    return 1;
}

/* Ice particle SIZE [microns] step lookup — clouds_lib.c:43-78 (static
 * there, reproduced digit-for-digit; the radius is size/2). */
static double ice_particle_size_h(double const temperature)
{
    double const tfreeze = 273.16;
    if (temperature > tfreeze - 25.) { return 100.6; }
    else if (temperature > tfreeze - 30.) { return 80.8; }
    else if (temperature > tfreeze - 35.) { return 93.5; }
    else if (temperature > tfreeze - 40.) { return 63.9; }
    else if (temperature > tfreeze - 45.) { return 42.5; }
    else if (temperature > tfreeze - 50.) { return 39.9; }
    else if (temperature > tfreeze - 55.) { return 21.6; }
    return 20.2;
}

/* Per-level trapezoid integration over the spectral grid
 * (output_fluxes, framework/src/driver.c:295-312). */
static void print_integrated(const char *label, fp_t const *flux,
                             int num_levels, SpectralGrid_t grid)
{
    int lev;
    fprintf(out, "%s\n", label);
    for (lev = 0; lev < num_levels; ++lev)
    {
        double total = 0.;
        uint64_t i;
        fp_t const *f = &(flux[(uint64_t)lev * grid.n]);
        for (i = 0; i + 1 < grid.n; ++i)
        {
            total += 0.5 * (f[i] + f[i + 1]) * grid.dw;
        }
        fprintf(out, "%.9e\n", total);
    }
}

int main(int argc, char **argv)
{
    if (argc != 3)
    {
        fprintf(stderr, "usage: %s <input_dir> <output_file>\n", argv[0]);
        return 1;
    }
    const char *dir = argv[1];
    out = fopen(argv[2], "w");
    if (out == NULL) { fprintf(stderr, "cannot open output\n"); return 1; }
    grtcode_set_verbosity(GRTCODE_NONE);

    /* ---- atmosphere (level 0 = TOA) ---- */
    int nlev, i;
    static fp_t p[MAXLEV], t[MAXLEV];
    static fp_t ppmv[5][MAXLEV];       /* H2O CO2 O3 N2O CH4 */
    static fp_t cfc_ppmv[2][MAXLEV];   /* CFC11 CFC12 */
    static fp_t cia_ppmv[2][MAXLEV];   /* N2 O2 */
    double ts, mu, tsi;
    static double emis_w[MAXSPEC], emis_v[MAXSPEC];
    static double alb_w[MAXSPEC], alb_v[MAXSPEC];
    int n_emis, n_alb;
    {
        FILE *f = fopen(join(dir, "atm.txt"), "r");
        if (f == NULL) { fprintf(stderr, "no atm.txt\n"); return 1; }
        if (fscanf(f, "%d", &nlev) != 1 || nlev > MAXLEV) return 1;
        for (i = 0; i < nlev; ++i)
        {
            double v[11];
            int j;
            for (j = 0; j < 11; ++j)
            {
                if (fscanf(f, "%lf", &(v[j])) != 1) return 1;
            }
            p[i] = v[0]; t[i] = v[1];
            for (j = 0; j < 5; ++j) ppmv[j][i] = v[2 + j];
            cfc_ppmv[0][i] = v[7]; cfc_ppmv[1][i] = v[8];
            cia_ppmv[0][i] = v[9]; cia_ppmv[1][i] = v[10];
        }
        if (fscanf(f, "%lf %lf %lf", &ts, &mu, &tsi) != 3) return 1;
        if (fscanf(f, "%d", &n_emis) != 1 || n_emis > MAXSPEC) return 1;
        for (i = 0; i < n_emis; ++i)
        {
            if (fscanf(f, "%lf %lf", &(emis_w[i]), &(emis_v[i])) != 2)
                return 1;
        }
        if (fscanf(f, "%d", &n_alb) != 1 || n_alb > MAXSPEC) return 1;
        for (i = 0; i < n_alb; ++i)
        {
            if (fscanf(f, "%lf %lf", &(alb_w[i]), &(alb_v[i])) != 2)
                return 1;
        }
        fclose(f);
    }
    /* Optional CS/AF tier inputs (absent -> clear-clean only). */
    {
        FILE *f = fopen(join(dir, "aerosol.txt"), "r");
        if (f != NULL)
        {
            int nl;
            if (fscanf(f, "%d %lf", &nl, &alpha_a) != 2) { return 1; }
            for (i = 0; i < nl; ++i)
            {
                if (fscanf(f, "%lf %lf %lf", &(aero_tau1um[i]),
                           &(aero_omega[i]), &(aero_gf[i])) != 3)
                { return 1; }
            }
            fclose(f);
            have_aero = 1;
        }
        f = fopen(join(dir, "cloud.txt"), "r");
        if (f != NULL)
        {
            int nl;
            if (fscanf(f, "%d", &nl) != 1) { return 1; }
            for (i = 0; i < nl; ++i)
            {
                if (fscanf(f, "%lf %lf %lf", &(cld_ql[i]), &(cld_qi[i]),
                           &(cld_thick[i])) != 3) { return 1; }
            }
            fclose(f);
            have_cloud = read_pade(dir, "pade_liquid.txt", &liquid_tbl) &&
                read_pade(dir, "pade_ice.txt", &ice_tbl);
        }
    }

    int num_layers = nlev - 1;
    static fp_t t_layers[MAXLEV];
    for (i = 0; i < num_layers; ++i)
    {
        /* Layer temperature midpoints (calc_pressures_and_temperatures,
         * utilities/src/curtis_godson.c). */
        t_layers[i] = 0.5 * (t[i] + t[i + 1]);
    }

    Device_t device;
    CHECK(create_device(&device, NULL));

    /* ---- grids (driver.c:916-921 pattern, custom bounds) ---- */
    SpectralGrid_t lw_grid, sw_grid;
    CHECK(create_spectral_grid(&lw_grid, 1.0, 3250.0, 0.1));
    CHECK(create_spectral_grid(&sw_grid, 2000.0, 20000.0, 1.0));

    int method = line_sample;   /* driver.c:618 */
    int molecules[5] = {1, 2, 3, 4, 6};
    int band;
    static fp_t flux_up[MAXLEV * 50000], flux_down[MAXLEV * 50000];

    fprintf(out, "nlev %d\n", nlev);
    for (band = 0; band < 2; ++band)
    {
        SpectralGrid_t grid = band == 0 ? lw_grid : sw_grid;
        GasOptics_t lbl;
        {
            /* join() reuses one static buffer — materialize each path. */
            char par[4096], h2o[4096], o3[4096];
            snprintf(par, sizeof(par), "%s/synthetic.par", dir);
            snprintf(h2o, sizeof(h2o), "%s/h2o_ctm", dir);
            snprintf(o3, sizeof(o3), "%s/o3_ctm.csv", dir);
            CHECK(create_gas_optics(&lbl, nlev, &grid, &device, par, h2o,
                                    o3, NULL, &method));
        }
        for (i = 0; i < 5; ++i)
        {
            CHECK(add_molecule(&lbl, molecules[i], NULL, NULL));
            CHECK(set_molecule_ppmv(&lbl, molecules[i], ppmv[i]));
        }
        CHECK(add_cfc(&lbl, CFC11, join(dir, "cfc11.csv")));
        CHECK(set_cfc_ppmv(&lbl, CFC11, cfc_ppmv[0]));
        CHECK(add_cfc(&lbl, CFC12, join(dir, "cfc12.csv")));
        CHECK(set_cfc_ppmv(&lbl, CFC12, cfc_ppmv[1]));
        CHECK(add_cia(&lbl, CIA_N2, CIA_N2, join(dir, "cia_n2n2.csv")));
        CHECK(add_cia(&lbl, CIA_O2, CIA_N2, join(dir, "cia_o2n2.csv")));
        CHECK(set_cia_ppmv(&lbl, CIA_N2, cia_ppmv[0]));
        CHECK(set_cia_ppmv(&lbl, CIA_O2, cia_ppmv[1]));

        Optics_t optics_gas, optics_rayleigh, optics_total;
        CHECK(create_optics(&optics_gas, num_layers, &grid, &device));
        CHECK(create_optics(&optics_rayleigh, num_layers, &grid, &device));
        CHECK(calculate_optical_depth(&lbl, p, t, &optics_gas));
        CHECK(rayleigh_scattering(&optics_rayleigh, p));
        Optics_t const *optics_array[4] =
            {&optics_gas, &optics_rayleigh, NULL, NULL};
        CHECK(add_optics(optics_array, 2, &optics_total));

        /* CS tier optics: aerosols via the live Angstrom-law sampling
         * (circ.c:363-410; the driver wiring at driver.c:426-431 whose
         * calculate_aerosol_optics body ships commented out — this pins
         * the revived contract) + the live update_optics/add_optics. */
        Optics_t optics_aero, optics_cs;
        if (have_aero)
        {
            CHECK(create_optics(&optics_aero, num_layers, &grid,
                                &device));
            size_t nel = (size_t)num_layers * grid.n;
            fp_t *ta = (fp_t *)malloc(nel * sizeof(fp_t));
            fp_t *oa = (fp_t *)malloc(nel * sizeof(fp_t));
            fp_t *ga = (fp_t *)malloc(nel * sizeof(fp_t));
            int lay;
            uint64_t j;
            for (lay = 0; lay < num_layers; ++lay)
            {
                for (j = 0; j < grid.n; ++j)
                {
                    /* circ.c:386-388: lambda[um] = 1e4 / w;
                     * tau = tau_1um * lambda^-alpha. */
                    double lambda = 1.e4 / (grid.w0 + j * grid.dw);
                    ta[lay * grid.n + j] =
                        aero_tau1um[lay] * pow(lambda, -1. * alpha_a);
                    oa[lay * grid.n + j] = aero_omega[lay];
                    ga[lay * grid.n + j] = aero_gf[lay];
                }
            }
            CHECK(update_optics(&optics_aero, ta, oa, ga));
            free(ta); free(oa); free(ga);
            optics_array[2] = &optics_aero;
            CHECK(add_optics(optics_array, 3, &optics_cs));
        }

        /* AF tier optics: deterministic condensate through the
         * reference's compute_all_from_pade + map_band_wave chain
         * (driver.c:475-540 with sample_condensate bypassed; tau =
         * extinction * thickness, driver.c:519-527). */
        Optics_t optics_liq, optics_ice, optics_af;
        if (have_cloud)
        {
            /* Pseudo-band edges per grid point (driver.c:476-492). */
            fp_t *band_limits =
                (fp_t *)malloc((grid.n + 1) * sizeof(fp_t));
            uint64_t j;
            for (j = 1; j < grid.n; ++j)
            {
                band_limits[j] = grid.w0 + (j - 0.5) * grid.dw;
            }
            band_limits[0] = grid.w0 - grid.dw;
            if (band_limits[0] < 0.) { band_limits[0] = 0.; }
            band_limits[grid.n] = grid.w0 + (grid.n - 1 + 1.0) * grid.dw;

            OpticalProperties_t liq_o, ice_o;
            construct_optics(&liq_o, liquid_tbl.nbnd,
                             (const double * const *)
                             liquid_tbl.band_lims_wvn);
            construct_optics(&ice_o, ice_tbl.nbnd,
                             (const double * const *)
                             ice_tbl.band_lims_wvn);
            size_t nel = (size_t)num_layers * grid.n;
            double *bl = (double *)calloc(nel, sizeof(double));
            double *ol = (double *)calloc(nel, sizeof(double));
            double *gl = (double *)calloc(nel, sizeof(double));
            double *bi = (double *)calloc(nel, sizeof(double));
            double *oi = (double *)calloc(nel, sizeof(double));
            double *gi = (double *)calloc(nel, sizeof(double));
            int ib, lay;
            for (ib = 0; ib < liquid_tbl.nbnd; ++ib)
            {
                for (lay = 0; lay < num_layers; ++lay)
                {
                    compute_all_from_pade(&liquid_tbl, cld_ql[lay], 10.0,
                                          &liq_o, ib);
                    map_band_wave(liq_o, &ib, band_limits,
                                  lay * (int)grid.n, (int)grid.n,
                                  bl, ol, gl);
                }
            }
            for (ib = 0; ib < ice_tbl.nbnd; ++ib)
            {
                for (lay = 0; lay < num_layers; ++lay)
                {
                    double rice =
                        ice_particle_size_h(t_layers[lay]) / 2.0;
                    compute_all_from_pade(&ice_tbl, cld_qi[lay], rice,
                                          &ice_o, ib);
                    map_band_wave(ice_o, &ib, band_limits,
                                  lay * (int)grid.n, (int)grid.n,
                                  bi, oi, gi);
                }
            }
            for (lay = 0; lay < num_layers; ++lay)
            {
                for (j = 0; j < grid.n; ++j)
                {
                    bl[lay * grid.n + j] *= cld_thick[lay];
                    bi[lay * grid.n + j] *= cld_thick[lay];
                }
            }
            CHECK(create_optics(&optics_liq, num_layers, &grid, &device));
            CHECK(create_optics(&optics_ice, num_layers, &grid, &device));
            CHECK(update_optics(&optics_liq, bl, ol, gl));
            CHECK(update_optics(&optics_ice, bi, oi, gi));
            free(bl); free(ol); free(gl);
            free(bi); free(oi); free(gi);
            free(band_limits);
            optics_array[2] = &optics_liq;
            optics_array[3] = &optics_ice;
            CHECK(add_optics(optics_array, 4, &optics_af));
        }

        if (band == 0)
        {
            /* LW pass (column_calculation, driver.c:385-401). */
            static fp_t emis_grid[50000];
            CHECK(interpolate_to_grid(grid, emis_w, emis_v,
                                      (size_t)n_emis, emis_grid,
                                      linear_sample, NULL));
            Longwave_t lw;
            CHECK(create_longwave(&lw, nlev, &grid, &device));
            CHECK(calculate_lw_fluxes(&lw, &optics_total, ts, t_layers, t,
                                      emis_grid, flux_up, flux_down));
            print_integrated("rlu", flux_up, nlev, grid);
            print_integrated("rld", flux_down, nlev, grid);
            if (have_aero)
            {
                CHECK(calculate_lw_fluxes(&lw, &optics_cs, ts, t_layers,
                                          t, emis_grid, flux_up,
                                          flux_down));
                print_integrated("rlu_cs", flux_up, nlev, grid);
                print_integrated("rld_cs", flux_down, nlev, grid);
            }
            if (have_cloud)
            {
                CHECK(calculate_lw_fluxes(&lw, &optics_af, ts, t_layers,
                                          t, emis_grid, flux_up,
                                          flux_down));
                print_integrated("rlu_af", flux_up, nlev, grid);
                print_integrated("rld_af", flux_down, nlev, grid);
            }
            CHECK(destroy_longwave(&lw));
        }
        else
        {
            /* SW pass (driver.c:404-421). */
            static fp_t alb_dir[50000], alb_dif[50000];
            CHECK(interpolate_to_grid(grid, alb_w, alb_v, (size_t)n_alb,
                                      alb_dir, linear_sample, NULL));
            memcpy(alb_dif, alb_dir, grid.n * sizeof(fp_t));
            SolarFlux_t solar;
            CHECK(create_solar_flux(&solar, &grid, join(dir, "solar.csv")));
            Shortwave_t sw;
            CHECK(create_shortwave(&sw, nlev, &grid, &device));
            CHECK(calculate_sw_fluxes(&sw, &optics_total, mu, 0.5, alb_dir,
                                      alb_dif, tsi, solar.incident_flux,
                                      flux_up, flux_down));
            print_integrated("rsu", flux_up, nlev, grid);
            print_integrated("rsd", flux_down, nlev, grid);
            if (have_aero)
            {
                CHECK(calculate_sw_fluxes(&sw, &optics_cs, mu, 0.5,
                                          alb_dir, alb_dif, tsi,
                                          solar.incident_flux,
                                          flux_up, flux_down));
                print_integrated("rsu_cs", flux_up, nlev, grid);
                print_integrated("rsd_cs", flux_down, nlev, grid);
            }
            if (have_cloud)
            {
                CHECK(calculate_sw_fluxes(&sw, &optics_af, mu, 0.5,
                                          alb_dir, alb_dif, tsi,
                                          solar.incident_flux,
                                          flux_up, flux_down));
                print_integrated("rsu_af", flux_up, nlev, grid);
                print_integrated("rsd_af", flux_down, nlev, grid);
                if (getenv("HARNESS_DEBUG_LEVEL") != NULL)
                {
                    int ld = atoi(getenv("HARNESS_DEBUG_LEVEL"));
                    uint64_t j2;
                    for (j2 = 0; j2 < grid.n; ++j2)
                    {
                        fprintf(stderr, "DBGS %llu %.9e %.9e\n",
                                (unsigned long long)j2,
                                flux_up[(uint64_t)ld * grid.n + j2],
                                flux_down[(uint64_t)ld * grid.n + j2]);
                    }
                }
                if (getenv("HARNESS_DEBUG_POINT") != NULL)
                {
                    uint64_t jd =
                        strtoull(getenv("HARNESS_DEBUG_POINT"), NULL, 10);
                    int lay;
                    fprintf(stderr, "DBG point %llu w=%.6f solar=%.9e "
                            "alb=%.9e\n", (unsigned long long)jd,
                            grid.w0 + jd * grid.dw,
                            solar.incident_flux[jd], alb_dir[jd]);
                    for (lay = 0; lay < num_layers; ++lay)
                    {
                        fprintf(stderr, "DBG lay %d tau=%.9e omega=%.9e "
                                "g=%.9e\n", lay,
                                optics_af.tau[lay * grid.n + jd],
                                optics_af.omega[lay * grid.n + jd],
                                optics_af.g[lay * grid.n + jd]);
                    }
                    for (lay = 0; lay < nlev; ++lay)
                    {
                        fprintf(stderr, "DBG lev %d up=%.9e down=%.9e\n",
                                lay, flux_up[(uint64_t)lay * grid.n + jd],
                                flux_down[(uint64_t)lay * grid.n + jd]);
                    }
                }
            }
            CHECK(destroy_shortwave(&sw));
            CHECK(destroy_solar_flux(&solar));
        }
        CHECK(destroy_optics(&optics_gas));
        CHECK(destroy_optics(&optics_rayleigh));
        CHECK(destroy_optics(&optics_total));
        if (have_aero)
        {
            CHECK(destroy_optics(&optics_aero));
            CHECK(destroy_optics(&optics_cs));
        }
        if (have_cloud)
        {
            CHECK(destroy_optics(&optics_liq));
            CHECK(destroy_optics(&optics_ice));
            CHECK(destroy_optics(&optics_af));
        }
        CHECK(destroy_gas_optics(&lbl));
    }
    fclose(out);
    return 0;
}
