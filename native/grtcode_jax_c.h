/* C ABI for the grtcode_jax framework.
 *
 * Equivalent of the reference's opaque-struct C API +
 * fortran-bindings shim (fortran-bindings/grtcode_fortran.F90:585-893,
 * malloc_structs.c:40-67): opaque structs become int64 handles, every call
 * returns GRT_SUCCESS (0) or a nonzero error code whose message is
 * retrievable with grt_errstr() (mirrors grtcode_errstr,
 * utilities/src/verbosity.c:46-58).
 *
 * The implementation (grtcode_jax_c.cpp) embeds CPython and dispatches into
 * grtcode_jax.bindings.capi_impl; all compute runs the jit-compiled JAX /
 * Pallas pipeline on whatever accelerator jax selects.
 */
#ifndef GRTCODE_JAX_C_H_
#define GRTCODE_JAX_C_H_

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

/* Return codes, mirroring the reference's grtcode_return_codes
 * (utilities/src/return_codes.h:25-40).  Python exceptions raised inside
 * the implementation map onto these: ValueError -> GRT_VALUE_ERR,
 * IndexError/KeyError -> GRT_RANGE_ERR, OSError family -> GRT_IO_ERR,
 * ZeroDivisionError -> GRT_DIVBYZERO_ERR, OverflowError ->
 * GRT_OVERFLOW_ERR, FloatingPointError -> GRT_INVALID_ERR,
 * MemoryError -> GRT_NON_NULL_ERR, NotImplementedError ->
 * GRT_COMPILER_ERR, device/runtime failures -> GRT_GPU_ERR, anything
 * else -> GRT_SENTINEL_ERR.  grt_errstr() carries the message. */
enum grt_return_codes {
  GRT_SUCCESS = 0,
  GRT_INVALID_ERR,
  GRT_DIVBYZERO_ERR,
  GRT_OVERFLOW_ERR,
  GRT_UNDERFLOW_ERR,
  GRT_SENTINEL_ERR,
  GRT_NULL_ERR,
  GRT_NON_NULL_ERR,
  GRT_RANGE_ERR,
  GRT_VALUE_ERR,
  GRT_COMPILER_ERR,
  GRT_IO_ERR,
  GRT_GPU_ERR
};

typedef int64_t grt_handle;

/* Runtime lifecycle.  grt_initialize is idempotent and safe inside an
 * already-running interpreter (the test path); when called from a plain
 * C/Fortran program it boots an embedded CPython. */
int grt_initialize(void);
int grt_finalize(void);
const char *grt_errstr(void);

/* Verbosity: 0 = none, 1 = warnings, 2 = info (grtcode_set_verbosity,
 * utilities/src/verbosity.c:28-44). */
int grt_set_verbosity(int level);

/* Device (utilities/src/device.c:26-75).  id >= 0 selects
 * jax.devices()[id]; id = -1 selects the host CPU.  The first device
 * created becomes the default placement for all compute entry points
 * (mirroring the Device_t handed to create_gas_optics in the reference);
 * grt_use_device switches the default explicitly. */
int grt_create_device(int device_id, grt_handle *out);
int grt_use_device(grt_handle device);
int grt_num_devices(int *out);

/* Spectral grid (utilities/src/spectral_grid.c:32-112). */
int grt_create_spectral_grid(double w0, double wn, double dw,
                             grt_handle *out);
/* props = {w0, num_points, dw} (f_spectral_grid_properties). */
int grt_spectral_grid_properties(grt_handle grid, double props[3]);

/* Optics container (utilities/src/optics.c:84-357).  Arrays are
 * row-major (num_layers, num_wavenumbers). */
int grt_create_optics(int num_layers, grt_handle grid, grt_handle *out);
int grt_optics_properties(grt_handle optics, double *tau, double *omega,
                          double *g);
/* Weighted combine of n optics objects into `result`
 * (add_optics_objects, optics.c:128-148). */
int grt_add_optics(grt_handle result, const grt_handle *parts, int n);

/* Solar flux (shortwave/src/solar_flux.c:27-99). */
int grt_create_solar_flux(grt_handle grid, const char *csv_path,
                          grt_handle *out);
int grt_solar_flux_properties(grt_handle solar, double *incident_flux);

/* Gas optics (gas-optics/src/gas_optics.h:39-180).  Paths may be NULL/""
 * to skip the corresponding continuum. */
int grt_create_gas_optics(grt_handle grid, int num_levels,
                          const char *hitran_path, const char *h2o_ctm_dir,
                          const char *o3_ctm_file, grt_handle *out);
/* min/max_line_center <= 0 means "use the grid bounds". */
int grt_add_molecule(grt_handle gas, int molecule_id, double min_line_center,
                     double max_line_center);
int grt_num_molecules(grt_handle gas, int *out);
int grt_set_molecule_ppmv(grt_handle gas, int molecule_id,
                          const double *ppmv /* num_levels */);
int grt_add_cfc(grt_handle gas, int cfc_id, const char *csv_path);
int grt_set_cfc_ppmv(grt_handle gas, int cfc_id, const double *ppmv);
int grt_add_cia(grt_handle gas, int species1, int species2,
                const char *csv_path);
int grt_set_cia_ppmv(grt_handle gas, int species_id, const double *ppmv);
/* Fills `optics` with absorption-only gas tau (f_calculate_optics ->
 * calculate_optical_depth, gas_optics.c:433). */
int grt_calculate_optical_depth(grt_handle gas,
                                const double *pressure_mb /* num_levels */,
                                const double *temperature /* num_levels */,
                                grt_handle optics);

/* Rayleigh scattering optics from level pressures [mb]
 * (shortwave/src/rayleigh.c:100-144). */
int grt_rayleigh_scattering(grt_handle optics, const double *pressure_mb);

/* Solvers (C-only in the reference: longwave.c:312, shortwave.c:506).
 * Outputs are row-major (num_levels, num_wavenumbers) in W cm m-2.
 * t_layers is the num_layers layer-temperature array (explicit, matching
 * calculate_lw_fluxes, longwave/src/longwave.c:312); pass NULL to use the
 * level-midpoint approximation 0.5*(T_lev[i] + T_lev[i+1]). */
int grt_longwave_fluxes(grt_handle optics, double t_surf,
                        const double *t_levels, const double *t_layers,
                        const double *emissivity, double *flux_up,
                        double *flux_down);
int grt_shortwave_fluxes(grt_handle optics, double mu_dir, double mu_dif,
                         const double *albedo_dir, const double *albedo_dif,
                         double total_solar_irradiance, grt_handle solar,
                         double *flux_up, double *flux_down);

/* Frees any handle (destroy_* family). */
int grt_destroy(grt_handle h);

#ifdef __cplusplus
} /* extern "C" */
#endif

#endif /* GRTCODE_JAX_C_H_ */
