// C ABI implementation: a thin C++ shim that embeds CPython and dispatches
// into grtcode_jax.bindings.capi_impl.
//
// Equivalent of the reference's fortran-bindings C shim
// (fortran-bindings/malloc_structs.c:40-67): instead of malloc'ing opaque
// structs for a C library, the shim holds int64 handles into a Python-side
// registry and crosses buffers as zero-copy memoryviews.  All numerics run
// in the jit-compiled JAX/Pallas pipeline — this file contains no compute.
//
// Build: see native/Makefile (g++ + python3-config --embed).

#include "grtcode_jax_c.h"

#include <Python.h>

#include <cstdio>
#include <cstring>
#include <mutex>

namespace {

char g_err[4096] = "";
bool g_we_initialized = false;
bool g_finalized = false;
std::mutex g_init_mutex;
PyObject *g_impl_module = nullptr;  // cached capi_impl module (owned ref)

int g_errcode = GRT_SENTINEL_ERR;  // code of the last captured exception

// Exception type name -> reference return code (return_codes.h:25-40).
int code_for_exception(const char *type_name) {
  if (!type_name) return GRT_SENTINEL_ERR;
  struct Entry {
    const char *name;
    int code;
  };
  static const Entry kMap[] = {
      {"ValueError", GRT_VALUE_ERR},
      {"IndexError", GRT_RANGE_ERR},
      {"KeyError", GRT_RANGE_ERR},
      {"FileNotFoundError", GRT_IO_ERR},
      {"PermissionError", GRT_IO_ERR},
      {"IsADirectoryError", GRT_IO_ERR},
      {"OSError", GRT_IO_ERR},
      {"IOError", GRT_IO_ERR},
      {"ZeroDivisionError", GRT_DIVBYZERO_ERR},
      {"OverflowError", GRT_OVERFLOW_ERR},
      {"FloatingPointError", GRT_INVALID_ERR},
      {"MemoryError", GRT_NON_NULL_ERR},
      {"NotImplementedError", GRT_COMPILER_ERR},
      {"XlaRuntimeError", GRT_GPU_ERR},
      {"RuntimeError", GRT_GPU_ERR},
  };
  for (const Entry &e : kMap) {
    if (std::strcmp(type_name, e.name) == 0) return e.code;
  }
  return GRT_SENTINEL_ERR;
}

// Capture the pending Python exception (with traceback) into g_err and
// translate its type to a return code in g_errcode.
void capture_py_error() {
  PyObject *type = nullptr, *value = nullptr, *tb = nullptr;
  PyErr_Fetch(&type, &value, &tb);
  PyErr_NormalizeException(&type, &value, &tb);
  PyObject *str = value ? PyObject_Str(value) : nullptr;
  const char *msg = str ? PyUnicode_AsUTF8(str) : "python error";
  PyObject *tname =
      type ? PyObject_GetAttrString(type, "__name__") : nullptr;
  const char *tn = tname ? PyUnicode_AsUTF8(tname) : "Exception";
  std::snprintf(g_err, sizeof(g_err), "%s: %s", tn ? tn : "Exception",
                msg ? msg : "");
  g_errcode = code_for_exception(tn);
  Py_XDECREF(tname);
  Py_XDECREF(str);
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
}

// RAII GIL scope: every ABI entry point runs under this.
struct Gil {
  PyGILState_STATE state;
  Gil() : state(PyGILState_Ensure()) {}
  ~Gil() { PyGILState_Release(state); }
};

PyObject *impl_module() {
  if (!g_impl_module) {
    g_impl_module = PyImport_ImportModule("grtcode_jax.bindings.capi_impl");
    if (!g_impl_module) capture_py_error();
  }
  return g_impl_module;
}

// True when the interpreter is up; otherwise set g_err and fail fast so a
// call after grt_finalize (or before grt_initialize) returns an error code
// instead of crashing inside PyGILState_Ensure.
bool interpreter_ready() {
  if (Py_IsInitialized()) return true;
  std::snprintf(g_err, sizeof(g_err),
                "grtcode_jax: interpreter not running (call grt_initialize)");
  return false;
}

// Call capi_impl.<fn>(*args); returns new ref or nullptr (g_err set).
PyObject *call(const char *fn, PyObject *args /* stolen */) {
  PyObject *mod = impl_module();
  if (!mod) {
    Py_XDECREF(args);
    return nullptr;
  }
  PyObject *f = PyObject_GetAttrString(mod, fn);
  if (!f) {
    capture_py_error();
    Py_XDECREF(args);
    return nullptr;
  }
  PyObject *res = PyObject_CallObject(f, args);
  Py_DECREF(f);
  Py_XDECREF(args);
  if (!res) capture_py_error();
  return res;
}

// Variants returning an int / int64 result or filling nothing.  On a
// Python exception they return the translated reference return code.
int call_status(const char *fn, PyObject *args) {
  PyObject *r = call(fn, args);
  if (!r) return g_errcode;
  long rc = PyLong_Check(r) ? PyLong_AsLong(r) : 0;
  Py_DECREF(r);
  return static_cast<int>(rc);
}

int call_handle(const char *fn, PyObject *args, grt_handle *out) {
  PyObject *r = call(fn, args);
  if (!r) return g_errcode;
  *out = static_cast<grt_handle>(PyLong_AsLongLong(r));
  Py_DECREF(r);
  return GRT_SUCCESS;
}

int call_int(const char *fn, PyObject *args, int *out) {
  PyObject *r = call(fn, args);
  if (!r) return g_errcode;
  *out = static_cast<int>(PyLong_AsLong(r));
  Py_DECREF(r);
  return GRT_SUCCESS;
}

// Zero-copy views over caller buffers (n doubles).
PyObject *mv_ro(const double *p, Py_ssize_t n) {
  return PyMemoryView_FromMemory(
      reinterpret_cast<char *>(const_cast<double *>(p)),
      n * static_cast<Py_ssize_t>(sizeof(double)), PyBUF_READ);
}
PyObject *mv_rw(double *p, Py_ssize_t n) {
  return PyMemoryView_FromMemory(reinterpret_cast<char *>(p),
                                 n * static_cast<Py_ssize_t>(sizeof(double)),
                                 PyBUF_WRITE);
}

PyObject *str_or_empty(const char *s) {
  return PyUnicode_FromString(s ? s : "");
}

// Query an int-valued size helper for an optics handle.
int optics_query(const char *fn, grt_handle h, Py_ssize_t *out) {
  int v = 0;
  int rc = call_int(fn, Py_BuildValue("(L)", (long long)h), &v);
  if (rc) return rc;
  *out = v;
  return GRT_SUCCESS;
}

}  // namespace

extern "C" {

int grt_initialize(void) {
  std::lock_guard<std::mutex> lock(g_init_mutex);
  if (g_finalized) {
    // CPython extensions (numpy, jax) do not survive Py_Finalize +
    // Py_Initialize in one process; refuse loudly instead of crashing.
    std::snprintf(g_err, sizeof(g_err),
                  "grtcode_jax: cannot re-initialize after grt_finalize "
                  "(CPython extension modules are not re-initializable); "
                  "restart the process");
    return GRT_SENTINEL_ERR;
  }
  if (!Py_IsInitialized()) {
    Py_InitializeEx(0);
    g_we_initialized = true;
    // Release the GIL acquired by Py_Initialize so later entry points
    // can PyGILState_Ensure from any thread.
    PyEval_SaveThread();
  }
  return GRT_SUCCESS;
}

int grt_finalize(void) {
  // Keep the interpreter alive when the host process owns it (in-process
  // test path); tear down only what we booted.  Idempotent.
  std::lock_guard<std::mutex> lock(g_init_mutex);
  if (g_we_initialized) {
    PyGILState_Ensure();
    Py_CLEAR(g_impl_module);  // drop cache before it dangles
    Py_Finalize();
    g_we_initialized = false;
    g_finalized = true;
  }
  return GRT_SUCCESS;
}

const char *grt_errstr(void) { return g_err; }

int grt_set_verbosity(int level) {
  if (!interpreter_ready()) return GRT_SENTINEL_ERR;
  Gil gil;
  return call_status("set_verbosity", Py_BuildValue("(i)", level));
}

int grt_create_device(int device_id, grt_handle *out) {
  if (!interpreter_ready()) return GRT_SENTINEL_ERR;
  Gil gil;
  return call_handle("create_device", Py_BuildValue("(i)", device_id), out);
}

int grt_use_device(grt_handle device) {
  if (!interpreter_ready()) return GRT_SENTINEL_ERR;
  Gil gil;
  return call_status("use_device", Py_BuildValue("(L)", (long long)device));
}

int grt_num_devices(int *out) {
  if (!interpreter_ready()) return GRT_SENTINEL_ERR;
  Gil gil;
  return call_int("num_devices", PyTuple_New(0), out);
}

int grt_create_spectral_grid(double w0, double wn, double dw,
                             grt_handle *out) {
  if (!interpreter_ready()) return GRT_SENTINEL_ERR;
  Gil gil;
  return call_handle("create_spectral_grid",
                     Py_BuildValue("(ddd)", w0, wn, dw), out);
}

int grt_spectral_grid_properties(grt_handle grid, double props[3]) {
  if (!interpreter_ready()) return GRT_SENTINEL_ERR;
  Gil gil;
  return call_status("spectral_grid_properties",
                     Py_BuildValue("(LN)", (long long)grid, mv_rw(props, 3)));
}

int grt_create_optics(int num_layers, grt_handle grid, grt_handle *out) {
  if (!interpreter_ready()) return GRT_SENTINEL_ERR;
  Gil gil;
  return call_handle("create_optics",
                     Py_BuildValue("(iL)", num_layers, (long long)grid), out);
}

int grt_optics_properties(grt_handle optics, double *tau, double *omega,
                          double *g) {
  if (!interpreter_ready()) return GRT_SENTINEL_ERR;
  Gil gil;
  Py_ssize_t n = 0;
  if (int rc = optics_query("optics_size", optics, &n)) return rc;
  return call_status(
      "optics_properties",
      Py_BuildValue("(LNNN)", (long long)optics, mv_rw(tau, n),
                    mv_rw(omega, n), mv_rw(g, n)));
}

int grt_add_optics(grt_handle result, const grt_handle *parts, int n) {
  if (!interpreter_ready()) return GRT_SENTINEL_ERR;
  Gil gil;
  PyObject *mv = PyMemoryView_FromMemory(
      reinterpret_cast<char *>(const_cast<grt_handle *>(parts)),
      static_cast<Py_ssize_t>(n) * sizeof(grt_handle), PyBUF_READ);
  return call_status("add_optics",
                     Py_BuildValue("(LN)", (long long)result, mv));
}

int grt_create_solar_flux(grt_handle grid, const char *csv_path,
                          grt_handle *out) {
  if (!interpreter_ready()) return GRT_SENTINEL_ERR;
  Gil gil;
  return call_handle(
      "create_solar_flux",
      Py_BuildValue("(LN)", (long long)grid, str_or_empty(csv_path)), out);
}

int grt_solar_flux_properties(grt_handle solar, double *incident_flux) {
  if (!interpreter_ready()) return GRT_SENTINEL_ERR;
  Gil gil;
  // Size = grid points of the bound grid; fetched Python-side via the
  // registry, so pass a view sized by a helper query.
  PyObject *r = call("solar_flux_size",
                     Py_BuildValue("(L)", (long long)solar));
  if (!r) return g_errcode;
  Py_ssize_t n = PyLong_AsSsize_t(r);
  Py_DECREF(r);
  return call_status(
      "solar_flux_properties",
      Py_BuildValue("(LN)", (long long)solar, mv_rw(incident_flux, n)));
}

int grt_create_gas_optics(grt_handle grid, int num_levels,
                          const char *hitran_path, const char *h2o_ctm_dir,
                          const char *o3_ctm_file, grt_handle *out) {
  if (!interpreter_ready()) return GRT_SENTINEL_ERR;
  Gil gil;
  return call_handle(
      "create_gas_optics",
      Py_BuildValue("(LiNNN)", (long long)grid, num_levels,
                    str_or_empty(hitran_path), str_or_empty(h2o_ctm_dir),
                    str_or_empty(o3_ctm_file)),
      out);
}

int grt_add_molecule(grt_handle gas, int molecule_id, double min_line_center,
                     double max_line_center) {
  if (!interpreter_ready()) return GRT_SENTINEL_ERR;
  Gil gil;
  return call_status("add_molecule",
                     Py_BuildValue("(Lidd)", (long long)gas, molecule_id,
                                   min_line_center, max_line_center));
}

int grt_num_molecules(grt_handle gas, int *out) {
  if (!interpreter_ready()) return GRT_SENTINEL_ERR;
  Gil gil;
  return call_int("num_molecules", Py_BuildValue("(L)", (long long)gas), out);
}

int grt_set_molecule_ppmv(grt_handle gas, int molecule_id,
                          const double *ppmv) {
  if (!interpreter_ready()) return GRT_SENTINEL_ERR;
  Gil gil;
  Py_ssize_t nlev = 0;
  if (int rc = optics_query("gas_optics_num_levels", gas, &nlev)) return rc;
  return call_status("set_molecule_ppmv",
                     Py_BuildValue("(LiN)", (long long)gas, molecule_id,
                                   mv_ro(ppmv, nlev)));
}

int grt_add_cfc(grt_handle gas, int cfc_id, const char *csv_path) {
  if (!interpreter_ready()) return GRT_SENTINEL_ERR;
  Gil gil;
  return call_status("add_cfc", Py_BuildValue("(LiN)", (long long)gas, cfc_id,
                                              str_or_empty(csv_path)));
}

int grt_set_cfc_ppmv(grt_handle gas, int cfc_id, const double *ppmv) {
  if (!interpreter_ready()) return GRT_SENTINEL_ERR;
  Gil gil;
  Py_ssize_t nlev = 0;
  if (int rc = optics_query("gas_optics_num_levels", gas, &nlev)) return rc;
  return call_status("set_cfc_ppmv", Py_BuildValue("(LiN)", (long long)gas,
                                                   cfc_id, mv_ro(ppmv, nlev)));
}

int grt_add_cia(grt_handle gas, int species1, int species2,
                const char *csv_path) {
  if (!interpreter_ready()) return GRT_SENTINEL_ERR;
  Gil gil;
  return call_status("add_cia",
                     Py_BuildValue("(LiiN)", (long long)gas, species1,
                                   species2, str_or_empty(csv_path)));
}

int grt_set_cia_ppmv(grt_handle gas, int species_id, const double *ppmv) {
  if (!interpreter_ready()) return GRT_SENTINEL_ERR;
  Gil gil;
  Py_ssize_t nlev = 0;
  if (int rc = optics_query("gas_optics_num_levels", gas, &nlev)) return rc;
  return call_status("set_cia_ppmv",
                     Py_BuildValue("(LiN)", (long long)gas, species_id,
                                   mv_ro(ppmv, nlev)));
}

int grt_calculate_optical_depth(grt_handle gas, const double *pressure_mb,
                                const double *temperature,
                                grt_handle optics) {
  if (!interpreter_ready()) return GRT_SENTINEL_ERR;
  Gil gil;
  Py_ssize_t nlev = 0;
  if (int rc = optics_query("gas_optics_num_levels", gas, &nlev)) return rc;
  return call_status(
      "calculate_optical_depth",
      Py_BuildValue("(LNNL)", (long long)gas, mv_ro(pressure_mb, nlev),
                    mv_ro(temperature, nlev), (long long)optics));
}

int grt_rayleigh_scattering(grt_handle optics, const double *pressure_mb) {
  if (!interpreter_ready()) return GRT_SENTINEL_ERR;
  Gil gil;
  Py_ssize_t n = 0;
  if (int rc = optics_query("optics_size", optics, &n)) return rc;
  Py_ssize_t nw = 0;
  if (int rc = optics_query("optics_num_wavenumbers", optics, &nw)) return rc;
  Py_ssize_t nlev = n / nw + 1;
  return call_status(
      "rayleigh_scattering",
      Py_BuildValue("(LN)", (long long)optics, mv_ro(pressure_mb, nlev)));
}

int grt_longwave_fluxes(grt_handle optics, double t_surf,
                        const double *t_levels, const double *t_layers,
                        const double *emissivity, double *flux_up,
                        double *flux_down) {
  if (!interpreter_ready()) return GRT_SENTINEL_ERR;
  Gil gil;
  Py_ssize_t nflux = 0, nw = 0, n = 0;
  if (int rc = optics_query("optics_levels_size", optics, &nflux)) return rc;
  if (int rc = optics_query("optics_num_wavenumbers", optics, &nw)) return rc;
  if (int rc = optics_query("optics_size", optics, &n)) return rc;
  Py_ssize_t nlev = n / nw + 1;
  PyObject *tlay;
  if (t_layers) {
    tlay = mv_ro(t_layers, nlev - 1);
  } else {
    tlay = Py_None;
    Py_INCREF(tlay);
  }
  return call_status(
      "longwave_fluxes",
      Py_BuildValue("(LdNNNNN)", (long long)optics, t_surf,
                    mv_ro(t_levels, nlev), tlay, mv_ro(emissivity, nw),
                    mv_rw(flux_up, nflux), mv_rw(flux_down, nflux)));
}

int grt_shortwave_fluxes(grt_handle optics, double mu_dir, double mu_dif,
                         const double *albedo_dir, const double *albedo_dif,
                         double total_solar_irradiance, grt_handle solar,
                         double *flux_up, double *flux_down) {
  if (!interpreter_ready()) return GRT_SENTINEL_ERR;
  Gil gil;
  Py_ssize_t nflux = 0, nw = 0;
  if (int rc = optics_query("optics_levels_size", optics, &nflux)) return rc;
  if (int rc = optics_query("optics_num_wavenumbers", optics, &nw)) return rc;
  return call_status(
      "shortwave_fluxes",
      Py_BuildValue("(LddNNdLNN)", (long long)optics, mu_dir, mu_dif,
                    mv_ro(albedo_dir, nw), mv_ro(albedo_dif, nw),
                    total_solar_irradiance, (long long)solar,
                    mv_rw(flux_up, nflux), mv_rw(flux_down, nflux)));
}

int grt_destroy(grt_handle h) {
  if (!interpreter_ready()) return GRT_SENTINEL_ERR;
  Gil gil;
  return call_status("destroy", Py_BuildValue("(L)", (long long)h));
}

}  // extern "C"
