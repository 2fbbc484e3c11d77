"""Language bindings (Equivalent of fortran-bindings/).

The reference exposes its C API to GFDL Fortran climate models through
``module grtcode`` iso_c_binding wrappers plus a C shim that mallocs opaque
structs (fortran-bindings/grtcode_fortran.F90:20-116, malloc_structs.c:40-67).

Here the equivalent is a stable C ABI (``native/grtcode_jax_c.{h,cpp}``)
implemented by a C++ shared library that embeds CPython and drives the JAX
pipeline, plus ``native/grtcode_jax.F90``, an iso_c_binding Fortran module
mirroring the reference's ``module grtcode`` surface.  :mod:`capi_impl` is the
Python half the C++ shim dispatches into.
"""
