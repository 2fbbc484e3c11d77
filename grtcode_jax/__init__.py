"""grtcode_jax — a JAX line-by-line radiative transfer framework.

A ground-up JAX / XLA / Pallas re-design with the capabilities of
NOAA-GFDL GRTCODE: HITRAN line-by-line gas optics (Voigt profiles, MT-CKD
water-vapor + ozone continua, CFC/HFC cross-sections, collision-induced
absorption), a four-stream longwave solver, a delta-Eddington + adding
two-stream shortwave solver, Rayleigh scattering, stochastic-overlap cloud
optics, and drivers for the CIRC, RFMIP-IRF, and ERA5 benchmarks — batched
over columns and sharded over (column x spectral) device meshes.
"""

__version__ = "0.1.0"

from .spectral import SpectralGrid  # noqa: F401
from .optics import Optics, combine  # noqa: F401
