"""Cloud physics (L3b): stochastic subcolumns + Pade band optics.

Re-design of the clouds library (clouds/clouds_lib.c, also the
dependencies/clouds-lib submodule): the incomplete-beta netCDF lookup
tables become exact `betainc` evaluations with a jittable bisection
inverse; the non-reentrant `rand()` subcolumn generator
(stochastic_clouds.c:16-21) becomes counter-based `jax.random` keys
(deterministic and batchable); Pade band optics evaluate vectorized over
(layer, band).
"""
from .beta import beta_value, beta_inverse
from .stochastic import overlap_parameter, cloudiness, sample_condensate
from .pade import PadeCloudOptics
from .hu_stamnes import HuStamnesLiquidOptics
from .lib import CloudOpticsLib, ice_particle_size

__all__ = ["beta_value", "beta_inverse", "overlap_parameter", "cloudiness",
           "sample_condensate", "PadeCloudOptics", "HuStamnesLiquidOptics",
           "CloudOpticsLib", "ice_particle_size"]
