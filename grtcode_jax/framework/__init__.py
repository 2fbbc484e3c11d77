"""Application framework: the shared radiation driver (L4).

Re-design of framework/src/driver.c: the reference's per-(time, column)
serial loop with per-column kernel launches becomes one batched, jitted,
optionally mesh-sharded computation per sky tier; applications (CIRC,
RFMIP-IRF, ERA5) construct an :class:`Atmosphere` batch and call
:class:`RadiationDriver`.
"""
from .atmosphere import Atmosphere, pressure_interp_layers_to_levels
from .driver import RadiationDriver, FluxResults

__all__ = ["Atmosphere", "RadiationDriver", "FluxResults",
           "pressure_interp_layers_to_levels"]
