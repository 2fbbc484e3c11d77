"""Multi-chip parallelism: device meshes and sharded radiative transfer.

Replacement for the reference's scale-out story (SLURM scripts
sharding the column dimension + post-hoc netCDF combiners,
GRTworkflow/run-rfmip-irf.sh:102-125, GRTworkflow/combiner.py): a 2-D
(columns x spectral) `jax.sharding.Mesh` where columns are embarrassingly
parallel and each spectral shard computes its own wavenumber window of
optical depth and fluxes, reducing integrated fluxes with `psum`.
"""
from .mesh import make_mesh
from .clear_sky import ClearSkyRT

__all__ = ["make_mesh", "ClearSkyRT"]
