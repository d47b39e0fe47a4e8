"""Core: the paper's contribution — combined spatial + temporal blocking."""
from repro_torch.core.blocking import BlockGeometry
from repro_torch.core.boundary import BoundaryCondition
from repro_torch.core.perf_model import Device, Prediction, autotune, predict
from repro_torch.core.stencils import (DIFFUSION2D, DIFFUSION3D, HOTSPOT2D,
                                       HOTSPOT3D, STENCILS, Stencil,
                                       default_coeffs, make_box, make_star)

__all__ = [
    "BlockGeometry", "BoundaryCondition", "DIFFUSION2D", "DIFFUSION3D",
    "Device", "HOTSPOT2D", "HOTSPOT3D", "Prediction", "STENCILS", "Stencil",
    "autotune", "default_coeffs", "make_box", "make_star", "predict",
]
