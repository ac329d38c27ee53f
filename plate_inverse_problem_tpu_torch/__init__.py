"""plate_inverse_problem_tpu_torch — the PyTorch / CUDA port of
``plate_inverse_problem_tpu`` for NVIDIA Hopper (H100).

It runs the mixed engine end to end on its three tiers: the 3-field
plate operator on the flat pattern or in the RCM block-tridiagonal layout,
the f64 FGMRES sweep with an f32 complement preconditioner (the dense
inverse of the reference stiffness up to 12288 DOF, above it a two-grid
cycle whose band matvec is a hand-written CUDA kernel,
``csrc/band_mv.cu``), and the accelerometer readout; and the inverse
problem on it: the adjoint sweep, the loss and its gradient, the
adjoint Gauss-Newton Jacobian and ``Problem.solveInverse(..., "gn")``.
The package imports torch, numpy and scipy, never jax.
"""
from . import config
from .convert import opdata_from_jax
from .models.accelerometer import Accelerometer
from .models.geometry import Geometry, GeometryParams
from .models.materials import get_material
from .models.problem import LossFunction, Problem, ResidualFunction
from .optimize import JointResidual, optimize_gauss_newton, optResult

__version__ = "0.1.0"

__all__ = [
    "Accelerometer",
    "Geometry",
    "GeometryParams",
    "JointResidual",
    "LossFunction",
    "Problem",
    "ResidualFunction",
    "config",
    "get_material",
    "opdata_from_jax",
    "optResult",
    "optimize_gauss_newton",
]
