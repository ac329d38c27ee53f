"""plate_inverse_problem_tpu_torch — the PyTorch / CUDA port of
``plate_inverse_problem_tpu`` for NVIDIA Hopper (H100).

It runs the mixed engine end to end on its three tiers, for every material
family (isotropic, orthotropic, orthotropic with a loss factor per modulus,
and the simple orthotropic laminates) and on both plate paths: the 3-field
laminate operator with the accelerometer readout, and the pure-bending
operator of a mid-plane symmetric plate without an accelerometer, read at
its test point.  The operator runs on the flat pattern or in the RCM
block-tridiagonal layout, in an f64 FGMRES sweep with an f32 complement
preconditioner (the dense inverse of the reference stiffness up to 12288
DOF, above it a two-grid cycle whose band matvec is a hand-written CUDA
kernel, ``csrc/band_mv.cu``); the flat-pattern operator is a second
hand-written kernel, ``csrc/csr_mv.cu``, which sums in one fixed order, so
a sweep gives the same bits in every run.  The inverse problem runs on it:
the adjoint sweep, the loss and its gradient, the adjoint Gauss-Newton
Jacobian, ``Problem.solveInverse`` by Gauss-Newton, gradient descent and
coordinate descent, with FRF compression; ``Problem.diagnoseSweep``
reports each frequency's convergence.  Geometries come from templates,
FreeFEM ``.edp`` scripts or ``.msh`` meshes.  The package imports torch,
numpy and scipy, never jax.
"""
from . import config
from .convert import opdata_from_jax
from .io.compress import Compressor
from .models.accelerometer import Accelerometer, AccelerometerParams
from .models.geometry import Geometry, GeometryParams
from .models.materials import (
    ATYPES,
    SOL,
    Isotropic,
    Material,
    Orthotropic,
    OrthotropicD4,
    SymmetricalSOL,
    get_material,
)
from .mesh import TriangleMesh, generate_plate_mesh, load_msh, save_msh
from .models.problem import LossFunction, Problem, ResidualFunction
from .optimize import (
    FixedParameterFunction,
    JointResidual,
    optimize_cd,
    optimize_cd_mem,
    optimize_cd_mem2,
    optimize_gauss_newton,
    optimize_gd,
    optResult,
)

__version__ = "0.1.0"

__all__ = [
    "ATYPES",
    "Accelerometer",
    "AccelerometerParams",
    "Compressor",
    "FixedParameterFunction",
    "Geometry",
    "GeometryParams",
    "Isotropic",
    "JointResidual",
    "LossFunction",
    "Material",
    "Orthotropic",
    "OrthotropicD4",
    "Problem",
    "ResidualFunction",
    "SOL",
    "SymmetricalSOL",
    "TriangleMesh",
    "config",
    "generate_plate_mesh",
    "get_material",
    "load_msh",
    "opdata_from_jax",
    "optResult",
    "optimize_cd",
    "optimize_cd_mem",
    "optimize_cd_mem2",
    "optimize_gauss_newton",
    "optimize_gd",
    "save_msh",
]
