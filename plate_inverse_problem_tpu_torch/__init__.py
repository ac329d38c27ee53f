"""plate_inverse_problem_tpu_torch — the PyTorch / CUDA port of
``plate_inverse_problem_tpu`` for NVIDIA Hopper (H100).

It runs the JAX package's three sweep engines: the mixed engine end to
end on its three tiers, and the modal (one generalized eigh per parameter
set) and direct (chunked dense LU) engines, which take frequency-dependent
materials too (``Problem(engine=...)``; ``engine=None`` picks as the JAX
package does for the device).  Every engine runs every material
family (isotropic, orthotropic, orthotropic with a loss factor per modulus,
and the simple orthotropic laminates) on both plate paths: the 3-field
laminate operator with the accelerometer readout, and the pure-bending
operator of a mid-plane symmetric plate without an accelerometer, read at
its test point.  The mixed engine's operator runs on the flat pattern or
in the RCM block-tridiagonal layout, in an f64 FGMRES sweep with an f32
complement preconditioner (the dense inverse of the reference stiffness
up to 12288 DOF, above it a two-grid cycle whose band matvec is a
hand-written CUDA kernel, ``csrc/band_mv.cu``, or on the flat layout a
recursive multilevel cycle); the flat-pattern operator of every engine,
and every product of the multilevel cycle, is a second hand-written
kernel, ``csrc/csr_mv.cu``, which sums in one fixed order, so a sweep
gives the same bits in every run.  The band basis comes from ARPACK on
the host or, factorization-free, from LOBPCG on the card
(``basis="lobpcg"``).  The inverse problem runs on it:
the adjoint and the forward-mode (tangent) sweeps, the loss with its
gradient and Hessian, the adjoint and forward-mode Gauss-Newton
Jacobians, ``Problem.solveInverse`` by Gauss-Newton, trust region,
Newton, L-BFGS, gradient and coordinate descent and scipy's global
optimizers, with FRF compression; ``Problem.diagnoseSweep`` reports each
frequency's convergence and ``Problem.getModePicture`` draws a deflection
shape.  Geometries come from templates, FreeFEM ``.edp`` scripts or
``.msh`` meshes.  ``plate_inverse_problem_tpu_torch.ops`` holds the
reference's standalone sparse API (``create_symbolic``, ``matvec``,
``spsolve``, ``find_permutation``) for any square system.
``diagnostics`` audits a sweep against the host f64 splu
(``oracle_check``), polishes its resonance peaks by one exact host
residual (``polish_peaks``, also ``solveForward(polish_peaks=...)``),
runs the parity study's modal expansion, guards against non-finite
values, captures ``torch.profiler`` traces and reports the devices;
``compat`` gives the reference's module layout; ``parallel`` shards the
sweep, the training step and the Gauss-Newton step over
``torch.distributed`` ranks.  The package imports
torch, numpy and scipy, never jax (matplotlib only inside
``getModePicture`` and the plotting helpers).
"""
from . import config, parallel
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
    optimize_lbfgs,
    optimize_newton,
    optimize_trust_region,
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
    "optimize_lbfgs",
    "optimize_newton",
    "optimize_trust_region",
    "parallel",
    "save_msh",
]
