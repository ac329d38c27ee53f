"""Optimizers of the inverse problem: Gauss-Newton on the device's adjoint
Jacobian with the normal equations on the host, and the first-order
methods (gradient descent, coordinate descent) as host loops over the
loss's value and gradient.  The trust-region, Newton and L-BFGS
optimizers are not ported yet (ROADMAP Queue 1, item D)."""
from .local import (
    FixedParameterFunction,
    optimize_cd,
    optimize_cd_mem,
    optimize_cd_mem2,
    optimize_gd,
    optResult,
)
from .second_order import JointResidual, optimize_gauss_newton

__all__ = [
    "FixedParameterFunction",
    "JointResidual",
    "optResult",
    "optimize_cd",
    "optimize_cd_mem",
    "optimize_cd_mem2",
    "optimize_gauss_newton",
    "optimize_gd",
]
