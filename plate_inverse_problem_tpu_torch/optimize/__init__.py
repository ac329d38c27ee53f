"""Optimizers of the inverse problem, as host loops over the device's
values and derivatives: Gauss-Newton on the residual's Jacobian with the
normal equations on the host, the trust-region and damped Newton methods
on the loss Hessian, L-BFGS (optax's algorithm, written out), and the
first-order methods (gradient descent, coordinate descent)."""
from .local import (
    FixedParameterFunction,
    get_model_newt,
    optimize_cd,
    optimize_cd_mem,
    optimize_cd_mem2,
    optimize_gd,
    optimize_trust_region,
    optResult,
    solve_trust_region_model,
)
from .second_order import (
    JointResidual,
    optimize_gauss_newton,
    optimize_lbfgs,
    optimize_newton,
)

__all__ = [
    "FixedParameterFunction",
    "JointResidual",
    "get_model_newt",
    "optResult",
    "optimize_cd",
    "optimize_cd_mem",
    "optimize_cd_mem2",
    "optimize_gauss_newton",
    "optimize_gd",
    "optimize_lbfgs",
    "optimize_newton",
    "optimize_trust_region",
    "solve_trust_region_model",
]
