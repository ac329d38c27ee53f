"""Optimizers of the inverse problem: Gauss-Newton on the device's adjoint
Jacobian, with the normal equations on the host.  The trust-region,
gradient-descent, coordinate-descent, Newton and L-BFGS optimizers are not
ported yet (ROADMAP Queue 1, item D)."""
from .local import optResult
from .second_order import JointResidual, optimize_gauss_newton

__all__ = ["JointResidual", "optResult", "optimize_gauss_newton"]
