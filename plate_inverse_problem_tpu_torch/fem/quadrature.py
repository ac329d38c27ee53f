"""Symmetric Gauss quadrature rule on the reference triangle.

The rule is given as barycentric coordinates (Q, 3) plus weights (Q,) that
sum to 1 (multiply by the element area).  Degree-5 (7-point) matches
FreeFEM's default ``int2d`` rule (qf5pT), which the reference relies on for
the indicator-weighted correction integrals.  The degree-2 rule is exported
as the JAX package's ``fem`` exports it; its degree-4 rule is used by none
of the ported code and is not copied.
"""
from __future__ import annotations

import numpy as np

# degree 2, 3 edge-midpoint points
TRI_DEGREE2 = (
    np.array(
        [[0.5, 0.5, 0.0], [0.0, 0.5, 0.5], [0.5, 0.0, 0.5]], dtype=np.float64
    ),
    np.array([1.0 / 3.0] * 3, dtype=np.float64),
)

# degree 5, 7 points (FreeFEM qf5pT)
_s15 = np.sqrt(15.0)
_b1 = (6.0 - _s15) / 21.0
_b2 = (6.0 + _s15) / 21.0
_v1 = (155.0 - _s15) / 1200.0
_v2 = (155.0 + _s15) / 1200.0
TRI_DEGREE5 = (
    np.array(
        [
            [1.0 / 3.0, 1.0 / 3.0, 1.0 / 3.0],
            [1 - 2 * _b1, _b1, _b1],
            [_b1, 1 - 2 * _b1, _b1],
            [_b1, _b1, 1 - 2 * _b1],
            [1 - 2 * _b2, _b2, _b2],
            [_b2, 1 - 2 * _b2, _b2],
            [_b2, _b2, 1 - 2 * _b2],
        ],
        dtype=np.float64,
    ),
    np.array([9.0 / 40.0, _v1, _v1, _v1, _v2, _v2, _v2], dtype=np.float64),
)
