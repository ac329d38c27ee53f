"""Device and dtype policy of the PyTorch port.

* f64 for the exact operator, the Krylov state and every residual;
* f32 for the preconditioner (two-grid cycle, band smoother, coarse inverse).

The JAX package runs its f32 products at HIGHEST precision (IEEE f32), so the
port turns TF32 off for matrix products and convolutions.  Nothing is placed
on a device implicitly: every entry point takes an explicit ``device``.
"""
from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

F64 = torch.float64   # operator, Krylov state, residuals
F32 = torch.float32   # preconditioner
