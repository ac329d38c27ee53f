"""Multi-device scaling over ``torch.distributed`` (port of the JAX
package's ``parallel``).

Frequencies are the data-parallel axis: each rank sweeps a slice of them,
the operator data is replicated (it is per-Problem work), and the only
collectives gather the FRF and add the loss, the gradient and the
Gauss-Newton partials.  A second ``dof`` axis row-partitions the dense
inverses of the preconditioner.  One rank drives one device: NCCL on the
card, gloo on the CPU.  ``python -m plate_inverse_problem_tpu_torch.parallel``
(or under ``torchrun``) runs the JAX package's ``examples/multichip.py``
workflow.
"""
from .freq_shard import (
    Mesh,
    ShardedFreqs,
    init,
    make_mesh,
    opdata_shardings,
    shard_frequencies,
    sharded_fr_function,
    sharded_gn_step,
    sharded_train_step,
)

__all__ = [
    "Mesh",
    "ShardedFreqs",
    "init",
    "make_mesh",
    "opdata_shardings",
    "shard_frequencies",
    "sharded_fr_function",
    "sharded_gn_step",
    "sharded_train_step",
]
