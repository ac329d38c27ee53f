"""Multi-device scaling over ``torch.distributed`` (port of the JAX
package's ``parallel``).

Frequencies are the data-parallel axis: each rank sweeps a slice of them,
and the collectives of that axis gather the FRF and add the loss, the
gradient and the Gauss-Newton partials.  A second ``dof`` axis partitions
what the JAX package places over ``dof`` (``opdata_shardings``): each
rank keeps its rows of the dense inverses (``invK64`` / ``invK32``, the
two-grid's coarse inverse ``mg_Kcinv``) and of the band basis ``W64``,
and its block rows of the two-grid's band (with its K1 window pack),
prolongation and diagonal, unless the axis is wider than the band's
block-row groups: then those stay whole on every rank.  The rest of the
operator data is replicated.  One rank drives one device: NCCL on the
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
