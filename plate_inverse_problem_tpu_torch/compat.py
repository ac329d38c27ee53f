"""Reference-API compatibility layer.

Lets scripts written against the reference package port 1:1::

    import plate_inverse_problem_tpu_torch.compat as jp   # was: import jax_plate as jp
    acc  = jp.Accelerometer.Accelerometer('AP1030')
    geom = jp.Geometry.Geometry('symm', acc, jp.Geometry.GeometryParams(...))
    mat  = jp.Material.get_material(7920.0, 'isotropic', E=..., G=..., beta=...)
    p    = jp.Problem.Problem(geom, mat, acc)

Mirrors the reference's module layout (jax_plate/__init__.py:1-12):
Problem, Material, Geometry, Accelerometer, Optimizers, Input, Utils, Sparse.
Port of the JAX package's ``compat.py``, built from the port's
subpackages; a ``Problem`` runs on the card unless given ``device="cpu"``.
"""
from __future__ import annotations

import sys
import types

from .models import accelerometer as _accel_mod
from .models import geometry as _geom_mod
from .models import materials as _mat_mod
from .models import problem as _prob_mod
from . import optimize as _opt_mod
from .io import compress as _comp_mod
from . import utils as _utils_mod
from . import ops as _ops_mod


def _module(name: str, **attrs) -> types.ModuleType:
    m = types.ModuleType(f"{__name__}.{name}")
    for k, v in attrs.items():
        setattr(m, k, v)
    sys.modules[m.__name__] = m
    return m


Accelerometer = _module(
    "Accelerometer",
    Accelerometer=_accel_mod.Accelerometer,
    AccelerometerParams=_accel_mod.AccelerometerParams,
)

Geometry = _module(
    "Geometry",
    Geometry=_geom_mod.Geometry,
    GeometryParams=_geom_mod.GeometryParams,
    TEMPLATES=_geom_mod.TEMPLATES,
)

Material = _module(
    "Material",
    ATYPES=_mat_mod.ATYPES,
    Material=_mat_mod.Material,
    Isotropic=_mat_mod.Isotropic,
    Orthotropic=_mat_mod.Orthotropic,
    OrthotropicD4=_mat_mod.OrthotropicD4,
    SOL=_mat_mod.SOL,
    SymmetricalSOL=_mat_mod.SymmetricalSOL,
    get_material=_mat_mod.get_material,
)

Problem = _module("Problem", Problem=_prob_mod.Problem)

Optimizers = _module(
    "Optimizers",
    optResult=_opt_mod.optResult,
    optimize_trust_region=_opt_mod.optimize_trust_region,
    optimize_gd=_opt_mod.optimize_gd,
    optimize_cd=_opt_mod.optimize_cd,
    optimize_cd_mem=_opt_mod.optimize_cd_mem,
    optimize_cd_mem2=_opt_mod.optimize_cd_mem2,
    FixedParameterFunction=_opt_mod.FixedParameterFunction,
    solve_trust_region_model=_opt_mod.solve_trust_region_model,
    get_model_newt=_opt_mod.get_model_newt,
)

Input = _module("Input", Compressor=_comp_mod.Compressor)

Utils = _module(
    "Utils",
    plot_fr=_utils_mod.plot_fr,
    plot_fr_radial=_utils_mod.plot_fr_radial,
    plot_fr_complex=_utils_mod.plot_fr_complex,
    png_matrix=_utils_mod.png_matrix,
    get_jax_plate_dir=_utils_mod.get_package_dir,
    get_source_dir=_utils_mod.get_repo_dir,
)

# the solver bridge (reference jax_plate/Sparse.py) maps onto the ops module:
# the standalone CSC primitives (create_symbolic/spsolve/matvec with AD,
# Sparse.py:92-236) plus the plate sweep engines that replace InnerState
Sparse = _module(
    "Sparse",
    create_symbolic=_ops_mod.create_symbolic,
    spsolve=_ops_mod.spsolve,
    matvec=_ops_mod.matvec,
    find_permutation=_ops_mod.find_permutation,
    FAMILIES=_ops_mod.FAMILIES,
    SymbolicPattern=_ops_mod.SymbolicPattern,
    sweep_solve=_ops_mod.sweep_solve,
    modal_sweep=_ops_mod.modal_sweep,
    direct_sweep=_ops_mod.direct_sweep,
    spmv_flat=_ops_mod.spmv_flat,
    to_dense=_ops_mod.to_dense,
)
