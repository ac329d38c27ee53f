"""Constitutive models: parameter vector theta -> laminate moduli.

Port of the JAX package's ``models/materials.py`` for the isotropic family
(reference Material.py:357-433).  The mixed engine needs the SPLIT transform
— real arrays ``(A, B, D)`` with complex moduli ``(1 + i beta) * (A, B, D)``
— evaluated in f64 torch.  The JAX side's ``_v2`` two-lane scalar trick is a
workaround for the TPU's lossy f64 scalar path and has no counterpart here.
"""
from __future__ import annotations

import abc

import numpy as np
import torch

ATYPES = {
    "isotropic": {"E", "G", "beta"},
    "orthotropic": {"E1", "E2", "G12", "nu12", "beta"},
    "orthotropic_d4": {"E1", "E2", "G12", "nu12", "b1", "b2", "b3", "b4"},
    "sol": {"E1", "E2", "G12", "nu12", "beta", "angles"},
    "symm_sol": {"E1", "G12", "nu12", "beta", "angles"},
}

class Material(abc.ABC):
    """Interface class for materials (reference Material.py:35-354).

    ``density`` [kg/m^3]; ``is_mps`` — midplane symmetric.
    """

    density: float
    is_mps: bool
    # position of beta in the parameter vector: the complex moduli are
    # (1 + i*beta) times a real vector
    _loss_factor_index: int

    def get_parameters(self) -> np.ndarray | None:
        if self.has_params:
            return np.asarray(self._get_param_tuple(), dtype=np.float64)
        return None

    @abc.abstractmethod
    def _get_param_tuple(self) -> tuple:
        ...

    @property
    def has_params(self) -> bool:
        return None not in self._get_param_tuple()

    @property
    def scalar_loss_factor(self) -> bool:
        """True when the complex moduli are (1 + i*beta) times a real
        vector (K_im = beta K_re exactly)."""
        return True

    @abc.abstractmethod
    def reference_coeffs(self, theta: np.ndarray, h: float):
        """Re (A, B, D) at ``theta`` in numpy f64, evaluated as the JAX
        package's complex ``get_ABD_transform`` evaluates it (the reference
        stiffness behind the equilibration and the preconditioner)."""

    @abc.abstractmethod
    def real_coeffs(self, params: torch.Tensor, h: float):
        """(A, B, D) REAL 6-vectors, order [11,12,16,22,26,66], in the
        dtype and on the device of ``params``."""

    def abd_split(self, params: torch.Tensor, h: float):
        """((Are, Aim), (Bre, Bim), (Dre, Dim)): the split complex moduli
        (JAX ``get_ABD_transform_split``).  Torch ops only, so gradients
        and forward tangents in ``params`` flow through."""
        A, B, D = self.real_coeffs(params, h)
        b = params[self._loss_factor_index]
        return (A, b * A), (B, b * B), (D, b * D)

    def __str__(self):
        s = f"{self.__class__.__name__} material with\n"
        for k, v in self.__dict__.items():
            if not k.startswith("_"):
                s += f"{k} = {v}\n"
        return s.rstrip()


class Isotropic(Material):
    """theta = [E, G, beta]; A = E h / (1 - nu^2), D = A h^2 / 12,
    nu = E/2G - 1 (reference Material.py:357-433)."""

    _loss_factor_index = 2

    def __init__(self, density, E=None, G=None, beta=None):
        self.density = density
        self.is_mps = True
        self.E = E
        self.G = G
        self.beta = beta

    def _get_param_tuple(self):
        return (self.E, self.G, self.beta)

    def reference_coeffs(self, theta: np.ndarray, h: float):
        E, G = np.float64(theta[0]), np.float64(theta[1])
        nu = E / (2.0 * G) - 1.0
        A = E * h / (1 - nu**2)
        D = A * h**2 / 12.0
        arr = np.array([1.0, nu, 0.0, 1.0, 0.0, (1 - nu) / 2])
        return A * arr, np.zeros(6), D * arr

    def real_coeffs(self, params: torch.Tensor, h: float):
        E, G = params[0], params[1]
        nu = E / (2.0 * G) - 1.0
        A = E * h / (1.0 - nu * nu)
        D = A * (h * h / 12.0)
        one = torch.ones_like(nu)
        zero = torch.zeros_like(nu)
        arr = torch.stack([one, nu, zero, one, zero, (1.0 - nu) / 2.0])
        return A * arr, torch.zeros_like(arr), D * arr


def get_material(main_arg: float | int | dict, atype: str | None = None,
                 **kwargs) -> Material:
    """Create a Material from density + atype + moduli kwargs, or from a
    dict with ``density``/``atype`` keys (reference Material.py:888-994)."""
    if isinstance(main_arg, (float, int)):
        density = float(main_arg)
        if not isinstance(atype, str):
            raise ValueError("Atype argument was not provided.")
        params = kwargs
    elif isinstance(main_arg, dict):
        try:
            density = main_arg["density"]
            atype = main_arg["atype"]
        except KeyError as err:
            raise RuntimeError(
                f"Required parameter {err.args[0]} was not provided in "
                "dictionary, cannot create Material.") from err
        params = {k: v for k, v in main_arg.items()
                  if k not in ("density", "atype", "is_mps")}
    else:
        raise TypeError("Argument `main_arg` should be a number or a `dict` "
                        "(material files are not ported yet).")

    if density <= 0:
        raise ValueError(
            f"Cannot create Material with negative material density: {density}.")
    if atype not in ATYPES:
        raise ValueError(
            f"Invalid anisotropy type {atype} for material. "
            f"Supported options are: {list(ATYPES.keys())}.")
    if atype != "isotropic":
        raise NotImplementedError(
            f"Material family {atype!r} is not ported yet (ROADMAP Queue 1, "
            "item 2: material transforms); only 'isotropic' is.")
    if not set(params.keys()).issubset(ATYPES[atype]):
        raise ValueError(
            "Mismatching anisotropy type and provided arguments: expected "
            f"values of {ATYPES[atype]}, got {params.keys()}.")
    return Isotropic(density, **params)
