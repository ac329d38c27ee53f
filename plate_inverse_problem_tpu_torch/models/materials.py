"""Constitutive models: parameter vector theta -> laminate moduli.

Port of the JAX package's ``models/materials.py`` (reference
Material.py:25-994): the five families ``Isotropic``, ``Orthotropic``,
``OrthotropicD4`` (a loss factor per modulus), ``SOL`` and
``SymmetricalSOL`` (simple orthotropic laminates), their constraints for
scipy optimizers, JSON persistence and the ``get_material`` factory.

The mixed engine needs the SPLIT transforms — real arrays
((Are, Aim), (Bre, Bim), (Dre, Dim)) of the complex moduli for the 3-field
path (``abd_split``), (Dre, Dim) for the pure-bending path (``d_split``) —
evaluated in f64 torch, so gradients and forward tangents in the
parameters flow through them.  The reference stiffness behind the
equilibration, the band basis and the preconditioner is their real part at
the material's own parameters, in numpy f64 (``reference_coeffs``,
``reference_d``), computed as the JAX package's complex transforms compute
it.  The laminates' Q -> (A, B, D) maps are numpy f64 6 x 6 matrices built
once per material on the host.  The JAX side's ``_v2`` two-lane scalar
trick is a workaround for the TPU's lossy f64 scalar path and has no
counterpart here.

A custom material subclasses ``Material`` and gives ``abd_split`` (and
``d_split`` for the pure-bending path).  Both take the angular frequency
as a last argument, as the JAX package's transforms do.  The mixed and
modal engines build their operator once per sweep, so for a transform
that depends on it ``Problem`` warns (``RuntimeWarning``) and runs the
direct engine, which evaluates it at every frequency, as the JAX package
does.
"""
from __future__ import annotations

import abc
import json
import os

import numpy as np
import torch

from ..utils.paths import get_package_dir

ATYPES = {
    "isotropic": {"E", "G", "beta"},
    "orthotropic": {"E1", "E2", "G12", "nu12", "beta"},
    # each modulus has its own loss factor
    "orthotropic_d4": {"E1", "E2", "G12", "nu12", "b1", "b2", "b3", "b4"},
    # simple orthotropic laminate: identical unidirectional layers;
    # angles in DEGREES, counter-clockwise, starting from the lowest layer
    "sol": {"E1", "E2", "G12", "nu12", "beta", "angles"},
    "symm_sol": {"E1", "G12", "nu12", "beta", "angles"},
}

MODULI_ORDER = ("11", "12", "16", "22", "26", "66")


# ---------------------------------------------------------------------------
# Classical lamination theory, closed form (replaces sympy at Material.py:660-741)
# ---------------------------------------------------------------------------

def _qbar_components(Q6: np.ndarray, theta_deg: float) -> np.ndarray:
    """Rotate a lamina stiffness Q (Voigt order [11,12,16,22,26,66]) by theta.

    Uses the same rotation convention as the reference (Material.py:670-680):
    ``m = cos t``, ``n = -sin t`` with T = [[m^2, n^2, -2mn],
                                           [n^2, m^2,  2mn],
                                           [ mn, -mn, m^2-n^2]]
    and Qbar = T Q T^T.  Returns Qbar in the same 6-vector Voigt order.
    """
    Q = np.array(
        [
            [Q6[0], Q6[1], Q6[2]],
            [Q6[1], Q6[3], Q6[4]],
            [Q6[2], Q6[4], Q6[5]],
        ]
    )
    t = np.deg2rad(theta_deg)
    m = np.cos(t)
    n = -np.sin(t)
    mn = m * n
    T = np.array(
        [
            [m * m, n * n, -2 * mn],
            [n * n, m * m, 2 * mn],
            [mn, -mn, m * m - n * n],
        ]
    )
    QT = T @ Q @ T.T
    return np.array([QT[0, 0], QT[0, 1], QT[0, 2], QT[1, 1], QT[1, 2], QT[2, 2]])


def q_to_abd_matrices(angles: np.ndarray, h: float) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Build the three 6x6 real matrices mapping a lamina Q-vector to laminate
    A/B/D vectors (Voigt order [11,12,16,22,26,66]).

    Equal-thickness plies spanning z in [-h/2, h/2]; A = sum Qbar_i dz,
    B = 1/2 sum Qbar_i d(z^2), D = 1/3 sum Qbar_i d(z^3) — matching the
    reference's symbolic construction (Material.py:690-741) evaluated at h.
    """
    angles = np.asarray(angles, dtype=np.float64)
    nl = angles.size
    zs = np.linspace(-h / 2.0, h / 2.0, nl + 1)
    dz1 = np.diff(zs)
    dz2 = np.diff(zs**2)
    dz3 = np.diff(zs**3)

    MA = np.zeros((6, 6))
    MB = np.zeros((6, 6))
    MD = np.zeros((6, 6))
    eye = np.eye(6)
    for k in range(6):
        for i in range(nl):
            qb = _qbar_components(eye[k], angles[i])
            MA[:, k] += qb * dz1[i]
            MB[:, k] += qb * dz2[i] / 2.0
            MD[:, k] += qb * dz3[i] / 3.0
    return MA, MB, MD


def _scale_lin(A: np.ndarray, scaling_params) -> np.ndarray:
    """Constraint matrix in the scaled parameter space x = theta / s."""
    if isinstance(scaling_params, float):
        return A * scaling_params
    return A * np.asarray(scaling_params)[None, :]


# ---------------------------------------------------------------------------
# Material base class
# ---------------------------------------------------------------------------

class Material(abc.ABC):
    """Interface class for materials (reference Material.py:35-354).

    ``density`` [kg/m^3]; ``is_mps`` — mid-plane symmetric, which selects
    the pure-bending path when no accelerometer is attached.
    """

    density: float
    is_mps: bool
    # position of beta in the parameter vector when the complex moduli are
    # (1 + i*beta) times a real vector; None for other families
    _loss_factor_index: int | None = None

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

    def real_coeffs(self, params: torch.Tensor, h: float):
        """(A, B, D) REAL 6-vectors, order [11,12,16,22,26,66], whose
        complex moduli are (1 + i*beta) times these, in the dtype and on
        the device of ``params`` (the scalar-loss families)."""
        raise NotImplementedError

    def abd_split(self, params: torch.Tensor, h: float, omega=0.0):
        """((Are, Aim), (Bre, Bim), (Dre, Dim)): the split complex moduli
        of the 3-field path (JAX ``get_ABD_transform_split``).  Torch ops
        only, so gradients and forward tangents in ``params`` flow
        through."""
        A, B, D = self.real_coeffs(params, h)
        b = params[self._loss_factor_index]
        return (A, b * A), (B, b * B), (D, b * D)

    def d_split(self, params: torch.Tensor, h: float, omega=0.0):
        """(Dre, Dim): the split bending moduli of the pure-bending path
        (JAX ``get_D_transform_split``)."""
        _, _, D = self.real_coeffs(params, h)
        return D, params[self._loss_factor_index] * D

    def reference_coeffs(self, theta: np.ndarray, h: float):
        """Re (A, B, D) at ``theta`` in numpy f64: the reference stiffness
        of the 3-field path.  The built-in families evaluate it as the JAX
        package's complex ``get_ABD_transform`` does; this default takes
        the real part of ``abd_split``."""
        th = torch.as_tensor(np.asarray(theta, np.float64))
        return tuple(re.numpy() for re, _ in self.abd_split(th, h))

    def reference_d(self, theta: np.ndarray, h: float) -> np.ndarray:
        """Re D at ``theta`` in numpy f64: the reference stiffness of the
        pure-bending path (JAX ``get_D_transform``'s real part)."""
        return self.reference_coeffs(theta, h)[2]

    # ----- constraints ----------------------------------------------------

    @staticmethod
    def _get_nonlin_constr(scaling_params=1.0):
        """(g, lo, hi, jac, hess) of a curved feasibility surface, or
        None."""
        return None

    @staticmethod
    def _get_lin_constr(scaling_params=1.0):
        return None

    @classmethod
    def get_constraints(cls, scaling_params: np.ndarray | None = None):
        """Constraint set for scipy.optimize in the SCALED parameter space
        the optimizers work in (contract of reference Material.py:205-264:
        a single constraint object, a [linear, nonlinear] list, or None).
        The nonlinear constraint carries its analytic jacobian and the
        hessian of <v, g(x)> that trust-constr asks for."""
        import scipy.optimize

        scale = 1.0 if scaling_params is None else np.array(scaling_params)
        built = []
        lin = cls._get_lin_constr(scale)
        if lin is not None:
            A, lo, hi = lin
            built.append(scipy.optimize.LinearConstraint(A, lo, hi))
        nonlin = cls._get_nonlin_constr(scale)
        if nonlin is not None:
            g, lo, hi, jac, hess = nonlin
            built.append(scipy.optimize.NonlinearConstraint(
                g, lo, hi, jac=jac, hess=hess))
        if not built:
            return None
        return built[0] if len(built) == 1 else built

    @classmethod
    def check_parameters(cls, params: np.ndarray, scaling_params=1.0) -> bool:
        """True when the (scaled) parameter vector satisfies every family
        constraint (contract of reference Material.py:266-308)."""
        x = np.asarray(params)
        lin = cls._get_lin_constr(scaling_params)
        checks = [] if lin is None else [(lin[0] @ x, lin[1], lin[2])]
        nonlin = cls._get_nonlin_constr(scaling_params)
        if nonlin is not None:
            g, lo, hi = nonlin[:3]
            checks.append((np.asarray(g(x)), lo, hi))
        return all(bool(np.all((lo <= v) & (v <= hi))) for v, lo, hi in checks)

    # ----- persistence ----------------------------------------------------

    def get_save_dict(self) -> dict:
        d = {}
        for k, v in self.__dict__.items():
            if k.startswith("_"):
                continue
            if isinstance(v, np.ndarray):
                v = v.tolist()
            d[k] = v
        return d

    def __str__(self):
        s = f"{self.__class__.__name__} material with\n"
        for k, v in self.get_save_dict().items():
            s += f"{k} = {v}\n"
        return s.rstrip()

    def save_to_file(self, material_name: str) -> None:
        """Write ``materials/<name>.json`` in the package (reference
        Material.py:331-354)."""
        folder = os.path.join(get_package_dir(), "materials")
        os.makedirs(folder, exist_ok=True)
        d = self.get_save_dict()
        d.setdefault("atype", _ATYPE_OF_CLASS[type(self).__name__])
        with open(os.path.join(folder, material_name + ".json"), "w") as file:
            json.dump(d, file, indent=4)


# ---------------------------------------------------------------------------
# Concrete materials
# ---------------------------------------------------------------------------

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

    def reference_d(self, theta: np.ndarray, h: float) -> np.ndarray:
        # the JAX package's D transform has its own formula (_isotropic_D)
        E, G = np.float64(theta[0]), np.float64(theta[1])
        nu = E / (2.0 * G) - 1.0
        D = E * h**3 / (12.0 * (1.0 - nu**2))
        return np.array([D, nu * D, 0.0, D, 0.0, D * (1 - nu) / 2])

    def real_coeffs(self, params: torch.Tensor, h: float):
        E, G = params[0], params[1]
        nu = E / (2.0 * G) - 1.0
        A = E * h / (1.0 - nu * nu)
        D = A * (h * h / 12.0)
        one = torch.ones_like(nu)
        zero = torch.zeros_like(nu)
        arr = torch.stack([one, nu, zero, one, zero, (1.0 - nu) / 2.0])
        return A * arr, torch.zeros_like(arr), D * arr

    @staticmethod
    def _get_lin_constr(scaling_params=1.0):
        # E, G, beta > 0; 2G < E < 3G  (0 < nu < 0.5); Material.py:412-433
        A = np.eye(5, 3)
        A[3, 0] = 1.0
        A[4, 0] = -1.0
        A[3, 1] = -2.0
        A[4, 1] = 3.0
        return _scale_lin(A, scaling_params), 1e-12, np.inf


class Orthotropic(Material):
    """theta = [E1, E2, G12, nu12, beta] (reference Material.py:436-542).

    As in the JAX package, D22 = D11 * E2/E1 (classical lamination theory;
    the reference's Material.py:499 has the ratio inverted).
    """

    _loss_factor_index = 4

    def __init__(self, density, E1=None, E2=None, G12=None, nu12=None, beta=None):
        self.density = density
        self.is_mps = True
        self.E1 = E1
        self.E2 = E2
        self.G12 = G12
        self.nu12 = nu12
        self.beta = beta

    def _get_param_tuple(self):
        return (self.E1, self.E2, self.G12, self.nu12, self.beta)

    def reference_coeffs(self, theta: np.ndarray, h: float):
        E1, E2, G12, nu12 = (np.float64(theta[i]) for i in range(4))
        E_ratio = E2 / E1
        nu21 = E_ratio * nu12
        A11 = E1 * h / (1 - nu12 * nu21)
        D11 = E1 * h**3 / (12 * (1 - nu12 * nu21))
        As = np.array([A11, nu21 * A11, 0.0, E_ratio * A11, 0.0, G12 * h])
        Ds = np.array([D11, nu21 * D11, 0.0, D11 * E_ratio, 0.0,
                       G12 * h**3 / 12])
        return As, np.zeros(6), Ds

    def real_coeffs(self, params: torch.Tensor, h: float):
        E1, E2, G12, nu12 = params[0], params[1], params[2], params[3]
        E_ratio = E2 / E1
        nu21 = E_ratio * nu12
        A11 = E1 * h / (1.0 - nu12 * nu21)
        D11 = A11 * (h * h / 12.0)
        z = torch.zeros_like(A11)
        As = torch.stack([A11, nu21 * A11, z, E_ratio * A11, z, G12 * h])
        Ds = torch.stack([D11, nu21 * D11, z, E_ratio * D11, z,
                          G12 * (h ** 3 / 12.0)])
        return As, torch.zeros_like(As), Ds

    @staticmethod
    def _get_nonlin_constr(scaling_params=1.0):
        # sqrt(E1/E2) > nu12  (Material.py:506-517), x = theta / s
        s = np.broadcast_to(np.asarray(scaling_params, np.float64), (5,))

        def g(x):
            x = np.asarray(x, np.float64)
            return np.array([np.sqrt(x[0] * s[0] / (x[1] * s[1]))
                             - x[3] * s[3]])

        def jac(x):
            x = np.asarray(x, np.float64)
            r = np.sqrt(x[0] * s[0] / (x[1] * s[1]))
            J = np.zeros((1, 5))
            J[0, 0] = 0.5 * r / x[0]
            J[0, 1] = -0.5 * r / x[1]
            J[0, 3] = -s[3]
            return J

        def hess(x, v):
            # d2/dx2 <v, g(x)>: only the sqrt term is curved
            x = np.asarray(x, np.float64)
            r = np.sqrt(x[0] * s[0] / (x[1] * s[1]))
            H = np.zeros((5, 5))
            H[0, 0] = -0.25 * r / x[0] ** 2
            H[1, 1] = 0.75 * r / x[1] ** 2
            H[0, 1] = H[1, 0] = -0.25 * r / (x[0] * x[1])
            return float(np.asarray(v).reshape(-1)[0]) * H

        return g, 1e-12, np.inf, jac, hess

    @staticmethod
    def _get_lin_constr(scaling_params=1.0):
        # all 5 positive; E1 > E2; 1.05 E1 > G12  (Material.py:519-542)
        A = np.eye(7, 5)
        A[5, 0] = 1.0
        A[5, 1] = -1.0
        A[6, 0] = 1.05
        A[6, 2] = -1.0
        return _scale_lin(A, scaling_params), 1e-12, np.inf


def _pair_mul(a, b):
    """(re, im) pair product."""
    return (a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0])


def _pair_div(a, b):
    d = b[0] * b[0] + b[1] * b[1]
    return ((a[0] * b[0] + a[1] * b[1]) / d, (a[1] * b[0] - a[0] * b[1]) / d)


class OrthotropicD4(Material):
    """Orthotropic with per-modulus loss factors,
    theta = [E1, E2, G12, nu12, b1, b2, b3, b4] (reference
    Material.py:545-636): E1 (1 + i b1), E2 (1 + i b2), G12 (1 + i b3),
    nu12 (1 + i b4), so K_im is no multiple of K_re."""

    def __init__(self, density, E1=None, E2=None, G12=None, nu12=None,
                 b1=None, b2=None, b3=None, b4=None):
        self.density = density
        self.is_mps = True
        self.E1 = E1
        self.E2 = E2
        self.G12 = G12
        self.nu12 = nu12
        self.b1 = b1
        self.b2 = b2
        self.b3 = b3
        self.b4 = b4

    def _get_param_tuple(self):
        return (self.E1, self.E2, self.G12, self.nu12,
                self.b1, self.b2, self.b3, self.b4)

    @property
    def scalar_loss_factor(self) -> bool:
        return False

    def reference_coeffs(self, theta: np.ndarray, h: float):
        # the JAX complex transform's arithmetic, in complex128
        t = np.asarray(theta, np.float64)
        E1 = t[0] * (1 + 1j * t[4])
        E2 = t[1] * (1 + 1j * t[5])
        G12 = t[2] * (1 + 1j * t[6])
        nu12 = t[3] * (1 + 1j * t[7])
        E_ratio = E2 / E1
        nu21 = E_ratio * nu12
        A11 = E1 * h / (1 - nu12 * nu21)
        D11 = E1 * h**3 / (12 * (1 - nu12 * nu21))
        As = np.array([A11, nu21 * A11, 0.0, E_ratio * A11, 0.0, G12 * h])
        Ds = np.array([D11, nu21 * D11, 0.0, D11 * E_ratio, 0.0,
                       G12 * h**3 / 12])
        return As.real, np.zeros(6), Ds.real

    @staticmethod
    def _split_coeff_rows(params, h):
        """The D4 coefficient algebra in split (re, im) pair arithmetic:
        ((Are, Aim), (Dre, Dim)) as the JAX package computes them."""
        p = [params[i] for i in range(8)]
        E1 = (p[0], p[0] * p[4])
        E2 = (p[1], p[1] * p[5])
        G12 = (p[2], p[2] * p[6])
        nu12 = (p[3], p[3] * p[7])
        E_ratio = _pair_div(E2, E1)
        nu21 = _pair_mul(E_ratio, nu12)
        nn = _pair_mul(nu12, nu21)
        den = (1.0 - nn[0], -nn[1])
        A11 = _pair_div((E1[0] * h, E1[1] * h), den)
        A12 = _pair_mul(nu21, A11)
        A22 = _pair_mul(E_ratio, A11)
        A66 = (G12[0] * h, G12[1] * h)
        hd = h**2 / 12.0
        D11 = (A11[0] * hd, A11[1] * hd)
        D12 = _pair_mul(nu21, D11)
        D22 = _pair_mul(E_ratio, D11)
        D66 = (G12[0] * h**3 / 12.0, G12[1] * h**3 / 12.0)
        z = torch.zeros_like(A11[0])

        def rows(c11, c12, c22, c66):
            return tuple(torch.stack([c11[k], c12[k], z, c22[k], z, c66[k]])
                         for k in (0, 1))

        return rows(A11, A12, A22, A66), rows(D11, D12, D22, D66)

    def abd_split(self, params: torch.Tensor, h: float, omega=0.0):
        (Are, Aim), (Dre, Dim) = self._split_coeff_rows(params, h)
        zB = torch.zeros_like(Are)
        return (Are, Aim), (zB, zB), (Dre, Dim)

    def d_split(self, params: torch.Tensor, h: float, omega=0.0):
        return self._split_coeff_rows(params, h)[1]


class SOL(Orthotropic):
    """Simple Orthotropic Laminate: identical unidirectional plies at given
    angles (reference Material.py:639-788).  The Q->(A,B,D) linear maps are
    closed-form numpy (see ``q_to_abd_matrices``), not sympy."""

    def __init__(self, density, angles, E1=None, E2=None, G12=None, nu12=None, beta=None):
        super().__init__(density, E1, E2, G12, nu12, beta)
        self.angles = np.array(angles, dtype=np.float64)
        # mid-plane symmetry <=> the angle stack is a palindrome
        # (Material.py:652-653)
        if np.sum(np.abs(self.angles - self.angles[::-1])) > 1e-6:
            self.is_mps = False
        self._abd_maps = {}

    def _maps(self, h: float):
        """(MA, MB, MD) numpy f64, built once per material and thickness."""
        if h not in self._abd_maps:
            self._abd_maps[h] = q_to_abd_matrices(self.angles, h)
        return self._abd_maps[h]

    @staticmethod
    def _q(E1, E2, G12, nu12):
        den = 1.0 - (E2 / E1) * (nu12 * nu12)
        return E1 / den, nu12 * E2 / den, E2 / den, G12

    def _q_vector(self, params):
        return self._q(params[0], params[1], params[2], params[3])

    def reference_coeffs(self, theta: np.ndarray, h: float):
        q11, q12, q22, q66 = self._q_vector(np.asarray(theta, np.float64))
        Q = np.array([q11, q12, 0.0, q22, 0.0, q66])
        return tuple(M @ Q for M in self._maps(h))

    def real_coeffs(self, params: torch.Tensor, h: float):
        q11, q12, q22, q66 = self._q_vector(params)
        z = torch.zeros_like(q11)
        Q = torch.stack([q11, q12, z, q22, z, q66])
        return tuple(torch.as_tensor(M, dtype=Q.dtype, device=Q.device) @ Q
                     for M in self._maps(h))

    def get_save_dict(self):
        d = super().get_save_dict()
        d["angles"] = list(np.asarray(self.angles))
        return d


class SymmetricalSOL(SOL):
    """SOL with E1 == E2 tied, theta = [E1, G12, nu12, beta]
    (reference Material.py:791-885)."""

    _loss_factor_index = 3

    def __init__(self, density, angles, E1=None, G12=None, nu12=None, beta=None):
        super().__init__(density, angles, E1, E1, G12, nu12, beta)

    @property
    def E2(self):
        return self.E1

    @E2.setter
    def E2(self, val):
        self.E1 = val

    def _get_param_tuple(self):
        return (self.E1, self.G12, self.nu12, self.beta)

    def _q_vector(self, params):
        return self._q(params[0], params[0], params[1], params[2])

    @staticmethod
    def _get_nonlin_constr(scaling_params=1.0):
        return None

    @staticmethod
    def _get_lin_constr(scaling_params=1.0):
        # E1, G12, beta > 0; 0 < nu12 < 1; E1 > G12  (Material.py:863-885)
        A = np.eye(5, 4)
        A[4, 0] = 1.0
        A[4, 1] = -1.0
        eps = 1e-12
        lb = np.full(5, eps)
        ub = np.full(5, np.inf)
        ub[2] = 1.0 - eps
        return _scale_lin(A, scaling_params), lb, ub


_ATYPE_OF_CLASS = {
    "Isotropic": "isotropic",
    "Orthotropic": "orthotropic",
    "OrthotropicD4": "orthotropic_d4",
    "SOL": "sol",
    "SymmetricalSOL": "symm_sol",
}


# ---------------------------------------------------------------------------
# Factory (reference Material.py:888-994)
# ---------------------------------------------------------------------------

def get_material(main_arg: str | float | int | dict, atype: str | None = None,
                 **kwargs) -> Material:
    """Create a Material from a name in the package's ``materials`` folder,
    a ``.json`` path, density + atype + moduli kwargs, or a dict with
    ``density``/``atype`` keys."""
    if isinstance(main_arg, str):
        _, ext = os.path.splitext(main_arg)
        if ext == ".json":
            fpath = os.path.abspath(main_arg)
        elif ext == "":
            fpath = os.path.join(get_package_dir(), "materials",
                                 main_arg + ".json")
        else:
            raise ValueError(
                f"Unsupported extension for material properties file: `{ext}`.")
        if not os.path.exists(fpath):
            raise ValueError(
                f"Could not find file {main_arg} or such material in "
                "`materials` folder.")
        with open(fpath, "r") as file:
            params_json = json.load(file)
        try:
            density = params_json["density"]
            atype = params_json["atype"]
        except KeyError as err:
            raise RuntimeError(
                f"Required parameter {err.args[0]} was not provided by the "
                f".json file {fpath}.") from err
        params = {k: v for k, v in params_json.items()
                  if k not in ("density", "atype", "is_mps")}
    elif isinstance(main_arg, (float, int)):
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
        raise TypeError(
            "Argument `main_arg` should have type `str`, number or `dict`.")

    if density <= 0:
        raise ValueError(
            f"Cannot create Material with negative material density: {density}.")
    if atype not in ATYPES:
        raise ValueError(
            f"Invalid anisotropy type {atype} for material. "
            f"Supported options are: {list(ATYPES.keys())}.")
    if atype in ("sol", "symm_sol") and "angles" not in params:
        raise ValueError(
            "Cannot create simple orthotropic laminate material without "
            "`angles` tuple.")
    if not set(params.keys()).issubset(ATYPES[atype]):
        raise ValueError(
            "Mismatching anisotropy type and provided arguments: expected "
            f"values of {ATYPES[atype]}, got {params.keys()}.")
    cls = {
        "isotropic": Isotropic,
        "orthotropic": Orthotropic,
        "orthotropic_d4": OrthotropicD4,
        "sol": SOL,
        "symm_sol": SymmetricalSOL,
    }[atype]
    return cls(density, **params)
