"""FreeFEM ``.edp`` geometry import: borders -> unstructured mesh.

The reference drives FreeFEM with user-editable ``.edp`` scripts
(reference jax_plate/Geometry.py:115-145): plate domains are
``border`` arcs combined by ``buildmesh``.  This parser understands that
geometry subset — ``real``/``int`` parameter lines, parametric ``border``
definitions, and the ``buildmesh(...)`` combination — and meshes the
domain with the native Delaunay mesher (mesh/delaunay.py), so arbitrary
user domains (holes, notches, curved arcs) work without FreeFEM.

Only the *geometry* statements are interpreted; FE-space/varf/solve
sections of an ``.edp`` are ignored (the solver stack here replaces them).
Expressions are evaluated in a restricted numpy namespace (``cos``,
``sin``, ``pi``, previously defined parameters, the arc parameter ``t``).
"""
from __future__ import annotations

import ast
import operator
import re
import warnings

import numpy as np

from .core import TriangleMesh
from .delaunay import build_mesh

# FreeFEM statements OUTSIDE the geometry subset this module interprets.
# The reference executes the whole script through FreeFEM
# (pyFreeFem/FreeFemIO.py:247-334); here the solver stack (fem/ + ops/)
# replaces the FE side, so these are skipped — loudly, because a user who
# wrote a custom varf expects it to matter.
_FE_STATEMENTS = (
    ("fespace", r"\bfespace\b"),
    ("varf", r"\bvarf\b"),
    ("problem", r"\bproblem\b"),
    ("solve", r"\bsolve\b"),
    ("macro", r"\bmacro\b"),
    ("matrix", r"\bmatrix\b"),
)


def warn_ignored_fe_statements(text: str, source: str = ".edp script"):
    """RuntimeWarning naming any FE-side statements the interpreter skips.

    Only the geometry subset (parameters, borders, buildmesh, ``on(...)``
    Dirichlet labels, the readout point) is interpreted; fespace / varf /
    solve / problem / macro / matrix sections are replaced by the
    framework's own Morley/3-field assembly (fem/assembly.py) and solver
    engines (ops/).  The reference would have executed them via FreeFEM —
    silence here would be a user trap.
    """
    stripped = _strip_comments(text)
    found = sorted({name for name, pat in _FE_STATEMENTS
                    if re.search(pat, stripped)})
    if found:
        warnings.warn(
            f"{source} contains FreeFEM FE statements the geometry "
            f"interpreter does not execute: {', '.join(found)}. Only "
            "borders/parameters/buildmesh/on(...)-labels/readout are read; "
            "element assembly and solves are performed by "
            "this package's own FEM stack instead.",
            RuntimeWarning, stacklevel=3)
    return found

_SAFE_FUNCS = {
    "cos": np.cos, "sin": np.sin, "tan": np.tan, "sqrt": np.sqrt,
    "exp": np.exp, "log": np.log, "abs": np.abs, "atan2": np.arctan2,
    "min": np.minimum, "max": np.maximum,
}
_SAFE_VARS = {"pi": np.pi}

_BINOPS = {
    ast.Add: operator.add, ast.Sub: operator.sub, ast.Mult: operator.mul,
    ast.Div: operator.truediv, ast.Pow: operator.pow,
    ast.Mod: operator.mod, ast.FloorDiv: operator.floordiv,
}
_UNARYOPS = {ast.UAdd: operator.pos, ast.USub: operator.neg}


def _strip_comments(text: str) -> str:
    """Remove ``//`` line comments and ``/* */`` blocks before any regex
    scan — a commented-out ``on(1, ...)`` or ``real L = ...;`` must not
    leak into the parsed geometry or the Dirichlet label set."""
    text = re.sub(r"/\*.*?\*/", " ", text, flags=re.DOTALL)
    return re.sub(r"//[^\n]*", " ", text)


def _eval(expr: str, env: dict):
    """Evaluate an .edp arithmetic expression over a whitelisted grammar.

    .edp files are UNTRUSTED input (the reference hands them to FreeFEM,
    which has its own interpreter); a raw Python ``eval`` — even with
    stripped builtins — is escapable through attribute chains, so only
    numbers, parameter names, arithmetic operators and calls to the
    whitelisted numpy functions are interpreted here.  Anything else
    raises ``ValueError``.
    """
    def ev(node):
        if isinstance(node, ast.Expression):
            return ev(node.body)
        if isinstance(node, ast.Constant):
            if isinstance(node.value, (int, float)) and not isinstance(
                    node.value, bool):
                return node.value
            raise ValueError(f"non-numeric literal {node.value!r}")
        if isinstance(node, ast.Name):
            if node.id in env:
                return env[node.id]
            if node.id in _SAFE_VARS:
                return _SAFE_VARS[node.id]
            raise ValueError(f"unknown name {node.id!r}")
        if isinstance(node, ast.BinOp) and type(node.op) in _BINOPS:
            return _BINOPS[type(node.op)](ev(node.left), ev(node.right))
        if isinstance(node, ast.UnaryOp) and type(node.op) in _UNARYOPS:
            return _UNARYOPS[type(node.op)](ev(node.operand))
        if isinstance(node, ast.Call):
            if (not isinstance(node.func, ast.Name)
                    or node.func.id not in _SAFE_FUNCS or node.keywords):
                raise ValueError("only calls to whitelisted functions")
            return _SAFE_FUNCS[node.func.id](*[ev(a) for a in node.args])
        raise ValueError(
            f"disallowed syntax {type(node).__name__} in .edp expression")

    # FreeFEM's ^ is power with power precedence (tighter than * and unary
    # minus, right-associative).  Translating the TOKEN to ** before parsing
    # preserves that grouping; mapping ast.BitXor to pow would inherit
    # Python's xor precedence and evaluate Lx*Ly^2 as (Lx*Ly)**2.
    expr = expr.replace("^", "**")
    try:
        tree = ast.parse(expr, mode="eval")
    except SyntaxError as err:
        raise ValueError(f"unparseable .edp expression {expr!r}") from err
    return ev(tree)


def parse_edp_geometry(text: str):
    """Parse parameters, borders and the buildmesh call of an .edp script.

    Returns ``(params, borders, calls)`` where ``params`` maps name ->
    float, ``borders`` maps name -> dict(t0, t1, x_expr, y_expr, label),
    and ``calls`` is the ordered buildmesh list of (border_name,
    n_segments, reversed).
    """
    text = _strip_comments(text)
    params: dict[str, float] = {}
    # \b, not ^: FreeFEM allows several statements per line
    for m in re.finditer(r"\b(?:real|int)\s+(\w+)\s*=\s*([^;]+);", text):
        name, expr = m.group(1), m.group(2).strip()
        try:
            params[name] = float(_eval(expr, dict(params)))
        except Exception:
            continue

    borders = {}
    for m in re.finditer(
            r"border\s+(\w+)\s*\(\s*t\s*=\s*([^,]+),\s*([^)]+)\)\s*"
            r"\{([^}]*)\}", text):
        name, t0e, t1e, body = m.groups()
        xb = re.search(r"x\s*=\s*([^;]+);", body)
        yb = re.search(r"y\s*=\s*([^;]+);", body)
        lb = re.search(r"label\s*=\s*([^;]+);", body)
        if xb is None or yb is None:
            continue
        borders[name] = {
            "t0": float(_eval(t0e, dict(params))),
            "t1": float(_eval(t1e, dict(params))),
            "x": xb.group(1).strip(),
            "y": yb.group(1).strip(),
            "label": int(_eval(lb.group(1), dict(params))) if lb else 0,
        }

    calls = []
    bm = re.search(r"buildmesh\s*\(([^;]*)\)\s*;", text, re.DOTALL)
    if bm:
        for part in re.finditer(r"([+-]?)\s*(\w+)\s*\(([^)]*)\)", bm.group(1)):
            sign, name, ne = part.groups()
            if name not in borders:
                continue
            n = int(round(float(_eval(ne, dict(params)))))
            calls.append((name, abs(n), sign == "-" or n < 0))
    return params, borders, calls


def parse_dirichlet_labels(text: str) -> tuple[int, ...]:
    """Border labels a script's own ``on(...)`` clauses pin (Dirichlet).

    The reference's varf templates hardcode ``on(1, u=funcBC, ux=0, uy=0)``
    (pyFFInterface.py:52-65, symm.edp:26), but a user script may clamp any
    label set — ``on(2, 3, w=0, ...)``.  We do not interpret varfs, yet the
    ``on`` clauses tell us *where* the essential BCs live, which is the one
    piece of varf semantics the solver stack needs.  Returns the sorted
    union of integer labels across all ``on(...)`` clauses (empty when the
    script has none — caller falls back to label 1).
    """
    labels: set[int] = set()
    for m in re.finditer(r"\bon\s*\(([^)]*)\)", _strip_comments(text)):
        for arg in m.group(1).split(","):
            arg = arg.strip()
            if "=" in arg:
                break                   # BC assignments follow the labels
            try:
                labels.add(int(arg))
            except ValueError:
                break                   # not a label list (e.g. on(C, ...))
    return tuple(sorted(labels))


def _discretize(border_def, n: int, reverse: bool, env):
    """(points, labels, end_point) of an arc; points exclude the arc end
    (arcs chain into loops), end_point is the exact x(t1), y(t1)."""
    t0, t1 = border_def["t0"], border_def["t1"]
    if reverse:
        t0, t1 = t1, t0
    t = np.linspace(t0, t1, n + 1)
    e = dict(env)
    e["t"] = t
    x = np.broadcast_to(np.asarray(_eval(border_def["x"], e), float), t.shape)
    y = np.broadcast_to(np.asarray(_eval(border_def["y"], e), float), t.shape)
    pts = np.stack([x, y], axis=1)
    return pts[:-1], np.full(n, border_def["label"], np.int32), pts[-1]


def mesh_from_edp(text: str, *, smooth: int = 4, seed: int | None = None,
                  jitter: float = 0.0,
                  density_scale: float = 1.0) -> TriangleMesh:
    """Mesh the buildmesh domain of an .edp script.

    Arcs are chained into closed loops by endpoint proximity (the FreeFEM
    convention: consecutive buildmesh arcs share endpoints; a loop closes
    when the chain returns to its starting point).

    ``density_scale`` multiplies every border's segment count (floored at
    2): scales < 1 produce the coarser meshes the multigrid hierarchy
    needs (Geometry.coarsened), > 1 refine.
    """
    params, borders, calls = parse_edp_geometry(text)
    if not calls:
        raise ValueError("no buildmesh(...) statement found in .edp script")
    if density_scale != 1.0:
        calls = [(nm, max(2, int(round(n * density_scale))), rev)
                 for nm, n, rev in calls]

    arcs = [_discretize(borders[nm], n, rev, params) for nm, n, rev in calls]

    # chain arcs into loops by exact endpoints
    loops = []
    cur_pts, cur_lab = [], []
    allp = np.concatenate([a[0] for a in arcs], axis=0)
    tol = 1e-9 + 1e-6 * float(max(np.ptp(allp, axis=0)))
    start = None
    for pts, lab, end in arcs:
        if start is None:
            start = pts[0]
        cur_pts.append(pts)
        cur_lab.append(lab)
        if np.linalg.norm(end - start) < tol:
            loops.append((np.concatenate(cur_pts), np.concatenate(cur_lab)))
            cur_pts, cur_lab, start = [], [], None
    if cur_pts:
        loops.append((np.concatenate(cur_pts), np.concatenate(cur_lab)))

    return build_mesh(loops, smooth=smooth, seed=seed, jitter=jitter)
