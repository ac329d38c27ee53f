"""Plate geometry: template / file -> static mesh + plate parameters.

Host copy of the JAX package's ``models/geometry.py`` (the reference's
``jax_plate/Geometry.py`` conventions: the same template names and
accelerometer positions), built directly by ``mesh.generators``.  A path
to a FreeFEM ``.edp`` script is accepted too — its ``real <name> =
<value>;`` parameter lines are parsed, its ``buildmesh`` domain is meshed
by ``mesh.edp`` and its ``on(...)`` labels clamp the plate; a ``.msh``
file gives exact-mesh import.
"""
from __future__ import annotations

import os
import re
from dataclasses import dataclass

from ..mesh import TriangleMesh, generate_plate_mesh, load_msh
from .accelerometer import Accelerometer

TEMPLATES = ["sh_r", "sh_i", "symm"]


@dataclass
class GeometryParams:
    """Parameters of a simple rectangular plate (reference Geometry.py:13-21)."""

    length: float
    width: float
    height: float
    accel_x: float = None
    accel_y: float = None


def _parse_edp_params(text: str) -> dict[str, float]:
    """Extract ``real <name> = <value>;`` parameter lines from an .edp script.

    Expressions like ``100*1e-3`` or ``Ly/2 - rAccel`` go through the
    AST-whitelist evaluator (mesh/edp._eval) — .edp files are untrusted
    input, so no Python ``eval``."""
    from ..mesh.edp import _eval, _strip_comments

    out: dict[str, float] = {}
    text = _strip_comments(text)
    # \b, not ^: FreeFEM allows several statements per line
    # (``real Lx = 0.1; real Ly = 0.02;``)
    for m in re.finditer(r"\breal\s+(\w+)\s*=\s*([^;]+);", text):
        name, expr = m.group(1), m.group(2).strip()
        try:
            out[name] = float(_eval(expr, dict(out)))
        except Exception:
            continue
    return out


class Geometry:
    """Plate geometry and mesh factory.

    Available templates (conventions follow reference Geometry.py:41-48):

    1) 'sh_r' — accelerometer at a custom position (needs accel_x, accel_y;
       accel_y is measured from the top edge, Geometry.py:92-94).
    2) 'sh_i' — accelerometer tangent in a corner of the plate.
    3) 'symm' — accelerometer on the width symmetry line (needs accel_x only).

    The clamped Dirichlet border (label 1) is the short side at x == length.

    ``mesh=`` (with ``height=`` or ``params``) takes a ready mesh instead,
    such as ``mesh.adapt.adapted_mesh``'s; ``export_vtk=True`` writes the
    mesh to ``geometry/export.vtu`` in the package when it is built.
    """

    def __init__(
        self,
        edp_or_template: str | os.PathLike = None,
        accelerometer: Accelerometer = None,
        params: GeometryParams = None,
        *,
        height: float = None,
        mesh: TriangleMesh = None,
        ny: int | None = None,
        refine: float = 1.0,
        export_vtk: bool = False,  # write geometry/export.vtu in the package
        clamped_labels: tuple[int, ...] | None = None,
    ):
        self.template = None
        self._mesh: TriangleMesh | None = None
        self.current_file = None
        # Dirichlet border label set.  Resolution order: explicit kwarg; a
        # user .edp script's own on(...) clauses (parsed below); the
        # templates' label 1 (symm.edp:26, pyFFInterface.py:52-65).
        self.clamped_labels = (
            tuple(int(x) for x in clamped_labels)
            if clamped_labels is not None else (1,))

        if mesh is not None:
            # direct mesh injection (an adapted mesh, mesh/adapt.py; no
            # reference analog)
            self._mesh = mesh
            if params is None and height is None:
                raise ValueError("Height must be given with an explicit mesh.")
            if params is None:
                params = GeometryParams(None, None, height, None, None)

        elif edp_or_template in TEMPLATES:
            if params is None:
                raise ValueError(
                    "`params` argument cannot be None when using a template."
                )
            if accelerometer is None:
                raise ValueError(
                    "`accelerometer` argument cannot be None when using a template."
                )
            self.template = edp_or_template

            if edp_or_template == "sh_r":
                if None in (params.accel_x, params.accel_y):
                    raise ValueError(
                        "Both coordinates of accelerometer should be specified "
                        "for the template sh_r."
                    )
                # convert from 'distance below top edge' to centred frame
                # (reference Geometry.py:92-94)
                params.accel_y = params.width / 2 - params.accel_y
            elif edp_or_template == "sh_i":
                if params.accel_y is not None or params.accel_x is not None:
                    raise ValueError(
                        "Both coordinates of accelerometer should be None for "
                        "the template sh_i."
                    )
                params.accel_x = accelerometer.radius
                params.accel_y = params.width / 2 - accelerometer.radius
            elif edp_or_template == "symm":
                if params.accel_y is not None:
                    raise ValueError(
                        "`y` coordinate of the accelerometer should be None "
                        "for the template symm."
                    )
                if params.accel_x is None:
                    raise ValueError(
                        "`x` coordinate of the accelerometer should not be "
                        "None for the template symm."
                    )
                params.accel_y = 0.0

        elif isinstance(edp_or_template, (str, os.PathLike)) and os.path.exists(
            edp_or_template
        ):
            ext = os.path.splitext(edp_or_template)[1]
            self.current_file = str(edp_or_template)
            if ext == ".msh":
                self._mesh = load_msh(self.current_file)
                if params is None and height is None:
                    raise ValueError(
                        "Height of the plate should be specified via `params` "
                        "arg or `height` kwarg when loading from a file."
                    )
                if params is None:
                    params = GeometryParams(None, None, height, None, None)
            elif ext == ".edp":
                with open(edp_or_template, "r") as fh:
                    text = fh.read()
                # loud, not silent: name any varf/fespace/solve/... sections
                # the geometry interpreter skips (the reference would have
                # executed them via FreeFEM; here fem/ and ops/ replace them)
                from ..mesh.edp import warn_ignored_fe_statements

                warn_ignored_fe_statements(text, source=self.current_file)
                vals = _parse_edp_params(text)
                if params is None and height is None:
                    raise ValueError(
                        "Height of the plate should be specified via `params` "
                        "arg or `height` kwarg when loading from a file."
                    )
                if params is None:
                    params = GeometryParams(
                        vals.get("Lx"), vals.get("Ly"), height,
                        vals.get("offsetAccelX"), vals.get("offsetAccelY"),
                    )
                self._edp_vals = vals
                if clamped_labels is None:
                    from ..mesh.edp import parse_dirichlet_labels

                    found = parse_dirichlet_labels(text)
                    if found:
                        self.clamped_labels = found
                # mesh the script's buildmesh domain directly (arbitrary
                # borders/holes — the reference would hand this to FreeFEM,
                # Geometry.py:115-145)
                try:
                    from ..mesh.edp import mesh_from_edp

                    self._mesh = mesh_from_edp(text)
                    # keep the script: .edp geometries re-mesh at scaled
                    # border densities, so they stay coarsenable (the
                    # two-grid preconditioner needs a coarser level)
                    self._edp_text = text
                    self._edp_density = 1.0
                except Exception as err:
                    import warnings

                    warnings.warn(
                        f"Could not mesh the .edp buildmesh domain ({err}); "
                        "falling back to the rectangle template with the "
                        "script's parsed Lx/Ly/accel parameters.",
                        RuntimeWarning,
                    )
                    self.template = "sh_r"
            else:
                raise ValueError(f"Unsupported geometry file extension {ext!r}.")
        else:
            if os.path.splitext(str(edp_or_template))[1] in (".edp", ".msh"):
                raise FileNotFoundError(f"Could not find file {edp_or_template}.")
            raise ValueError(
                f"Could not find template {edp_or_template}. Valid options "
                f"are: {TEMPLATES}."
            )

        self.length = params.length
        self.width = params.width
        self.height = params.height
        self.accel_x = params.accel_x
        self.accel_y = params.accel_y
        self.accel_r = accelerometer.radius if accelerometer is not None else None
        self._ny = ny
        self._refine = refine
        self._export_vtk = export_vtk

    # ------------------------------------------------------------------

    def get_mesh(self) -> TriangleMesh:
        """Build (or return the cached) static mesh."""
        if self._mesh is None and getattr(self, "_edp_text", None) is not None:
            from ..mesh.edp import mesh_from_edp

            self._mesh = mesh_from_edp(
                self._edp_text,
                density_scale=getattr(self, "_edp_density", 1.0))
        if self._mesh is None:
            if self.template is None:
                raise RuntimeError("Geometry has neither a template nor a mesh.")
            self._mesh = generate_plate_mesh(
                self.template,
                self.length,
                self.width,
                self.accel_r,
                accel_x=self.accel_x,
                accel_y=self.accel_y,
                ny=self._ny,
                refine=self._refine,
            )
        if self._export_vtk:
            # counterpart of the reference's savevtk hook (Geometry.py:224-232)
            from ..mesh.io import save_vtu
            from ..utils.paths import get_package_dir

            out = os.path.join(get_package_dir(), "geometry")
            os.makedirs(out, exist_ok=True)
            save_vtu(self._mesh, os.path.join(out, "export.vtu"))
            self._export_vtk = False
        return self._mesh

    @property
    def can_coarsen(self) -> bool:
        """True when a coarser mesh of the same domain can be generated —
        template-based and .edp-script geometries; .msh imports and
        injected meshes have no parametric description to regenerate
        from."""
        return (self.template is not None
                or getattr(self, "_edp_text", None) is not None)

    def coarsened(self, factor: float = 2.0) -> "Geometry":
        """A coarser Geometry of the same domain (multigrid hierarchies).

        Template geometries re-generate at ``refine/factor``; .edp
        geometries re-mesh the script's buildmesh domain with border
        densities scaled by ``1/factor`` (linear density — DOF count drops
        ~factor^2, matching the template behavior)."""
        if not self.can_coarsen:
            raise ValueError(
                "Only template- or .edp-based geometries can be coarsened "
                "(.msh imports have no parametric description); use "
                "precond='dense' for this Problem.")
        g = Geometry.__new__(Geometry)
        g.__dict__.update(self.__dict__)
        g._mesh = None
        g._export_vtk = False
        if self.template is not None:
            g._refine = self._refine / factor
        else:
            g._edp_density = getattr(self, "_edp_density", 1.0) / factor
        return g

    @property
    def test_point(self) -> tuple[float, float]:
        """AFC measurement point of the pure-bending path.

        A user ``.edp`` may define its own ``xtest``/``ytest`` (the
        reference reads them from the script — symm.edp:13-14,
        pyFFInterface.py:36-46); honor those when present, else the
        accelerometer centre, as in the reference templates."""
        vals = getattr(self, "_edp_vals", None) or {}
        if "xtest" in vals and "ytest" in vals:
            return (float(vals["xtest"]), float(vals["ytest"]))
        if self.accel_x is None or self.accel_y is None:
            raise ValueError(
                "Readout/test point undefined: give the geometry an "
                "accelerometer position (accel_x/accel_y) or define "
                "xtest/ytest in the .edp script.")
        return (self.accel_x, self.accel_y)

    def __str__(self):
        d = {
            k: v
            for k, v in self.__dict__.items()
            if not k.startswith("_") and k != "current_file"
        }
        return f"Geometry with {d}."
