"""Plate geometry: template -> static mesh + plate parameters.

Host copy of the JAX package's ``models/geometry.py`` for the template path
(the reference's ``jax_plate/Geometry.py`` conventions: the same template
names and accelerometer positions), built directly by ``mesh.generators``.
The ``.edp`` / ``.msh`` file import is not ported yet (ROADMAP Queue 1,
item B).
"""
from __future__ import annotations

import os
from dataclasses import dataclass

from ..mesh import TriangleMesh, generate_plate_mesh
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


class Geometry:
    """Plate geometry and mesh factory.

    Available templates (conventions follow reference Geometry.py:41-48):

    1) 'sh_r' — accelerometer at a custom position (needs accel_x, accel_y;
       accel_y is measured from the top edge, Geometry.py:92-94).
    2) 'sh_i' — accelerometer tangent in a corner of the plate.
    3) 'symm' — accelerometer on the width symmetry line (needs accel_x only).

    The clamped Dirichlet border (label 1) is the short side at x == length.
    """

    def __init__(
        self,
        edp_or_template: str | os.PathLike,
        accelerometer: Accelerometer = None,
        params: GeometryParams = None,
        *,
        ny: int | None = None,
        refine: float = 1.0,
        clamped_labels: tuple[int, ...] | None = None,
    ):
        self._mesh: TriangleMesh | None = None
        # Dirichlet border label set: explicit kwarg, else the templates'
        # label 1 (symm.edp:26, pyFFInterface.py:52-65).
        self.clamped_labels = (
            tuple(int(x) for x in clamped_labels)
            if clamped_labels is not None else (1,))

        if edp_or_template in TEMPLATES:
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

        else:
            if os.path.splitext(str(edp_or_template))[1] in (".edp", ".msh"):
                raise NotImplementedError(
                    "Geometry from a .edp/.msh file is not ported yet "
                    "(ROADMAP Queue 1, item B: .edp/.msh geometry "
                    "import); use a template.")
            raise ValueError(
                f"Could not find template {edp_or_template}. Valid options "
                f"are: {TEMPLATES}."
            )

        self.length = params.length
        self.width = params.width
        self.height = params.height
        self.accel_x = params.accel_x
        self.accel_y = params.accel_y
        self.accel_r = accelerometer.radius
        self._ny = ny
        self._refine = refine

    # ------------------------------------------------------------------

    def get_mesh(self) -> TriangleMesh:
        """Build (or return the cached) static mesh."""
        if self._mesh is None:
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
        return self._mesh

    def coarsened(self, factor: float = 2.0) -> "Geometry":
        """A coarser Geometry of the same domain (multigrid hierarchies):
        the template re-generated at ``refine/factor``."""
        g = Geometry.__new__(Geometry)
        g.__dict__.update(self.__dict__)
        g._mesh = None
        g._refine = self._refine / factor
        return g

    @property
    def test_point(self) -> tuple[float, float]:
        """AFC measurement point of the pure-bending path: the
        accelerometer centre, as in the reference templates."""
        if self.accel_x is None or self.accel_y is None:
            raise ValueError(
                "Readout/test point undefined: give the geometry an "
                "accelerometer position (accel_x/accel_y).")
        return (self.accel_x, self.accel_y)

    def __str__(self):
        d = {
            k: v
            for k, v in self.__dict__.items()
            if not k.startswith("_")
        }
        return f"Geometry with {d}."
