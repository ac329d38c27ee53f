"""Accelerometer sensor catalog.

The sensor enters the physics twice: its mass/rotary inertia load the plate
through the indicator-weighted mass corrections (fem/assembly.py), and its
``effective_height``/``transverse_sensitivity`` shape the measured response
mix (models/problem.py 3-field readout).  Field names and the JSON schema
match the reference so existing catalog files load unchanged
(jax_plate/Accelerometer.py:7-33, accelerometers/*.json); the bundled
AP1030 entry is the sensor every reference example uses.
"""
from __future__ import annotations

import json
import os
from dataclasses import asdict, dataclass

from ..utils.paths import get_package_dir


def _catalog_path(name: str) -> str:
    return os.path.join(get_package_dir(), "accelerometers", name + ".json")


@dataclass
class AccelerometerParams:
    """Physical description of a cylindrical accelerometer.

    ``mass`` [kg] and ``radius`` [m] drive the added-inertia corrections;
    ``height`` [m] with ``effective_height`` (relative 0..1 along the axis,
    bottom to top) locates the sensing element; ``transverse_sensitivity``
    is the relative in-plane pickup (fraction, not percent).
    """

    mass: float
    radius: float
    height: float = None
    effective_height: float = None
    transverse_sensitivity: float = None


class Accelerometer:
    """A sensor loaded from the catalog by name, or built from params.

    ``Accelerometer("AP1030")`` reads ``accelerometers/AP1030.json`` from
    the package; ``Accelerometer(AccelerometerParams(...))`` wraps explicit
    values.  The five schema fields become instance attributes.
    """

    def __init__(self, name_or_params: str | AccelerometerParams):
        if isinstance(name_or_params, AccelerometerParams):
            fields = asdict(name_or_params)
        elif isinstance(name_or_params, str):
            path = _catalog_path(name_or_params)
            if not os.path.exists(path):
                raise ValueError(
                    f"No accelerometer named {name_or_params!r} in the "
                    f"catalog (expected {path})."
                )
            with open(path) as fh:
                fields = json.load(fh)
        else:
            raise TypeError(
                f"Expected a catalog name (str) or AccelerometerParams, got "
                f"{type(name_or_params).__name__}."
            )

        for key in ("mass", "radius", "height", "effective_height",
                    "transverse_sensitivity"):
            setattr(self, key, fields[key])

    def __str__(self):
        return f"Accelerometer with {self.__dict__}."
