"""Collision/visual shape specs (static plan data, numpy only).

Counterpart of nimblephysics_tpu/dynamics/shapes.py. A shape is a static
spec attached to a body; the collision layer lowers (shape_type, size)
pairs into batched primitive tests with fixed shapes.
"""

from __future__ import annotations

import dataclasses

import numpy as np

BOX = "box"
SPHERE = "sphere"
CAPSULE = "capsule"
CYLINDER = "cylinder"
CONE = "cone"
ELLIPSOID = "ellipsoid"
PLANE = "plane"
MESH = "mesh"
MULTI_SPHERE = "multisphere"
HEIGHTMAP = "heightmap"
LINE_SEGMENT = "linesegment"
POINT_CLOUD = "pointcloud"
SOFT_MESH = "softmesh"
ARROW = "arrow"


@dataclasses.dataclass(frozen=True, eq=False)
class ShapeSpec:
    """One shape attached to a body.

    `size` per type (DART conventions): box: full side lengths (3,);
    sphere: [radius]; capsule/cylinder/cone: [radius, height] (axis =
    local z); ellipsoid: full axis lengths (3,); plane: [nx, ny, nz,
    offset] in the shape frame.
    """

    shape_type: str
    size: np.ndarray
    T_offset: np.ndarray = dataclasses.field(
        default_factory=lambda: np.eye(4)
    )  # body -> shape transform
    friction: float = 1.0
    restitution: float = 0.0
    collidable: bool = True
