"""Collision/visual shape specs (static plan data, numpy only).

Counterpart of nimblephysics_tpu/dynamics/shapes.py. A shape is a static
spec attached to a body; the collision layer lowers (shape_type, size)
pairs into batched primitive tests with fixed shapes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

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
    offset] in the shape frame; heightmap: [sx, sy, sz], the xy grid
    spacing and the height scale; mesh and multisphere: unused (their
    geometry is `mesh_vertices` and `spheres`).
    """

    shape_type: str
    size: np.ndarray
    T_offset: np.ndarray = dataclasses.field(
        default_factory=lambda: np.eye(4)
    )  # body -> shape transform
    friction: float = 1.0
    restitution: float = 0.0
    collidable: bool = True
    mesh_vertices: Optional[np.ndarray] = None  # (n, 3) for convex meshes
    # heightmap: heights (H, W) in the shape frame, grid point (i, j) at
    # ((i - (W - 1)/2) sx, (j - (H - 1)/2) sy, heights[j, i] sz).
    heights: Optional[np.ndarray] = None
    # multisphere: (N, 4) rows [cx, cy, cz, radius].
    spheres: Optional[np.ndarray] = None

    def bounding_radius(self) -> float:
        """Radius of a bounding sphere centred at the shape frame origin
        (inf for planes, heightmaps and the rest)."""
        s = np.asarray(self.size, dtype=np.float64)
        t = self.shape_type
        if t == SPHERE:
            return float(s[0])
        if t == BOX:
            return float(np.linalg.norm(s / 2.0))
        if t in (CAPSULE, CYLINDER, CONE):
            return float(np.hypot(s[0], s[1] / 2.0))
        if t == ELLIPSOID:
            return float(np.max(s) / 2.0)
        if t == MESH and self.mesh_vertices is not None:
            return float(np.linalg.norm(self.mesh_vertices, axis=1).max())
        return float("inf")
