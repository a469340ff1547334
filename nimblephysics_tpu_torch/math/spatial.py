"""Spatial (6D) inertia and the inertia of the primitive shapes.

Counterpart of nimblephysics_tpu/math/spatial.py ([angular; linear]
ordering). The primitive moments take plain numbers or arrays and return
float64 tensors; models/builtin.py reads them as numpy.
"""

from __future__ import annotations

import math

import torch

from nimblephysics_tpu_torch.math.lie import skew


def _t(x):
    return x if torch.is_tensor(x) else torch.as_tensor(x, dtype=torch.float64)


def spatial_inertia_matrix(mass, com, moment):
    """6x6 spatial inertia about the body-frame origin, from the mass, the
    COM (..., 3) and the rotational inertia about the COM (..., 3, 3):
    G = [[I + m [c]x [c]x^T, m [c]x], [m [c]x^T, m I3]]."""
    mass, com, moment = _t(mass), _t(com), _t(moment)
    c = skew(com)
    ct = c.transpose(-1, -2)
    m = mass[..., None, None]
    eye = torch.eye(3, dtype=c.dtype, device=c.device)
    top = torch.cat([moment + m * (c @ ct), m * c], dim=-1)
    bottom = torch.cat([m * ct, (m * eye).expand_as(c)], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def _diag3(x, y, z, mass, div):
    return torch.diag_embed(torch.stack([x, y, z], dim=-1) * mass[..., None] / div)


def inertia_box(mass, size):
    """A solid box with full side lengths `size` (3,)."""
    s = _t(size)
    x, y, z = s[..., 0], s[..., 1], s[..., 2]
    return _diag3(y * y + z * z, x * x + z * z, x * x + y * y, _t(mass), 12.0)


def inertia_sphere(mass, radius):
    i = 0.4 * _t(mass) * _t(radius) ** 2
    return i[..., None, None] * torch.eye(3, dtype=i.dtype)


def inertia_ellipsoid(mass, size):
    """An ellipsoid with full axis lengths `size` (DART's convention)."""
    r = _t(size) / 2.0
    x, y, z = r[..., 0], r[..., 1], r[..., 2]
    return _diag3(y * y + z * z, x * x + z * z, x * x + y * y, _t(mass), 5.0)


def inertia_cylinder(mass, radius, height):
    """A solid cylinder, axis z."""
    m, rr, hh = _t(mass), _t(radius) ** 2, _t(height) ** 2
    ixx = m * (3.0 * rr + hh) / 12.0
    return torch.diag(torch.stack([ixx, ixx, m * rr / 2.0]))


def inertia_capsule(mass, radius, height):
    """A solid capsule, axis z: a cylinder of `height` and hemispherical
    caps, the mass split between them by volume
    (CapsuleShape::computeInertia)."""
    m, r, h = _t(mass), _t(radius), _t(height)
    rr = r * r
    v_cyl = math.pi * rr * h
    v_sph = 4.0 / 3.0 * math.pi * rr * r
    m_cyl = m * v_cyl / (v_cyl + v_sph)
    m_sph = m * v_sph / (v_cyl + v_sph)
    ixx = (m_cyl * (3.0 * rr + h * h) / 12.0
           + m_sph * (0.4 * rr + 0.375 * r * h + 0.25 * h * h))
    izz = m_cyl * rr / 2.0 + m_sph * 0.4 * rr
    return torch.diag(torch.stack([ixx, ixx, izz]))
