"""Model zoo: the half-cheetah benchmark world, the box stack, the
reference benchmark suite's jump-worm and catapult worlds and the
inverted double pendulum, built in code.

Counterpart of nimblephysics_tpu/models/builtin.py (physical parameters
of the reference assets data/skel/half_cheetah.skel and
inverted_double_pendulum.skel; box_stack of the box-stack benchmark;
jump_worm and catapult of python/nimblephysics_benchmarks). Each returns
(World, q0, v0).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from nimblephysics_tpu_torch.dynamics.joints import (
    FREE,
    PRISMATIC,
    REVOLUTE,
    TRANSLATIONAL_2D,
    WELD,
)
from nimblephysics_tpu_torch.dynamics.shapes import ShapeSpec
from nimblephysics_tpu_torch.dynamics.skeleton import Skeleton
from nimblephysics_tpu_torch.simulation.world import World

_HALF_PI = np.pi / 2.0


def _T(p=(0.0, 0.0, 0.0), euler_xyz=(0.0, 0.0, 0.0)) -> np.ndarray:
    cx, sx = np.cos(euler_xyz[0]), np.sin(euler_xyz[0])
    cy, sy = np.cos(euler_xyz[1]), np.sin(euler_xyz[1])
    cz, sz = np.cos(euler_xyz[2]), np.sin(euler_xyz[2])
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    T = np.eye(4)
    T[:3, :3] = Rx @ Ry @ Rz
    T[:3, 3] = p
    return T


def _capsule(radius, height, T_offset=None, mu=1.0, e=0.0) -> ShapeSpec:
    return ShapeSpec(
        "capsule",
        np.array([radius, height]),
        T_offset=np.eye(4) if T_offset is None else T_offset,
        friction=mu,
        restitution=e,
    )


def inertia_box(mass, size) -> np.ndarray:
    """Moment of a solid box with full side lengths `size` (3,) about its
    COM (math/spatial.inertia_box of the JAX package)."""
    x, y, z = np.asarray(size, dtype=np.float64)
    return np.diag([y * y + z * z, x * x + z * z, x * x + y * y]) * mass / 12.0


def _inertia_capsule(mass, radius, height) -> np.ndarray:
    """Solid capsule about its COM, axis z (CapsuleShape::computeInertia):
    mass split between the cylinder and the caps by volume."""
    rr = radius * radius
    v_cyl = np.pi * rr * height
    v_sph = 4.0 / 3.0 * np.pi * rr * radius
    v = v_cyl + v_sph
    m_cyl = mass * v_cyl / v
    m_sph = mass * v_sph / v
    h = height
    ixx = m_cyl * (3.0 * rr + h * h) / 12.0 + m_sph * (
        0.4 * rr + 0.375 * radius * h + 0.25 * h * h
    )
    izz = m_cyl * rr / 2.0 + m_sph * 0.4 * rr
    return np.diag([ixx, ixx, izz])


def _capsule_inertia(mass, radius, height, T_offset) -> np.ndarray:
    R = T_offset[:3, :3]
    return R @ _inertia_capsule(mass, radius, height) @ R.T


def half_cheetah(
    friction: float = 0.9, ground_restitution: float = 0.0
) -> Tuple[World, np.ndarray, np.ndarray]:
    """Planar half-cheetah (9 dof: root x/y/pitch + 6 leg joints), one
    skeleton chain over a static ground plane; gravity -y, all revolutes
    about -z."""
    w = World(name="half_cheetah", gravity=(0.0, -9.81, 0.0), time_step=0.002)

    ground = Skeleton("ground")
    ground.add_joint_and_body(
        WELD,
        name="ground",
        T_pj=_T((0.0, -0.025, 0.0)),
        mass=1.0,
        shapes=(
            ShapeSpec(
                "plane",
                np.array([0.0, 1.0, 0.0, 0.025]),  # top face of the slab
                friction=friction,
                restitution=ground_restitution,
            ),
        ),
    )
    w.add_skeleton(ground)

    pose = {
        "h_pelvis": (0.0, 0.7, 0.0),
        "h_head": (0.6, 0.8, 0.0),
        "b_thigh": (-0.5, 0.7, 0.0),
        "b_shin": (-0.34, 0.45, 0.0),
        "b_foot": (-0.62, 0.31, 0.0),
        "f_thigh": (0.5, 0.7, 0.0),
        "f_shin": (0.36, 0.46, 0.0),
        "f_foot": (0.49, 0.28, 0.0),
    }
    # (mass, com offset, capsule radius, capsule height, shape euler-y)
    body = {
        "h_pelvis": (4.89254870769, (0.0, 0.0, 0.0), 0.046, 1.0, 0.0),
        "h_head": (1.46776461231, (0.0, 0.0, 0.0), 0.046, 0.3, -0.87),
        "b_thigh": (1.53524804, (0.1, -0.13, 0.0), 0.046, 0.29, 3.8),
        "b_shin": (1.58093995, (-0.14, -0.07, 0.0), 0.046, 0.29, 2.03),
        "b_foot": (1.0691906, (0.03, -0.097, 0.0), 0.046, 0.188, 0.27),
        "f_thigh": (1.42558747, (-0.07, -0.12, 0.0), 0.046, 0.266, -0.52),
        "f_shin": (1.17885117, (0.065, -0.09, 0.0), 0.046, 0.212, 0.6),
        "f_foot": (0.84986945, (0.045, -0.07, 0.0), 0.046, 0.14, 0.6),
    }
    # child -> (parent, limits (lo, hi), damping)
    legs = {
        "b_thigh": ("h_pelvis", (-0.52, 1.05), 0.6),
        "b_shin": ("b_thigh", (-0.785, 0.785), 0.45),
        "b_foot": ("b_shin", (-0.4, 0.785), 0.3),
        "f_thigh": ("h_pelvis", (-1.0, 0.7), 0.45),
        "f_shin": ("f_thigh", (-1.2, 0.87), 0.3),
        "f_foot": ("f_shin", (-0.5, 0.5), 0.15),
    }

    def shape_of(name):
        m, com, r, h, ey = body[name]
        return m, com, r, h, _T(com, (_HALF_PI, ey, 0.0))

    sk = Skeleton("half_cheetah")
    Twb = {k: _T(v) for k, v in pose.items()}

    # Root: x prismatic -> y prismatic -> pitch revolute.
    aux2 = sk.add_joint_and_body(
        PRISMATIC, parent=-1, name="h_pelvis_aux2", axis=[1.0, 0.0, 0.0],
        T_pj=_T((0.0, 0.7, 0.0)), mass=0.1, inertia=np.eye(3) * 0.01,
    )
    aux = sk.add_joint_and_body(
        PRISMATIC, parent=aux2, name="h_pelvis_aux", axis=[0.0, 1.0, 0.0],
        mass=0.1, inertia=np.eye(3) * 0.01,
    )
    m, com, r, h, T_off = shape_of("h_pelvis")
    pelvis = sk.add_joint_and_body(
        REVOLUTE, parent=aux, name="h_pelvis", axis=[0.0, 0.0, -1.0],
        mass=m, com=np.asarray(com),
        inertia=_capsule_inertia(m, r, h, T_off),
        shapes=(_capsule(r, h, T_off, mu=friction),),
    )
    idx = {"h_pelvis": pelvis}

    m, com, r, h, T_off = shape_of("h_head")
    T_rel = np.linalg.inv(Twb["h_pelvis"]) @ Twb["h_head"]
    idx["h_head"] = sk.add_joint_and_body(
        WELD, parent=pelvis, name="h_head", T_pj=T_rel,
        mass=m, com=np.asarray(com),
        inertia=_capsule_inertia(m, r, h, T_off),
        shapes=(_capsule(r, h, T_off, mu=friction),),
    )

    for child in ["b_thigh", "b_shin", "b_foot", "f_thigh", "f_shin", "f_foot"]:
        parent_name, (lo, hi), damp = legs[child]
        m, com, r, h, T_off = shape_of(child)
        idx[child] = sk.add_joint_and_body(
            REVOLUTE,
            parent=idx[parent_name],
            name=child,
            axis=[0.0, 0.0, -1.0],
            T_pj=np.linalg.inv(Twb[parent_name]) @ Twb[child],
            mass=m,
            com=np.asarray(com),
            inertia=_capsule_inertia(m, r, h, T_off),
            shapes=(_capsule(r, h, T_off, mu=friction),),
            position_lower=[lo],
            position_upper=[hi],
            damping=[damp],
        )

    w.add_skeleton(sk)
    w.set_action_space(list(range(3, 9)))  # the 6 leg joints
    return w, np.zeros(9), np.zeros(9)


def box_stack(
    n_boxes: int = 2,
    size: float = 0.2,
    friction: float = 0.9,
) -> Tuple[World, np.ndarray, np.ndarray]:
    """`n_boxes` free boxes stacked on a ground plane, the box-box SAT
    manifold workload: each box 75% the size of the one below, q0 stacking
    them a hair (1e-4) into contact. Box i's dofs are 6i..6i+5: rotation
    coordinates, then x, y, z."""
    w = World(name="box_stack", time_step=0.001)
    sizes = [size * (0.75**i) for i in range(n_boxes)]
    for i, s in enumerate(sizes):
        sk = Skeleton(f"box{i}")
        sk.add_joint_and_body(
            FREE,
            name=f"box{i}",
            mass=1.0,
            inertia=inertia_box(1.0, np.full(3, s)),
            shapes=(ShapeSpec("box", np.full(3, s, dtype=np.float64),
                              friction=friction),),
        )
        w.add_skeleton(sk)
    ground = Skeleton("ground")
    ground.add_joint_and_body(
        WELD,
        name="ground",
        mass=1.0,
        shapes=(ShapeSpec("plane", np.array([0.0, 0.0, 1.0, 0.0]),
                          friction=friction),),
    )
    w.add_skeleton(ground)
    q0 = np.zeros(6 * n_boxes)
    z = 0.0
    for i, s in enumerate(sizes):
        z += s / 2.0
        q0[6 * i + 5] = z - 1e-4  # a hair into contact
        z += s / 2.0
    return w, q0, np.zeros(6 * n_boxes)


def inverted_double_pendulum() -> Tuple[World, np.ndarray, np.ndarray]:
    """Cart + two-link pole (3 dof) with no collidable shape: a world with
    no constraint rows."""
    w = World(name="inverted_double_pendulum", gravity=(0.0, -9.81, 0.0),
              time_step=0.01)
    sk = Skeleton("pendulum")
    cart = sk.add_joint_and_body(
        PRISMATIC, parent=-1, name="cart", axis=[1.0, 0.0, 0.0], mass=10.0,
        inertia=np.eye(3) * 0.1,
        shapes=(ShapeSpec("box", np.array([0.3, 0.15, 0.15]), collidable=False),),
        damping=[0.5],
    )
    link_inertia = np.eye(3) * (1.0 * 0.6**2 / 12.0)
    link1 = sk.add_joint_and_body(
        REVOLUTE, parent=cart, name="link1", axis=[0.0, 0.0, 1.0], mass=1.0,
        com=np.array([0.0, 0.3, 0.0]), inertia=link_inertia, damping=[0.1],
    )
    sk.add_joint_and_body(
        REVOLUTE, parent=link1, name="link2", T_pj=_T((0.0, 0.6, 0.0)),
        axis=[0.0, 0.0, 1.0], mass=1.0, com=np.array([0.0, 0.3, 0.0]),
        inertia=link_inertia, damping=[0.1],
    )
    w.add_skeleton(sk)
    return w, np.zeros(3), np.zeros(3)


def _tail_segment(sk, parent, name, force, first):
    """One jump-worm/catapult tail link: revolute about +z with limits
    [0, pi] and a force limit, a 0.05 x 0.25 x 0.05 box, the joint at the
    child box's bottom face (and the parent box's top face for chained
    segments).

    The inertia is the box's own (inertia_box), as in the JAX package,
    which documents it as a deliberate deviation: the reference benchmark
    bodies keep DART's default identity moment of inertia."""
    size = np.array([0.05, 0.25, 0.05])
    return sk.add_joint_and_body(
        REVOLUTE,
        parent=parent,
        name=name,
        axis=[0.0, 0.0, 1.0],
        T_pj=None if first else _T((0.0, 0.125, 0.0)),
        T_cj=_T((0.0, -0.125, 0.0)),
        mass=1.0,
        inertia=inertia_box(1.0, size),
        shapes=(ShapeSpec("box", size),),
        position_lower=[0.0],
        position_upper=[np.pi],
        force_limit=[force],
    )


def jump_worm() -> Tuple[World, np.ndarray, np.ndarray]:
    """The reference benchmark suite's jump worm: a 2D (x, y) root box
    with a 3-segment revolute tail over a welded box floor (5 dofs,
    box-box contact). Actions drive the 3 tail joints."""
    w = World(name="jump_worm", gravity=(0.0, -9.81, 0.0), time_step=0.001)
    worm = Skeleton("jump_worm")
    root_size = np.array([0.1, 0.1, 0.1])
    seg = worm.add_joint_and_body(
        TRANSLATIONAL_2D,
        parent=-1,
        name="root",
        axes=[[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]],
        mass=1.0,
        inertia=inertia_box(1.0, root_size),
        shapes=(ShapeSpec("box", root_size),),
    )
    for i in range(3):
        seg = _tail_segment(worm, seg, f"tail{i + 1}", 100.0, first=(i == 0))
    w.add_skeleton(worm)
    floor = Skeleton("floor")
    floor.add_joint_and_body(
        WELD, name="floor", T_pj=_T((0.0, -0.7, 0.0)), mass=1.0,
        shapes=(ShapeSpec("box", np.array([2.5, 0.25, 0.5])),),
    )
    w.add_skeleton(floor)
    w.set_action_space([2, 3, 4])
    # The reference's start: positions [0, -0.14, 90, 90, 45] deg.
    q0 = np.array([0.0, -0.14, _HALF_PI, _HALF_PI, np.pi / 4.0])
    return w, q0, np.zeros(5)


def catapult() -> Tuple[World, np.ndarray, np.ndarray]:
    """The reference benchmark suite's catapult: a passive 2D projectile
    box and a welded-base 3-link arm over a box floor, with a
    non-collidable target box (5 dofs). Actions drive the 3 arm joints."""
    w = World(name="catapult", gravity=(0.0, -9.81, 0.0), time_step=0.001)
    proj = Skeleton("projectile")
    proj_size = np.array([0.1, 0.1, 0.1])
    proj.add_joint_and_body(
        TRANSLATIONAL_2D,
        parent=-1,
        name="projectile",
        axes=[[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]],
        mass=1.0,
        inertia=inertia_box(1.0, proj_size),
        shapes=(ShapeSpec("box", proj_size),),
    )
    w.add_skeleton(proj)
    cat = Skeleton("catapult")
    seg = cat.add_joint_and_body(WELD, name="base", T_pj=_T((0.5, -0.45, 0.0)),
                                 mass=1.0)
    for i in range(3):
        seg = _tail_segment(cat, seg, f"arm{i + 1}", 1000.0, first=(i == 0))
    w.add_skeleton(cat)
    floor = Skeleton("floor")
    fb = floor.add_joint_and_body(
        WELD, name="floor", T_pj=_T((1.2, -0.7, 0.0)), mass=1.0,
        shapes=(ShapeSpec("box", np.array([3.5, 0.25, 0.5])),),
    )
    floor.add_joint_and_body(  # the reach target, world (2.2, 2.2); visual only
        WELD, parent=fb, name="target", T_pj=_T((1.0, 2.9, 0.0)), mass=1.0,
        shapes=(ShapeSpec("box", np.array([0.1, 0.1, 0.1]), collidable=False),),
    )
    w.add_skeleton(floor)
    w.set_action_space([2, 3, 4])
    # The reference's start: arm [45 deg, 0, 0.65 rad], projectile (0, 0).
    q0 = np.array([0.0, 0.0, np.pi / 4.0, 0.0, 0.65])
    return w, q0, np.zeros(5)
