"""The bundled programmatic full-body human model.

Counterpart of nimblephysics_tpu/models/human.py: a programmatic skeleton
approximating the Rajagopal 2015 OpenSim model's topology (pelvis-rooted
free joint, 38 dofs and 19 bodies: legs with hip, knee, ankle, subtalar
and mtp, a lumbar trunk and a neck, arms with shoulder, elbow, forearm
and wrist), segment masses and lengths from standard anthropometry (de
Leva 1996 fractions), capsule and box shapes, joint limits and a
25-marker gait-lab set for the MarkerFitter. Y is up (OpenSim
convention).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from nimblephysics_tpu_torch.dynamics.shapes import ShapeSpec
from nimblephysics_tpu_torch.dynamics.skeleton import Skeleton
from nimblephysics_tpu_torch.simulation.world import World


def _T(p=(0.0, 0.0, 0.0)) -> np.ndarray:
    T = np.eye(4)
    T[:3, 3] = p
    return T


def _capsule_inertia(mass, radius, length) -> np.ndarray:
    # Solid-cylinder approximation about the capsule center, axis = z.
    ixx = mass * (3 * radius**2 + length**2) / 12.0
    return np.diag([ixx, ixx, 0.5 * mass * radius**2])


def _box_inertia(mass, size) -> np.ndarray:
    s = np.asarray(size)
    return np.diag(
        [
            mass * (s[1] ** 2 + s[2] ** 2) / 12.0,
            mass * (s[0] ** 2 + s[2] ** 2) / 12.0,
            mass * (s[0] ** 2 + s[1] ** 2) / 12.0,
        ]
    )


def rajagopal_humanoid(
    total_mass: float = 75.16, height: float = 1.70
) -> Tuple[Skeleton, Dict[str, Tuple[str, np.ndarray]]]:
    """Build the bundled humanoid. Returns (skeleton, markers).

    markers: name -> (body_name, local_offset) — a gait-lab-style marker
    set (pelvis cluster, thigh/shank clusters, foot + upper-body markers)
    for MarkerFitter tests and examples.

    Y is up (OpenSim convention); the pelvis free joint is the root.
    """
    m = total_mass
    h = height
    # de Leva (1996) adjusted Zatsiorsky segment mass fractions.
    frac = {
        "pelvis": 0.1117,
        "torso": 0.3033,  # thorax+abdomen
        "head": 0.0694,
        "thigh": 0.1416,
        "shank": 0.0433,
        "foot": 0.0137,
        "upper_arm": 0.0271,
        "forearm": 0.0162,
        "hand": 0.0061,
    }
    # Segment lengths as height fractions (Winter 2009).
    L_thigh = 0.245 * h
    L_shank = 0.246 * h
    L_foot = 0.152 * h
    L_torso = 0.288 * h
    L_uarm = 0.186 * h
    L_farm = 0.146 * h
    pelvis_w = 0.191 * h / 2.0  # hip-to-hip half width

    sk = Skeleton("rajagopal_humanoid")

    def capsule_y(radius, length, mu=1.0):
        # Capsule along local Y (shape capsules are z-aligned: rotate).
        Rz = np.eye(4)
        Rz[:3, :3] = np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0]], float)
        return ShapeSpec(
            "capsule", np.array([radius, length]), T_offset=Rz, friction=mu
        )

    # Pelvis (free root).
    pelvis = sk.add_joint_and_body(
        "free",
        parent=-1,
        name="pelvis",
        mass=m * frac["pelvis"],
        com=(0.0, 0.0, 0.0),
        inertia=_box_inertia(m * frac["pelvis"], (0.25, 0.15, 0.3)),
        shapes=(ShapeSpec("box", np.array([0.24, 0.14, 2 * pelvis_w]),),),
    )

    # Torso: lumbar 3-dof euler (Rajagopal: back joint,
    # lumbar_extension/bending/rotation).
    torso = sk.add_joint_and_body(
        "euler",
        parent=pelvis,
        name="torso",
        euler_order="zxy",
        T_pj=_T((0.0, 0.09, 0.0)),
        T_cj=_T((0.0, -L_torso / 2.0, 0.0)),
        mass=m * frac["torso"],
        com=(0.0, 0.0, 0.0),
        inertia=_box_inertia(m * frac["torso"], (0.26, L_torso, 0.3)),
        shapes=(ShapeSpec("box", np.array([0.24, L_torso, 0.3])),),
        position_lower=np.deg2rad([-90, -40, -40]),
        position_upper=np.deg2rad([30, 40, 40]),
    )
    # Head on a 3-dof neck.
    sk.add_joint_and_body(
        "ball",
        parent=torso,
        name="head",
        T_pj=_T((0.0, L_torso / 2.0 + 0.02, 0.0)),
        T_cj=_T((0.0, -0.12, 0.0)),
        mass=m * frac["head"],
        inertia=np.eye(3) * m * frac["head"] * 0.11**2 * 0.4,
        shapes=(ShapeSpec("sphere", np.array([0.11])),),
    )

    markers: Dict[str, Tuple[str, np.ndarray]] = {}

    def leg(side: str, sign: float):
        hip = sk.add_joint_and_body(
            "euler",  # hip_flexion/adduction/rotation (Rajagopal order)
            parent=pelvis,
            name=f"femur_{side}",
            euler_order="zxy",
            T_pj=_T((0.0, -0.07, sign * pelvis_w)),
            T_cj=_T((0.0, L_thigh / 2.0, 0.0)),
            mass=m * frac["thigh"],
            inertia=_capsule_inertia(m * frac["thigh"], 0.07, L_thigh),
            shapes=(capsule_y(0.07, L_thigh),),
            position_lower=np.deg2rad([-30, -50, -40]),
            position_upper=np.deg2rad([120, 30, 40]),
        )
        knee = sk.add_joint_and_body(
            "revolute",  # knee_angle
            parent=hip,
            name=f"tibia_{side}",
            axis=(0, 0, 1),
            T_pj=_T((0.0, -L_thigh / 2.0, 0.0)),
            T_cj=_T((0.0, L_shank / 2.0, 0.0)),
            mass=m * frac["shank"],
            inertia=_capsule_inertia(m * frac["shank"], 0.05, L_shank),
            shapes=(capsule_y(0.05, L_shank),),
            position_lower=np.deg2rad([-120.0]),
            position_upper=np.deg2rad([3.0]),
        )
        # ankle_angle (plantarflexion) + subtalar (inversion).
        ankle = sk.add_joint_and_body(
            "universal",
            parent=knee,
            name=f"talus_{side}",
            axes=((0, 0, 1), (1, 0, 0)),
            T_pj=_T((0.0, -L_shank / 2.0, 0.0)),
            T_cj=_T((0.0, 0.02, 0.0)),
            mass=0.2,
            inertia=np.eye(3) * 1e-3,
            position_lower=np.deg2rad([-50, -35]),
            position_upper=np.deg2rad([30, 35]),
        )
        foot = sk.add_joint_and_body(
            "weld",
            parent=ankle,
            name=f"calcn_{side}",
            T_pj=_T((0.03, -0.03, 0.0)),
            mass=m * frac["foot"] - 0.2,
            com=(0.05, -0.02, 0.0),
            inertia=_box_inertia(m * frac["foot"], (L_foot, 0.05, 0.07)),
            shapes=(
                ShapeSpec(
                    "box",
                    np.array([L_foot, 0.05, 0.07]),
                    T_offset=_T((0.04, -0.025, 0.0)),
                    friction=1.0,
                ),
            ),
        )
        sk.add_joint_and_body(
            "revolute",  # mtp_angle (toes)
            parent=foot,
            name=f"toes_{side}",
            axis=(0, 0, 1),
            T_pj=_T((L_foot / 2.0 + 0.03, -0.03, 0.0)),
            mass=0.2,
            com=(0.02, 0.0, 0.0),
            inertia=np.eye(3) * 5e-4,
            shapes=(
                ShapeSpec(
                    "box",
                    np.array([0.06, 0.03, 0.07]),
                    T_offset=_T((0.03, -0.005, 0.0)),
                    friction=1.0,
                ),
            ),
            position_lower=np.deg2rad([-30.0]),
            position_upper=np.deg2rad([60.0]),
        )
        s = side.upper()
        markers[f"{s}ASI"] = ("pelvis", np.array([0.12, 0.02, sign * 0.12]))
        markers[f"{s}PSI"] = ("pelvis", np.array([-0.12, 0.03, sign * 0.05]))
        markers[f"{s}THI"] = (f"femur_{side}", np.array([0.05, 0.05, sign * 0.05]))
        markers[f"{s}KNE"] = (f"femur_{side}", np.array([0.0, -L_thigh / 2, sign * 0.06]))
        markers[f"{s}TIB"] = (f"tibia_{side}", np.array([0.04, 0.05, sign * 0.04]))
        markers[f"{s}ANK"] = (f"tibia_{side}", np.array([0.0, -L_shank / 2, sign * 0.045]))
        markers[f"{s}HEE"] = (f"calcn_{side}", np.array([-0.04, -0.02, 0.0]))
        markers[f"{s}TOE"] = (f"calcn_{side}", np.array([L_foot / 2 + 0.02, -0.02, 0.0]))

    def arm(side: str, sign: float):
        sh = sk.add_joint_and_body(
            "euler",  # arm_flex/arm_add/arm_rot
            parent=torso,
            name=f"humerus_{side}",
            euler_order="zxy",
            T_pj=_T((0.0, L_torso / 2.0 - 0.03, sign * 0.20)),
            T_cj=_T((0.0, L_uarm / 2.0, 0.0)),
            mass=m * frac["upper_arm"],
            inertia=_capsule_inertia(m * frac["upper_arm"], 0.04, L_uarm),
            shapes=(capsule_y(0.04, L_uarm),),
            position_lower=np.deg2rad([-90, -120, -90]),
            position_upper=np.deg2rad([180, 30, 90]),
        )
        el = sk.add_joint_and_body(
            "revolute",  # elbow_flex
            parent=sh,
            name=f"ulna_{side}",
            axis=(0, 0, 1),
            T_pj=_T((0.0, -L_uarm / 2.0, 0.0)),
            T_cj=_T((0.0, L_farm / 2.0, 0.0)),
            mass=m * frac["forearm"],
            inertia=_capsule_inertia(m * frac["forearm"], 0.035, L_farm),
            shapes=(capsule_y(0.035, L_farm),),
            position_lower=np.deg2rad([0.0]),
            position_upper=np.deg2rad([150.0]),
        )
        # pro_sup + wrist flexion (Rajagopal: radioulnar + wrist).
        sk.add_joint_and_body(
            "universal",
            parent=el,
            name=f"hand_{side}",
            axes=((0, 1, 0), (0, 0, 1)),
            T_pj=_T((0.0, -L_farm / 2.0, 0.0)),
            T_cj=_T((0.0, 0.06, 0.0)),
            mass=m * frac["hand"],
            inertia=np.eye(3) * 2e-3,
            shapes=(ShapeSpec("box", np.array([0.04, 0.16, 0.08])),),
            position_lower=np.deg2rad([-90, -70]),
            position_upper=np.deg2rad([90, 70]),
        )
        s = side.upper()
        markers[f"{s}SHO"] = (f"humerus_{side}", np.array([0.0, L_uarm / 2, sign * 0.05]))
        markers[f"{s}ELB"] = (f"humerus_{side}", np.array([0.0, -L_uarm / 2, sign * 0.04]))
        markers[f"{s}WRA"] = (f"ulna_{side}", np.array([0.0, -L_farm / 2, sign * 0.035]))

    leg("r", +1.0)
    leg("l", -1.0)
    arm("r", +1.0)
    arm("l", -1.0)
    markers["C7"] = ("torso", np.array([-0.13, L_torso / 2 - 0.02, 0.0]))
    markers["CLAV"] = ("torso", np.array([0.12, L_torso / 2 - 0.04, 0.0]))
    markers["STRN"] = ("torso", np.array([0.13, 0.05, 0.0]))

    idx_of = {b.name: i for i, b in enumerate(sk.bodies)}
    for name, (body, off) in markers.items():
        sk.add_marker(name, idx_of[body], off)
    return sk, markers


def human_standing(
    total_mass: float = 75.16, height: float = 1.70
) -> Tuple[World, np.ndarray, np.ndarray]:
    """Humanoid standing on a ground plane (World, q0, v0) — the bundled
    convenience world (reference analog: RajagopalHumanBodyModel usage in
    examples)."""
    sk, _ = rajagopal_humanoid(total_mass, height)
    w = World(
        name="human_standing", gravity=(0.0, -9.81, 0.0), time_step=1e-3
    )
    w.add_skeleton(sk)
    ground = Skeleton("ground")
    ground.add_joint_and_body(
        "weld",
        parent=-1,
        name="ground",
        mass=0.0,
        shapes=(
            ShapeSpec(
                "plane", np.array([0.0, 1.0, 0.0, 0.0]), friction=1.0
            ),
        ),
    )
    w.add_skeleton(ground)
    nv = w.num_dofs
    q0 = np.zeros(nv)
    # Pelvis height so feet just touch the ground: hip offset + thigh +
    # shank + ankle/foot stack.
    q0[4] = 0.07 + 0.245 * height + 0.246 * height + 0.01 + 0.03 + 0.05
    return w, q0, np.zeros(nv)
