"""Helpers shared by the tests that hold nimblephysics_tpu_torch against
the JAX package: world dumps, seeded inputs and array conversion.

Inputs are made with numpy from a seed and handed to both sides; arrays
cross between the frameworks as numpy.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

F64 = dict(device="cpu", dtype=torch.float64)


def dump_world(world) -> dict:
    """A JAX-package World as the plain-array spec that
    nimblephysics_tpu_torch.convert.world_from_arrays reads."""
    skels = []
    for s in world.skeletons:
        joints = [
            dict(
                type=j.joint_type,
                parent=j.parent,
                name=b.name,
                T_pj=np.asarray(j.T_pj),
                T_cj=np.asarray(j.T_cj),
                axes=None if j.axes is None else np.asarray(j.axes),
                euler_order=j.euler_order,
                screw_pitch=j.screw_pitch,
                damping=j.damping,
                spring_stiffness=j.spring_stiffness,
                rest_position=j.rest_position,
                position_lower=j.position_lower,
                position_upper=j.position_upper,
                velocity_limit=j.velocity_limit,
                force_limit=j.force_limit,
                props=j.props,
                custom=None if j.custom is None else dict(
                    n_dofs=j.custom.n_dofs,
                    rot_axes=np.asarray(j.custom.rot_axes),
                    trans_axes=np.asarray(j.custom.trans_axes),
                    drives=list(j.custom.drives),
                    functions=[(f.kind, f.params, f.scale) for f in j.custom.functions],
                ),
            )
            for j, b in zip(s.joints, s.bodies)
        ]
        bodies = [
            dict(
                mass=b.mass,
                com=np.asarray(b.com),
                inertia=np.asarray(b.inertia),
                shapes=[
                    dict(
                        type=sh.shape_type,
                        size=np.asarray(sh.size),
                        T_offset=np.asarray(sh.T_offset),
                        friction=sh.friction,
                        restitution=sh.restitution,
                        collidable=sh.collidable,
                        mesh_vertices=sh.mesh_vertices,
                        heights=sh.heights,
                        spheres=sh.spheres,
                    )
                    for sh in b.shapes
                ],
            )
            for b in s.bodies
        ]
        skels.append(
            dict(
                name=s.name,
                self_collision=s.self_collision_enabled,
                adjacent_body_check=s.adjacent_body_check,
                joints=joints,
                bodies=bodies,
            )
        )
    return dict(
        name=world.name,
        gravity=np.asarray(world.gravity),
        time_step=world.time_step,
        solver=dataclasses.asdict(world.solver),
        parallel_velocity_and_position_updates=(
            world.parallel_velocity_and_position_updates
        ),
        action_indices=np.asarray(world.action_indices),
        collision_overrides=[(i, j, c) for (i, j), c in world.collision_overrides.items()],
        actuator_types={d: dict(a) for d, a in world.actuator_types.items()},
        dynamic_constraints=[dict(c) for c in world.dynamic_constraints],
        skeletons=skels,
    )


def half_cheetah_pair():
    """(JAX world, port world, q0), both under SolverConfig.throughput()."""
    from nimblephysics_tpu.models import half_cheetah as jax_hc
    from nimblephysics_tpu.simulation.world import SolverConfig as JaxCfg

    from nimblephysics_tpu_torch.models import half_cheetah
    from nimblephysics_tpu_torch.simulation import SolverConfig

    jw, q0, _ = jax_hc()
    jw.solver = JaxCfg.throughput()
    tw, _, _ = half_cheetah()
    tw.solver = SolverConfig.throughput()
    return jw, tw, np.asarray(q0, np.float64)


def box_stack_pair(n_boxes, solver="default", **solver_kw):
    """(JAX world, port world, q0) of box_stack(n_boxes), the port's
    carried across with world_from_arrays, under the default
    SolverConfig or throughput(), with solver_kw replaced."""
    from nimblephysics_tpu.models import box_stack
    from nimblephysics_tpu.simulation.world import SolverConfig as JaxCfg

    from nimblephysics_tpu_torch.convert import world_from_arrays

    jw, q0, _ = box_stack(n_boxes=n_boxes)
    cfg = JaxCfg() if solver == "default" else JaxCfg.throughput()
    jw.solver = dataclasses.replace(cfg, **solver_kw)
    return jw, world_from_arrays(dump_world(jw)), np.asarray(q0, np.float64)


def islands_scene(n_boxes=3, **solver_kw):
    """(JAX world, port world, q) of tests/test_islands.py's scene: box_stack
    with every box-box pair filtered off and the boxes spread along x,
    each a hair into the ground, so that each box is its own island."""
    jw, tw, q0 = box_stack_pair(n_boxes, **solver_kw)
    for i in range(n_boxes):
        for j in range(i + 1, n_boxes):
            jw.collision_overrides[(i, j)] = False
    from nimblephysics_tpu_torch.convert import world_from_arrays

    tw = world_from_arrays(dump_world(jw))
    q = q0.copy()
    for i in range(n_boxes):
        q[6 * i + 3] = 1.0 * i
        q[6 * i + 4] = 0.0
        q[6 * i + 5] = 0.2 * 0.75**i / 2 - 1e-4
    return jw, tw, q


def batch_states(q0, B, seed, drop=0.0, spread=0.03):
    """Seeded (nv, B) q, v, u around q0 with the root height shifted by
    `drop` (tests/test_batched.py::_batch_states)."""
    rng = np.random.RandomState(seed)
    nv = len(q0)
    q = np.tile(q0[:, None], (1, B)) + spread * rng.randn(nv, B)
    q[1] += drop
    v = 0.3 * rng.randn(nv, B)
    u = 0.3 * rng.randn(nv, B)
    return q, v, u


def t64(x):
    return torch.as_tensor(np.array(x), **F64)


def n(x):
    """torch or jax array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def small_contact_metas(**kw):
    """(JAX LcpMeta, port LcpMeta) of a hand-made plan of 4 contacts
    (12 rows: normal, friction, friction), with the given knobs."""
    from nimblephysics_tpu.constraint.lcp import LcpMeta as JaxMeta

    from nimblephysics_tpu_torch.constraint.lcp import LcpMeta

    findex = np.full(12, -1, np.int32)
    findex[1::3] = findex[2::3] = np.arange(0, 12, 3)
    isf = findex >= 0
    return (JaxMeta(findex=findex, is_friction=isf, **kw),
            LcpMeta(findex=findex, is_friction=isf, **kw))


def small_contact_problem(seed, B, r=4, negative_normals=False):
    """Seeded F (12, r, B), b, mu (0.9 on friction rows), z0 for the small
    contact plan; negative_normals lets warm-start impulses go below 0."""
    rng = np.random.RandomState(seed)
    F = 0.5 * rng.randn(12, r, B)
    b = rng.randn(12, B)
    mu = np.where(np.arange(12)[:, None] % 3 > 0, 0.9, 0.0) * np.ones((1, B))
    z0 = 0.1 * rng.randn(12, B)
    return F, b, mu, (z0 if negative_normals else np.abs(z0))


# The wedged island of tests/test_lcp_ladder.py: 2 contacts, mu ~ 25, a
# rank-2 Delassus operator. The pinned active-set solve and the seed both
# fail validity, and the cfm-softened rung of the ladder serves the world.
_WEDGED_F = np.array([[-0.331251, 0.316671], [0.418912, 0.296337],
                      [-0.190547, 0.004128], [-0.104258, -0.010608],
                      [0.102123, -0.012412], [-0.083917, -0.617333]])
_WEDGED_B = np.array([0.003603, -0.015651, 0.0003, 0.012215, -0.002442, -0.00458])
_WEDGED_MU = np.array([0.0, 25.286028, 25.286028, 0.0, 25.286028, 25.286028])


def wedged_island():
    """(JAX meta, port meta, F, b, mu, z0) for 4 worlds: 0-1 the wedged
    island, 2-3 healthy resting contacts (test_always_mode_matches_lazy's
    batch). Meta: 24 APGD iterations, 3 refine rounds, 16 PGS sweeps."""
    from nimblephysics_tpu.constraint.lcp import LcpMeta as JaxMeta

    from nimblephysics_tpu_torch.constraint.lcp import LcpMeta

    findex = np.array([-1, 0, 0, -1, 3, 3], np.int32)
    kw = dict(findex=findex, is_friction=findex >= 0, iterations=24,
              refine_rounds=3, seed_pgs_sweeps=16)
    W = 4
    F = np.repeat(_WEDGED_F[:, :, None], W, axis=2)
    b = np.repeat(_WEDGED_B[:, None], W, axis=1)
    mu = np.repeat(_WEDGED_MU[:, None], W, axis=1)
    F[:, :, 2:] = np.array([[1.0, 0.0], [0.0, 0.5], [0.3, 0.1],
                            [0.9, 0.05], [0.1, 0.6], [0.2, 0.2]])[:, :, None]
    b[:, 2:] = np.array([0.2, 0.0, 0.0, 0.15, 0.0, 0.0])[:, None]
    mu[:, 2:] = np.array([0.0, 0.9, 0.9, 0.0, 0.9, 0.9])[:, None]
    return JaxMeta(**kw), LcpMeta(**kw), F, b, mu, np.zeros((6, W))


def _same(a, b):
    """Equal plan arrays, None for None, inf for inf."""
    if a is None or b is None:
        return a is None and b is None
    return np.array_equal(np.asarray(a), np.asarray(b))


def assert_same_meta(tm, jm):
    """Two LcpMeta: rows, bounds and knobs."""
    for f in ("findex", "is_friction", "lo_const", "hi_const"):
        assert _same(getattr(tm, f), getattr(jm, f)), f
    for f in ("iterations", "tol", "ridge", "refine_rounds", "seed_pgs_sweeps",
              "k_active", "solver"):
        assert getattr(tm, f) == getattr(jm, f), f


def assert_same_plan(te, je):
    """A port BatchedEngine's static plan equals a JAX one's: the flattened
    tree, the collider's slots, every row family, the LcpMeta with its
    bounds, the islands and the contact cap."""
    tf, jf = te.fw, je.fw
    assert (tf.nb, tf.nv) == (jf.nb, jf.nv)
    np.testing.assert_array_equal(tf.anc, jf.anc)
    for a, b in zip(tf.G_body, jf.G_body):
        np.testing.assert_allclose(a, b, rtol=1e-14, atol=1e-14)
    for tj, jj in zip(tf.joints, jf.joints):
        assert (tj.parent, tj.q_index, tj.num_dofs, tj.spec.joint_type) == (
            jj.parent, jj.q_index, jj.num_dofs, jj.spec.joint_type)
        for f in ("R_pj", "p_pj", "R_ci", "p_ci", "Ad_cj"):
            np.testing.assert_allclose(getattr(tj, f), getattr(jj, f), atol=1e-14)
        if jj.num_dofs:  # constant S, or S(q)
            assert (tj.S_const is None) == (jj.S_const is None)
            if jj.S_const is not None:
                np.testing.assert_allclose(tj.S_const, jj.S_const, atol=1e-14)
    tc, jc = te.bcollider, je.bcollider
    assert [(s.kind, s.body_a, s.body_b, s.n_slots) for s in tc.slots] == [
        (s.kind, s.body_a, s.body_b, s.n_slots) for s in jc.slots]
    np.testing.assert_allclose(tc.mu, jc.mu)
    np.testing.assert_allclose(tc.restitution, jc.restitution)
    assert tc.num_contacts == jc.num_contacts
    assert te.num_rows == je.num_rows and te.skel_slices == je.skel_slices
    ta, ja = te.assembler, je.assembler
    assert [(r.dof, r.sign, r.limit) for r in ta.limit_rows] == [
        (r.dof, r.sign, r.limit) for r in ja.limit_rows]
    assert ta.motor_rows == ja.motor_rows and ta.dyn_rows == ja.dyn_rows
    assert_same_meta(te.meta, je.meta)
    assert (te.islands is None) == (je.islands is None)
    for (tr, td, tm), (jr, jd, jm) in zip(te.islands or (), je.islands or ()):
        np.testing.assert_array_equal(tr, jr)
        np.testing.assert_array_equal(td, jd)
        assert_same_meta(tm, jm)
    assert te.contact_cap == je.contact_cap


def reference_pair(name):
    """(JAX world, port world from its own model function, port world carried
    across with world_from_arrays, q0) of a model both packages build:
    jump_worm, catapult or inverted_double_pendulum."""
    from nimblephysics_tpu import models as jm

    from nimblephysics_tpu_torch import models as tm
    from nimblephysics_tpu_torch.convert import world_from_arrays

    jw, q0, _ = getattr(jm, name)()
    tw, tq0, _ = getattr(tm, name)()
    np.testing.assert_array_equal(tq0, q0)
    return jw, tw, world_from_arrays(dump_world(jw)), np.asarray(q0, np.float64)


def jax_step_fn(jax_world):
    """The JAX package's single-world forward step as one jitted function
    f(q, v, control, body_params) -> [q'; v'] (cold-started, as the
    BackpropSnapshot steps), numpy in and out."""
    import jax
    import jax.numpy as jnp

    from nimblephysics_tpu.neural.timestep import Engine

    eng = Engine(jax_world)

    @jax.jit
    def step(q, v, u, bp):
        r = eng.step(q, v, u, body_params=bp)
        return jnp.concatenate([r.q, r.v])

    def f(q, v, u, bp=None):
        return np.asarray(step(q, v, u, bp))

    return f


def shallow_cheetah_state(steps=91, control=3.0, seed=20):
    """(JAX half-cheetah world, port world, q, v, u) of a state in shallow
    contact (~5 mm deep, six live rows when stepped cold): the state after
    `steps` steps of the port's CPU float64 rollout from the model's start
    (root height jittered) under a seeded control of `control` randn on
    the action dofs drawn each step, warm-started, as chip_smoke.py's
    phase 20 runs it; u is the control drawn for the next step."""
    jw, tw, qs, vs, us = shallow_cheetah_states(steps, control, seed, keep=1)
    return jw, tw, qs[0], vs[0], us[0]


def shallow_cheetah_states(steps=91, control=3.0, seed=20, keep=4):
    """shallow_cheetah_state's rollout, keeping its last `keep` states:
    (JAX world, port world, q (keep, nv), v (keep, nv), u (keep, nv)),
    each u the control drawn for the step after its state."""
    from nimblephysics_tpu.models import half_cheetah

    from nimblephysics_tpu_torch.convert import world_from_arrays
    from nimblephysics_tpu_torch.neural import Engine

    jw, q0, v0 = half_cheetah()
    tw = world_from_arrays(dump_world(jw))
    rng = np.random.RandomState(seed)
    q = np.asarray(q0, np.float64).copy()
    q[1] += rng.uniform(-0.02, 0.02)
    eng = Engine(tw, device="cpu")
    us = [tw.action_to_forces(t64(control * rng.randn(tw.action_size)))
          for _ in range(steps + 1)]
    s = (t64(q), t64(v0), torch.zeros(eng.num_constraint_rows, **F64))
    kept = []
    with torch.no_grad():
        for k, u in enumerate(us[:steps]):
            r = eng.step(s[0], s[1], u, z_warm=s[2])
            s = (r.q, r.v, r.impulses)
            if k >= steps - keep:
                kept.append((n(s[0]), n(s[1]), n(us[k + 1])))
    qs, vs, ctl = (np.stack(x) for x in zip(*kept))
    return jw, tw, qs, vs, ctl


def ik_mapping_pair(jax_world, port_world, entries):
    """(JAX IKMapping, port IKMapping) holding the same (kind, body)
    entries, kind one of "spatial", "linear", "angular"."""
    from nimblephysics_tpu.neural.mappings import IKMapping as JaxIK

    from nimblephysics_tpu_torch.neural.mappings import IKMapping

    pair = (JaxIK(jax_world), IKMapping(port_world))
    for kind, b in entries:
        for m in pair:
            getattr(m, f"add_{kind}_body_node")(b)
    return pair
