"""nimblephysics_tpu_torch's marker-fitting path (biomechanics/,
math/iksolver.py, dynamics/queries.py, models/human.py) against the JAX
package, float64 on the CPU, from seeded numpy inputs.

* The bundled humanoid (38 dofs, 19 bodies, 25 markers): its world,
  plan and markers array by array; scaled FK and marker positions at a
  seeded pose and scales (1e-12), their Jacobians in q, offsets and
  scales (autograd against jax.jacrev, 1e-10); the frame-batched form
  against the single-pose one, and the closed-form marker Jacobians
  against autograd.
* ScaleGroups.from_symmetry, MultivariateGaussian and Anthropometrics
  (log_pdf, condition, measure, the CSV and XML loaders, gradients),
  clean_marker_traces, solve_ik, the geometry queries with their
  gradients.
* IKInitializer.initialize on the humanoid (1e-8); MarkerFitter.fit on
  ball_chain(3) with Adam and with Gauss-Newton, and on the humanoid with
  Gauss-Newton at T = 3, 2 outer and 2 IK iterations: poses, scales,
  offsets and per-frame errors within 1e-8 of 1 + max|.|.
* The JAX test's recovery criterion (tests/test_biomechanics.py) on the
  port alone.

The JAX side compiles once in the test that reads it (its humanoid fit
~25 s cold); the module fixtures compile nothing, since a test worker
runs a shared fixture again.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nimblephysics_tpu import biomechanics as jb
from nimblephysics_tpu.batched import BatchedEngine as JaxEngine
from nimblephysics_tpu.biomechanics import scaled_fk as jfk
from nimblephysics_tpu.dynamics import queries as jq
from nimblephysics_tpu.math.iksolver import solve_ik as jax_solve_ik
from nimblephysics_tpu.models import human as jhuman
from nimblephysics_tpu.simulation.world import World as JaxWorld

from nimblephysics_tpu_torch import biomechanics as tb
from nimblephysics_tpu_torch.batched import BatchedEngine
from nimblephysics_tpu_torch.biomechanics import scaled_fk as tfk
from nimblephysics_tpu_torch.convert import world_from_arrays
from nimblephysics_tpu_torch.dynamics import queries as tq
from nimblephysics_tpu_torch.math.iksolver import solve_ik
from nimblephysics_tpu_torch.models import human as thuman
from torch_parity import F64, assert_same_plan, dump_world, n, t64
from worlds import ball_chain

FIT_TOL = 1e-8


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (1.0 + np.abs(b).max()))


def port_skeleton(jax_skel):
    """The port's copy of a JAX skeleton (markers included)."""
    w = JaxWorld()
    w.add_skeleton(jax_skel)
    return world_from_arrays(dump_world(w)).skeletons[0]


def _same_dump(a, b, path="world"):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _same_dump(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same_dump(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=path)
    else:
        assert a == b, path


def test_humanoid_world_plan_and_markers_match_jax():
    """human_standing and rajagopal_humanoid: the world dump (joints,
    limits, shapes, the ground, markers) equal to the JAX package's, the
    batched plan equal, and a carried-across world the same again."""
    jw, jq0, jv0 = jhuman.human_standing()
    tw, tq0, tv0 = thuman.human_standing()
    _same_dump(dump_world(tw), dump_world(jw))
    _same_dump(dump_world(world_from_arrays(dump_world(jw))), dump_world(jw))
    np.testing.assert_array_equal(tq0, jq0)
    np.testing.assert_array_equal(tv0, jv0)
    assert_same_plan(BatchedEngine(tw, **F64), JaxEngine(jw))
    jsk, jm = jhuman.rajagopal_humanoid()
    tsk, tm = thuman.rajagopal_humanoid()
    assert (tsk.num_dofs, tsk.num_bodies, len(tsk.markers)) == (38, 19, 25)
    assert list(tm) == list(jm)
    for name, (b, off, fixed) in jsk.markers.items():
        tb_, toff, tfixed = tsk.markers[name]
        assert (tb_, tfixed) == (b, fixed)
        np.testing.assert_array_equal(toff, off)


@pytest.fixture(scope="module")
def humanoid():
    """The JAX humanoid, the port's copy, its marker table and a seeded
    pose, scales and offsets."""
    jsk, _ = jhuman.rajagopal_humanoid()
    tsk = port_skeleton(jsk)
    names, bodies, offsets, fixed = jfk.marker_table(jsk)
    rng = np.random.RandomState(11)
    q = 0.3 * rng.randn(jsk.num_dofs)
    s = 1.0 + 0.1 * rng.randn(jsk.num_bodies, 3)
    off = offsets + 0.01 * rng.randn(*offsets.shape)
    return jsk, tsk, bodies, q, s, off


def test_scaled_fk_and_markers_match_jax(humanoid):
    """Values to 1e-12 and Jacobians in (q, scales, offsets) to 1e-10,
    autograd against jax.jacrev; marker_table equal."""
    jsk, tsk, bodies, q, s, off = humanoid
    for got, want in zip(tfk.marker_table(tsk), jfk.marker_table(jsk)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    def jf(qq, oo, ss):
        return jfk.marker_world_positions(jsk, qq, bodies, oo, ss)

    def tf(qq, oo, ss):
        return tfk.marker_world_positions(tsk, qq, bodies, oo, ss)

    args = (q, off, s)

    @jax.jit
    def jax_side(qq, oo, ss):
        return (jfk.scaled_forward_kinematics(jsk, qq, ss), jf(qq, oo, ss),
                jax.jacrev(jf, argnums=(0, 1, 2))(qq, oo, ss))

    T_s, pos, want = jax_side(*map(jnp.asarray, args))
    assert rel(n(tfk.scaled_forward_kinematics(tsk, t64(q), t64(s))), T_s) <= 1e-12
    assert rel(n(tf(*map(t64, args))), pos) <= 1e-12
    got = torch.autograd.functional.jacobian(tf, tuple(map(t64, args)), vectorize=True)
    for g, w in zip(got, want):
        assert rel(n(g), w) <= 1e-10


def test_frame_batched_forms_match_single_pose(humanoid):
    """The trailing-frame forms (batched fk) against the single-pose ones
    frame by frame, and marker_jacobians' closed forms against autograd
    of the single-pose positions."""
    jsk, tsk, bodies, q, s, off = humanoid
    rng = np.random.RandomState(12)
    T = 2
    Q = t64(q[:, None] + 0.2 * rng.randn(len(q), T))
    S, O = t64(s), t64(off)
    R, p, _ = tfk.scaled_forward_kinematics_frames(tsk, Q, S)
    pos_t = tfk.marker_world_positions_frames(tsk, Q, bodies, O, S)
    pos, J_q, J_s, J_o = tfk.marker_jacobians(tsk, Q, bodies, O, S)
    for t in range(T):
        T1 = tfk.scaled_forward_kinematics(tsk, Q[:, t], S)
        assert rel(n(R[..., t]), n(T1[:, :3, :3])) <= 1e-14
        assert rel(n(p[..., t]), n(T1[:, :3, 3])) <= 1e-14
        single = tfk.marker_world_positions(tsk, Q[:, t], bodies, O, S)
        assert rel(n(pos_t[..., t]), n(single)) <= 1e-14
        assert rel(n(pos[..., t]), n(single)) <= 1e-14
        jq_, js_, jo_ = torch.autograd.functional.jacobian(
            lambda qq, ss, oo: tfk.marker_world_positions(tsk, qq, bodies, oo, ss),
            (Q[:, t], S, O), vectorize=True)
        assert rel(n(J_q[..., t]), n(jq_)) <= 1e-13
        assert rel(n(J_s[..., t]), n(js_)) <= 1e-13
        own = torch.stack([jo_[m, :, m] for m in range(len(bodies))])
        assert rel(n(J_o[..., t]), n(own)) <= 1e-13
        assert float(jo_.abs().sum() - own.abs().sum()) <= 1e-12


def test_scale_groups_from_symmetry(humanoid):
    """The humanoid's left/right pairs, the expansion and its gradient
    (each group's sum of its members')."""
    jsk, tsk, *_ = humanoid
    jg, tg = jb.ScaleGroups.from_symmetry(jsk), tb.ScaleGroups.from_symmetry(tsk)
    np.testing.assert_array_equal(tg.member_of, jg.member_of)
    assert tg.n_groups == jg.n_groups == 11
    gs = 1.0 + 0.1 * np.random.RandomState(13).randn(tg.n_groups, 3)
    w = np.random.RandomState(14).randn(tsk.num_bodies, 3)
    x = t64(gs).requires_grad_(True)
    (tg.expand(x) * t64(w)).sum().backward()
    g_j = jax.grad(lambda z: jnp.sum(jg.expand(z) * w))(jnp.asarray(gs))
    np.testing.assert_array_equal(n(x.grad), np.asarray(g_j))
    np.testing.assert_array_equal(n(tg.identity(device="cpu")), np.asarray(jg.identity()))
    with pytest.raises(ValueError, match="two scale groups"):
        tb.ScaleGroups(tsk, [[1, 2], [2, 3]])


ANTHRO_XML = """<Metrics>
  <Metric><Name>reach</Name>
    <MarkerA><BodyNode>link0</BodyNode><Offset>0 0 0.2</Offset></MarkerA>
    <MarkerB><BodyNode>link2</BodyNode><Offset>0 0.05 -0.2</Offset></MarkerB>
    <MeasureAlongAxis>0 0 0</MeasureAlongAxis><BodyPose>0.1 0 0 0 0.2 0 0 0 0</BodyPose>
  </Metric>
  <Metric><Name>drop</Name>
    <MarkerA><BodyNode>link1</BodyNode><Offset>0.05 0 0.2</Offset></MarkerA>
    <MarkerB><BodyNode>link2</BodyNode><Offset>0 0 -0.2</Offset></MarkerB>
    <MeasureAlongAxis>0 0 1</MeasureAlongAxis><BodyPose>0 0 0 0 0 0 0 0 0</BodyPose>
  </Metric>
</Metrics>
"""


def test_anthropometrics_match_jax(tmp_path):
    """MultivariateGaussian from a seeded CSV (load_from_csv, condition,
    log_pdf) and Anthropometrics from a metrics XML (pair metrics at two
    poses, one along an axis) plus an axis metric, on a 3-link chain:
    measure, log_pdf and its gradient in the body scales."""
    jsk = ball_chain(3, length=0.4)
    tsk = port_skeleton(jsk)
    rng = np.random.RandomState(15)
    data = rng.randn(40, 4) @ rng.randn(4, 4) * 0.02 + [1.2, 0.8, 0.45, 66.0]
    csv = tmp_path / "ansur.csv"
    csv.write_text("reach,drop,shank,Heightin\n"
                   + "\n".join(",".join(f"{x:.6f}" for x in r) for r in data)
                   + "\nnot,a,number,row\n")
    xml = tmp_path / "metrics.xml"
    xml.write_text(ANTHRO_XML)
    cols = ["reach", "drop", "shank", "Heightin"]
    jg = jb.MultivariateGaussian.load_from_csv(str(csv), cols)
    tg = tb.MultivariateGaussian.load_from_csv(str(csv), cols)
    np.testing.assert_array_equal(tg.mu, jg.mu)
    np.testing.assert_array_equal(tg.cov, jg.cov)
    x = data[3]
    assert rel(n(tg.log_pdf(t64(x))), jg.log_pdf(jnp.asarray(x))) <= 1e-12
    jc, tc = jg.condition({"Heightin": 66.2}), tg.condition({"Heightin": 66.2})
    assert tc.names == jc.names
    assert rel(tc.mu, jc.mu) <= 1e-12 and rel(tc.cov, jc.cov) <= 1e-12

    def anthro(mod, skel, gauss):
        a = mod.Anthropometrics.load_from_file(str(xml))
        a.add_metric("shank", 1, 2, 0.4)
        a.set_skeleton(skel)
        a.set_distribution(gauss)
        return a

    ja, ta = anthro(jb, jsk, jc), anthro(tb, tsk, tc)
    assert ta.get_metric_names() == ja.get_metric_names() == ["reach", "drop", "shank"]
    s = 1.0 + 0.1 * rng.randn(3, 3)
    got = ta.measure(body_scales=s, device="cpu")
    want, (jv, jgrad) = jax.jit(lambda x: (ja.measure(body_scales=x),
                                           jax.value_and_grad(ja.log_pdf)(x)))(jnp.asarray(s))
    for k in want:
        assert rel(n(got[k]), want[k]) <= 1e-12
    x = t64(s).requires_grad_(True)
    lp = ta.log_pdf(x)
    lp.backward()
    assert rel(n(lp), jv) <= 1e-12
    assert rel(n(x.grad), jgrad) <= 1e-10
    with pytest.raises(ValueError, match="condition"):
        anthro(tb, tsk, tg).log_pdf(x)


def test_clean_marker_traces_match_jax():
    """Seeded traces with spikes, a ripple and gaps (short and long)."""
    rng = np.random.RandomState(16)
    T, M = 60, 4
    t = np.arange(T)[:, None, None] * 0.01
    obs = np.sin(t * (1 + np.arange(M))[None, :, None] + rng.rand(1, M, 3)) \
        + 0.001 * rng.randn(T, M, 3)
    obs[10, 0] += 0.5
    obs[30, 2] += 0.05
    obs[20:24, 1] = np.nan
    obs[35:50, 3] = np.nan
    got, rep = tb.clean_marker_traces(obs, dt=0.01)
    want, jrep = jb.clean_marker_traces(obs, dt=0.01)
    np.testing.assert_array_equal(got, want)
    assert rep == jrep and rep["spikes_removed"] > 0 and rep["gap_frames_filled"] > 0


def test_solve_ik_matches_jax():
    """A planar 3-link arm's tip and heading to a reachable target, with
    the bounds and the step clamp live."""
    def arm(lib):
        def f(q):
            a = lib.cumsum(q, 0)
            lengths = (0.5, 0.4, 0.3)
            x = sum(l * lib.cos(a[i]) for i, l in enumerate(lengths))
            y = sum(l * lib.sin(a[i]) for i, l in enumerate(lengths))
            return lib.stack([x, y, 0.1 * a[-1]])
        return f

    target_q = np.array([0.4, -0.7, 0.5])
    target = np.asarray(arm(jnp)(jnp.asarray(target_q)))
    lo, hi = -0.6 * np.ones(3), 0.6 * np.ones(3)
    kw = dict(iterations=6, step_clamp=0.3)
    want = jax_solve_ik(arm(jnp), jnp.asarray(target), jnp.zeros(3), lower=jnp.asarray(lo),
                        upper=jnp.asarray(hi), **kw)
    got = solve_ik(arm(torch), target, np.zeros(3), lower=lo, upper=hi, device="cpu", **kw)
    assert got.device.type == "cpu" and got.dtype == torch.float64
    assert rel(n(got), want) <= 1e-12
    assert float(np.abs(np.asarray(want) - target_q).max()) > 0.05  # a bound held it


def shaped_skeleton(mod):
    """A free box with a revolute capsule and a ball-jointed sphere and
    mesh under it, built with `mod`'s Skeleton and ShapeSpec."""
    sk = mod.Skeleton("shaped")
    Rx = np.eye(4)
    Rx[:3, :3] = [[1, 0, 0], [0, 0, -1], [0, 1, 0]]
    Rx[:3, 3] = [0.02, 0.0, -0.1]
    root = sk.add_joint_and_body("free", shapes=(mod.ShapeSpec("box", np.array([0.3, 0.2, 0.1])),))
    arm = sk.add_joint_and_body(
        "revolute", parent=root, axis=(0, 1, 0), T_pj=_translation((0.15, 0.0, -0.05)),
        T_cj=_translation((0.0, 0.0, 0.2)),
        shapes=(mod.ShapeSpec("capsule", np.array([0.04, 0.3]), T_offset=Rx),))
    verts = np.array([[0.05, 0, 0], [-0.05, 0.02, 0], [0, 0.06, 0.03], [0, -0.04, -0.07]])
    sk.add_joint_and_body(
        "ball", parent=arm, T_pj=_translation((0.0, 0.0, -0.2)),
        T_cj=_translation((0.0, 0.0, 0.1)),
        shapes=(mod.ShapeSpec("sphere", np.array([0.06])),
                mod.ShapeSpec("mesh", np.zeros(3), mesh_vertices=verts)))
    return sk


def _translation(p):
    T = np.eye(4)
    T[:3, 3] = p
    return T


def test_geometry_queries_match_jax():
    """body_vertex_table, skeleton_height and skeleton_lowest_point with
    their gradients in q and the scales (one jit of the JAX pair), and
    marker_dist_to_nearest_vertex with its gradients in the offset and
    the scale, on a box, capsule, sphere and mesh skeleton."""
    from nimblephysics_tpu import dynamics as jd

    from nimblephysics_tpu_torch import dynamics as td

    jsk, tsk = shaped_skeleton(jd), shaped_skeleton(td)
    rng = np.random.RandomState(20)
    q = 0.4 * rng.randn(jsk.num_dofs)
    s = 1.0 + 0.1 * rng.randn(jsk.num_bodies, 3)
    for a, b in zip(tq.body_vertex_table(tsk), jq.body_vertex_table(jsk)):
        np.testing.assert_array_equal(a, b)

    @jax.jit
    def jax_side(qq, ss):
        def both(a, b):
            return jnp.stack([jq.skeleton_height(jsk, a, b),
                              jq.skeleton_lowest_point(jsk, a, b, up=(0.0, 0.0, 1.0))])

        return both(qq, ss), jax.jacrev(both, argnums=(0, 1))(qq, ss)

    vals, (gq, gs) = jax_side(jnp.asarray(q), jnp.asarray(s))
    for k, (name, up) in enumerate((("skeleton_height", (0.0, 1.0, 0.0)),
                                    ("skeleton_lowest_point", (0.0, 0.0, 1.0)))):
        qq, ss = t64(q).requires_grad_(True), t64(s).requires_grad_(True)
        v = getattr(tq, name)(tsk, qq, ss, up=up)
        v.backward()
        assert rel(n(v), vals[k]) <= 1e-12, name
        assert rel(n(qq.grad), gq[k]) <= 1e-10 and rel(n(ss.grad), gs[k]) <= 1e-10, name
    b = 2
    off = np.array([0.03, 0.05, 0.01])
    mo, bs = t64(off).requires_grad_(True), t64(s[b]).requires_grad_(True)
    d = tq.marker_dist_to_nearest_vertex(tsk, b, mo, bs)
    d.backward()
    jd_, (gm, gb) = jax.value_and_grad(
        lambda a, c: jq.marker_dist_to_nearest_vertex(jsk, b, a, c), argnums=(0, 1))(
            jnp.asarray(off), jnp.asarray(s[b]))
    assert rel(n(d), jd_) <= 1e-12
    assert rel(n(mo.grad), gm) <= 1e-10 and rel(n(bs.grad), gb) <= 1e-10


def humanoid_mocap(jsk, T, seed, occlude=0.02):
    """Seeded synthetic mocap of the humanoid: poses 0.1 rad of noise
    about standing, true scales inside the bounds, occlusions."""
    rng = np.random.RandomState(seed)
    names, bodies, offsets, _ = jfk.marker_table(jsk)
    q = 0.1 * rng.randn(T, jsk.num_dofs)
    q[:, 4] += 0.93
    s = np.clip(1.0 + 0.05 * rng.randn(jsk.num_bodies, 3), 0.85, 1.15)
    tsk = port_skeleton(jsk)
    obs = np.stack([n(tfk.marker_world_positions(tsk, t64(q[t]), bodies, t64(offsets),
                                                 t64(s))) for t in range(T)])
    obs[rng.rand(T, len(bodies)) < occlude] = np.nan
    obs[1, 3] = np.nan
    return tsk, obs


@pytest.fixture(scope="module")
def humanoid_case(humanoid):
    """The JAX humanoid, the port's copy and 3 frames of its synthetic
    mocap (nothing compiled: each test compiles what it reads)."""
    jsk = humanoid[0]
    tsk, obs = humanoid_mocap(jsk, 3, seed=18)
    return jsk, tsk, obs


def assert_same_fit(got, want):
    for k in ("poses", "body_scales", "marker_offsets", "per_frame_error"):
        assert rel(getattr(got, k), getattr(want, k)) <= FIT_TOL, k
    assert abs(got.avg_marker_error - want.avg_marker_error) <= FIT_TOL
    assert got.marker_names == want.marker_names


def test_ik_initializer_on_humanoid_matches_jax(humanoid_case):
    """Kabsch segment poses of the pelvis and torso, the free root in
    closed form and the torso's euler joint by the frame-batched
    Gauss-Newton."""
    jsk, tsk, obs = humanoid_case
    want = jb.IKInitializer(jsk).initialize(obs)
    got = tb.IKInitializer(tsk, device="cpu").initialize(obs)
    assert np.abs(want).max() > 0.05
    assert rel(got, want) <= FIT_TOL


def test_marker_fitter_gn_on_humanoid_matches_jax(humanoid_case):
    """Gauss-Newton, T = 3, 2 outer and 2 IK iterations, from the port's
    initial poses handed to both packages (the JAX fit's compile is ~25
    s of this file's ~60)."""
    jsk, tsk, obs = humanoid_case
    q0 = tb.IKInitializer(tsk, device="cpu").initialize(obs)
    kw = dict(q_init=q0, outer_iterations=2, ik_iterations=2, outer_solver="gn")
    got = tb.MarkerFitter(tsk, device="cpu").fit(obs, **kw)
    want = jb.MarkerFitter(jsk).fit(obs, **kw)
    assert got.poses.shape == (3, 38) and np.isfinite(got.avg_marker_error)
    assert_same_fit(got, want)


CHAIN_MARKERS = (
    ("m0", 0, [0.05, 0.0, -0.1]), ("m1", 1, [0.0, 0.05, -0.15]), ("m2", 2, [0.0, 0.0, -0.2]),
    ("m3", 2, [0.05, 0.0, 0.0]), ("m4", 1, [-0.05, 0.0, 0.0]), ("m5", 0, [0.0, -0.05, 0.0]),
)


def marked_chain():
    jsk = ball_chain(3, length=0.4)
    for name, b, o in CHAIN_MARKERS:
        jsk.add_marker(name, b, o, fixed=True)
    return jsk, port_skeleton(jsk)


def chain_mocap(tsk, T, seed, true_scales):
    names, bodies, offsets, _ = tfk.marker_table(tsk)
    rng = np.random.RandomState(seed)
    poses = 0.25 * rng.randn(T, tsk.num_dofs)
    obs = np.stack([n(tfk.marker_world_positions(tsk, t64(poses[t]), bodies, t64(offsets),
                                                 t64(true_scales))) for t in range(T)])
    obs[min(3, T - 1), 1] = np.nan
    return obs


def chain_prior(mod, skel):
    """The anthropometric prior of test_anthropometrics_match_jax's
    metrics (two pair metrics and an axis one) on the chain: a Gaussian
    2 cm wide about values near theirs at the grouped truth."""
    a = mod.Anthropometrics()
    a.add_pair_metric("reach", [0.1, 0, 0, 0, 0.2, 0, 0, 0, 0], "link0", [0, 0, 0.2],
                      "link2", [0, 0.05, -0.2])
    a.add_pair_metric("drop", np.zeros(9), "link1", [0.05, 0, 0.2], "link2", [0, 0, -0.2],
                      axis=[0, 0, 1])
    a.add_metric("shank", 1, 2, 0.4)
    a.set_skeleton(skel)
    mu = [1.30, 0.95, 0.58]
    a.set_distribution(mod.MultivariateGaussian(a.get_metric_names(), mu, 4e-4 * np.eye(3)))
    return a


@pytest.mark.parametrize("solver", ["adam", "gn", "gn_groups", "adam_prior"])
def test_marker_fitter_on_ball_chain_matches_jax(solver):
    """4 frames, 3 outer and 3 IK iterations, an occlusion, the scale
    bounds live (a true scale past the upper bound); the Adam fit cleans
    its traces first (a spike removed). gn_groups: the Gauss-Newton step
    with links 1 and 2 sharing one scale (the closed-form Jacobian's
    group branch); adam_prior: Adam with those groups and an
    anthropometric prior. Both fit data whose links 1 and 2 share a
    stretch inside the bounds: with the ungrouped truth, the shared scale
    sits on its bounds and the IK turns the ball joints through ~44 rad,
    where both packages' poses drift apart by 3e-7 at 3 iterations while
    their scales and offsets agree to 1e-14."""
    jsk, tsk = marked_chain()
    true = np.ones((3, 3))
    true[1, 2], true[0, 2] = 1.5, 0.9
    if "_" in solver:
        true[1, 2] = true[2, 2] = 1.15
    obs = chain_mocap(tsk, 4, 19, true)
    kw = dict(outer_iterations=3, ik_iterations=3, lr_scales=0.03,
              outer_solver=solver.split("_")[0])
    if solver == "adam":
        obs = np.concatenate([obs, obs[-1:] + 0.01])
        obs[3, 5] += 0.5  # a spike
        kw.update(clean_traces=True, dt=0.01)
        assert tb.clean_marker_traces(obs, dt=0.01)[1]["spikes_removed"] > 0
    args = dict(regularize_scales=0.01, regularize_offsets=100.0)
    j_args, t_args = dict(args), dict(args)
    if solver != "adam" and solver != "gn":
        j_args["scale_groups"] = jb.ScaleGroups(jsk, [[1, 2]])
        t_args["scale_groups"] = tb.ScaleGroups(tsk, [[1, 2]])
    if solver == "adam_prior":
        j_args.update(anthropometrics=chain_prior(jb, jsk), anthropometric_weight=1e-2)
        t_args.update(anthropometrics=chain_prior(tb, tsk), anthropometric_weight=1e-2)
    got = tb.MarkerFitter(tsk, device="cpu", **t_args).fit(obs, **kw)
    want = jb.MarkerFitter(jsk, **j_args).fit(obs, **kw)
    if "_" in solver:
        assert got.body_scales[1, 2] == got.body_scales[2, 2] != 1.0
    assert_same_fit(got, want)


def test_marker_fitter_recovers_scales_and_poses():
    """tests/test_biomechanics.py's recovery criterion on the port alone:
    12 frames from known scales, 40 Adam iterations of 6 IK steps: under
    5 mm RMS, the stretched and shrunk links within 0.06."""
    _, tsk = marked_chain()
    true = np.ones((3, 3))
    true[1, 2], true[0, 2] = 1.15, 0.9
    obs = chain_mocap(tsk, 12, 3, true)
    obs[7, 4] = np.nan
    res = tb.MarkerFitter(tsk, regularize_scales=0.01, regularize_offsets=100.0,
                          device="cpu").fit(obs, outer_iterations=40, ik_iterations=6,
                                            lr_scales=0.03)
    assert res.avg_marker_error < 5e-3, res.avg_marker_error
    np.testing.assert_allclose(res.body_scales[1, 2], 1.15, atol=0.06)
    np.testing.assert_allclose(res.body_scales[0, 2], 0.9, atol=0.06)
