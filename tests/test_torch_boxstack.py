"""The port's box-stack path against the JAX package, float64 on the CPU,
B <= 4: the SO(3) maps, ball and free joints, box-plane and box-box
contacts, K1b's plain version on the box stack's LCP, and the 2-box
stack's step; the step's VJP against finite differences.

The JAX functions are compiled one at a time (jax.jit); the JAX
BatchedEngine.step of a box stack is never compiled (48 s for 2 boxes
here) nor differentiated: the slice test runs it op by op, once, in a
module fixture (~30 s with a cold cache, most of this file's time). The
JAX boxed_lcp_b of the 72-row LCP compiles in 19-26 s, so K1b's plain
version (apgd_plain, then pgs_plain) is held against the JAX pure seed
_pgs(_apgd) it stands for (lcp_pallas.py:240-247), padded with inert rows
to 97 where _pgs rolls its row loop (as tests/test_torch_pgs.py does);
the rest of boxed_lcp_b is row-count blind and held at n = 12 and 60 by
the earlier parity tests.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nimblephysics_tpu.batched import BatchedEngine as JaxEngine
from nimblephysics_tpu.batched import articulated as ja
from nimblephysics_tpu.batched import collision as jc
from nimblephysics_tpu.batched import lcp as jlcp
from nimblephysics_tpu.batched import linalg as jl

from nimblephysics_tpu_torch.batched import BatchedEngine
from nimblephysics_tpu_torch.batched import articulated as ta
from nimblephysics_tpu_torch.batched import collision as tc
from nimblephysics_tpu_torch.batched import lcp_cuda
from nimblephysics_tpu_torch.batched import linalg as tl
from nimblephysics_tpu_torch.convert import world_from_arrays
from torch_parity import F64, box_stack_pair, dump_world, n, t64

B = 4

# -- SO(3) maps ----------------------------------------------------------------

ANGLES = {
    "small": [0.0, 1e-12, 1e-7, 0.3],
    "large": [2.0, 3.1, np.pi - 1e-3, np.pi],
}


def _rotvecs(case):
    rng = np.random.RandomState(len(case))
    axes = rng.randn(3, B)
    return axes / np.linalg.norm(axes, axis=0) * np.asarray(ANGLES[case])


SO3 = {
    "exp_so3": lambda m, w: m.exp_so3(w),
    "so3_right_jacobian_b": lambda m, w: m.so3_right_jacobian_b(w),
    "log_so3": lambda m, w: m.log_so3(m.exp_so3(w)),
}


@pytest.mark.parametrize("case", ANGLES)
@pytest.mark.parametrize("fn", SO3)
def test_so3_map_and_gradient_match_jax(fn, case):
    """Values to 1e-12, and the gradient of their sum finite on both sides
    (theta = 0 and pi - 1e-3 included) and equal to 1e-8: just above the
    Taylor cutoff (theta = 1e-7) the generic branch's t - sin t cancels,
    and both sides' gradients carry ~eps/t^3 of noise (1.8e-10 apart at
    entries of 0.1). At theta = pi log is multivalued, so its gradient is
    only held finite there, and its value to the rotation it maps back
    to (its sign follows the rounding of an antisymmetric part ~1e-16)."""
    w = _rotvecs(case)
    f = SO3[fn]
    want = jax.jit(lambda x: f(jl, x))(jnp.asarray(w))
    got = f(tl, t64(w))
    held = slice(None) if not (fn == "log_so3" and case == "large") else slice(0, 3)
    np.testing.assert_allclose(n(got)[..., held], n(want)[..., held], atol=1e-12, rtol=0)
    if held != slice(None):
        np.testing.assert_allclose(n(tl.exp_so3(got))[..., 3], n(tl.exp_so3(t64(w)))[..., 3],
                                   atol=1e-12, rtol=0)
    if fn == "log_so3" and case == "small":
        np.testing.assert_allclose(n(got), w, atol=1e-12, rtol=0)
    gj = n(jax.jit(jax.grad(lambda x: jnp.sum(f(jl, x))))(jnp.asarray(w)))
    x = t64(w).requires_grad_()
    (gt,) = torch.autograd.grad(f(tl, x).sum(), x)
    assert np.isfinite(gj).all() and torch.isfinite(gt).all()
    np.testing.assert_allclose(n(gt)[:, held], gj[:, held], atol=1e-8, rtol=0)


# -- ball and free joints -------------------------------------------------------


def _T(p, euler):
    R = np.asarray(jl.exp_so3(jnp.asarray(np.asarray(euler, float)[:, None])))[:, :, 0]
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = R, p
    return T


@pytest.fixture(scope="module")
def chain():
    """A free root body with a ball-jointed child, both joints offset and
    rotated (T_pj, T_cj), over a ground plane; the port's world carried
    across with world_from_arrays. Seeded states with rotations ~0.5."""
    from nimblephysics_tpu.dynamics import BALL, FREE, Skeleton
    from nimblephysics_tpu.dynamics.shapes import ShapeSpec
    from nimblephysics_tpu.simulation import World

    w = World(time_step=1e-3)
    sk = Skeleton("chain")
    root = sk.add_joint_and_body(
        FREE, name="root", T_cj=_T((0.02, -0.01, 0.03), (0.2, -0.1, 0.3)),
        mass=2.0, com=(0.01, 0.02, -0.03), inertia=np.diag([0.02, 0.03, 0.025]))
    sk.add_joint_and_body(
        BALL, parent=root, name="arm", T_pj=_T((0.1, -0.05, 0.2), (0.3, -0.2, 0.5)),
        T_cj=_T((0.0, 0.02, -0.15), (-0.4, 0.1, 0.2)), mass=1.0,
        com=(0.05, 0.0, -0.02), inertia=np.diag([0.01, 0.012, 0.008]))
    w.add_skeleton(sk)
    ground = Skeleton("ground")
    ground.add_joint_and_body("weld", name="ground",
                              shapes=(ShapeSpec("plane", np.array([0.0, 0.0, 1.0, 0.0])),))
    w.add_skeleton(ground)
    tw = world_from_arrays(dump_world(w))
    rng = np.random.RandomState(11)
    q = 0.5 * rng.randn(9, B)
    v = rng.randn(9, B)
    return ja.FlatWorld(w), ta.FlatWorld(tw), q, v, w.gravity


def test_joint_types_carried_across(chain):
    jf, tf, *_ = chain
    assert [j.spec.joint_type for j in tf.joints] == ["free", "ball", "weld"]
    assert tf.nv == jf.nv == 9
    np.testing.assert_array_equal(tf.anc, jf.anc)


@pytest.mark.parametrize("fn", ["fk", "bias_forces", "mass_matrix_blocks",
                                "integrate_positions"])
def test_ball_and_free_joints_match_jax(chain, fn):
    jf, tf, q, v, g = chain
    jq, jv, tq, tv = jnp.asarray(q), jnp.asarray(v), t64(q), t64(v)
    if fn == "fk":
        want = jax.jit(lambda q: ja.fk(jf, q)[:3])(jq)
        got = ta.fk(tf, tq)[:3]
        pairs = list(zip(got[0] + got[1], want[0] + want[1])) + [(got[2], want[2])]
    elif fn == "bias_forces":
        def jbias(q, v):
            R, p, W, S, rels = ja.fk(jf, q)
            return ja.bias_forces(jf, q, v, rels, S, g)

        _, _, _, S, rels = ta.fk(tf, tq)
        pairs = [(ta.bias_forces(tf, tq, tv, rels, S), jax.jit(jbias)(jq, jv))]
    elif fn == "mass_matrix_blocks":
        want = jax.jit(lambda q: ja.mass_matrix_blocks(jf, *ja.fk(jf, q)[:3]))(jq)
        pairs = list(zip(ta.mass_matrix_blocks(tf, *ta.fk(tf, tq)[:3]), want))
    else:
        want = jax.jit(lambda q, v: ja.integrate_positions(jf, q, v, 0.01))(jq, jv)
        got = ta.integrate_positions(tf, tq, tv, 0.01)
        # The exp map differs from q + v dt at second order (1.5e-5 here).
        assert np.abs(n(got) - (q + 0.01 * v)).max() > 1e-6
        pairs = [(got, want)]
    for a, b in pairs:
        a, b = n(a), n(b)
        np.testing.assert_allclose(a, np.broadcast_to(b, a.shape), atol=1e-10, rtol=0)


def test_s_dot_dq_carries_gradients(chain):
    """The closed-form S-dot of ball and free joints under
    torch.autograd.grad: bias_forces' VJP against central differences."""
    _, tf, q, v, _ = chain
    rng = np.random.RandomState(12)
    wt = t64(rng.randn(9, B))

    def loss(q, v):
        _, _, _, S, rels = ta.fk(tf, q)
        return (wt * ta.bias_forces(tf, q, v, rels, S)).sum()

    x = [t64(q).requires_grad_(), t64(v).requires_grad_()]
    grads = torch.autograd.grad(loss(*x), x)
    h = 1e-6
    for _ in range(2):
        d = [rng.randn(9, B) for _ in range(2)]
        fd = (float(loss(*[t64(a + h * da) for a, da in zip((q, v), d)]))
              - float(loss(*[t64(a - h * da) for a, da in zip((q, v), d)]))) / (2 * h)
        ad = sum(float((g * t64(da)).sum()) for g, da in zip(grads, d))
        assert abs(fd - ad) <= 1e-7 * (1.0 + abs(ad)), (fd, ad)


# -- box-plane and box-box -----------------------------------------------------

HALF_A = np.array([0.1, 0.1, 0.1])
HALF_B = np.array([0.075, 0.06, 0.09])


def _rot(rng, axis, angle, tilt):
    """Rotations about a fixed axis by angle (B,) plus a small random tilt."""
    w = np.outer(np.asarray(axis, float), angle) + tilt * rng.randn(3, B)
    return np.asarray(jl.exp_so3(jnp.asarray(w)))


def _box_pair(case):
    """Seeded pairs of box B resting on box A (half sizes HALF_A, HALF_B),
    ~2-3 mm deep: face on face (yaw jitter), B's edge on A's face (B
    turned 45 deg about x), or edge on edge (A about x, B about y)."""
    rng = np.random.RandomState({"face_face": 1, "face_edge": 2, "edge_edge": 3}[case])
    pa = 0.01 * rng.randn(3, B)
    if case == "face_face":
        Ra = _rot(rng, [0, 0, 1], np.zeros(B), 0.005)
        Rb = _rot(rng, [0, 0, 1], rng.uniform(-0.3, 0.3, B), 0.005)
        lift = 0.1 + 0.09
    elif case == "face_edge":
        Ra = _rot(rng, [0, 0, 1], np.zeros(B), 0.005)
        Rb = _rot(rng, [1, 0, 0], np.full(B, np.pi / 4), 0.005)
        lift = 0.1 + (0.06 + 0.09) / np.sqrt(2)
    else:
        Ra = _rot(rng, [1, 0, 0], np.full(B, np.pi / 4), 0.05)
        Rb = _rot(rng, [0, 1, 0], np.full(B, np.pi / 4), 0.05)
        lift = (0.1 + 0.1 + 0.075 + 0.09) / np.sqrt(2)
    pb = pa + np.array([0.0, 0.0, lift - 0.003])[:, None] + 0.001 * rng.randn(3, B)
    return Ra, pa, Rb, pb


_JAX_BOX_BOX = jax.jit(lambda Ra, pa, Rb, pb: jc.box_box_b(Ra, pa, HALF_A, Rb, pb, HALF_B))


@pytest.mark.parametrize("case,touching", [("face_face", 4), ("face_edge", 2),
                                           ("edge_edge", 1)])
def test_box_box_b_matches_jax(case, touching):
    """Each case reaches its SAT feature in every world: 4 penetrating
    slots face on face, 2 for an edge on a face, 1 edge-edge contact."""
    Ra, pa, Rb, pb = _box_pair(case)
    want = _JAX_BOX_BOX(*map(jnp.asarray, (Ra, pa, Rb, pb)))
    got = tc.box_box_b(t64(Ra)[None], t64(pa)[None], t64(HALF_A)[None, :, None],
                       t64(Rb)[None], t64(pb)[None], t64(HALF_B)[None, :, None])
    for a, b in zip(got, want):
        np.testing.assert_allclose(n(a), n(b), atol=1e-10, rtol=0)
    np.testing.assert_array_equal((n(got[2]) > 0).sum(axis=0), touching)


def test_box_plane_b_matches_jax():
    Ra, pa, _, _ = _box_pair("edge_edge")
    nw = np.tile([[0.1], [-0.2], [1.0]], (1, B)) / np.sqrt(1.05)
    dw = np.full(B, -0.05)
    want = jax.jit(lambda R, p, nn, d: jc.box_plane_b(R, p, HALF_A, nn, d))(
        *map(jnp.asarray, (Ra, pa, nw, dw)))
    got = tc.box_plane_b(t64(Ra)[None], t64(pa)[None], t64(HALF_A)[None, :, None],
                         t64(nw)[None], t64(dw)[None])
    for a, b in zip(got, want):
        np.testing.assert_allclose(n(a), n(b), atol=1e-10, rtol=0)
    assert (n(got[2]) > 0).any() and (n(got[2]) < 0).any()


# -- K1b's plain version on the box stack's LCP ---------------------------------

PAD_TO = 97  # above 96 rows the JAX _pgs rolls its row loop


def test_k1b_plain_on_box_stack_lcp_matches_jax_seed():
    """apgd_plain + 16 sweeps of pgs_plain on the 2-box stack's own LCP
    (n = 72, r = 12, warm-started from one step's impulses, the default
    SolverConfig) against the JAX pure seed on the same rows."""
    jw, tw, q0 = box_stack_pair(2)
    eng = BatchedEngine(tw, **F64)
    meta = eng.meta
    assert (meta.n, meta.iterations, meta.seed_pgs_sweeps) == (72, 32, 16)
    q = np.tile(q0[:, None], (1, B))
    q[8] += np.random.RandomState(13).uniform(-0.2, 0.2, B)
    zero = t64(np.zeros((12, B)))
    first = eng.step(t64(q), zero, zero)
    p = eng.lcp_problem(first.q, first.v, zero)
    arrays = [n(x) for x in (p.F, p.b, p.mu, first.impulses)]
    got = n(lcp_cuda.seed_plain(meta, *[t64(x) for x in arrays[:1]], 0.0,
                                *[t64(x) for x in arrays[1:]]))
    jm = JaxEngine(jw).meta
    extra = PAD_TO - jm.n
    findex = np.concatenate([jm.findex, np.full(extra, -1, np.int32)])
    pm = dataclasses.replace(jm, findex=findex, is_friction=findex >= 0)
    polish = dataclasses.replace(pm, iterations=pm.seed_pgs_sweeps)
    padded = [np.concatenate([x, np.zeros((extra,) + x.shape[1:])]) for x in arrays]
    want = n(jax.jit(lambda F, b, mu, z: jlcp._pgs(
        polish, F, 0.0, b, mu, jlcp._apgd(pm, F, 0.0, b, mu, z)))(*map(jnp.asarray, padded)))
    assert not want[jm.n:].any()
    np.testing.assert_allclose(got, want[: jm.n], atol=1e-10, rtol=0)
    assert np.abs(got).max() > 1e-3


# -- the 2-box stack's step -------------------------------------------------------

# Tolerances of tests/test_torch_engine.py's ground case: the pinned
# solves amplify the two implementations' summation orders by up to
# ~1e10 eps.
Q_TOL, V_TOL, Z_TOL = 1e-10, 1e-7, 1e-7


def _stack_start(q0, seed):
    """boxstack_bench.py's start (q0, the top box's yaw jittered by
    +-0.2) with a little seeded noise on q and v."""
    rng = np.random.RandomState(seed)
    nv = len(q0)
    q = np.tile(q0[:, None], (1, B)) + 1e-3 * rng.randn(nv, B)
    q[nv - 4] += rng.uniform(-0.2, 0.2, B)
    return q, 0.02 * rng.randn(nv, B)


@pytest.fixture(scope="module")
def two_steps():
    """Two warm-started throughput() steps of the 2-box stack on each side,
    the JAX engine op by op (never compiled)."""
    jw, tw, q0 = box_stack_pair(2, solver="throughput")
    je, te = JaxEngine(jw), BatchedEngine(tw, **F64)
    q, v = _stack_start(q0, 14)
    u = np.zeros_like(q)
    jx = (jnp.asarray(q), jnp.asarray(v), jnp.zeros((je.num_rows, B)))
    tx = (t64(q), t64(v), t64(np.zeros((te.num_rows, B))))
    out = []
    for _ in range(2):
        jr = je.step(jx[0], jx[1], jnp.asarray(u), z_warm=jx[2])
        tr = te.step(tx[0], tx[1], t64(u), z_warm=tx[2])
        out.append((jr, tr))
        jx, tx = (jr.q, jr.v, jr.impulses), (tr.q, tr.v, tr.impulses)
    return out


def test_two_box_steps_match_jax(two_steps):
    """Both steps in one test, so that one worker runs the fixture."""
    for jr, tr in two_steps:
        np.testing.assert_allclose(n(tr.q), n(jr.q), atol=Q_TOL, rtol=Q_TOL)
        np.testing.assert_allclose(n(tr.v), n(jr.v), atol=V_TOL, rtol=V_TOL)
        np.testing.assert_allclose(n(tr.impulses), n(jr.impulses), atol=Z_TOL, rtol=Z_TOL)
        np.testing.assert_allclose(n(tr.contact_depths), n(jr.contact_depths), atol=1e-12)
        np.testing.assert_allclose(n(tr.contact_points), n(jr.contact_points), atol=1e-12)
        assert np.abs(n(tr.impulses)).max() > 1e-3
        assert (n(tr.contact_depths)[:8] > 0).any(), "box on box must touch"


# -- the step's VJP against finite differences -------------------------------------

H, FD_TOL = 1e-4, 1e-4  # as tests/test_torch_grad.py


def _masks(s):
    return s.clamping, s.upper, s.at_hi, s.valid, s.sign_u * s.upper


def _rest_start(q0, seed, worlds=2):
    """The stack at rest with every contact ~1 mm deep (box i lowered by
    (i + 1) mm: box-on-box contacts of q0 only touch, and a difference
    step would open and close them), the top box's yaw jittered by
    +-0.2, and seeded velocities of 1e-3."""
    rng = np.random.RandomState(seed)
    nv = len(q0)
    q = np.tile(q0[:, None], (1, worlds))
    q[5::6] -= 1e-3 * np.arange(1, nv // 6 + 1)[:, None]
    q[nv - 4] += rng.uniform(-0.2, 0.2, worlds)
    return q, 1e-3 * rng.randn(nv, worlds)


@pytest.mark.parametrize("fn", ["step", "remat_step"])
def test_box_stack_step_vjp_matches_finite_differences(fn):
    """The 2-box stack at rest under the default SolverConfig: the VJP of
    step (and remat_step) along seeded directions against central
    differences of step, with the active set fixed within the step."""
    _, tw, q0 = box_stack_pair(2)
    eng = BatchedEngine(tw, **F64)
    q, v = _rest_start(q0, 15)
    u = np.zeros_like(q)
    rng = np.random.RandomState(16)
    wq, wv = t64(rng.randn(*q.shape)), t64(rng.randn(*v.shape))
    x = [t64(a).requires_grad_() for a in (q, v, u)]
    r = getattr(eng, fn)(*x)
    grads = torch.autograd.grad((wq * r.q).sum() + (wv * r.v).sum(), x)

    def loss_and_masks(*args):
        p = eng.lcp_problem(*[t64(a) for a in args])
        z, u_, s = eng._solve(p, torch.zeros_like(p.b), eng._lcp_options(None, None, None))
        rr = eng._finish(t64(args[0]), t64(args[1]), p, z, u_)
        return float((wq * rr.q).sum() + (wv * rr.v).sum()), s.lcps[0], z

    L0, s0, z0 = loss_and_masks(q, v, u)
    assert float(z0.abs().max()) > 0 and bool(s0.valid.all())
    for _ in range(2):
        d = [rng.randn(*a.shape) for a in (q, v, u)]
        side = []
        for sgn in (1.0, -1.0):
            L, s, _ = loss_and_masks(*[a + sgn * H * da for a, da in zip((q, v, u), d)])
            # The masks, and sign_u where it is read (rows at the friction
            # bound): resting friction impulses are ~0 and flip sign.
            for a, c in zip(_masks(s), _masks(s0)):
                assert torch.equal(a, c), "the active set moved within the difference"
            side.append(L)
        fd = (side[0] - side[1]) / (2 * H)
        ad = sum(float((g * t64(da)).sum()) for g, da in zip(grads, d))
        assert abs(fd - ad) <= FD_TOL * abs(ad), (fd, ad)
