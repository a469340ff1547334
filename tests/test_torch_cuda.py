"""Card-only tests of nimblephysics_tpu_torch: the APGD seed kernel, with
and without its Gauss-Seidel polish (K1 and K1b), against its plain
PyTorch version in float32 at the main path's shape, at the box stack's
(n = 144, r = 18) and on the box-stack engine's own LCPs (2 and 3 boxes,
5 boxes under contact_cap 48, one island of the islands scene), its
refusal beyond its launch plan (the 10-box stack's uncapped LCP
included), its wide tier on the 10- and 20-box legs' capped LCPs and a
10-box step,
the islands' one launch per island and step, the training step's
kernel launches and gradients, K1 and K1b on the box-bounded LCPs of the
motor scenes (servo, mimic, locked, ball, weld; chip_smoke.motor_scene),
and one jump_worm step on the card with one K1b launch and never the
plain seed.

They need an NVIDIA GPU and nvcc and skip elsewhere. This file imports
neither jax nor the JAX package, so that it runs where only PyTorch is
installed (the tests' conftest imports jax, hence --noconftest):

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

# float32 tolerances of the kernel against the plain version, relative to
# a world's impulse scale 1 + max|z| (the readings are in chip_smoke.py):
# K1, and K1b with its 16 sweeps of polish.
KERNEL_TOL = 1e-5
PGS_TOL = 1e-4


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _engine_and_lcps(dev, B=1024, default_config=False):
    from nimblephysics_tpu_torch.batched import BatchedEngine
    from nimblephysics_tpu_torch.models import half_cheetah
    from nimblephysics_tpu_torch.simulation import SolverConfig

    world, q0, _ = half_cheetah()
    world.solver = SolverConfig() if default_config else SolverConfig.throughput()
    eng = BatchedEngine(world, device=dev)
    rng = np.random.RandomState(0)

    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32,
                               device=dev).contiguous()

    q = np.tile(q0[:, None], (1, B)) + 0.02 * rng.randn(9, B)
    q[1] -= 0.27
    u = t(0.3 * rng.randn(9, B))
    first = eng.step(t(q), t(0.3 * rng.randn(9, B)), u)
    p = eng.lcp_problem(first.q, first.v, u)
    mu_r = np.where(eng.meta.is_friction[:, None], 0.9, 0.0) * np.ones((1, B))
    return eng, {
        "engine_lcp": (p.F, p.b.contiguous(), p.mu.contiguous(),
                       first.impulses.contiguous()),
        "random": tuple(t(x) for x in (
            0.5 * rng.randn(60, 9, B), rng.randn(60, B), mu_r,
            0.1 * np.abs(rng.randn(60, B)))),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["engine_lcp", "random"])
def test_apgd_kernel_matches_plain(case):
    from nimblephysics_tpu_torch.batched import lcp_cuda

    eng, lcps = _engine_and_lcps(_cuda())
    F, b, mu, z0 = lcps[case]
    before = lcp_cuda.apgd_seed.launches
    got = lcp_cuda.apgd_cuda(eng.meta, F, b, mu, z0)
    want = lcp_cuda.apgd_plain(eng.meta, F, 0.0, b, mu, z0)
    torch.cuda.synchronize()
    assert lcp_cuda.apgd_seed.launches == before + 1
    scale = 1.0 + want.abs().amax(dim=0)
    assert torch.isfinite(got).all()
    assert ((got - want).abs() <= KERNEL_TOL * scale).all()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["engine_lcp", "random"])
def test_apgd_seed_on_card_is_kernel_plus_pgd_step(case):
    from nimblephysics_tpu_torch.batched import lcp_cuda

    eng, lcps = _engine_and_lcps(_cuda())
    F, b, mu, z0 = lcps[case]
    got = lcp_cuda.apgd_seed(eng.meta, F, b, mu, z0)
    z = lcp_cuda.apgd_plain(eng.meta, F, 0.0, b, mu, z0)
    want = lcp_cuda.pgd_step(eng.meta, F, 0.0, b, mu, z)
    torch.cuda.synchronize()
    scale = 1.0 + want.abs().amax(dim=0)
    assert ((got - want).abs() <= KERNEL_TOL * scale).all()


@pytest.mark.cuda
def test_apgd_kernel_zero_world_stays_finite():
    """A world whose rows are all zero (no active constraint) gets L = 1e-9
    and keeps its warm start, finite."""
    from nimblephysics_tpu_torch.batched import lcp_cuda

    eng, lcps = _engine_and_lcps(_cuda(), B=64)
    F, b, mu, z0 = (x.clone() for x in lcps["random"])
    F[:, :, 0] = 0.0
    b[:, 0] = 0.0
    got = lcp_cuda.apgd_cuda(eng.meta, F, b, mu, z0)
    want = lcp_cuda.apgd_plain(eng.meta, F, 0.0, b, mu, z0)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got[:, 0], want[:, 0])


@pytest.mark.cuda
def test_wrapper_raises_on_float64():
    from nimblephysics_tpu_torch.batched import lcp_cuda

    eng, lcps = _engine_and_lcps(_cuda(), B=32)
    F, b, mu, z0 = (x.double() for x in lcps["random"])
    with pytest.raises(TypeError, match="float32"):
        lcp_cuda.apgd_cuda(eng.meta, F, b, mu, z0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["engine_lcp", "random"])
def test_k1b_kernel_matches_plain(case):
    """Default config: one launch runs the APGD and its 16 sweeps of polish,
    against apgd_plain then pgs_plain."""
    from nimblephysics_tpu_torch.batched import lcp_cuda

    eng, lcps = _engine_and_lcps(_cuda(), default_config=True)
    meta = eng.meta
    assert meta.seed_pgs_sweeps == 16
    F, b, mu, z0 = lcps[case]
    before = lcp_cuda.apgd_seed.launches
    got = lcp_cuda.seed_kernel(meta, F, b, mu, z0)
    want = lcp_cuda.seed_plain(meta, F, 0.0, b, mu, z0)
    torch.cuda.synchronize()
    assert lcp_cuda.apgd_seed.launches == before + 1
    scale = 1.0 + want.abs().amax(dim=0)
    assert torch.isfinite(got).all()
    assert ((got - want).abs() <= PGS_TOL * scale).all()


def _box_stack(dev, sweeps, B=1024):
    """The box-stack LCP the JAX package names at lcp_pallas.py:207-210:
    48 contacts of a normal and two friction rows (n = 144), a seeded
    random F of rank 18."""
    from nimblephysics_tpu_torch.constraint.lcp import LcpMeta

    rows = np.arange(144)
    isf = rows % 3 > 0
    meta = LcpMeta(findex=np.where(isf, rows - rows % 3, -1).astype(np.int32),
                   is_friction=isf, iterations=32 if sweeps else 24,
                   seed_pgs_sweeps=sweeps)
    rng = np.random.RandomState(3)
    mu = np.where(isf[:, None], 0.9, 0.0) * np.ones((1, B))
    lcp = [torch.as_tensor(x, dtype=torch.float32, device=dev).contiguous()
           for x in (0.5 * rng.randn(144, 18, B), rng.randn(144, B), mu,
                     0.1 * np.abs(rng.randn(144, B)))]
    return meta, lcp


@pytest.mark.cuda
@pytest.mark.parametrize("sweeps", [0, 16], ids=["K1", "K1b"])
def test_box_stack_lcp_matches_plain(sweeps):
    """n = 144, r = 18 (rank padded to 24, above the one-thread design's
    16): the kernel against the plain versions."""
    from nimblephysics_tpu_torch.batched import lcp_cuda

    meta, (F, b, mu, z0) = _box_stack(_cuda(), sweeps)
    got = lcp_cuda.apgd_cuda(meta, F, b, mu, z0, pgs_sweeps=sweeps)
    want = lcp_cuda.seed_plain(meta, F, 0.0, b, mu, z0)
    torch.cuda.synchronize()
    scale = 1.0 + want.abs().amax(dim=0)
    assert torch.isfinite(got).all()
    assert ((got - want).abs() <= (PGS_TOL if sweeps else KERNEL_TOL) * scale).all()


@pytest.mark.cuda
@pytest.mark.parametrize("n,r", [(2000, 32), (60, 129)])
def test_wrapper_raises_above_capacity(n, r):
    """Above the launch plan's capacity (the wide tier's: n <= 1024, rank
    <= 128) the wrapper raises with the numbers; it never falls back to
    the plain seed."""
    from nimblephysics_tpu_torch.batched import lcp_cuda
    from nimblephysics_tpu_torch.constraint.lcp import LcpMeta

    dev = _cuda()
    meta = LcpMeta(findex=-np.ones(n, np.int32), is_friction=np.zeros(n, bool))
    F = torch.zeros(n, r, 4, device=dev)
    b = torch.zeros(n, 4, device=dev)
    before = lcp_cuda.apgd_seed.launches
    with pytest.raises(NotImplementedError, match=str(r)):
        lcp_cuda.apgd_cuda(meta, F, b, b, b)
    assert lcp_cuda.apgd_seed.launches == before


@pytest.mark.cuda
def test_training_step_launches_the_kernel_once_per_step():
    """A training step of horizon H launches the kernel H times (the
    forward; the remat'd backward replays the saved seed), and its loss
    and gradients are finite."""
    from nimblephysics_tpu_torch.batched import BatchedEngine, lcp_cuda
    from nimblephysics_tpu_torch.models import half_cheetah
    from nimblephysics_tpu_torch.parallel import MlpPolicy, train_step_batched

    dev = _cuda()
    world, q0, v0 = half_cheetah()  # the default SolverConfig: K1b
    eng = BatchedEngine(world, device=dev)
    B, H = 64, 3
    rng = np.random.RandomState(1)
    x0 = np.concatenate([q0, v0])
    states = np.tile(x0[:, None], (1, B)) + 0.01 * rng.randn(len(x0), B)
    states = torch.as_tensor(states, dtype=torch.float32, device=dev)
    policy = MlpPolicy(len(x0), world.action_size, 16, device=dev)
    train = train_step_batched(eng, policy, horizon=H, learning_rate=1e-3)
    lcp_cuda.apgd_seed.launches = 0
    res = train(states)
    torch.cuda.synchronize()
    assert lcp_cuda.apgd_seed.launches == H
    assert torch.isfinite(res.loss) and torch.isfinite(res.states).all()
    for p in policy.parameters():
        assert torch.isfinite(p.grad).all()
    assert any(float(p.grad.abs().max()) > 0 for p in policy.parameters())


# The box-stack path: (boxes, contact_cap, filter the box-box pairs).
BOX_LEGS = {"box2": (2, None, False), "box3": (3, None, False),
            "box5_cap48": (5, 48, False), "islands": (3, None, True)}


def _box_engine(dev, n_boxes, cap=None, islands=False):
    """box_stack(n_boxes) under its default SolverConfig on the card, with
    contact_cap `cap`, or as the islands scene (box-box pairs filtered,
    the boxes spread along x); and its start q0."""
    import dataclasses

    from nimblephysics_tpu_torch.batched import BatchedEngine
    from nimblephysics_tpu_torch.models import box_stack

    world, q0, _ = box_stack(n_boxes)
    if cap is not None:
        world.solver = dataclasses.replace(world.solver, contact_cap=cap)
    if islands:
        for i in range(n_boxes):
            for j in range(i + 1, n_boxes):
                world.collision_overrides[(i, j)] = False
            q0[6 * i + 3:6 * i + 6] = (1.0 * i, 0.0, 0.2 * 0.75**i / 2 - 1e-4)
    return BatchedEngine(world, device=dev), q0


def _box_state(dev, eng, q0, B, steps):
    """q0 with the top box's yaw jittered by +-0.2 (boxstack_bench.py's
    start), after `steps` warm-started steps: (q, v, z, u)."""
    rng = np.random.RandomState(5)
    q = np.tile(q0[:, None], (1, B))
    q[len(q0) - 4] += rng.uniform(-0.2, 0.2, B)
    q = torch.as_tensor(q, dtype=torch.float32, device=dev)
    v, u = torch.zeros_like(q), torch.zeros_like(q)
    z = None
    for _ in range(steps):
        r = eng.step(q, v, u, z_warm=z)
        q, v, z = r.q, r.v, r.impulses
    return q, v, z, u


@pytest.mark.cuda
@pytest.mark.parametrize("sweeps", [0, 16], ids=["K1", "K1b"])
@pytest.mark.parametrize("leg", BOX_LEGS)
def test_box_stack_engine_lcp_matches_plain(leg, sweeps):
    """The LCP each leg's step solves (the capped one, an island's),
    warm-started as in a rollout: kernel against plain."""
    from nimblephysics_tpu_torch.batched import lcp_cuda

    dev = _cuda()
    eng, q0 = _box_engine(dev, *BOX_LEGS[leg])
    q, v, z, u = _box_state(dev, eng, q0, 1024, 3)
    (meta, F, b, mu, zw), = eng.lcp_blocks(eng.lcp_problem(q, v, u), z)[0][:1]
    F, b, mu, zw = (x.contiguous() for x in (F, b, mu, zw))
    got = lcp_cuda.apgd_cuda(meta, F, b, mu, zw, pgs_sweeps=sweeps)
    want = lcp_cuda.apgd_plain(meta, F, 0.0, b, mu, zw)
    if sweeps:
        want = lcp_cuda.pgs_plain(meta, F, 0.0, b, mu, want, sweeps=sweeps)
    torch.cuda.synchronize()
    scale = 1.0 + want.abs().amax(dim=0)
    assert torch.isfinite(got).all()
    assert ((got - want).abs() <= (PGS_TOL if sweeps else KERNEL_TOL) * scale).all()
    assert float(want.abs().max()) > 0


@pytest.mark.cuda
def test_islands_launch_the_seed_once_per_island_and_step():
    from nimblephysics_tpu_torch.batched import lcp_cuda

    dev = _cuda()
    eng, q0 = _box_engine(dev, *BOX_LEGS["islands"])
    assert len(eng.islands) == 3
    lcp_cuda.apgd_seed.launches = 0
    q, v, z, _ = _box_state(dev, eng, q0, 256, 2)
    torch.cuda.synchronize()
    assert lcp_cuda.apgd_seed.launches == 6
    assert torch.isfinite(q).all() and torch.isfinite(z).all()


@pytest.mark.cuda
@pytest.mark.parametrize("sweeps", [0, 16], ids=["K1", "K1b"])
@pytest.mark.parametrize("boxes,cap,cluster", [(10, 96, 1), (20, 192, 2)],
                         ids=["box10", "box20"])
def test_wide_tier_matches_plain_on_capped_box_lcps(boxes, cap, cluster, sweeps):
    """The 10- and 20-box legs' capped LCPs (n = 288, r = 60; n = 576,
    r = 120) take the wide tier, F in one CTA's shared memory and in a
    cluster of two CTAs': kernel against plain at 256 worlds."""
    from nimblephysics_tpu_torch.batched import lcp_cuda

    dev = _cuda()
    eng, q0 = _box_engine(dev, boxes, cap)
    q, v, z, u = _box_state(dev, eng, q0, 256, 3)
    (meta, F, b, mu, zw), = eng.lcp_blocks(eng.lcp_problem(q, v, u), z)[0][:1]
    F, b, mu, zw = (x.contiguous() for x in (F, b, mu, zw))
    plan = lcp_cuda.seed_plan(*F.shape[:2], lcp_cuda.smem_limit(dev.index or 0))
    assert plan.tier == "wide" and plan.cluster == cluster
    assert lcp_cuda.wide_layout(meta) == 2  # contact triples
    got = lcp_cuda.apgd_cuda(meta, F, b, mu, zw, pgs_sweeps=sweeps)
    want = lcp_cuda.apgd_plain(meta, F, 0.0, b, mu, zw)
    if sweeps:
        want = lcp_cuda.pgs_plain(meta, F, 0.0, b, mu, want, sweeps=sweeps)
    scale = 1.0 + want.abs().amax(dim=0)
    assert torch.isfinite(got).all()
    assert ((got - want).abs() <= (PGS_TOL if sweeps else KERNEL_TOL) * scale).all()
    assert float(want.abs().max()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("sweeps", [0, 16], ids=["K1", "K1b"])
@pytest.mark.parametrize("n,r,cluster,order",
                         [(300, 20, 2, "triples"), (63, 128, 1, "triples"),
                          (1023, 128, 4, "triples"), (288, 60, 1, "swapped"),
                          (576, 120, 2, "permuted")],
                         ids=["rows_300", "rank_128", "capacity", "swapped", "permuted"])
def test_wide_tier_matches_plain_on_random_lcps(n, r, cluster, order, sweeps):
    """Seeded random LCPs of contacts (a normal and two friction rows each)
    past the narrow tier, up to the wide tier's capacity, 256 worlds, on
    clusters of 1, 2 and 4 CTAs; one with each triple's normal second
    (layout 1: the normal in the group, after a friction row), and one with
    its rows permuted, so that friction rows find their normals in other
    groups and in the other CTA (layout 0: the second pass over F)."""
    from nimblephysics_tpu_torch.batched import lcp_cuda
    from nimblephysics_tpu_torch.constraint.lcp import LcpMeta

    dev = _cuda()
    rows = np.arange(n)
    isf = rows % 3 > 0
    fi = np.where(isf, rows - rows % 3, -1)
    if order != "triples":
        perm = (np.random.RandomState(n).permutation(n) if order == "permuted"
                else rows + np.where(rows % 3 == 0, 1, np.where(rows % 3 == 1, -1, 0)))
        pos = np.argsort(perm)
        isf, fi = isf[perm], np.where(fi[perm] >= 0, pos[np.maximum(fi[perm], 0)], -1)
    meta = LcpMeta(findex=fi.astype(np.int32), is_friction=isf, iterations=32,
                   seed_pgs_sweeps=sweeps)
    assert lcp_cuda.wide_layout(meta) == {"triples": 2, "swapped": 1, "permuted": 0}[order]
    rng = np.random.RandomState(n + r)
    B = 256

    def t(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev).contiguous()

    F, b = t(0.5 * rng.randn(n, r, B)), t(rng.randn(n, B))
    mu, z0 = t(np.where(isf[:, None], 0.9, 0.0) * np.ones((1, B))), t(0.1 * np.abs(rng.randn(n, B)))
    plan = lcp_cuda.seed_plan(n, r, lcp_cuda.smem_limit(dev.index or 0))
    assert plan.tier == "wide" and plan.cluster == cluster
    got = lcp_cuda.apgd_cuda(meta, F, b, mu, z0, pgs_sweeps=sweeps)
    want = lcp_cuda.seed_plain(meta, F, 0.0, b, mu, z0)
    scale = 1.0 + want.abs().amax(dim=0)
    assert torch.isfinite(got).all()
    assert ((got - want).abs() <= (PGS_TOL if sweeps else KERNEL_TOL) * scale).all()


@pytest.mark.cuda
def test_ten_box_stack_steps_on_the_wide_tier():
    """The 10-box leg (contact_cap 96: n = 288, r = 60) steps on the card:
    one K1b launch a step, finite."""
    from nimblephysics_tpu_torch.batched import lcp_cuda

    dev = _cuda()
    eng, q0 = _box_engine(dev, 10, 96)
    before = lcp_cuda.apgd_seed.launches
    q, v, z, _ = _box_state(dev, eng, q0, 64, 2)
    torch.cuda.synchronize()
    assert lcp_cuda.apgd_seed.launches == before + 2
    assert torch.isfinite(q).all() and torch.isfinite(z).all()


@pytest.mark.cuda
def test_uncapped_ten_box_stack_is_refused_with_its_numbers():
    """The 10-box stack without its contact cap (n = 1320, r = 60) is past
    the wide tier's capacity: the step raises, nothing is launched."""
    from nimblephysics_tpu_torch.batched import lcp_cuda

    dev = _cuda()
    eng, q0 = _box_engine(dev, 10, None)
    before = lcp_cuda.apgd_seed.launches
    with pytest.raises(NotImplementedError, match="n=1320, r=60"):
        _box_state(dev, eng, q0, 64, 1)
    assert lcp_cuda.apgd_seed.launches == before


def _slice_lcp(dev, name, B=1024):
    """The default-config LCP of one of chip_smoke's slice worlds after 5
    steps from its start at B worlds: (meta, F, b, mu, z_warm)."""
    import chip_smoke

    from nimblephysics_tpu_torch.batched import BatchedEngine

    if name == "jump_worm":
        _, q0, v0, eng = chip_smoke.make_ref_engine(dev, name)
        carry, drive = chip_smoke.ref_start(eng, q0, v0, np.random.RandomState(1), dev, B)
    else:
        eng = BatchedEngine(chip_smoke.motor_scene(name)[0], device=dev)
        carry, drive = chip_smoke.motor_start(eng, name, np.random.RandomState(1), dev, B)
    q, v, z = chip_smoke.advance(eng, carry, drive, 5)
    u = (eng.action_to_forces(drive(torch.cat([q, v]))).detach()
         if isinstance(drive, torch.nn.Module) else drive)
    return [x.contiguous() if torch.is_tensor(x) else x
            for x in eng.lcp_blocks(eng.lcp_problem(q, v, u), z)[0][0]]


@pytest.mark.cuda
@pytest.mark.parametrize("sweeps", [0, 16], ids=["K1", "K1b"])
@pytest.mark.parametrize("name", ["servo", "mimic", "locked", "ball", "weld", "jump_worm"])
def test_slice_lcp_matches_plain(name, sweeps):
    """K1 / K1b on the LCPs with finite upper and negative lower bounds
    (servo and mimic rows), unbounded rows (locked, ball, weld) and the
    worm's contacts and limits, against the plain versions; the
    saturated servo sits at its bound."""
    from nimblephysics_tpu_torch.batched import lcp_cuda

    meta, F, b, mu, zw = _slice_lcp(_cuda(), name)
    z = lcp_cuda.apgd_cuda(meta, F, b, mu, zw, pgs_sweeps=sweeps)
    want = lcp_cuda.apgd_plain(meta, F, 0.0, b, mu, zw)
    if sweeps:
        want = lcp_cuda.pgs_plain(meta, F, 0.0, b, mu, want, sweeps=sweeps)
    scale = 1.0 + want.abs().amax(dim=0)
    assert float(((z - want).abs() / scale).max()) <= (PGS_TOL if sweeps else KERNEL_TOL)
    if name == "servo":
        assert torch.allclose(z[0], torch.full_like(z[0], float(meta.hi_const[0])), rtol=1e-6)


@pytest.mark.cuda
def test_jump_worm_step_on_the_card():
    """One default-config jump_worm step at 1024 worlds: one K1b launch,
    never the plain seed, finite, and within float32 rounding of the CPU
    float64 step from the same state."""
    from unittest import mock

    import chip_smoke

    from nimblephysics_tpu_torch.batched import BatchedEngine, lcp_cuda

    dev = _cuda()
    world, q0, v0, eng = chip_smoke.make_ref_engine(dev, "jump_worm")
    (q, v, z), policy = chip_smoke.ref_start(eng, q0, v0, np.random.RandomState(2), dev, 1024)
    u = eng.action_to_forces(policy(torch.cat([q, v]))).detach()

    def refuse(*_, **__):
        raise AssertionError("the plain seed ran on the card")

    before = lcp_cuda.apgd_seed.launches
    with mock.patch.object(lcp_cuda, "seed_plain", refuse), \
            mock.patch.object(lcp_cuda, "apgd_plain", refuse):
        r = eng.step(q, v, u, z_warm=z)
    assert lcp_cuda.apgd_seed.launches == before + 1
    assert all(bool(torch.isfinite(x).all()) for x in (r.q, r.v, r.impulses))
    cpu = BatchedEngine(world, device="cpu", dtype=torch.float64)
    c = cpu.step(*(x.double().cpu() for x in (q, v, u)), z_warm=z.double().cpu())
    assert float((r.q.double().cpu() - c.q).abs().max()) <= 1e-6
    assert float(r.impulses.abs().max()) > 0
