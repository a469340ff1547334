"""Card-only tests of nimblephysics_tpu_torch: the APGD seed kernel, with
and without its Gauss-Seidel polish (K1 and K1b), against its plain
PyTorch version in float32 at the main path's shape and at the box
stack's (n = 144, r = 18), its refusal beyond its launch plan, and the
training step's kernel launches and gradients.

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
@pytest.mark.parametrize("n,r", [(2000, 32), (60, 33)])
def test_wrapper_raises_above_capacity(n, r):
    """Above the launch plan's capacity the wrapper raises with the
    numbers; it never falls back to the plain seed."""
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
