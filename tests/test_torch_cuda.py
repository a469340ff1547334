"""Card-only tests of nimblephysics_tpu_torch: the APGD seed kernel
against its plain PyTorch version in float32, at the main path's shape.

They need an NVIDIA GPU and nvcc and skip elsewhere. This file imports
neither jax nor the JAX package, so that it runs where only PyTorch is
installed (the tests' conftest imports jax, hence --noconftest):

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

# float32 tolerance of the kernel against the plain version, relative to
# a world's impulse scale 1 + max|z| (the readings are in chip_smoke.py).
KERNEL_TOL = 1e-5


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _engine_and_lcps(dev, B=1024):
    from nimblephysics_tpu_torch.batched import BatchedEngine
    from nimblephysics_tpu_torch.models import half_cheetah
    from nimblephysics_tpu_torch.simulation import SolverConfig

    world, q0, _ = half_cheetah()
    world.solver = SolverConfig.throughput()
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
