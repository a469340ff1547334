"""The APGD seed kernel's launch plan and the zero-column padding it rests
on, on the CPU (no GPU or nvcc needed).

`lcp_cuda.seed_plan` turns n, r and the card's shared memory per block
into the kernel's tier (narrow: a warp per world; wide: a block per
world, past rank 32 or 256 rows), the padded rank (a template width of
csrc/apgd_seed.cu), the rows each lane owns, the worlds a block holds,
and its bytes, or says why the card cannot take the LCP. The kernel pads
F with zero columns up to its width; that is exact when zero columns
change nothing, which the plain versions show bit for bit in float64.
"""

import re

import numpy as np
import pytest
import torch

from nimblephysics_tpu_torch.batched import lcp_cuda
from nimblephysics_tpu_torch.constraint.lcp import LcpMeta

# Shared memory one block may opt into on an H100 (NVIDIA's data sheet).
H100_SMEM = 232448


@pytest.mark.parametrize(
    "n,r,width,rows,worlds,stride,smem",
    [(60, 9, 12, 2, 8, 1033, 34016),  # the half-cheetah's LCP
     (144, 18, 24, 8, 8, 4201, 136736),  # the box stack, lcp_pallas.py:207-210
     (102, 5, 8, 8, 8, 1335, 44352),  # jump_worm
     (174, 5, 8, 8, 8, 2271, 75456),  # catapult
     (1, 1, 8, 2, 8, 21, 688),  # the servo and locked pendulums
     (1, 2, 8, 2, 8, 21, 688),  # the mimic double pendulum
     (27, 6, 8, 2, 8, 359, 11920),  # the ball-pinned box
     (30, 12, 12, 2, 8, 523, 17216)],  # the welded boxes
    ids=["half_cheetah", "box_stack", "jump_worm", "catapult", "servo",
         "mimic", "ball", "weld"])
def test_seed_plan_fits(n, r, width, rows, worlds, stride, smem):
    plan = lcp_cuda.seed_plan(n, r, H100_SMEM)
    assert plan.fits and plan.why == "" and plan.tier == "narrow"
    assert (plan.rank_width, plan.rows_per_lane, plan.worlds_per_block,
            plan.world_stride, plan.smem_bytes) == (width, rows, worlds, stride, smem)
    assert plan.lanes_per_world == 32 and plan.world_stride % 2 == 1
    # A world's region: F [n][R + 1], b, mu, z, 1 / A_ii, then u (R).
    assert plan.world_stride >= n * (width + 5) + width
    assert plan.smem_bytes == 4 * (4 * n + worlds * stride)


@pytest.mark.parametrize(
    "n,r,width,smem",
    [(288, 60, 64, 12672),  # the 10-box leg's capped LCP
     (576, 120, 128, 24192),  # the 20-box leg's: F alone is 288 KiB
     (257, 32, 32, 11432),  # one row past the narrow tier
     (256, 33, 64, 11392),  # one rank past it
     (1024, 128, 128, 42112)],  # the wide tier's capacity
    ids=["box10_cap96", "box20_cap192", "rows_257", "rank_33", "capacity"])
def test_seed_plan_wide_tier(n, r, width, smem):
    """A block of 256 threads per world; shared memory holds 10 vectors of
    n words and 288 more, and F lies in a global workspace of n R floats a
    world."""
    plan = lcp_cuda.seed_plan(n, r, H100_SMEM)
    assert plan.fits and plan.why == "" and plan.tier == "wide"
    assert (plan.rank_width, plan.smem_bytes) == (width, smem)
    assert (plan.worlds_per_block, plan.lanes_per_world, plan.rows_per_lane) == (1, 256, 0)
    assert plan.world_stride == n * width
    assert plan.smem_bytes == 4 * (10 * n + 288)
    assert plan.workspace_floats == n * width


def test_seed_plan_halves_the_block_to_fit():
    plan = lcp_cuda.seed_plan(144, 18, 48 * 1024)
    assert plan.fits and plan.worlds_per_block == 2
    assert plan.smem_bytes <= 48 * 1024


@pytest.mark.parametrize("n,r,limit,words", [
    (2000, 32, H100_SMEM, ["n=2000", "r=32", "rows <= 1024"]),
    (60, 129, H100_SMEM, ["r=129", "rank <= 128"]),
    (576, 120, 16 * 1024, ["24192 bytes", "16384"]),
], ids=["rows", "rank", "shared_memory"])
def test_seed_plan_refuses_above_capacity(n, r, limit, words):
    """Past the wide tier's capacity (n <= 1024, rank <= 128) or the card's
    shared memory, the plan says why, with the
    numbers; apgd_cuda raises with its words and launches nothing."""
    plan = lcp_cuda.seed_plan(n, r, limit)
    assert not plan.fits and plan.tier == "wide"
    for word in words:
        assert word in plan.why


def test_the_narrow_tier_falls_to_the_wide_one_for_shared_memory():
    """An LCP that the narrow tier holds but the card's shared memory does
    not (the box-stack LCP at 16 KiB a block) runs on the wide tier."""
    narrow = lcp_cuda._narrow_plan(144, 18, 16 * 1024)
    assert not narrow.fits and "19108 bytes" in narrow.why
    plan = lcp_cuda.seed_plan(144, 18, 16 * 1024)
    assert plan.fits and plan.tier == "wide" and plan.workspace_floats == 144 * 32


def test_plan_widths_are_the_kernels_instantiations():
    src = lcp_cuda.SOURCE.read_text()
    macro = re.search(r"#define NT_INSTANCES\(X\)(.*?)\n\n", src, re.S)[1]
    built = {(int(a), int(b)) for a, b in re.findall(r"X\((\d+), (\d+)\)", macro)}
    assert built == set(lcp_cuda.INSTANCES)
    for n, r in ((60, 9), (60, 18), (100, 9), (256, 32)):
        plan = lcp_cuda.seed_plan(n, r, H100_SMEM)
        assert (plan.rank_width, plan.rows_per_lane) in built
        assert plan.rows_per_lane * 32 >= n
    wide = re.search(r"#define WIDE_INSTANCES\(X\)(.*?)\n", src)[1]
    assert {int(w) for w in re.findall(r"X\((\d+)\)", wide)} == set(lcp_cuda.WIDE_WIDTHS)
    for n, r in ((288, 60), (576, 120), (300, 20), (1024, 128)):
        assert lcp_cuda.seed_plan(n, r, H100_SMEM).rank_width in lcp_cuda.WIDE_WIDTHS


@pytest.mark.parametrize("width", [12, 16])
def test_zero_column_padding_is_exact(width):
    """apgd_plain then pgs_plain (the default config's 32 iterations and 16
    sweeps) on F padded from r = 9 with zero columns equal the unpadded
    result bit for bit in float64. 16 worlds: at that trailing width
    torch's CPU sums add the reduced axis in order for both widths (at 4
    or 8 they take another order, which moves the last bits)."""
    contacts, B, r = 20, 16, 9
    rows = np.arange(3 * contacts)
    isf = rows % 3 > 0
    meta = LcpMeta(findex=np.where(isf, rows - rows % 3, -1).astype(np.int32),
                   is_friction=isf, iterations=32, seed_pgs_sweeps=16)
    rng = np.random.RandomState(4)
    n = meta.n
    F = torch.as_tensor(0.5 * rng.randn(n, r, B))
    b = torch.as_tensor(rng.randn(n, B))
    mu = torch.as_tensor(np.where(isf[:, None], 0.9, 0.0) * np.ones((1, B)))
    z0 = torch.as_tensor(0.1 * np.abs(rng.randn(n, B)))
    Fp = torch.cat([F, torch.zeros(n, width - r, B, dtype=F.dtype)], dim=1)
    want = lcp_cuda.seed_plain(meta, F, 0.0, b, mu, z0)
    got = lcp_cuda.seed_plain(meta, Fp, 0.0, b, mu, z0)
    assert torch.equal(got, want)
    assert not torch.equal(want, z0)


def test_kernel_refuses_an_lcp_with_no_rows():
    """apgd_cuda raises on n = 0 before it looks at the card (the engine
    never calls it so: a world with no rows solves no LCP)."""
    meta = LcpMeta(findex=np.zeros(0, np.int32), is_friction=np.zeros(0, bool))
    x = torch.zeros(0, 2)
    with pytest.raises(ValueError, match="no rows"):
        lcp_cuda.apgd_cuda(meta, torch.zeros(0, 3, 2), x, x, x)
    assert lcp_cuda.apgd_seed.launches == 0
