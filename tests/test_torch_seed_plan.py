"""The APGD seed kernel's launch plan and the zero-column padding it rests
on, on the CPU (no GPU or nvcc needed).

`lcp_cuda.seed_plan` turns n, r and the card's shared memory per block
into the kernel's tier (narrow: a warp per world; wide: a CTA, or a
cluster of 2 or 4 CTAs, per world, past rank 32 or 256 rows, F held in
their shared memory), the padded rank (a template width of
csrc/apgd_seed.cu), the rows each lane or CTA owns, the worlds a block
holds, and its bytes, or says why the card cannot take the LCP. The
kernel pads F with zero columns up to its width; that is exact when zero
columns change nothing, which the plain versions show bit for bit in
float64. The wide tier's polish takes the rows in blocks of six with the
in-block Gram terms; a float64 model of that order below equals
`pgs_plain`'s row-by-row Gauss-Seidel to rounding.
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
    "n,r,width,cluster,rows,smem",
    [(288, 60, 64, 1, 288, 91848),  # the 10-box leg's capped LCP: one CTA
     (576, 120, 128, 2, 288, 183624),  # the 20-box leg's: F is 288 KiB, two CTAs
     (257, 32, 32, 1, 264, 48488),  # one row past the narrow tier
     (256, 33, 64, 1, 264, 84584),  # one rank past it
     (1024, 128, 128, 4, 264, 193736)],  # the wide tier's capacity: four CTAs
    ids=["box10_cap96", "box20_cap192", "rows_257", "rank_33", "capacity"])
def test_seed_plan_wide_tier(n, r, width, cluster, rows, smem):
    """A cluster of 1, 2 or 4 CTAs of 256 threads per world, each holding
    its share of the rows (whole polish blocks of twelve, at most 288) of F
    [row][R] in shared memory, beside the Gram terms (68 floats a block),
    the polish's row inputs (4 floats a row), z and the friction code over
    the cluster's rows, and the partial sums (18 sets of R + 1); no global
    workspace."""
    plan = lcp_cuda.seed_plan(n, r, H100_SMEM)
    assert plan.fits and plan.why == "" and plan.tier == "wide"
    assert (plan.rank_width, plan.cluster, plan.rows_per_cta, plan.smem_bytes) == (
        width, cluster, rows, smem)
    assert (plan.worlds_per_block, plan.lanes_per_world, plan.rows_per_lane) == (
        1, 256 * cluster, 0)
    assert plan.world_stride == rows * width
    N = cluster * rows
    assert plan.smem_bytes == 4 * (rows * width + 68 * N // 12 + 6 * N + 18 * (width + 1))
    assert N >= n and rows % 12 == 0 and rows <= 288 and plan.smem_bytes <= H100_SMEM
    assert not hasattr(plan, "workspace_floats")
    # The smallest cluster that holds the LCP: a smaller one would take
    # more than 288 rows or more shared memory than a block may have.
    for smaller in (c for c in (1, 2, 4) if c < cluster):
        share = 12 * -(-(-(-n // smaller)) // 12)
        assert share > 288 or lcp_cuda.wide_smem_bytes(width, smaller, share) > H100_SMEM


def test_seed_plan_halves_the_block_to_fit():
    plan = lcp_cuda.seed_plan(144, 18, 48 * 1024)
    assert plan.fits and plan.worlds_per_block == 2
    assert plan.smem_bytes <= 48 * 1024


@pytest.mark.parametrize("n,r,limit,words", [
    (2000, 32, H100_SMEM, ["n=2000", "r=32", "rows <= 1024"]),
    (60, 129, H100_SMEM, ["r=129", "rank <= 128"]),
    (576, 120, 16 * 1024, ["109896 bytes", "a cluster of 4", "16384"]),
], ids=["rows", "rank", "shared_memory"])
def test_seed_plan_refuses_above_capacity(n, r, limit, words):
    """Past the wide tier's capacity (n <= 1024, rank <= 128) or the card's
    shared memory at the largest cluster (4 CTAs), the plan says why, with
    the numbers; apgd_cuda raises with its words and launches nothing."""
    plan = lcp_cuda.seed_plan(n, r, limit)
    assert not plan.fits and plan.tier == "wide"
    for word in words:
        assert word in plan.why


def test_the_narrow_tier_falls_to_the_wide_one_for_shared_memory():
    """An LCP that the narrow tier holds but the card's shared memory does
    not (the box-stack LCP at 16 KiB a block) runs on the wide tier, in a
    cluster of 4 CTAs of 36 rows each."""
    narrow = lcp_cuda._narrow_plan(144, 18, 16 * 1024)
    assert not narrow.fits and "19108 bytes" in narrow.why
    plan = lcp_cuda.seed_plan(144, 18, 16 * 1024)
    assert plan.fits and plan.tier == "wide"
    assert (plan.cluster, plan.rows_per_cta, plan.smem_bytes) == (4, 36, 13704)


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
    # The wide tier's shape constants, as the plan and wide_smem_bytes use them.
    const = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(const["kWideThreads"]) == lcp_cuda.WIDE_THREADS
    assert int(const["kGroup"]) == lcp_cuda.WIDE_GROUP
    assert int(const["kGramStride"]) == lcp_cuda.WIDE_GRAM_STRIDE
    assert int(const["kMaxCluster"]) == max(lcp_cuda.WIDE_CLUSTERS)
    assert (lcp_cuda.WIDE_THREADS // 32 * int(const["kGroupsPerWarp"]) * lcp_cuda.WIDE_GROUP
            == lcp_cuda.WIDE_CTA_ROWS)


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


def _blocked_polish(meta, F, b, mu, z0, sweeps, drop=None):
    """A float64 model of the wide tier's polish order (csrc/apgd_seed.cu,
    wide_polish): rows in blocks of twelve; at a block's start its twelve
    F_i . u; each row's value before the clip starts as z_i + (b_i - F_i .
    u) / A_ii, and each earlier row m of the block, once solved, takes
    (G_im / A_ii) dz_m off it (G_im = F_i . F_m, the in-block Gram terms);
    a friction row is bounded by its normal's z (this block's new value if
    the normal came earlier in it, else the stored one); then one
    u += F_blk^T dz_blk. drop = (i, m) leaves G_im out in every block."""
    n, r, B = F.shape
    fidx = np.maximum(meta.findex, 0)
    diag = (F * F).sum(dim=1)
    inv = torch.where(diag > 1e-12, 1.0 / diag.clamp(min=1e-12), torch.zeros_like(diag))
    lo, hi = (torch.as_tensor(x, dtype=F.dtype)[:, None]
              for x in (meta.lo_const if meta.lo_const is not None else np.zeros(n),
                        meta.hi_const if meta.hi_const is not None else np.full(n, np.inf)))
    z = z0.clone()
    u = torch.einsum("irb,ib->rb", F, z)
    for _ in range(sweeps):
        for i0 in range(0, n, 12):
            rows = range(i0, min(i0 + 12, n))
            Fb = F[i0:i0 + 12]
            P = torch.einsum("irb,rb->ib", Fb, u)
            H = torch.einsum("irb,mrb->imb", Fb, Fb) * inv[i0:i0 + 12, None]
            acc = {i: z[i] + (b[i] - P[i - i0]) * inv[i] for i in rows}
            x, dz = {}, {}
            for i in rows:
                xi = acc[i]
                if meta.is_friction[i]:
                    zn = x[fidx[i]] if i0 <= fidx[i] < i else z[fidx[i]]
                    xi = torch.minimum(torch.maximum(xi, -mu[i] * zn), mu[i] * zn)
                else:
                    xi = torch.minimum(torch.maximum(xi, lo[i]), hi[i])
                x[i], dz[i] = xi, xi - z[i]
                for j in rows:
                    if j > i and drop != (j - i0, i - i0):
                        acc[j] = acc[j] - H[j - i0, i - i0] * dz[i]
            for i in rows:
                u = u + F[i] * dz[i]
                z[i] = x[i]
    return z


def _layout_meta(contacts, extra, order):
    """contacts normal + two friction rows each, then `extra` bounded
    non-friction rows; rows permuted by `order` (None: the assembler's
    triples)."""
    n = 3 * contacts + extra
    isf = np.zeros(n, bool)
    fi = np.full(n, -1, np.int32)
    for c in range(contacts):
        isf[3 * c + 1: 3 * c + 3] = True
        fi[3 * c + 1: 3 * c + 3] = 3 * c
    lo = np.zeros(n)
    hi = np.full(n, np.inf)
    lo[3 * contacts:], hi[3 * contacts:] = -0.3, 0.4
    if order is not None:
        pos = np.argsort(order)  # old row -> new row
        isf, lo, hi = isf[order], lo[order], hi[order]
        fi = np.where(fi[order] >= 0, pos[np.maximum(fi[order], 0)], -1).astype(np.int32)
    return LcpMeta(findex=fi, is_friction=isf, iterations=32, seed_pgs_sweeps=16,
                   lo_const=lo, hi_const=hi)


@pytest.mark.parametrize("layout", ["triples", "permuted"])
def test_blocked_polish_order_is_gauss_seidel(layout):
    """The wide tier's blocked polish (in-block Gram terms folded into the
    later rows as each row is solved) gives pgs_plain's z to float64
    rounding, on contact triples with bounded rows after them (n = 35: the
    last block is short) and on a permutation that
    puts normals after their friction rows, in other blocks and in the
    same one; with a Gram term dropped it does not."""
    contacts, extra, B = 9, 8, 4
    order = None if layout == "triples" else np.random.RandomState(7).permutation(3 * contacts + extra)
    meta = _layout_meta(contacts, extra, order)
    assert lcp_cuda.wide_layout(meta) == (0 if layout == "permuted" else 2)
    n, r = meta.n, 10
    rng = np.random.RandomState(5)
    F = torch.as_tensor(0.5 * rng.randn(n, r, B))
    b = torch.as_tensor(rng.randn(n, B))
    mu = torch.as_tensor(np.where(meta.is_friction[:, None], 0.9, 0.0) * np.ones((1, B)))
    z0 = lcp_cuda.apgd_plain(meta, F, 0.0, b, mu, torch.as_tensor(0.1 * np.abs(rng.randn(n, B))))
    want = lcp_cuda.pgs_plain(meta, F, 0.0, b, mu, z0, sweeps=16)
    got = _blocked_polish(meta, F, b, mu, z0, 16)
    assert float((got - want).abs().max()) <= 1e-12 * (1.0 + float(want.abs().max()))
    assert float((want - z0).abs().max()) > 1e-3  # the polish moved z
    dropped = _blocked_polish(meta, F, b, mu, z0, 16, drop=(1, 0))
    assert float((dropped - want).abs().max()) > 1e-6


def test_wide_layout_codes():
    """The wide tier's layout code: 2 (contact triples: the polish reads a
    friction row's normal from a register) for the assembler's triples,
    with or without rows after them, and for no friction at all; 1
    (grouped: every friction row's normal shares its aligned group of six
    rows) for triples in another order within their group; 0 where a
    triple straddles a group boundary."""
    free = LcpMeta(findex=np.full(7, -1, np.int32), is_friction=np.zeros(7, bool))
    for meta in (_layout_meta(96, 0, None), _layout_meta(5, 7, None), free):
        assert lcp_cuda.wide_layout(meta) == 2
    swapped = _layout_meta(4, 0, np.r_[1, 0, 2, np.arange(3, 12)])  # a normal second
    assert lcp_cuda.wide_layout(swapped) == 1
    shifted = _layout_meta(4, 1, np.r_[12, np.arange(12)])  # one bounded row first
    assert lcp_cuda.wide_layout(shifted) == 0
