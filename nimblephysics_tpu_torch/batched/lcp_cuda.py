"""The APGD seed of the batched boxed LCP, with its projected Gauss-Seidel
polish: a CUDA kernel for Hopper, and its plain PyTorch versions.

Counterpart of nimblephysics_tpu/batched/lcp_pallas.py. `apgd_seed`
mirrors apgd_seed_tpu there:

  * a tensor on the CPU takes `apgd_plain`, the port of batched/lcp._apgd,
    then, when meta.seed_pgs_sweeps > 0, `pgs_plain`, the port of
    batched/lcp._pgs (what the JAX package runs off the TPU);
  * a CUDA tensor launches `csrc/apgd_seed.cu` (which replaces the Pallas
    kernel _apgd_kernel in both its forms, K1 without the polish and K1b
    with it; see the note at the top of that file) on detached inputs,
    then re-attaches one differentiable projected-gradient step, as the
    TPU path ships that step's output. It launches or raises; it never
    falls back to the plain version.

The kernel is compiled with nvcc at first use into csrc/build/ (a shared
library with a plain C interface, loaded with ctypes). Nothing here is
built or imported from a GPU toolchain when the module is imported.
`seed_plan` is its launch plan against the card's limits, which the
library reports: the narrow tier (a warp per world, rank <= 32, n <= 256)
where it fits, else the wide tier (a CTA, or a cluster of 2 or 4 CTAs,
per world, rank <= 128, n <= 1024, F held in the CTAs' shared memory).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Tuple

import numpy as np
import torch

from nimblephysics_tpu_torch.batched.lcp import (
    _Av,
    _const_bounds,
    _diag_A,
    _rows,
)
from nimblephysics_tpu_torch.constraint.lcp import LcpMeta

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCE = _CSRC / "apgd_seed.cu"
BUILD_DIR = _CSRC / "build"
# --split-compile=0 optimizes the instantiations in parallel on every core
# (7.6 s instead of 18.5 s for the 16 of csrc/apgd_seed.cu on the H100
# machine's 8 cores, the same registers and spills).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "--split-compile=0",
)
# The kernel's instantiations (NT_INSTANCES in csrc/apgd_seed.cu): the
# rank is padded with zero columns to the first width that holds it, and
# the rows each lane owns to 2 (F in registers) where n <= 64 and the width
# is at most 16, else to 8.
RANK_WIDTHS = (8, 12, 16, 24, 32)
ROWS_PER_LANE = (2, 8)
INSTANCES = tuple((w, k) for k in ROWS_PER_LANE for w in RANK_WIDTHS
                  if k == 8 or w <= 16)
LANES_PER_WORLD = 32  # a warp per world in the APGD phases
WORLDS_PER_BLOCK = 8  # eight consecutive worlds: one 32-byte sector a row
# The wide tier (WIDE_INSTANCES in csrc/apgd_seed.cu): a cluster of 1, 2
# or 4 CTAs (WIDE_CLUSTERS) of WIDE_THREADS threads per world, the rank
# padded to the first of WIDE_WIDTHS that holds it, up to WIDE_MAX_ROWS
# rows. Each CTA holds its share of the rows, a multiple of WIDE_BLOCK (the
# polish's blocks: two groups of WIDE_GROUP, the rows a warp takes at a
# time) and at most WIDE_CTA_ROWS (six groups a warp), of F [row][R] in its
# shared memory (wide_smem_bytes).
WIDE_WIDTHS = (32, 64, 128)
WIDE_MAX_ROWS = 1024
WIDE_THREADS = 256
WIDE_WARPS = WIDE_THREADS // 32
WIDE_GROUP = 6
WIDE_BLOCK = 2 * WIDE_GROUP
WIDE_CTA_ROWS = WIDE_WARPS * 6 * WIDE_GROUP
WIDE_CLUSTERS = (1, 2, 4)
# A polish block's Gram terms, F_i . F_m / A_ii for m < i < WIDE_BLOCK (66),
# padded.
WIDE_GRAM_STRIDE = 68


def wide_smem_bytes(width: int, cluster: int, rows: int) -> int:
    """Shared memory of one wide-tier CTA (wide_smem_floats in
    csrc/apgd_seed.cu): F [rows][width]; the Gram terms (N / WIDE_BLOCK
    blocks of WIDE_GRAM_STRIDE, N = cluster rows); the polish's row inputs
    (4 N), z and the friction code (N each); the warps' and the CTA's
    partial sums, 2 (WIDE_WARPS + 1) sets of width + 1."""
    N = cluster * rows
    return 4 * (rows * width + N // WIDE_BLOCK * WIDE_GRAM_STRIDE + 6 * N
                + 2 * (WIDE_WARPS + 1) * (width + 1))


@dataclasses.dataclass(frozen=True)
class SeedPlan:
    """How the kernel runs an LCP of n rows and rank r on a card.

    tier: "narrow" (a warp per world, F in shared memory, several worlds a
    block) or "wide" (a CTA or a cluster of CTAs per world, F in their
    shared memory). rank_width: the template width r is padded to (0: no
    tier holds the LCP); rows_per_lane: the rows a lane owns in the narrow
    tier (0 in the wide one); lanes_per_world: threads per world;
    worlds_per_block: worlds a block holds (narrow: halved from
    WORLDS_PER_BLOCK until the block fits; wide: 1); world_stride: floats
    of one world's shared-memory region (narrow: odd, so that the polish's
    lanes, one per world, fall on distinct banks) or of the F rows a CTA
    holds (wide); smem_bytes: shared memory per block (CTA); fits: whether
    the card (smem_limit bytes a block) takes it, and if not, why;
    cluster: CTAs per world (wide; 1 in the narrow tier); rows_per_cta:
    the rows each of them holds (wide).
    """

    n: int
    r: int
    rank_width: int
    rows_per_lane: int
    lanes_per_world: int
    worlds_per_block: int
    world_stride: int
    smem_bytes: int
    smem_limit: int
    fits: bool
    why: str = ""
    tier: str = "narrow"
    cluster: int = 1
    rows_per_cta: int = 0


def _narrow_plan(n: int, r: int, smem_limit: int) -> SeedPlan:
    """A world's region holds F as [n][R + 1] (R the padded rank), b, mu,
    z, the polish's 1 / A_ii (n each) and u (R); the block adds the per-row
    lo, hi, is_friction and findex (4 n words)."""
    width = next((w for w in RANK_WIDTHS if w >= r), 0)
    rows = next((k for k in ROWS_PER_LANE
                 if LANES_PER_WORLD * k >= n and (width, k) in INSTANCES), 0)
    if not (width and rows):
        return SeedPlan(n, r, width, rows, LANES_PER_WORLD, 0, 0, 0, smem_limit,
                        False, f"n={n}, r={r} is beyond the narrow tier (rank <= "
                        f"{RANK_WIDTHS[-1]}, rows <= "
                        f"{LANES_PER_WORLD * ROWS_PER_LANE[-1]})")
    stride = (n * (width + 5) + width) | 1
    worlds = WORLDS_PER_BLOCK
    while True:
        smem = 4 * (4 * n + worlds * stride)
        if smem <= smem_limit or worlds == 1:
            break
        worlds //= 2
    fits = smem <= smem_limit
    why = "" if fits else (
        f"n={n}, r={r} (width {width}) needs {smem} bytes of shared memory "
        f"for one world, above the card's {smem_limit} per block")
    return SeedPlan(n, r, width, rows, LANES_PER_WORLD, worlds, stride, smem,
                    smem_limit, fits, why)


def _wide_plan(n: int, r: int, smem_limit: int) -> SeedPlan:
    """The smallest cluster (1, 2 or 4 CTAs) whose CTAs each hold their
    share of the rows (rounded up to whole polish blocks, at most
    WIDE_CTA_ROWS) and of F within the card's shared memory per block."""
    width = next((w for w in WIDE_WIDTHS if w >= r), 0)
    if not width or n > WIDE_MAX_ROWS:
        return SeedPlan(n, r, width, 0, WIDE_THREADS, 0, 0, 0, smem_limit, False,
                        f"n={n}, r={r} is beyond the kernel's capacity (rank <= "
                        f"{WIDE_WIDTHS[-1]}, rows <= {WIDE_MAX_ROWS})", "wide")
    for cluster in WIDE_CLUSTERS:
        share = -(-n // cluster)
        rows = WIDE_BLOCK * -(-share // WIDE_BLOCK)
        smem = wide_smem_bytes(width, cluster, rows)
        if rows <= WIDE_CTA_ROWS and smem <= smem_limit:
            return SeedPlan(n, r, width, 0, WIDE_THREADS * cluster, 1, rows * width,
                            smem, smem_limit, True, "", "wide", cluster, rows)
    return SeedPlan(n, r, width, 0, WIDE_THREADS * cluster, 1, rows * width, smem,
                    smem_limit, False,
                    f"n={n}, r={r} (width {width}) needs {smem} bytes of shared "
                    f"memory a CTA in a cluster of {cluster}, above the card's "
                    f"{smem_limit} per block", "wide", cluster, rows)


@functools.lru_cache(maxsize=64)
def seed_plan(n: int, r: int, smem_limit: int) -> SeedPlan:
    """The launch plan of apgd_cuda for F (n, r, B) on a card that lets a
    block opt into smem_limit bytes of shared memory: the narrow tier
    where one of its instantiations holds the LCP and fits, else the wide
    tier (F in the shared memory of a CTA or of a cluster of CTAs), else a
    refusal that says why.
    """
    plan = _narrow_plan(n, r, smem_limit)
    return plan if plan.fits else _wide_plan(n, r, smem_limit)


def _side(a, b, half):
    """d max(a, b) / d a as torch.maximum differentiates it: 1 where a > b,
    1/2 (`half`, a 0-d tensor) at a tie, else 0; a and b not both
    infinite."""
    return torch.heaviside(a - b, half)


class _Clip(torch.autograd.Function):
    """min(max(x, lo), hi) of tensors, x finite, with the gradient
    torch.minimum and torch.maximum give it (ties split in halves), formed
    in the backward pass as products of the incoming gradient with weights
    computed from the saved tensors. A Jacobian's rows run the backward
    vmapped over them (is_grads_batched), and torch.maximum/minimum's own
    backward takes torch.where, which vmap runs row by row; these products
    are batched."""

    @staticmethod
    def forward(ctx, x, lo, hi):
        m = torch.maximum(x, lo)
        ctx.save_for_backward(x, lo, hi, m)
        return torch.minimum(m, hi)

    @staticmethod
    def backward(ctx, g):
        x, lo, hi, m = ctx.saved_tensors
        half = x.new_full((), 0.5)
        gm = g * _side(hi, m, half)
        need = ctx.needs_input_grad
        return (gm * _side(x, lo, half) if need[0] else None,
                gm * _side(lo, x, half) if need[1] else None,
                g * _side(m, hi, half) if need[2] else None)


clip = _Clip.apply  # clip(x, lo, hi) = torch.minimum(torch.maximum(x, lo), hi)


def apgd_plain(meta: LcpMeta, F, cfm, b, mu, z0):
    """Accelerated projected-gradient seed (port of batched/lcp._apgd).

    Six power iterations bound the spectrum of A = F F^T + cfm I, then
    `meta.iterations` Nesterov steps of projected gradient on A z - b.
    F (n, r, B), b/mu/z0 (n, B) -> z (n, B).
    """
    isf, fidx = _rows(meta, F.device)
    v = torch.ones_like(b)
    for _ in range(6):
        v2 = _Av(F, cfm, v)
        n2 = torch.sum(v2 * v2, dim=0, keepdim=True)
        zero = n2 < 1e-24
        v = torch.where(
            zero, torch.zeros_like(v2), v2 / torch.sqrt(torch.where(zero, 1.0, n2))
        )
    ray = torch.sum(v * _Av(F, cfm, v), dim=0)
    L = torch.maximum(ray * 1.05, torch.amax(_diag_A(F, cfm), dim=0)) + 1e-9
    step = (1.0 / L)[None, :]
    lo_c, hi_c = _const_bounds(meta, F.dtype, F.device)

    def proj(y):
        zn = torch.where(isf, y, clip(y, lo_c, hi_c))
        bound = mu * torch.clamp(zn[fidx], min=0.0)
        return torch.where(isf, clip(y, -bound, bound), zn)

    z, z_prev = z0, z0
    for k in range(meta.iterations):
        beta = (k - 1.0) / (k + 2.0)
        y = z + beta * (z - z_prev)
        z, z_prev = proj(y - step * (_Av(F, cfm, y) - b)), z
    return z


def pgs_plain(meta: LcpMeta, F, cfm, b, mu, z0, sweeps=None):
    """Projected Gauss-Seidel sweeps (port of batched/lcp._pgs), the plain
    version of the kernel's polish (K1b).

    `sweeps` sweeps (meta.iterations by default, as the PGS seed runs it)
    over the rows in static order, with a running u = F^T z. Row i sets
    z_i += (b_i - F_i . u - cfm z_i) inv_diag_i with inv_diag_i =
    1/max(A_ii, 1e-12) where A_ii > 1e-12, else 0, then clips it to
    [lo_i, hi_i], or for a friction row to +-mu_i z[findex_i] (no max with
    0: min(max(x, -bound), bound), as jnp.clip gives), and adds
    F_i^T dz_i to u. The JAX package rolls the same loop above 96 rows
    with the same arithmetic. Rows are kept as a list, so the sweeps write
    nothing in place and stay differentiable.
    F (n, r, B), b/mu/z0 (n, B) -> z (n, B).
    """
    fidx = np.maximum(meta.findex, 0)
    diag = _diag_A(F, cfm)
    inv_diag = torch.where(
        diag > 1e-12, 1.0 / torch.clamp(diag, min=1e-12), torch.zeros_like(diag)
    )
    lo_c, hi_c = _const_bounds(meta, F.dtype, F.device)
    Fr = F.unbind(0)  # n x (r, B)
    z = list(z0.unbind(0))
    u = torch.sum(F * z0[:, None, :], dim=0)  # (r, B)
    for _ in range(meta.iterations if sweeps is None else sweeps):
        for i in range(meta.n):
            Az_i = torch.sum(Fr[i] * u, dim=0) + cfm * z[i]
            zi = z[i] + (b[i] - Az_i) * inv_diag[i]
            if meta.is_friction[i]:
                bound = mu[i] * z[fidx[i]]
                zi = clip(zi, -bound, bound)
            else:
                zi = clip(zi, lo_c[i], hi_c[i])
            u = u + Fr[i] * (zi - z[i])
            z[i] = zi
    return torch.stack(z)


def seed_plain(meta: LcpMeta, F, cfm, b, mu, z0):
    """The APGD seed off the card: apgd_plain, then meta.seed_pgs_sweeps
    sweeps of pgs_plain (apgd_seed_tpu's pure_seed, lcp_pallas.py:240-247).
    """
    z = apgd_plain(meta, F, cfm, b, mu, z0)
    if meta.seed_pgs_sweeps:
        z = pgs_plain(meta, F, cfm, b, mu, z, sweeps=meta.seed_pgs_sweeps)
    return z


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the APGD seed kernel is built with the CUDA "
            "toolkit at first use on a machine with a GPU"
        )
    return path


def _library_path(source: Path) -> Path:
    digest = hashlib.sha256(
        source.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{source.stem}_{digest}.so"


def build(verbose: bool = False, source: Path = SOURCE) -> Tuple[Path, float, str]:
    """Compile `source` (csrc/apgd_seed.cu) unless it is already built.

    Returns (library path, seconds spent compiling, compiler output).
    With verbose=True ptxas reports registers, shared memory and spills.
    The library is written under a temporary name and renamed, so
    concurrent builders never load a partial file.
    """
    source = Path(source)
    out = _library_path(source)
    if out.exists() and not verbose:
        return out, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, str(source)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)
    return out, seconds, proc.stdout + proc.stderr


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()[0]))
    p, i, z = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
    lib.apgd_seed_f32.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i,
                                  ctypes.c_float, i, i, i, i, z, p]
    lib.apgd_seed_f32.restype = i
    lib.apgd_seed_smem_limit.argtypes = [i]
    lib.apgd_seed_smem_limit.restype = i
    lib.apgd_seed_occupancy.argtypes = [i, i, i, i, z]
    lib.apgd_seed_occupancy.restype = i
    lib.apgd_wide_f32.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i,
                                  ctypes.c_float, i, i, i, i, z, p]
    lib.apgd_wide_f32.restype = i
    lib.apgd_wide_occupancy.argtypes = [i, i, i, z]
    lib.apgd_wide_occupancy.restype = i
    return lib


@functools.lru_cache(maxsize=8)
def smem_limit(device_index: int) -> int:
    """Shared memory one block may opt into on the card, in bytes."""
    return int(_library().apgd_seed_smem_limit(device_index))


def wide_residency(plan: SeedPlan, polish: bool) -> Tuple[int, int]:
    """(CTAs of the wide tier resident on the whole card at this plan,
    the card's SMs): cudaOccupancyMaxActiveBlocksPerMultiprocessor times
    the SMs, or cudaOccupancyMaxActiveClusters times the cluster."""
    ctas = _library().apgd_wide_occupancy(
        plan.rank_width, int(polish), plan.cluster, plan.smem_bytes)
    if ctas < 0:
        raise RuntimeError("apgd_wide_occupancy failed")
    return ctas, torch.cuda.get_device_properties(
        torch.cuda.current_device()).multi_processor_count


def resident_warps(plan: SeedPlan, polish: bool) -> int:
    """Warps of the kernel resident on one SM at this plan
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor times the block's
    warps; the wide tier's CTAs on the card spread over its SMs)."""
    if plan.tier == "wide":
        ctas, sms = wide_residency(plan, polish)
        return ctas * (WIDE_THREADS // 32) // sms
    else:
        blocks = _library().apgd_seed_occupancy(
            plan.rank_width, plan.rows_per_lane, int(polish),
            plan.worlds_per_block, plan.smem_bytes)
    if blocks < 0:
        raise RuntimeError("apgd_seed_occupancy failed")
    return blocks * plan.worlds_per_block * plan.lanes_per_world // 32


@functools.lru_cache(maxsize=64)
def wide_layout(meta: LcpMeta) -> int:
    """The wide tier's layout code. 2: the friction rows are the
    assembler's contact triples (rows 3 c + 1 and 3 c + 2 bounded by row
    3 c for a prefix of the rows, no friction after it, or no friction at
    all), so the polish bounds a friction row by its normal's new z without
    reading memory. 1: every friction row's normal lies in the row's
    aligned group of WIDE_GROUP rows, so an APGD iteration clips friction
    inside a warp and reads F once. 0: neither."""
    fr = np.flatnonzero(meta.is_friction)
    if fr.size == 0:
        return 2
    normal = np.maximum(meta.findex[fr], 0)
    rows = np.arange(3 * (int(fr.max()) // 3 + 1))
    if np.array_equal(fr, rows[rows % 3 > 0]) and np.array_equal(normal, fr - fr % 3):
        return 2
    return int(np.all(normal // WIDE_GROUP == fr // WIDE_GROUP))


@functools.lru_cache(maxsize=16)
def _static_rows(meta: LcpMeta, device: torch.device):
    """Per-row kernel inputs: is_friction, findex (int32), lo, hi (f32).

    Infinite bounds (hi = +inf of a contact or limit row, lo = -inf and
    hi = +inf of a locked motor or a ball or weld row) are passed as they
    are: the kernel only clips against them with fminf/fmaxf, exact at
    +-inf as torch.minimum/maximum in the plain versions. The Pallas kernel
    clamps them to +-3.4e38 because of its TPU lowering; a finite iterate
    is clipped the same either way.
    """
    fr = meta.findex >= 0
    fidx = np.maximum(meta.findex, 0)
    if np.any(meta.is_friction[fidx[fr]]):
        raise ValueError("findex of a friction row must name a normal row")
    lo, hi = _const_bounds(meta, torch.float32, device)
    isf = torch.as_tensor(meta.is_friction.astype(np.int32), device=device)
    fidx_t = torch.as_tensor(fidx.astype(np.int32), device=device)
    return isf, fidx_t, lo[:, 0].contiguous(), hi[:, 0].contiguous()


def apgd_cuda(meta: LcpMeta, F, b, mu, z0, cfm: float = 0.0,
              pgs_sweeps: int = 0):
    """Launch the kernel: F (n, r, B), b/mu/z0 (n, B), f32, contiguous, on
    one CUDA device -> z (n, B). pgs_sweeps > 0 adds the polish (K1b) in
    the same launch. Counts each launch in apgd_seed.launches.
    """
    n, r, B = F.shape
    if n == 0:
        raise ValueError("apgd_cuda: an LCP with no rows (the engine solves none)")
    for name, x, shape in (("F", F, (n, r, B)), ("b", b, (n, B)),
                           ("mu", mu, (n, B)), ("z0", z0, (n, B))):
        if not x.is_cuda or x.device != F.device:
            raise ValueError(f"apgd_cuda: {name} must lie on {F.device}")
        if x.dtype != torch.float32:
            raise TypeError(f"apgd_cuda: {name} is {x.dtype}; the kernel takes float32")
        if tuple(x.shape) != shape:
            raise ValueError(f"apgd_cuda: {name} has shape {tuple(x.shape)}, expected {shape}")
        if not x.is_contiguous():
            raise ValueError(f"apgd_cuda: {name} must be contiguous")
    if n != meta.n:
        raise ValueError(f"apgd_cuda: F has {n} rows, the plan {meta.n}")
    plan = seed_plan(n, r, smem_limit(F.device.index))
    if not plan.fits:
        # Above the plan's capacity it raises; it never falls back to the
        # plain seed.
        raise NotImplementedError(f"apgd_cuda: {plan.why}")
    isf, fidx, lo, hi = _static_rows(meta, F.device)
    z = torch.empty_like(b)
    stream = torch.cuda.current_stream(F.device).cuda_stream
    if plan.tier == "wide":
        err = _library().apgd_wide_f32(
            F.data_ptr(), b.data_ptr(), mu.data_ptr(), z0.data_ptr(), z.data_ptr(),
            isf.data_ptr(), fidx.data_ptr(), lo.data_ptr(), hi.data_ptr(),
            n, r, B, int(meta.iterations), int(pgs_sweeps), float(cfm),
            plan.rank_width, plan.cluster, plan.rows_per_cta,
            wide_layout(meta), plan.smem_bytes, stream,
        )
        if err != 0:
            raise RuntimeError(f"apgd_seed wide kernel launch failed: CUDA error {err}")
        apgd_seed.launches += 1
        return z
    err = _library().apgd_seed_f32(
        F.data_ptr(), b.data_ptr(), mu.data_ptr(), z0.data_ptr(), z.data_ptr(),
        isf.data_ptr(), fidx.data_ptr(), lo.data_ptr(), hi.data_ptr(),
        n, r, B, int(meta.iterations), int(pgs_sweeps), float(cfm),
        plan.rank_width, plan.rows_per_lane, plan.worlds_per_block,
        plan.world_stride, plan.smem_bytes, stream,
    )
    if err != 0:
        raise RuntimeError(f"apgd_seed kernel launch failed: CUDA error {err}")
    apgd_seed.launches += 1
    return z


def pgd_step(meta: LcpMeta, F, cfm, b, mu, z):
    """One differentiable projected-gradient step from z with step
    1/(4 max_i A_ii): the step apgd_seed_tpu re-attaches to the kernel's
    output (lcp_pallas.py:266-274)."""
    isf, fidx = _rows(meta, F.device)
    lo_c, hi_c = _const_bounds(meta, F.dtype, F.device)
    step = 1.0 / (4.0 * torch.amax(_diag_A(F, cfm), dim=0) + 1e-9)
    y = z - step[None, :] * (_Av(F, cfm, z) - b)
    zn = torch.where(isf, y, torch.minimum(torch.maximum(y, lo_c), hi_c))
    bound = mu * torch.clamp(zn[fidx], min=0.0)
    return torch.where(isf, torch.minimum(torch.maximum(y, -bound), bound), zn)


def seed_kernel(meta: LcpMeta, F, b, mu, z0, cfm=0.0):
    """The kernel's output for apgd_seed's inputs: one launch on detached
    float32 copies, with meta.seed_pgs_sweeps sweeps of polish (K1b when
    that is > 0), as apgd_pallas passes them into the Pallas kernel."""
    return apgd_cuda(
        meta, F.detach().contiguous(), b.detach().contiguous(),
        mu.detach().contiguous(), z0.detach().contiguous(), float(cfm),
        pgs_sweeps=int(meta.seed_pgs_sweeps),
    )


def apgd_seed(meta: LcpMeta, F, b, mu, z0, cfm=0.0, z_kernel=None):
    """APGD seed of boxed_lcp_b.

    CPU tensors: seed_plain (gradient-carrying). CUDA tensors: the kernel
    on detached inputs plus `pgd_step` (lcp_pallas.apgd_seed_tpu parity).
    z_kernel, the kernel's output on these inputs from an earlier
    seed_kernel call, re-attaches the step to it without a launch (what a
    checkpoint's recompute needs, as apgd_seed_tpu name-saves it).
    """
    if F.device.type == "cpu":
        return seed_plain(meta, F, cfm, b, mu, z0)
    if F.device.type != "cuda":
        raise ValueError(f"apgd_seed: no kernel for device {F.device}")
    if z_kernel is None:
        z_kernel = seed_kernel(meta, F, b, mu, z0, cfm)
    return pgd_step(meta, F, cfm, b, mu, z_kernel)


apgd_seed.launches = 0  # kernel launches since the last reset
