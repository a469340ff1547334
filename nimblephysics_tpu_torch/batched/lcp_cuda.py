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
`seed_plan` is its launch plan (padded rank, worlds per block, shared
memory) against the card's limits, which the library reports.
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


@dataclasses.dataclass(frozen=True)
class SeedPlan:
    """How the kernel runs an LCP of n rows and rank r on a card.

    rank_width: the template width r is padded to, and rows_per_lane the
    rows a lane owns (0: no instantiation holds the LCP);
    worlds_per_block: worlds (warps) per block, halved from
    WORLDS_PER_BLOCK until the block fits; world_stride: floats of one
    world's shared-memory region (odd, so that the polish's lanes, one per
    world, fall on distinct banks); smem_bytes: shared memory per block;
    fits: whether the card (smem_limit bytes a block) takes it, and if
    not, why.
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


@functools.lru_cache(maxsize=64)
def seed_plan(n: int, r: int, smem_limit: int) -> SeedPlan:
    """The launch plan of apgd_cuda for F (n, r, B) on a card that lets a
    block opt into smem_limit bytes of shared memory.

    A world's region holds F as [n][R + 1] (R the padded rank), b, mu, z,
    the polish's 1 / A_ii (n each) and u (R); the block adds the per-row lo, hi,
    is_friction and findex (4 n words).
    """
    width = next((w for w in RANK_WIDTHS if w >= r), 0)
    rows = next((k for k in ROWS_PER_LANE
                 if LANES_PER_WORLD * k >= n and (width, k) in INSTANCES), 0)
    if not (width and rows):
        return SeedPlan(n, r, width, rows, LANES_PER_WORLD, 0, 0, 0, smem_limit,
                        False, f"n={n}, r={r} is beyond the kernel's "
                        f"instantiations (rank <= {RANK_WIDTHS[-1]}, rows <= "
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
        zn = torch.where(isf, y, torch.minimum(torch.maximum(y, lo_c), hi_c))
        bound = mu * torch.clamp(zn[fidx], min=0.0)
        return torch.where(
            isf, torch.minimum(torch.maximum(y, -bound), bound), zn
        )

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
                zi = torch.minimum(torch.maximum(zi, -bound), bound)
            else:
                zi = torch.minimum(torch.maximum(zi, lo_c[i]), hi_c[i])
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
    return lib


@functools.lru_cache(maxsize=8)
def smem_limit(device_index: int) -> int:
    """Shared memory one block may opt into on the card, in bytes."""
    return int(_library().apgd_seed_smem_limit(device_index))


def resident_warps(plan: SeedPlan, polish: bool) -> int:
    """Warps of the kernel resident on one SM at this plan
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor times the block's
    warps)."""
    blocks = _library().apgd_seed_occupancy(
        plan.rank_width, plan.rows_per_lane, int(polish),
        plan.worlds_per_block, plan.smem_bytes)
    if blocks < 0:
        raise RuntimeError("apgd_seed_occupancy failed")
    return blocks * plan.worlds_per_block * plan.lanes_per_world // 32


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
    err = _library().apgd_seed_f32(
        F.data_ptr(), b.data_ptr(), mu.data_ptr(), z0.data_ptr(), z.data_ptr(),
        isf.data_ptr(), fidx.data_ptr(), lo.data_ptr(), hi.data_ptr(),
        n, r, B, int(meta.iterations), int(pgs_sweeps), float(cfm),
        plan.rank_width, plan.rows_per_lane, plan.worlds_per_block,
        plan.world_stride, plan.smem_bytes,
        torch.cuda.current_stream(F.device).cuda_stream,
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
