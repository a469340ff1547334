"""The APGD seed of the batched boxed LCP: a CUDA kernel for Hopper, and
its plain PyTorch version.

Counterpart of nimblephysics_tpu/batched/lcp_pallas.py. `apgd_seed`
mirrors apgd_seed_tpu there:

  * a tensor on the CPU takes `apgd_plain`, the port of batched/lcp._apgd
    (what the JAX package runs off the TPU);
  * a CUDA tensor launches `csrc/apgd_seed.cu` (which replaces the Pallas
    kernel _apgd_kernel, see the note at the top of that file) on
    detached inputs, then re-attaches one differentiable projected-
    gradient step, as the TPU path ships that step's output. It launches
    or raises; it never falls back to the plain version.

The kernel is compiled with nvcc at first use into csrc/build/ (a shared
library with a plain C interface, loaded with ctypes). Nothing here is
built or imported from a GPU toolchain when the module is imported.
"""

from __future__ import annotations

import ctypes
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
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)


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


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the APGD seed kernel is built with the CUDA "
            "toolkit at first use on a machine with a GPU"
        )
    return path


def _library_path() -> Path:
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"libapgd_seed_{digest}.so"


def build(verbose: bool = False) -> Tuple[Path, float, str]:
    """Compile csrc/apgd_seed.cu unless this source is already built.

    Returns (library path, seconds spent compiling, compiler output).
    With verbose=True ptxas reports registers, shared memory and spills.
    The library is written under a temporary name and renamed, so
    concurrent builders never load a partial file.
    """
    out = _library_path()
    if out.exists() and not verbose:
        return out, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, str(SOURCE)]
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
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.apgd_seed_f32.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i,
                                  ctypes.c_float, p]
    lib.apgd_seed_f32.restype = i
    lib.apgd_seed_smem_bytes.argtypes = [i, i]
    lib.apgd_seed_smem_bytes.restype = ctypes.c_size_t
    lib.apgd_seed_smem_limit.argtypes = [i]
    lib.apgd_seed_smem_limit.restype = i
    lib.apgd_seed_max_rank.argtypes = []
    lib.apgd_seed_max_rank.restype = i
    return lib


@functools.lru_cache(maxsize=16)
def _static_rows(meta: LcpMeta, device: torch.device):
    """Per-row kernel inputs: is_friction, findex (int32), lo, hi (f32).

    hi = +inf is passed as is (IEEE min/max clip against it exactly); the
    Pallas kernel clamps it to 3.4e38 because of its TPU lowering.
    """
    fr = meta.findex >= 0
    fidx = np.maximum(meta.findex, 0)
    if np.any(meta.is_friction[fidx[fr]]):
        raise ValueError("findex of a friction row must name a normal row")
    lo, hi = _const_bounds(meta, torch.float32, device)
    isf = torch.as_tensor(meta.is_friction.astype(np.int32), device=device)
    fidx_t = torch.as_tensor(fidx.astype(np.int32), device=device)
    return isf, fidx_t, lo[:, 0].contiguous(), hi[:, 0].contiguous()


def apgd_cuda(meta: LcpMeta, F, b, mu, z0, cfm: float = 0.0):
    """Launch the kernel: F (n, r, B), b/mu/z0 (n, B), f32, contiguous, on
    one CUDA device -> z (n, B). Counts each launch in apgd_seed.launches.
    """
    n, r, B = F.shape
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
    lib = _library()
    if r > lib.apgd_seed_max_rank():
        raise NotImplementedError(
            f"apgd_cuda: rank {r} above the kernel's {lib.apgd_seed_max_rank()}"
        )
    smem = lib.apgd_seed_smem_bytes(n, r)
    limit = lib.apgd_seed_smem_limit(F.device.index)
    if smem > limit:
        # LCPs of hundreds of rows: a capacity rule for them is ROADMAP
        # queue 2 (K1 capacity), not a silent fall back to the plain seed.
        raise NotImplementedError(
            f"apgd_cuda: n={n}, r={r} needs {smem} bytes of shared memory "
            f"per block, above the card's {limit}"
        )
    isf, fidx, lo, hi = _static_rows(meta, F.device)
    z = torch.empty_like(b)
    err = lib.apgd_seed_f32(
        F.data_ptr(), b.data_ptr(), mu.data_ptr(), z0.data_ptr(), z.data_ptr(),
        isf.data_ptr(), fidx.data_ptr(), lo.data_ptr(), hi.data_ptr(),
        n, r, B, int(meta.iterations), float(cfm),
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


def apgd_seed(meta: LcpMeta, F, b, mu, z0, cfm=0.0):
    """APGD seed of boxed_lcp_b.

    CPU tensors: apgd_plain (gradient-carrying). CUDA tensors: the kernel
    on detached inputs plus `pgd_step` (lcp_pallas.apgd_seed_tpu parity).
    """
    if F.device.type == "cpu":
        return apgd_plain(meta, F, cfm, b, mu, z0)
    if F.device.type != "cuda":
        raise ValueError(f"apgd_seed: no kernel for device {F.device}")
    z_k = apgd_cuda(
        meta, F.detach().contiguous(), b.detach().contiguous(),
        mu.detach().contiguous(), z0.detach().contiguous(), float(cfm),
    )
    return pgd_step(meta, F, cfm, b, mu, z_k)


apgd_seed.launches = 0  # kernel launches since the last reset
