// APGD seed of the batched boxed LCP, with its optional projected
// Gauss-Seidel polish, one world per thread, for Hopper (sm_90a). Built by
// nimblephysics_tpu_torch/batched/lcp_cuda.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes.
//
// Replaces the Pallas TPU kernel nimblephysics_tpu/batched/lcp_pallas.py
// ::_apgd_kernel (launched by apgd_pallas), both of its forms: K1
// (pgs_sweeps = 0) and K1b (pgs_sweeps > 0, lcp_pallas.py:118-149). Per
// world, with A = F F^T + cfm I and F (n, r):
//   * 6 power iterations v <- A v / |A v| (rsqrt of max(|A v|^2, 1e-24),
//     so a world whose rows are all zero gets v = 0), one Rayleigh
//     quotient, L = max(1.05 ray, max_i A_ii) + 1e-9, step = 1/L;
//   * `iterations` Nesterov steps, beta_k = (k - 1)/(k + 2) for k = 0..,
//     of projected gradient on A z - b: non-friction rows clipped to
//     [lo, hi] (hi = +inf is passed as is), friction rows to
//     +-mu_i max(z[findex_i], 0) with the bounding normal row already
//     projected. findex of a friction row must name a non-friction row.
//   * K1b: then `pgs_sweeps` projected Gauss-Seidel sweeps over the rows
//     in static order (batched/lcp._pgs): with a running u = F^T z,
//     row i takes z_i += (b_i - F_i . u - cfm z_i) / A_ii (0 where
//     A_ii <= 1e-12), clipped to [lo_i, hi_i], or for a friction row to
//     +-mu_i z[findex_i] (no max with 0, as the TPU kernel), then
//     u += F_i^T dz_i. As on the TPU, z stays per row on chip and u runs
//     along in registers; the inverse diagonal takes the z_prev slots the
//     Nesterov loop no longer needs, so the polish needs no more shared
//     memory than K1. Whether there is a polish is a template flag, so
//     K1's instantiation carries none of its code or registers (a
//     runtime branch cost K1 16% of its time).
//
// What bounds it on this card: one operator application is 2 n r FMAs,
// and a world takes 31 of them (6 power iterations, the Rayleigh quotient,
// 24 iterations on the throughput path; 39 under the default config, whose
// 16 sweeps add about 16 more) against one read of F. At n = 60, r = 9,
// B = 4096 that is under 1 GFLOP against ~12.8 MB, a few microseconds
// either way at the card's f32 peak and memory rate. What actually bounds
// this design is latency: one thread per world gives 4096 threads for 132
// SMs, and a Gauss-Seidel sweep is sequential across rows. The design does
// two things about it: a block is one warp of 32 worlds, so the 128
// blocks spread over the SMs, and the block stages its worlds' F, b, mu
// and iterate in shared memory once (as the TPU kernel keeps F in VMEM),
// so every operator application and sweep reads shared memory, laid out
// [row][col][world] so that a warp's 32 loads hit 32 banks. A warp per
// world (rows across lanes) is later work.

#include <cfloat>

#include <cuda_runtime.h>

namespace {

constexpr int kWorldsPerBlock = 32;
constexpr int kMaxRank = 16;

template <int R, bool kPolish>
__global__ void apgd_seed_kernel(const float* __restrict__ F,
                                 const float* __restrict__ b,
                                 const float* __restrict__ mu,
                                 const float* __restrict__ z0,
                                 float* __restrict__ z_out,
                                 const int* __restrict__ is_friction,
                                 const int* __restrict__ findex,
                                 const float* __restrict__ lo,
                                 const float* __restrict__ hi,
                                 int n, int B, int iterations, int pgs_sweeps,
                                 float cfm) {
  extern __shared__ float smem[];
  const int t = threadIdx.x;
  const int w = blockIdx.x * kWorldsPerBlock + t;
  const bool live = w < B;

  // Shared layout, each per-world array strided by kWorldsPerBlock:
  // F (n*R), b (n), mu (n), z (n), z_prev (n), then per-row statics.
  float* sF = smem;
  float* sb = sF + n * R * kWorldsPerBlock;
  float* smu = sb + n * kWorldsPerBlock;
  float* sz = smu + n * kWorldsPerBlock;
  float* szp = sz + n * kWorldsPerBlock;
  float* slo = szp + n * kWorldsPerBlock;
  float* shi = slo + n;
  int* sisf = reinterpret_cast<int*>(shi + n);
  int* sfidx = sisf + n;

  for (int i = t; i < n; i += kWorldsPerBlock) {
    slo[i] = lo[i];
    shi[i] = hi[i];
    sisf[i] = is_friction[i];
    sfidx[i] = findex[i];
  }
  if (live) {
    for (int k = 0; k < n * R; ++k)
      sF[k * kWorldsPerBlock + t] = F[(size_t)k * B + w];
    for (int i = 0; i < n; ++i) {
      sb[i * kWorldsPerBlock + t] = b[(size_t)i * B + w];
      smu[i * kWorldsPerBlock + t] = mu[(size_t)i * B + w];
    }
  }
  __syncthreads();
  if (!live) return;

#define FF(i, j) sF[((i) * R + (j)) * kWorldsPerBlock + t]
#define Z(i) sz[(i) * kWorldsPerBlock + t]
#define ZP(i) szp[(i) * kWorldsPerBlock + t]

  float u[R];

  // Power iteration on A, with v in Z and A v in ZP; diag max on the way.
  float diag_max = -FLT_MAX;
  for (int i = 0; i < n; ++i) {
    Z(i) = 1.0f;
    float d = cfm;
#pragma unroll
    for (int j = 0; j < R; ++j) d += FF(i, j) * FF(i, j);
    diag_max = fmaxf(diag_max, d);
  }
  for (int it = 0; it < 7; ++it) {
#pragma unroll
    for (int j = 0; j < R; ++j) u[j] = 0.0f;
    for (int i = 0; i < n; ++i) {
      const float vi = Z(i);
#pragma unroll
      for (int j = 0; j < R; ++j) u[j] += FF(i, j) * vi;
    }
    float acc = 0.0f;  // |A v|^2 for it < 6, v . A v for the last pass
    for (int i = 0; i < n; ++i) {
      float avi = cfm * Z(i);
#pragma unroll
      for (int j = 0; j < R; ++j) avi += FF(i, j) * u[j];
      if (it < 6) {
        ZP(i) = avi;
        acc += avi * avi;
      } else {
        acc += Z(i) * avi;
      }
    }
    if (it < 6) {
      const float s = rsqrtf(fmaxf(acc, 1e-24f));
      for (int i = 0; i < n; ++i) Z(i) = ZP(i) * s;
    } else {
      diag_max = fmaxf(acc * 1.05f, diag_max) + 1e-9f;  // now L
    }
  }
  const float step = 1.0f / diag_max;

  for (int i = 0; i < n; ++i) {
    const float v = z0[(size_t)i * B + w];
    Z(i) = v;
    ZP(i) = v;
  }
  for (int k = 0; k < iterations; ++k) {
    const float beta = ((float)k - 1.0f) / ((float)k + 2.0f);
#pragma unroll
    for (int j = 0; j < R; ++j) u[j] = 0.0f;
    for (int i = 0; i < n; ++i) {
      const float zi = Z(i);
      const float yi = zi + beta * (zi - ZP(i));
#pragma unroll
      for (int j = 0; j < R; ++j) u[j] += FF(i, j) * yi;
    }
    for (int i = 0; i < n; ++i) {
      const float zi = Z(i);
      const float yi = zi + beta * (zi - ZP(i));
      float g = 0.0f;
#pragma unroll
      for (int j = 0; j < R; ++j) g += FF(i, j) * u[j];
      g = g + cfm * yi - sb[i * kWorldsPerBlock + t];
      float x = yi - step * g;
      if (!sisf[i]) x = fminf(fmaxf(x, slo[i]), shi[i]);
      ZP(i) = zi;
      Z(i) = x;
    }
    for (int i = 0; i < n; ++i) {
      if (sisf[i]) {
        const float bound =
            smu[i * kWorldsPerBlock + t] * fmaxf(Z(sfidx[i]), 0.0f);
        Z(i) = fminf(fmaxf(Z(i), -bound), bound);
      }
    }
  }

  if (kPolish) {
    // K1b. u = F^T z from the Nesterov loop's z; ZP(i) = 1 / A_ii.
#pragma unroll
    for (int j = 0; j < R; ++j) u[j] = 0.0f;
    for (int i = 0; i < n; ++i) {
      const float zi = Z(i);
      float d = 0.0f;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        u[j] += FF(i, j) * zi;
        d += FF(i, j) * FF(i, j);
      }
      d += cfm;
      ZP(i) = d > 1e-12f ? 1.0f / fmaxf(d, 1e-12f) : 0.0f;
    }
    for (int s = 0; s < pgs_sweeps; ++s) {
      for (int i = 0; i < n; ++i) {
        const float zi = Z(i);
        float az = cfm * zi;
#pragma unroll
        for (int j = 0; j < R; ++j) az += FF(i, j) * u[j];
        float x = zi + (sb[i * kWorldsPerBlock + t] - az) * ZP(i);
        if (sisf[i]) {
          const float bound = smu[i * kWorldsPerBlock + t] * Z(sfidx[i]);
          x = fminf(fmaxf(x, -bound), bound);
        } else {
          x = fminf(fmaxf(x, slo[i]), shi[i]);
        }
        const float dz = x - zi;
#pragma unroll
        for (int j = 0; j < R; ++j) u[j] += FF(i, j) * dz;
        Z(i) = x;
      }
    }
  }
  for (int i = 0; i < n; ++i) z_out[(size_t)i * B + w] = Z(i);
#undef FF
#undef Z
#undef ZP
}

template <int R>
cudaError_t launch(const float* F, const float* b, const float* mu,
                   const float* z0, float* z, const int* isf, const int* fidx,
                   const float* lo, const float* hi, int n, int B,
                   int iterations, int pgs_sweeps, float cfm, size_t smem,
                   cudaStream_t stream) {
  auto kernel = pgs_sweeps > 0 ? apgd_seed_kernel<R, true>
                                : apgd_seed_kernel<R, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (B + kWorldsPerBlock - 1) / kWorldsPerBlock;
  kernel<<<blocks, kWorldsPerBlock, smem, stream>>>(
      F, b, mu, z0, z, isf, fidx, lo, hi, n, B, iterations, pgs_sweeps, cfm);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared-memory bytes one block needs; the caller checks it against the
// card's per-block limit before launching.
size_t apgd_seed_smem_bytes(int n, int r) {
  return sizeof(float) * (size_t)n * (r + 4) * kWorldsPerBlock +
         (2 * sizeof(float) + 2 * sizeof(int)) * (size_t)n;
}

int apgd_seed_max_rank() { return kMaxRank; }

// Largest dynamic shared memory one block may opt into on `device`.
int apgd_seed_smem_limit(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return 0;
  return v;
}

// F (n, r, B), b/mu/z0/z (n, B) f32 contiguous on the device; per-row
// is_friction, findex (>= 0), lo, hi of length n; pgs_sweeps = 0 for K1,
// > 0 for K1b's polish. Launches on `stream` and returns
// cudaGetLastError() after the launch (0 = launched).
int apgd_seed_f32(const float* F, const float* b, const float* mu,
                  const float* z0, float* z, const int* is_friction,
                  const int* findex, const float* lo, const float* hi, int n,
                  int r, int B, int iterations, int pgs_sweeps, float cfm,
                  void* stream) {
  if (n <= 0 || B <= 0 || r < 1 || r > kMaxRank || iterations < 0 ||
      pgs_sweeps < 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = apgd_seed_smem_bytes(n, r);
  cudaStream_t s = (cudaStream_t)stream;
#define CASE(R)                                                           \
  case R:                                                                 \
    return (int)launch<R>(F, b, mu, z0, z, is_friction, findex, lo, hi, n, \
                          B, iterations, pgs_sweeps, cfm, smem, s);
  switch (r) {
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
    CASE(9) CASE(10) CASE(11) CASE(12) CASE(13) CASE(14) CASE(15) CASE(16)
  }
#undef CASE
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
