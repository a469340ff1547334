// APGD seed of the batched boxed LCP, with its optional projected
// Gauss-Seidel polish, for Hopper (sm_90a): a warp per world for the
// power and Nesterov iterations, a lane per world for the polish. Built by
// nimblephysics_tpu_torch/batched/lcp_cuda.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC --split-compile=0
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
//     u += F_i^T dz_i.
//
// What bounds it on this card: one operator application is 2 n r FMAs,
// and a world takes 31 of them on the throughput path (6 power
// iterations, the Rayleigh quotient, 24 iterations) against one read of
// F; at n = 60, r = 9, B = 4096 that is a few microseconds either way at
// the card's f32 peak and memory rate. What bounds a kernel of this shape
// is latency and the SM's shared-memory/shuffle pipe, which issues one warp
// instruction a cycle: one thread per world leaves one warp on each SM,
// whose every shared-memory load and FMA chain stalls it, and a warp per
// world that reads F and z from shared memory in every iteration spends
// the pipe on them. The polish adds 16 n dependent row updates per world.
// This design:
//   * a world is a warp: lane l owns rows l, l + 32, ... (up to ROWS of
//     them) and keeps their F rows (where ROWS * R <= 32), z, z_prev, b,
//     mu and bounds in registers. u = F^T y is formed as per-lane partial
//     sums, then a butterfly reduce-scatter that halves the values each
//     lane holds at every level and an all-gather (28 shuffles at width
//     12 instead of 60); F u is lane-local; |A v|^2, the Rayleigh quotient
//     and max_i A_ii take one reduce each; a friction row reads its
//     normal row's projected z through shared memory. A block holds eight
//     worlds (eight warps);
//   * the block stages its worlds' F, b, mu and z0 from the public
//     (n, r, B) layout cooperatively, eight consecutive worlds per 32-byte
//     sector, into shared memory laid out per world as [row][R + 1]: the
//     odd row stride puts 32 lanes on 32 rows in 32 banks, and the odd
//     world stride puts the polish's eight lanes (one per world) on eight
//     banks. z is written back the same way;
//   * the rank is padded with zero columns to a few template widths
//     (8, 12, 16, 24, 32; exact, since a zero column adds exact zeros to
//     u and to F u), and the rows per lane to 2 (n <= 64, r <= 16) or 8
//     (n <= 256). The polish is a template flag, so K1 carries none of its
//     registers;
//   * the polish is sequential across rows, so a warp on one world would
//     repeat one lane's work 32 times (that variant ran K1b 3x slower on
//     an H100); instead warp 0 of the block runs it with a lane per world,
//     u in registers, everything row i + 1 needs but z fetched while row i
//     is solved, the bound chosen without a branch, and the row's dot
//     product in four partial sums, so that the dependent chain per row is
//     short.
// How many worlds a block holds and its shared memory are chosen by the
// caller (lcp_cuda.seed_plan), which checks them against the card's
// limits that this file reports.

#include <cfloat>

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;  // lanes per world in the APGD phases: a warp
constexpr int kMaxWorldsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

// Values each lane holds at the reduce-scatter's start: R rounded up to a
// power of 2.
template <int R>
constexpr int kPow2 = R <= 8 ? 8 : R <= 16 ? 16 : 32;

// Reduce-scatter over the warp: at offset OFF the C values a lane holds
// halve, the lane keeping the upper half where its OFF bit is set; once
// one is left it is summed over the remaining offsets.
template <int C, int OFF, int P>
__device__ __forceinline__ void halve(float (&v)[P], int lane) {
  if constexpr (OFF > 0) {
    if constexpr (C == 1) {
      v[0] += __shfl_xor_sync(kFull, v[0], OFF);
      halve<1, OFF / 2>(v, lane);
    } else {
      constexpr int H = C / 2;
      const bool up = lane & OFF;
#pragma unroll
      for (int m = 0; m < H; ++m) {
        const float send = up ? v[m] : v[m + H];
        const float keep = up ? v[m + H] : v[m];
        v[m] = keep + __shfl_xor_sync(kFull, send, OFF);
      }
      halve<H, OFF / 2>(v, lane);
    }
  }
}

// The lane that holds column j's sum after halve<P, 16>.
__host__ __device__ constexpr int source_lane(int j, int P) {
  int lane = 0;
  for (int off = kLanes / 2, c = P; off > 0 && c > 1; off >>= 1, c /= 2) {
    if (j >= c / 2) {
      lane += off;
      j -= c / 2;
    }
  }
  return lane;
}

// u <- the sum of u over the warp's lanes, in every lane.
template <int R>
__device__ __forceinline__ void warp_allreduce(float (&u)[R], int lane) {
  constexpr int P = kPow2<R>;
  float v[P];
#pragma unroll
  for (int j = 0; j < P; ++j) v[j] = j < R ? u[j] : 0.0f;
  halve<P, kLanes / 2>(v, lane);
#pragma unroll
  for (int j = 0; j < R; ++j) u[j] = __shfl_sync(kFull, v[0], source_lane(j, P));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(kFull, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

// What one Gauss-Seidel row update reads besides z: F_i, b_i, 1 / A_ii,
// mu_i and the row's statics.
template <int R>
struct PolishRow {
  float f[R];
  float b, inv, mu, lo, hi;
  int fr, fi;
};

template <int R>
__device__ __forceinline__ void load_polish_row(
    PolishRow<R>& row, int i, const float* __restrict__ sF,
    const float* __restrict__ sb, const float* __restrict__ sinv,
    const float* __restrict__ smu, const float* __restrict__ slo,
    const float* __restrict__ shi, const int* __restrict__ sisf,
    const int* __restrict__ sfidx) {
#pragma unroll
  for (int j = 0; j < R; ++j) row.f[j] = sF[i * (R + 1) + j];
  row.b = sb[i];
  row.inv = sinv[i];
  row.mu = smu[i];
  row.lo = slo[i];
  row.hi = shi[i];
  row.fr = sisf[i];
  row.fi = sfidx[i];
}

// One Gauss-Seidel row update of one world (one lane).
template <int R>
__device__ __forceinline__ void pgs_row(const PolishRow<R>& row, float (&u)[R],
                                        int i, float* sz, float cfm) {
  const float zi = sz[i];
  const float zf = sz[row.fi];
  float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < R; ++j) a[j & 3] += row.f[j] * u[j];
  const float az = ((a[0] + a[1]) + (a[2] + a[3])) + cfm * zi;
  const float bound = row.mu * zf;
  const float lo = row.fr ? -bound : row.lo;
  const float hi = row.fr ? bound : row.hi;
  const float x = fminf(fmaxf(zi + (row.b - az) * row.inv, lo), hi);
  const float dz = x - zi;
#pragma unroll
  for (int j = 0; j < R; ++j) u[j] += row.f[j] * dz;
  sz[i] = x;
}

// Shared memory: per-row statics lo, hi, is_friction, findex (4 n words),
// then one region of `ws` floats per world: F [n][R + 1], b, mu, z and
// the polish's 1 / A_ii (n each), u (R). blockDim.x = 32 W for W worlds, W a power of 2;
// n <= 32 ROWS.
template <int R, int ROWS, bool kPolish>
__global__ void __launch_bounds__(kLanes * kMaxWorldsPerBlock)
    apgd_seed_kernel(const float* __restrict__ F, const float* __restrict__ b,
                     const float* __restrict__ mu,
                     const float* __restrict__ z0, float* __restrict__ z_out,
                     const int* __restrict__ is_friction,
                     const int* __restrict__ findex,
                     const float* __restrict__ lo,
                     const float* __restrict__ hi, int n, int r, int B,
                     int iterations, int pgs_sweeps, float cfm, int ws) {
  constexpr int S = R + 1;  // odd row stride
  constexpr bool kFInRegs = ROWS * R <= 32;
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int lane = tid & (kLanes - 1);
  const int W = blockDim.x / kLanes;
  const int wmask = W - 1;
  const int wshift = __ffs(W) - 1;
  const int w0 = blockIdx.x * W;
  const int live = min(W, B - w0);  // worlds of this block inside the batch

  float* slo = smem;
  float* shi = slo + n;
  int* sisf = reinterpret_cast<int*>(shi + n);
  int* sfidx = sisf + n;
  float* const worlds = smem + 4 * n;

  for (int i = tid; i < n; i += blockDim.x) {
    slo[i] = lo[i];
    shi[i] = hi[i];
    sisf[i] = is_friction[i];
    sfidx[i] = findex[i];
  }
  // F[i, j, w0 + w] to world w's [i][j], eight consecutive worlds per
  // sector; columns r..R-1 are the zero padding.
#pragma unroll 4
  for (int idx = tid; idx < n * R * W; idx += blockDim.x) {
    const int w = idx & wmask;
    const int k = idx >> wshift;
    const int i = k / R;
    const int j = k - i * R;
    float v = 0.0f;
    if (j < r && w < live) v = F[(size_t)(i * r + j) * B + w0 + w];
    worlds[w * ws + i * S + j] = v;
  }
#pragma unroll 2
  for (int idx = tid; idx < n * W; idx += blockDim.x) {
    const int w = idx & wmask;
    const int i = idx >> wshift;
    float* const rows = worlds + w * ws + n * S;
    const size_t g = (size_t)i * B + w0 + w;
    const bool in = w < live;
    rows[i] = in ? b[g] : 0.0f;
    rows[n + i] = in ? mu[g] : 0.0f;
    rows[2 * n + i] = in ? z0[g] : 0.0f;
  }
  __syncthreads();

  const int wl = tid >> 5;  // this warp's world in the block
  if (wl < live) {
    const float* const sF = worlds + wl * ws;
    float* const sz = worlds + wl * ws + n * (S + 2);

    // This lane's rows lane + 32 k, k < ROWS, in registers.
    bool in[ROWS], fr[ROWS];
    int fi[ROWS];
    float rb[ROWS], rmu[ROWS], rlo[ROWS], rhi[ROWS], z[ROWS], zp[ROWS];
    float f[kFInRegs ? ROWS : 1][R];
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
      const int i = lane + kLanes * k;
      in[k] = i < n;
      const int s = in[k] ? i : 0;
      fr[k] = in[k] && sisf[s];
      fi[k] = sfidx[s];
      rb[k] = in[k] ? sF[n * S + s] : 0.0f;
      rmu[k] = sF[n * S + n + s];
      rlo[k] = slo[s];
      rhi[k] = shi[s];
      z[k] = in[k] ? sz[s] : 0.0f;
      if constexpr (kFInRegs) {
#pragma unroll
        for (int j = 0; j < R; ++j) f[k][j] = in[k] ? sF[s * S + j] : 0.0f;
      }
    }
    // F[lane + 32 k][j], from registers or shared memory; only read for
    // rows inside the LCP.
    auto Fk = [&](int k, int j) -> float {
      if constexpr (kFInRegs)
        return f[k][j];
      else
        return sF[(lane + kLanes * k) * S + j];
    };
    float u[R];

    // Power iteration on A, v in zp; max_i A_ii on the way.
    float diag_max = -FLT_MAX;
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
      zp[k] = in[k] ? 1.0f : 0.0f;
      if (in[k]) {
        float d = 0.0f;
#pragma unroll
        for (int j = 0; j < R; ++j) d += Fk(k, j) * Fk(k, j);
        diag_max = fmaxf(diag_max, d + cfm);
      }
    }
    diag_max = warp_max(diag_max);
    for (int it = 0; it < 7; ++it) {
#pragma unroll
      for (int j = 0; j < R; ++j) u[j] = 0.0f;
#pragma unroll
      for (int k = 0; k < ROWS; ++k) {
        if (in[k]) {
#pragma unroll
          for (int j = 0; j < R; ++j) u[j] += Fk(k, j) * zp[k];
        }
      }
      warp_allreduce(u, lane);
      float acc = 0.0f;  // |A v|^2 for it < 6, v . A v for the last pass
#pragma unroll
      for (int k = 0; k < ROWS; ++k) {
        if (in[k]) {
          float avk = 0.0f;
#pragma unroll
          for (int j = 0; j < R; ++j) avk += Fk(k, j) * u[j];
          avk += cfm * zp[k];
          if (it < 6) {
            acc += avk * avk;
            zp[k] = avk;
          } else {
            acc += zp[k] * avk;
          }
        }
      }
      acc = warp_sum(acc);
      if (it < 6) {
        const float s = rsqrtf(fmaxf(acc, 1e-24f));
#pragma unroll
        for (int k = 0; k < ROWS; ++k) zp[k] *= s;
      } else {
        diag_max = fmaxf(acc * 1.05f, diag_max) + 1e-9f;  // now L
      }
    }
    const float step = 1.0f / diag_max;

#pragma unroll
    for (int k = 0; k < ROWS; ++k) zp[k] = z[k];
    for (int it = 0; it < iterations; ++it) {
      const float beta = ((float)it - 1.0f) / ((float)it + 2.0f);
      float y[ROWS];
#pragma unroll
      for (int j = 0; j < R; ++j) u[j] = 0.0f;
#pragma unroll
      for (int k = 0; k < ROWS; ++k) {
        y[k] = z[k] + beta * (z[k] - zp[k]);
        if (in[k]) {
#pragma unroll
          for (int j = 0; j < R; ++j) u[j] += Fk(k, j) * y[k];
        }
      }
      warp_allreduce(u, lane);
#pragma unroll
      for (int k = 0; k < ROWS; ++k) {
        zp[k] = z[k];
        if (in[k]) {
          float g = 0.0f;
#pragma unroll
          for (int j = 0; j < R; ++j) g += Fk(k, j) * u[j];
          g = g + cfm * y[k] - rb[k];
          const float x = y[k] - step * g;
          z[k] = fr[k] ? x : fminf(fmaxf(x, rlo[k]), rhi[k]);
          sz[lane + kLanes * k] = z[k];
        }
      }
      __syncwarp();  // friction rows read other lanes' projected normals
#pragma unroll
      for (int k = 0; k < ROWS; ++k) {
        if (fr[k]) {
          const float bound = rmu[k] * fmaxf(sz[fi[k]], 0.0f);
          z[k] = fminf(fmaxf(z[k], -bound), bound);
        }
      }
      __syncwarp();
    }
#pragma unroll
    for (int k = 0; k < ROWS; ++k)
      if (in[k]) sz[lane + kLanes * k] = z[k];

    if constexpr (kPolish) {
      // u = F^T z for the polish, and its 1 / A_ii after z.
      float* const sinv = sz + n;
#pragma unroll
      for (int j = 0; j < R; ++j) u[j] = 0.0f;
#pragma unroll
      for (int k = 0; k < ROWS; ++k) {
        if (in[k]) {
          float d = 0.0f;
#pragma unroll
          for (int j = 0; j < R; ++j) {
            u[j] += Fk(k, j) * z[k];
            d += Fk(k, j) * Fk(k, j);
          }
          d += cfm;
          sinv[lane + kLanes * k] = d > 1e-12f ? 1.0f / fmaxf(d, 1e-12f) : 0.0f;
        }
      }
      warp_allreduce(u, lane);
      if (lane == 0) {
#pragma unroll
        for (int j = 0; j < R; ++j) sinv[n + j] = u[j];
      }
    }
  }

  if constexpr (kPolish) {
    __syncthreads();
    if (tid < live) {  // warp 0, lane = world
      const float* const sF = worlds + tid * ws;
      const float* const sb = sF + n * S;
      const float* const smu = sb + n;
      float* const sz = worlds + tid * ws + n * (S + 2);
      const float* const sinv = sz + n;
      float u[R];
#pragma unroll
      for (int j = 0; j < R; ++j) u[j] = sinv[n + j];
      PolishRow<R> ra, rb;
      load_polish_row(ra, 0, sF, sb, sinv, smu, slo, shi, sisf, sfidx);
      const int total = pgs_sweeps * n;
      int i = 0;
      for (int t = 0; t < total; t += 2) {
        const int i1 = i + 1 == n ? 0 : i + 1;
        load_polish_row(rb, i1, sF, sb, sinv, smu, slo, shi, sisf, sfidx);
        pgs_row(ra, u, i, sz, cfm);
        if (t + 1 == total) break;
        const int i2 = i1 + 1 == n ? 0 : i1 + 1;
        load_polish_row(ra, i2, sF, sb, sinv, smu, slo, shi, sisf, sfidx);
        pgs_row(rb, u, i1, sz, cfm);
        i = i2;
      }
    }
  }

  __syncthreads();
#pragma unroll 2
  for (int idx = tid; idx < n * W; idx += blockDim.x) {
    const int w = idx & wmask;
    const int i = idx >> wshift;
    if (w < live) z_out[(size_t)i * B + w0 + w] = worlds[w * ws + n * (S + 2) + i];
  }
}

// ---------------------------------------------------------------------------
// The wide tier: LCPs past the instantiations above (rank > 32 or n > 256),
// up to n = 1024 rows and rank 128, such as a 10-box stack's capped LCP
// (n = 288, r = 60) or a 20-box stack's (n = 576, r = 120). A world's F
// no longer fits a warp's registers, and the 20-box one (276 KB) not even
// a block's shared memory, so a world is a block of kWideThreads threads:
//   * the block stages its world's F from the public (n, r, B) layout as
//     [row][R] (R = r padded with zero columns to 32, 64 or 128) into its
//     own region of a global workspace that the caller allocates; every
//     later read of F is coalesced and hits L2 while the SM works on that
//     world;
//   * u = F^T y: thread t sums column t mod R over the rows t / R,
//     t / R + 256 / R, ..., and the 256 / R partial columns are added
//     through shared memory;
//   * F u: a warp takes eight rows at a time, each lane the columns
//     lane + 32 k, and one reduce-scatter (halve<8, 16>, 9 shuffles for
//     eight rows) leaves row m's sum in lanes 4 m .. 4 m + 3, lane 4 m
//     updates the row; the friction rows are clipped after every row's
//     normal is projected (one barrier);
//   * the polish is sequential across rows, so warp 0 runs it: u (R) is
//     spread over the lanes, row i + 1's F and statics are fetched while
//     row i is reduced, and each row costs one 5-level warp sum.
// The arithmetic is the narrow tier's (the header above); only the order
// of the sums differs.

constexpr int kWideThreads = 256;
constexpr int kWideWarps = kWideThreads / kLanes;
// Floats of shared memory besides F: lo, hi, is_friction, findex, b, mu,
// z, z_prev, y and the inverse diagonal (n each), the partial columns
// (kWideThreads) and the block reductions (32).
constexpr int kWideVectors = 10;
constexpr int kWideExtra = kWideThreads + 32;

// Block-wide sum or max of x, the same value in every thread (a fixed
// order over the warps).
template <bool kMax>
__device__ __forceinline__ float block_reduce(float x, float* red) {
  x = kMax ? warp_max(x) : warp_sum(x);
  __syncthreads();  // red is free: every thread has read the last result
  if ((threadIdx.x & (kLanes - 1)) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float s = red[0];
#pragma unroll
  for (int k = 1; k < kWideWarps; ++k) s = kMax ? fmaxf(s, red[k]) : s + red[k];
  return s;
}

// u = F^T y over the block: partial columns into part (kWideThreads
// floats), then each lane of every warp gathers u[lane + 32 k].
template <int R>
__device__ __forceinline__ void wide_FTy(const float* Fw, const float* sy,
                                         float* part, int n, float (&u)[R / 32]) {
  constexpr int G = kWideThreads / R;
  const int tid = threadIdx.x;
  const int j = tid & (R - 1);
  const int g = tid / R;
  float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  int i = g;
#pragma unroll 1
  for (; i + 3 * G < n; i += 4 * G) {
#pragma unroll
    for (int m = 0; m < 4; ++m) a[m] += Fw[(size_t)(i + m * G) * R + j] * sy[i + m * G];
  }
  for (; i < n; i += G) a[0] += Fw[(size_t)i * R + j] * sy[i];
  part[tid] = (a[0] + a[1]) + (a[2] + a[3]);
  __syncthreads();
  const int lane = tid & (kLanes - 1);
#pragma unroll
  for (int k = 0; k < R / 32; ++k) {
    float s = 0.0f;
#pragma unroll
    for (int gg = 0; gg < G; ++gg) s += part[gg * R + 32 * k + lane];
    u[k] = s;
  }
}

// For every row i: row(i, F_i . u) in one lane, eight rows a warp at a
// time. With kSquares, F_i . F_i instead.
template <int R, bool kSquares, typename Row>
__device__ __forceinline__ void wide_rows(const float* Fw, int n,
                                          const float (&u)[R / 32], Row row) {
  constexpr int NJ = R / 32;
  const int lane = threadIdx.x & (kLanes - 1);
  const int warp = threadIdx.x >> 5;
#pragma unroll 1
  for (int i0 = 8 * warp; i0 < n; i0 += 8 * kWideWarps) {
    float p[8];
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      p[m] = 0.0f;
      if (i0 + m < n) {
#pragma unroll
        for (int k = 0; k < NJ; ++k) {
          const float f = Fw[(size_t)(i0 + m) * R + 32 * k + lane];
          p[m] += f * (kSquares ? f : u[k]);
        }
      }
    }
    halve<8, kLanes / 2>(p, lane);
    const int i = i0 + ((lane >> 2) & 7);
    if ((lane & 3) == 0 && i < n) row(i, p[0]);
  }
}

// What one polish row reads besides z.
template <int NJ>
struct WideRow {
  float f[NJ];
  float b, inv, mu, lo, hi;
  int fr, fi;
};

template <int R>
__device__ __forceinline__ void load_wide_row(
    WideRow<R / 32>& row, int i, int lane, const float* Fw, const float* sb,
    const float* sinv, const float* smu, const float* slo, const float* shi,
    const int* sisf, const int* sfidx) {
#pragma unroll
  for (int k = 0; k < R / 32; ++k) row.f[k] = Fw[(size_t)i * R + 32 * k + lane];
  row.b = sb[i];
  row.inv = sinv[i];
  row.mu = smu[i];
  row.lo = slo[i];
  row.hi = shi[i];
  row.fr = sisf[i];
  row.fi = sfidx[i];
}

// One block per world, kWideThreads threads. Shared memory: lo, hi,
// is_friction, findex, b, mu, z, z_prev, y, the diagonal / its inverse
// (n each), the partial columns and the reductions (kWideExtra). World
// w's F is work[w n R ...].
template <int R, bool kPolish>
__global__ void __launch_bounds__(kWideThreads)
    apgd_wide_kernel(const float* __restrict__ F, const float* __restrict__ b,
                     const float* __restrict__ mu,
                     const float* __restrict__ z0, float* __restrict__ z_out,
                     const int* __restrict__ is_friction,
                     const int* __restrict__ findex,
                     const float* __restrict__ lo,
                     const float* __restrict__ hi, int n, int r, int B,
                     int iterations, int pgs_sweeps, float cfm, float* work) {
  constexpr int NJ = R / 32;
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int lane = tid & (kLanes - 1);
  const int w = blockIdx.x;

  float* const slo = smem;
  float* const shi = slo + n;
  int* const sisf = reinterpret_cast<int*>(shi + n);
  int* const sfidx = sisf + n;
  float* const sb = smem + 4 * n;
  float* const smu = sb + n;
  float* const sz = smu + n;
  float* const szp = sz + n;
  float* const sy = szp + n;
  float* const sinv = sy + n;
  float* const part = smem + kWideVectors * n;
  float* const red = part + kWideThreads;
  float* const Fw = work + (size_t)w * n * R;

  for (int i = tid; i < n; i += kWideThreads) {
    const size_t gi = (size_t)i * B + w;
    slo[i] = lo[i];
    shi[i] = hi[i];
    sisf[i] = is_friction[i];
    sfidx[i] = findex[i];
    sb[i] = b[gi];
    smu[i] = mu[gi];
    sz[i] = z0[gi];
    szp[i] = z0[gi];
    sy[i] = 1.0f;  // the power iteration's start
  }
#pragma unroll 4
  for (int idx = tid; idx < n * R; idx += kWideThreads) {
    const int i = idx / R;
    const int j = idx & (R - 1);
    Fw[idx] = j < r ? F[(size_t)(i * r + j) * B + w] : 0.0f;
  }
  __syncthreads();

  float u[NJ];
  // A_ii (kept in sinv for the polish) and its largest value.
  float dmax = -FLT_MAX;
  wide_rows<R, true>(Fw, n, u, [&](int i, float d) {
    sinv[i] = d + cfm;
    dmax = fmaxf(dmax, d + cfm);
  });
  dmax = block_reduce<true>(dmax, red);

  // Power iteration on A with v in sy, then the Rayleigh quotient.
  float L = 0.0f;
  for (int it = 0; it < 7; ++it) {
    wide_FTy<R>(Fw, sy, part, n, u);
    float acc = 0.0f;
    wide_rows<R, false>(Fw, n, u, [&](int i, float fu) {
      const float av = fu + cfm * sy[i];
      if (it < 6) {
        acc += av * av;
        sy[i] = av;
      } else {
        acc += sy[i] * av;
      }
    });
    acc = block_reduce<false>(acc, red);
    if (it < 6) {
      const float s = rsqrtf(fmaxf(acc, 1e-24f));
      for (int i = tid; i < n; i += kWideThreads) sy[i] *= s;
      __syncthreads();
    } else {
      L = fmaxf(acc * 1.05f, dmax) + 1e-9f;
    }
  }
  const float step = 1.0f / L;

  // Nesterov projected-gradient steps on z (sz), z_prev in szp.
  for (int it = 0; it < iterations; ++it) {
    const float beta = ((float)it - 1.0f) / ((float)it + 2.0f);
    for (int i = tid; i < n; i += kWideThreads) sy[i] = sz[i] + beta * (sz[i] - szp[i]);
    __syncthreads();
    wide_FTy<R>(Fw, sy, part, n, u);
    wide_rows<R, false>(Fw, n, u, [&](int i, float fu) {
      const float x = sy[i] - step * (fu + cfm * sy[i] - sb[i]);
      szp[i] = sz[i];
      sz[i] = sisf[i] ? x : fminf(fmaxf(x, slo[i]), shi[i]);
    });
    __syncthreads();
    for (int i = tid; i < n; i += kWideThreads) {
      if (sisf[i]) {
        const float bound = smu[i] * fmaxf(sz[sfidx[i]], 0.0f);
        sz[i] = fminf(fmaxf(sz[i], -bound), bound);
      }
    }
    __syncthreads();
  }

  if constexpr (kPolish) {
    for (int i = tid; i < n; i += kWideThreads) {
      const float d = sinv[i];
      sinv[i] = d > 1e-12f ? 1.0f / fmaxf(d, 1e-12f) : 0.0f;
    }
    wide_FTy<R>(Fw, sz, part, n, u);  // its first barrier orders sinv too
    if (tid < kLanes) {
      WideRow<NJ> ra, rb;
      load_wide_row<R>(ra, 0, lane, Fw, sb, sinv, smu, slo, shi, sisf, sfidx);
      const int total = pgs_sweeps * n;
      int i = 0;
      for (int t = 0; t < total; ++t) {
        const int i1 = i + 1 == n ? 0 : i + 1;
        if (t + 1 < total)
          load_wide_row<R>(rb, i1, lane, Fw, sb, sinv, smu, slo, shi, sisf, sfidx);
        float p = 0.0f;
#pragma unroll
        for (int k = 0; k < NJ; ++k) p += ra.f[k] * u[k];
        p = warp_sum(p);
        const float zi = sz[i];
        const float bound = ra.mu * sz[ra.fi];
        const float rlo = ra.fr ? -bound : ra.lo;
        const float rhi = ra.fr ? bound : ra.hi;
        const float x = fminf(fmaxf(zi + (ra.b - (p + cfm * zi)) * ra.inv, rlo), rhi);
        const float dz = x - zi;
#pragma unroll
        for (int k = 0; k < NJ; ++k) u[k] += ra.f[k] * dz;
        __syncwarp();
        if (lane == 0) sz[i] = x;
        __syncwarp();
        ra = rb;
        i = i1;
      }
    }
  }

  __syncthreads();
  for (int i = tid; i < n; i += kWideThreads) z_out[(size_t)i * B + w] = sz[i];
}

template <int R, bool kPolish>
cudaError_t launch_wide(const float* F, const float* b, const float* mu,
                        const float* z0, float* z, const int* isf,
                        const int* fidx, const float* lo, const float* hi,
                        int n, int r, int B, int iterations, int pgs_sweeps,
                        float cfm, float* work, size_t smem,
                        cudaStream_t stream) {
  auto kernel = apgd_wide_kernel<R, kPolish>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<B, kWideThreads, smem, stream>>>(F, b, mu, z0, z, isf, fidx, lo, hi,
                                            n, r, B, iterations, pgs_sweeps,
                                            cfm, work);
  return cudaGetLastError();
}

template <int R, bool kPolish>
int occupancy_wide(size_t smem) {
  auto kernel = apgd_wide_kernel<R, kPolish>;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return -1;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                    kWideThreads, smem) !=
      cudaSuccess)
    return -1;
  return blocks;
}

template <int R, int ROWS, bool kPolish>
cudaError_t launch(const float* F, const float* b, const float* mu,
                   const float* z0, float* z, const int* isf, const int* fidx,
                   const float* lo, const float* hi, int n, int r, int B,
                   int iterations, int pgs_sweeps, float cfm, int W, int ws,
                   size_t smem, cudaStream_t stream) {
  auto kernel = apgd_seed_kernel<R, ROWS, kPolish>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (B + W - 1) / W;
  kernel<<<blocks, kLanes * W, smem, stream>>>(F, b, mu, z0, z, isf, fidx,
                                               lo, hi, n, r, B, iterations,
                                               pgs_sweeps, cfm, ws);
  return cudaGetLastError();
}

template <int R, int ROWS, bool kPolish>
int occupancy(int W, size_t smem) {
  auto kernel = apgd_seed_kernel<R, ROWS, kPolish>;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return -1;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                    kLanes * W, smem) !=
      cudaSuccess)
    return -1;
  return blocks;
}

}  // namespace

// The instantiations (rank width, rows per lane): 2 rows a lane, F in
// registers, up to width 16; 8 rows a lane, F read from shared memory, at
// every width.
#define NT_INSTANCES(X) \
  X(8, 2) X(12, 2) X(16, 2) X(8, 8) X(12, 8) X(16, 8) X(24, 8) X(32, 8)
// The wide tier's rank widths (up to 1024 rows).
#define WIDE_INSTANCES(X) X(32) X(64) X(128)

extern "C" {

// Largest dynamic shared memory one block may opt into on `device`.
int apgd_seed_smem_limit(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return 0;
  return v;
}

// Resident blocks per SM of the instantiation (rank width, rows per lane,
// with or without the polish) at W worlds per block and `smem` bytes of
// shared memory (cudaOccupancyMaxActiveBlocksPerMultiprocessor); -1 on an
// unknown instantiation or a CUDA error.
int apgd_seed_occupancy(int rank_width, int rows_per_lane, int polish, int W,
                        size_t smem) {
#define NT_CASE(R, ROWS)                               \
  if (rank_width == R && rows_per_lane == ROWS)        \
    return polish ? occupancy<R, ROWS, true>(W, smem)  \
                  : occupancy<R, ROWS, false>(W, smem);
  NT_INSTANCES(NT_CASE)
#undef NT_CASE
  return -1;
}

// F (n, r, B), b/mu/z0/z (n, B) f32 contiguous on the device; per-row
// is_friction, findex (>= 0), lo, hi of length n; pgs_sweeps = 0 for K1,
// > 0 for K1b's polish. The launch plan (lcp_cuda.seed_plan): rank width
// R >= r and rows per lane ROWS with n <= 32 ROWS (one of NT_INSTANCES),
// W worlds per block (1, 2, 4 or 8), a world region of
// ws >= n (R + 5) + R floats, smem >= 4 (4 n + W ws) bytes. Launches on
// `stream` and returns cudaGetLastError() after the launch (0 = launched).
int apgd_seed_f32(const float* F, const float* b, const float* mu,
                  const float* z0, float* z, const int* is_friction,
                  const int* findex, const float* lo, const float* hi, int n,
                  int r, int B, int iterations, int pgs_sweeps, float cfm,
                  int rank_width, int rows_per_lane, int W, int ws,
                  size_t smem, void* stream) {
  if (n <= 0 || n > kLanes * rows_per_lane || B <= 0 || r < 1 ||
      r > rank_width || iterations < 0 || pgs_sweeps < 0 || W < 1 ||
      W > kMaxWorldsPerBlock || (W & (W - 1)) ||
      ws < n * (rank_width + 5) + rank_width ||
      smem < sizeof(float) * (4 * (size_t)n + (size_t)W * ws))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define NT_CASE(R, ROWS)                                                     \
  if (rank_width == R && rows_per_lane == ROWS)                             \
    return (int)(pgs_sweeps > 0                                             \
                     ? launch<R, ROWS, true>(F, b, mu, z0, z, is_friction,  \
                                             findex, lo, hi, n, r, B,       \
                                             iterations, pgs_sweeps, cfm, W, \
                                             ws, smem, s)                   \
                     : launch<R, ROWS, false>(F, b, mu, z0, z, is_friction, \
                                              findex, lo, hi, n, r, B,      \
                                              iterations, 0, cfm, W, ws,    \
                                              smem, s));
  NT_INSTANCES(NT_CASE)
#undef NT_CASE
  return (int)cudaErrorInvalidValue;
}

// Resident blocks (worlds) per SM of the wide tier at rank width
// `rank_width` with `smem` bytes of shared memory; -1 on an unknown width or
// a CUDA error.
int apgd_wide_occupancy(int rank_width, int polish, size_t smem) {
#define WIDE_CASE(R)                                               \
  if (rank_width == R)                                             \
    return polish ? occupancy_wide<R, true>(smem)                  \
                  : occupancy_wide<R, false>(smem);
  WIDE_INSTANCES(WIDE_CASE)
#undef WIDE_CASE
  return -1;
}

// The wide tier, one block of 256 threads per world: F (n, r, B),
// b/mu/z0/z (n, B) as apgd_seed_f32; n <= 1024, r <= rank_width (32, 64 or
// 128). F is staged into work, B n rank_width floats on the device;
// smem >= 4 (10 n + 288) bytes. Returns cudaGetLastError() after the
// launch (0 = launched).
int apgd_wide_f32(const float* F, const float* b, const float* mu,
                  const float* z0, float* z, const int* is_friction,
                  const int* findex, const float* lo, const float* hi, int n,
                  int r, int B, int iterations, int pgs_sweeps, float cfm,
                  int rank_width, float* work, size_t smem, void* stream) {
  const size_t words = (size_t)kWideVectors * n + kWideExtra;
  if (!work || n <= 0 || n > 1024 || B <= 0 || r < 1 || r > rank_width ||
      iterations < 0 || pgs_sweeps < 0 || smem < sizeof(float) * words)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define WIDE_CASE(R)                                                          \
  if (rank_width == R)                                                        \
    return (int)(pgs_sweeps > 0                                               \
                     ? launch_wide<R, true>(F, b, mu, z0, z, is_friction,     \
                                            findex, lo, hi, n, r, B,          \
                                            iterations, pgs_sweeps, cfm,      \
                                            work, smem, s)                    \
                     : launch_wide<R, false>(F, b, mu, z0, z, is_friction,    \
                                             findex, lo, hi, n, r, B,         \
                                             iterations, 0, cfm, work, smem,  \
                                             s));
  WIDE_INSTANCES(WIDE_CASE)
#undef WIDE_CASE
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
