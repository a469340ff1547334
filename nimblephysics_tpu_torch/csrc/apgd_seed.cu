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

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

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
// does not fit a warp's registers, so a world is a CTA of kWideThreads
// threads, or a cluster of 2 or 4 of them where one CTA cannot hold it.
// F stays on chip for the whole launch:
//   * each CTA stages its share of the rows once, from the public
//     (n, r, B) layout, as [row][R] (R = r padded with zero columns to 32,
//     64 or 128) into its shared memory: the 10-box F (72 KiB) in one CTA,
//     two CTAs a SM; the 20-box F (288 KiB, past the 227 KB a CTA may
//     take) in a cluster of two CTAs of 144 KiB each. Nothing of F is read
//     from device memory after that;
//   * rows are taken in groups of kGroup = 6 (two contact triples), a
//     warp's groups fixed for the launch; lane 4 m owns the group's row m
//     and keeps its z, z_prev, y, b, mu and bounds in registers;
//   * one pass over F an iteration: a warp loads a group's F rows into
//     registers, forms F_i . u (one reduce-scatter, halve<8, 16>, for six
//     rows), updates the rows, clips a friction row by its normal (a
//     shuffle: the assembler's contact triples keep the normal in the
//     group), forms the next y and adds F_i^T y_i into the next u with the
//     same registers. Where some friction row's normal lies in another
//     group (no layout the assembler builds), the rows wait for every
//     normal (a CTA or cluster barrier) and the group's F is read a second
//     time. The power iteration folds its normalisation into u the same
//     way (u = F^T (A v) / |A v|), so it takes one pass an iteration too;
//   * u is summed over the warps through shared memory and over a
//     cluster's CTAs through distributed shared memory, in a fixed order,
//     so every warp of every CTA holds the same u;
//   * the polish (K1b) runs on warp 0 of the cluster's first CTA, in
//     blocks of two groups (12 rows): the block's twelve F_i . u in one
//     reduce-scatter, then the twelve row updates on scalars with the
//     in-block Gram terms G_im = F_i . F_m (m < i, formed once before the
//     first sweep, scaled by 1 / A_ii): z_i + (b_i - F_i . u - cfm z_i) /
//     A_ii - sum_{m < i} (G_im / A_ii) dz_m, the same z as row-by-row
//     Gauss-Seidel. Each dz_m is folded into the later rows' sums as soon
//     as it is known, so a row's dependent chain is dz_{i-1}, one FMA, the
//     clip and dz_i; then one u += F_blk^T dz_blk. Rows of another CTA are
//     read through distributed shared memory.
// The arithmetic is the narrow tier's (the header above); only the order
// of the sums differs. What bounds it on this card: the least time for the
// work (2 n r FMAs an operator application, 39 of them and the polish's
// sweeps) is ~0.1-0.25 ms at the card's f32 peak on the box LCPs; the
// polish is a chain of n x sweeps dependent row updates a world on one
// warp, and F on chip leaves room for two worlds a SM (10 boxes) or half
// of one (20 boxes), so its latency sets the time (PERF.md).

constexpr int kWideThreads = 256;
constexpr int kWideWarps = kWideThreads / kLanes;
constexpr int kGroup = 6;           // rows of a group: two contact triples
constexpr int kGroupsPerWarp = 6;   // so a CTA holds up to 288 rows
constexpr int kCtaRows = kWideWarps * kGroupsPerWarp * kGroup;
// The polish's blocks: two groups. A block's Gram terms F_i . F_m / A_ii
// for m < i < kBlock, packed at m + i (i - 1) / 2, padded to 68 floats.
constexpr int kBlock = 2 * kGroup;
constexpr int kGramStride = 68;
constexpr int kMaxCluster = 4;

// Shared memory of a CTA, in floats, at rank width R, a cluster of C CTAs
// of nl rows each (N = C nl, indexed by the global row): F [nl][R]; the
// Gram terms (N / kBlock blocks of kGramStride); the polish's row inputs
// {b, 1 / A_ii, lo, hi} (lo, hi = -mu, mu for a friction row) (4 N); z
// and the friction code (N each); the warps' partial sums of u and of one
// scalar, two sets of kWideWarps (R + 1); the CTA's sums for the cluster,
// two sets of R + 1.
__host__ __device__ constexpr size_t wide_smem_floats(int R, int C, int nl) {
  return (size_t)nl * R + (size_t)C * nl / kBlock * kGramStride + 6 * (size_t)C * nl +
         (size_t)2 * (kWideWarps + 1) * (R + 1);
}

// u and a scalar summed (the scalar's maximum with kMax) over the CTA's
// warps and the cluster's CTAs, the same values in every thread. The warps'
// sums go to part (two sets, alternating, so that a warp may run ahead
// into the next pass), the CTA's to xch, read by every CTA of the cluster
// in rank order after one cluster barrier.
template <int R, bool kVec, bool kMax>
__device__ __forceinline__ float wide_reduce(float (&u)[R / 32], float s,
                                             float* part, float* xch,
                                             int& par, int C,
                                             cg::cluster_group& cluster) {
  constexpr int NJ = R / 32, S = R + 1;
  const int lane = threadIdx.x & (kLanes - 1);
  const int warp = threadIdx.x >> 5;
  float* const pp = part + par * kWideWarps * S;
  s = kMax ? warp_max(s) : warp_sum(s);
  if constexpr (kVec) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) pp[warp * S + 32 * j + lane] = u[j];
  }
  if (lane == 0) pp[warp * S + R] = s;
  __syncthreads();
  const float* src = pp;
  int parts = kWideWarps;
  if (C > 1) {
    float* const x = xch + par * S;
    for (int t = threadIdx.x; t <= R; t += kWideThreads) {
      if (kVec || t == R) {
        float a = pp[t];
#pragma unroll
        for (int w = 1; w < kWideWarps; ++w)
          a = (kMax && t == R) ? fmaxf(a, pp[w * S + t]) : a + pp[w * S + t];
        x[t] = a;
      }
    }
    cluster.sync();
    src = x;
    parts = C;
  }
  // The k-th of the parts terms: warp k's sums, or CTA k's.
  auto term = [&](int k, int t) -> float {
    return C > 1 ? cluster.map_shared_rank(const_cast<float*>(src), k)[t] : src[k * S + t];
  };
  if constexpr (kVec) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      float a = term(0, 32 * j + lane);
      for (int k = 1; k < parts; ++k) a += term(k, 32 * j + lane);
      u[j] = a;
    }
  }
  float t = term(0, R);
  for (int k = 1; k < parts; ++k) t = kMax ? fmaxf(t, term(k, R)) : t + term(k, R);
  par ^= 1;
  return t;
}

// F_m . v for a group's rows m < kGroup over the warp: lane l holds
// columns l + 32 j of the rows (f) and of v. Returns, in lanes 4 m .. 4 m + 3,
// row m's sum.
template <int NJ>
__device__ __forceinline__ float group_dot(const float (&f)[kGroup][NJ],
                                           const float (&v)[NJ], int lane) {
  float p[8];
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    p[m] = 0.0f;
    if (m < kGroup) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) p[m] = fmaf(f[m][j], v[j], p[m]);
    }
  }
  halve<8, kLanes / 2>(p, lane);
  return p[0];
}

// up += F_grp^T y, with row m's y in lane 4 m.
template <int NJ>
__device__ __forceinline__ void group_accumulate(const float (&f)[kGroup][NJ],
                                                 float y, float (&up)[NJ]) {
#pragma unroll
  for (int m = 0; m < kGroup; ++m) {
    const float ym = __shfl_sync(kFull, y, 4 * m);
#pragma unroll
    for (int j = 0; j < NJ; ++j) up[j] = fmaf(f[m][j], ym, up[j]);
  }
}

template <int NJ>
__device__ __forceinline__ void load_group(float (&f)[kGroup][NJ],
                                           const float* rows, int lane) {
#pragma unroll
  for (int m = 0; m < kGroup; ++m) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) f[m][j] = rows[m * NJ * 32 + 32 * j + lane];
  }
}

// F_m . v for a block's rows m < kBlock (two groups) over the warp.
// Returns, in lanes 2 m and 2 m + 1, row m's sum.
template <int NJ>
__device__ __forceinline__ float block_dot(const float (&f0)[kGroup][NJ],
                                           const float (&f1)[kGroup][NJ],
                                           const float (&v)[NJ], int lane) {
  float p[16];
#pragma unroll
  for (int m = 0; m < 16; ++m) {
    p[m] = 0.0f;
    if (m < kBlock) {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        p[m] = fmaf(m < kGroup ? f0[m][j] : f1[m - kGroup][j], v[j], p[m]);
    }
  }
  halve<16, kLanes / 2>(p, lane);
  return p[0];
}

// The polish on one warp (K1b): `sweeps` projected Gauss-Seidel sweeps in
// blocks of kBlock rows. u (lane l: columns l + 32 j) enters as F^T z. z,
// the row inputs, the friction code and the Gram terms are the cluster's
// first CTA's (this one's); F rows of group g lie in CTA g / ngl's shared
// memory. Every lane runs the rows' scalar updates and stores z itself.
// kTriples: the rows are the assembler's contact triples (a friction row's
// normal is the first row of its triple) and then rows without friction,
// so a friction row's bound reads its normal's new z from a register, and
// a lane reads z only where it wrote it. Otherwise the normal's z is read
// from shared memory (or taken from this block's rows where it came
// earlier in them), after the warp's stores of the previous block.
template <int R, bool kTriples>
__device__ __forceinline__ void wide_polish(float (&u)[R / 32], const float* sF,
                                            float* sz, const float4* srow,
                                            const int* scode, const float* sgram,
                                            int n, int nl, int C, int sweeps,
                                            float cfm, cg::cluster_group& cluster) {
  constexpr int NJ = R / 32;
  const int lane = threadIdx.x & (kLanes - 1);
  const int ngl = nl / kGroup;
  const int nblocks = (n + kBlock - 1) / kBlock;
  const int total = sweeps * nblocks;
  auto rows_of = [&](int g) -> float* {
    const int c = g / ngl;
    float* p = const_cast<float*>(sF) + (size_t)(g - c * ngl) * kGroup * R;
    return C > 1 ? cluster.map_shared_rank(p, c) : p;
  };
  // With one CTA a SM (R = 128) the registers hold the next block's F rows
  // too, fetched (through distributed shared memory where another CTA
  // holds them) while this block is solved; at two CTAs a SM a block reads
  // its own rows, from its own CTA's shared memory.
  constexpr bool kPrefetch = R > 64;
  int blk = 0;
  // One block: its F rows (c0, c1), the next block's (n0, n1). The body has
  // no branch, so that the compiler can schedule it whole.
  auto block = [&](float (&c0)[kGroup][NJ], float (&c1)[kGroup][NJ],
                   float (&n0)[kGroup][NJ], float (&n1)[kGroup][NJ]) {
    const int next = blk + 1 == nblocks ? 0 : blk + 1;
    const int i0 = blk * kBlock;
    if constexpr (kPrefetch) {
      load_group(n0, rows_of(2 * next), lane);
      load_group(n1, rows_of(2 * next + 1), lane);
    } else {
      load_group(c0, rows_of(2 * blk), lane);
      load_group(c1, rows_of(2 * blk + 1), lane);
    }
    const float* const h = sgram + blk * kGramStride;  // G_im / A_ii
    const float p = block_dot(c0, c1, u, lane);
    // acc_i: row i's new value before the clip, less the terms of the
    // block's rows not yet solved: z_i + (b_i - F_i . u - cfm z_i) / A_ii.
    float acc[kBlock], zb[kBlock], lo[kBlock], hi[kBlock];
    int code[kBlock];
#pragma unroll
    for (int m = 0; m < kBlock; ++m) {
      const float4 in = srow[i0 + m];  // b, 1 / A_ii, lo, hi (-mu, mu: friction)
      code[m] = scode[i0 + m];
      zb[m] = sz[i0 + m];
      lo[m] = in.z;
      hi[m] = in.w;
      const float pm = __shfl_sync(kFull, p, 2 * m);
      acc[m] = zb[m] + (in.x - (pm + cfm * zb[m])) * in.y;
    }
    // Row by row: clip, then dz_m off the later rows and into u. z is
    // stored after the block, so that no store stands between the loads
    // above and their use.
    float x[kBlock];
#pragma unroll
    for (int m = 0; m < kBlock; ++m) {
      float rlo = lo[m], rhi = hi[m];
      if (!kTriples || m % 3) {
        float zn;
        if constexpr (kTriples) {
          zn = x[m - m % 3];
        } else {
          zn = sz[max(code[m], 0)];  // the normal's z, unless it came earlier here
#pragma unroll
          for (int k = 0; k < m; ++k) zn = code[m] == i0 + k ? x[k] : zn;
        }
        const bool fr = code[m] >= 0;
        rlo = fr ? rlo * zn : rlo;
        rhi = fr ? rhi * zn : rhi;
      }
      x[m] = fminf(fmaxf(acc[m], rlo), rhi);
      const float dz = x[m] - zb[m];
#pragma unroll
      for (int i = m + 1; i < kBlock; ++i) acc[i] = fmaf(-h[m + i * (i - 1) / 2], dz, acc[i]);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        u[j] = fmaf(m < kGroup ? c0[m][j] : c1[m - kGroup][j], dz, u[j]);
    }
#pragma unroll
    for (int m = 0; m < kBlock; ++m) sz[i0 + m] = x[m];  // every lane, the same value
    if constexpr (!kTriples) __syncwarp();  // other lanes' z, read as a normal's
    blk = next;
  };
  float a0[kGroup][NJ], a1[kGroup][NJ];
  if constexpr (kPrefetch) {
    float b0[kGroup][NJ], b1[kGroup][NJ];
    load_group(a0, rows_of(0), lane);
    load_group(a1, rows_of(1), lane);
    for (int t = 0; t < total; t += 2) {
      block(a0, a1, b0, b1);
      if (t + 1 < total) block(b0, b1, a0, a1);
    }
  } else {
    for (int t = 0; t < total; ++t) block(a0, a1, a0, a1);
  }
}

// A cluster of C CTAs (1, 2 or 4) of kWideThreads threads per world; CTA
// c of world w is block w C + c and holds rows [c nl, c nl + nl), nl a
// multiple of kBlock, at most kCtaRows. layout: 2 if the friction rows are
// the assembler's contact triples (wide_polish's kTriples), 1 if every
// friction row's normal lies in its group of kGroup rows, else 0.
template <int R, bool kPolish>
__global__ void __launch_bounds__(kWideThreads, R <= 64 ? 2 : 1)
    apgd_wide_kernel(const float* __restrict__ F, const float* __restrict__ b,
                     const float* __restrict__ mu,
                     const float* __restrict__ z0, float* __restrict__ z_out,
                     const int* __restrict__ is_friction,
                     const int* __restrict__ findex,
                     const float* __restrict__ lo,
                     const float* __restrict__ hi, int n, int r, int B,
                     int iterations, int pgs_sweeps, float cfm, int C, int nl,
                     int layout) {
  constexpr int NJ = R / 32;
  constexpr int GW = kGroupsPerWarp;
  const bool grouped = layout > 0;
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int lane = tid & (kLanes - 1);
  const int warp = tid >> 5;
  const int rank = C > 1 ? (int)cluster.block_rank() : 0;
  const int w = blockIdx.x / C;
  const int N = C * nl;
  const int row0 = rank * nl;
  const int ngl = nl / kGroup;

  float* const sF = smem;
  float* const sgram = sF + (size_t)nl * R;
  float4* const srow = reinterpret_cast<float4*>(sgram + (size_t)(N / kBlock) * kGramStride);
  float* const sz = reinterpret_cast<float*>(srow + N);
  int* const scode = reinterpret_cast<int*>(sz + N);
  float* const part = reinterpret_cast<float*>(scode + N);
  float* const xch = part + 2 * kWideWarps * (R + 1);
  // The cluster's first CTA's copy of p (this CTA's where C = 1).
  auto first = [&](auto* p) { return C > 1 ? cluster.map_shared_rank(p, 0) : p; };

  if constexpr (kPolish) {
    if (rank == 0) {  // the polish's per-row inputs, every row
      for (int i = tid; i < N; i += kWideThreads) {
        const bool in = i < n;
        const bool fr = in && is_friction[i];
        const size_t g = (size_t)i * B + w;
        const float m = fr ? mu[g] : 0.0f;
        srow[i] = make_float4(in ? b[g] : 0.0f, 0.0f, fr ? -m : in ? lo[i] : 0.0f,
                              fr ? m : in ? hi[i] : 0.0f);
        scode[i] = fr ? findex[i] : -1;
        sz[i] = 0.0f;
      }
    }
  }
  // F[row0 + i, j, w] to [i][j]; columns r..R-1 and rows past n are zero.
#pragma unroll 8
  for (int idx = tid; idx < nl * R; idx += kWideThreads) {
    const int i = idx / R;
    const int j = idx & (R - 1);
    const int gi = row0 + i;
    sF[idx] = (gi < n && j < r) ? F[((size_t)gi * r + j) * B + w] : 0.0f;
  }

  // This lane's rows: lane 4 m owns row m of each of its warp's groups
  // warp + kWideWarps k, k < GW.
  const int m = lane >> 2;
  const bool owner = (lane & 3) == 0 && m < kGroup;
  float rz[GW], rzp[GW], ry[GW], rb[GW], rmu[GW], rlo[GW], rhi[GW];
  int rfi[GW];  // the normal (global row) of a friction row, else -1
  unsigned valid = 0;
#pragma unroll
  for (int k = 0; k < GW; ++k) {
    const int gl = warp + kWideWarps * k;
    const int gi = row0 + gl * kGroup + m;
    const bool in = owner && gl < ngl && gi < n;
    valid |= in ? 1u << k : 0u;
    const size_t g = (size_t)(in ? gi : 0) * B + w;
    rb[k] = in ? b[g] : 0.0f;
    rmu[k] = in ? mu[g] : 0.0f;
    rz[k] = in ? z0[g] : 0.0f;
    rzp[k] = rz[k];
    rlo[k] = in ? lo[gi] : 0.0f;
    rhi[k] = in ? hi[gi] : 0.0f;
    rfi[k] = in && is_friction[gi] ? findex[gi] : -1;
    ry[k] = in ? 1.0f : 0.0f;  // the power iteration's start
  }
  if (C > 1)
    cluster.sync();  // F staged, every CTA of the cluster running
  else
    __syncthreads();

  float u[NJ], up[NJ];
  int par = 0;
  float f[kGroup][NJ];
  auto group_rows = [&](int gl) { return sF + (size_t)gl * kGroup * R; };

  // A_ii (its largest value; its inverse and the Gram terms for the
  // polish), and u = F^T v for v = 1.
  float dmax = -FLT_MAX;
#pragma unroll
  for (int j = 0; j < NJ; ++j) up[j] = 0.0f;
#pragma unroll
  for (int k = 0; k < GW; ++k) {
    const int gl = warp + kWideWarps * k;
    if (gl < ngl) {
      load_group(f, group_rows(gl), lane);
      float p[8];
#pragma unroll
      for (int mm = 0; mm < 8; ++mm) {
        p[mm] = 0.0f;
        if (mm < kGroup) {
#pragma unroll
          for (int j = 0; j < NJ; ++j) p[mm] = fmaf(f[mm][j], f[mm][j], p[mm]);
        }
      }
      halve<8, kLanes / 2>(p, lane);
      const float a = p[0] + cfm;
      const int gi = row0 + gl * kGroup + m;
      if (valid >> k & 1u) {
        dmax = fmaxf(dmax, a);
        if constexpr (kPolish)
          first(srow)[gi].y = a > 1e-12f ? 1.0f / fmaxf(a, 1e-12f) : 0.0f;
      }
      if constexpr (kPolish) {
        float q[16];
#pragma unroll
        for (int mm = 1; mm < kGroup; ++mm) {
#pragma unroll
          for (int kk = 0; kk < mm; ++kk) {
            float d = 0.0f;
#pragma unroll
            for (int j = 0; j < NJ; ++j) d = fmaf(f[mm][j], f[kk][j], d);
            q[mm * (mm - 1) / 2 + kk] = d;
          }
        }
        q[15] = 0.0f;
        halve<16, kLanes / 2>(q, lane);
        // Lane 2 e holds pair e = (i, k), e = k + i (i - 1) / 2, scaled by
        // row i's 1 / A_ii (in lane 4 i); an odd group's rows are the
        // block's rows 6..11.
        const float inv = a > 1e-12f ? 1.0f / fmaxf(a, 1e-12f) : 0.0f;
        const int e = min(lane >> 1, 14);
        const int pi = e < 1 ? 1 : e < 3 ? 2 : e < 6 ? 3 : e < 10 ? 4 : 5;
        const int pk = e - pi * (pi - 1) / 2;
        const int gg = rank * ngl + gl;
        const int odd = (gg & 1) * kGroup;
        float* const blk = first(sgram) + (gg >> 1) * kGramStride;
        const float h = q[0] * __shfl_sync(kFull, inv, 4 * pi);
        if ((lane & 1) == 0 && (lane >> 1) < 15)
          blk[(pi + odd) * (pi + odd - 1) / 2 + pk + odd] = h;
        if (odd) {  // with the rows of the group before it, the block's 0..5
          float fp[kGroup][NJ];
          load_group(fp, group_rows(gl - 1), lane);
#pragma unroll
          for (int ii = 0; ii < kGroup; ++ii) {
            const float d = group_dot(fp, f[ii], lane);  // F_ii . F_m in lanes 4 m
            const float hd = d * __shfl_sync(kFull, inv, 4 * ii);
            if (owner) blk[(ii + kGroup) * (ii + kGroup - 1) / 2 + m] = hd;
          }
        }
      }
#pragma unroll
      for (int mm = 0; mm < kGroup; ++mm) {
#pragma unroll
        for (int j = 0; j < NJ; ++j) up[j] += f[mm][j];
      }
    }
  }
  dmax = wide_reduce<R, true, true>(up, dmax, part, xch, par, C, cluster);
#pragma unroll
  for (int j = 0; j < NJ; ++j) u[j] = up[j];

  // The passes below take every warp through GW groups without a branch,
  // so that the compiler can overlap one group's shuffles with the next
  // one's loads: a warp with fewer groups repeats its last real one, whose
  // rows it does not own there (y = 0, nothing added).
  auto group_of = [&](int k) { return min(warp + kWideWarps * k, ngl - 1); };

  // Power iteration on A, v in ry, normalised through u: a pass forms
  // A v, |A v|^2 and F^T A v; the last forms v . A v and F^T z0, the
  // first Nesterov step's u.
  float L = 0.0f;
  for (int it = 0; it < 7; ++it) {
    const bool power = it < 6;
#pragma unroll
    for (int j = 0; j < NJ; ++j) up[j] = 0.0f;
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < GW; ++k) {
      load_group(f, group_rows(group_of(k)), lane);
      const bool own = valid >> k & 1u;
      const float av = group_dot(f, u, lane) + cfm * ry[k];
      acc += own ? (power ? av * av : ry[k] * av) : 0.0f;
      const float y = power ? (own ? av : 0.0f) : rz[k];
      ry[k] = power ? y : ry[k];
      group_accumulate(f, y, up);
    }
    acc = wide_reduce<R, true, false>(up, acc, part, xch, par, C, cluster);
    if (power) {
      const float s = rsqrtf(fmaxf(acc, 1e-24f));
#pragma unroll
      for (int k = 0; k < GW; ++k) ry[k] *= s;
#pragma unroll
      for (int j = 0; j < NJ; ++j) u[j] = up[j] * s;
    } else {
      L = fmaxf(acc * 1.05f, dmax) + 1e-9f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) u[j] = up[j];
    }
  }
  const float step = 1.0f / L;

  // Nesterov projected-gradient steps: y_0 = z0, u = F^T y; an iteration
  // takes z to proj(y - step (A y - b)), then forms the next y and its
  // F^T y (F^T z after the last, for the polish).
#pragma unroll
  for (int k = 0; k < GW; ++k) ry[k] = rz[k];
  for (int it = 0; it < iterations; ++it) {
    const bool last = it + 1 == iterations;
    const float beta = ((float)(it + 1) - 1.0f) / ((float)(it + 1) + 2.0f);
#pragma unroll
    for (int j = 0; j < NJ; ++j) up[j] = 0.0f;
    if (grouped) {  // a friction row's normal is in its group: one pass
#pragma unroll
      for (int k = 0; k < GW; ++k) {
        const int gl = group_of(k);
        load_group(f, group_rows(gl), lane);
        const float y = ry[k];
        const float x = y - step * (group_dot(f, u, lane) + cfm * y - rb[k]);
        const bool fr = rfi[k] >= 0;
        float zc = fr ? x : fminf(fmaxf(x, rlo[k]), rhi[k]);
        const float zn = __shfl_sync(kFull, zc, fr ? 4 * (rfi[k] - row0 - gl * kGroup) : lane);
        const float bound = rmu[k] * fmaxf(zn, 0.0f);
        zc = fr ? fminf(fmaxf(zc, -bound), bound) : zc;
        rzp[k] = rz[k];
        rz[k] = zc;
        ry[k] = zc + beta * (zc - rzp[k]);
        group_accumulate(f, last ? zc : ry[k], up);
      }
    } else {  // every normal projected first, then the friction rows
#pragma unroll
      for (int k = 0; k < GW; ++k) {
        const int gl = group_of(k);
        load_group(f, group_rows(gl), lane);
        const float y = ry[k];
        const float x = y - step * (group_dot(f, u, lane) + cfm * y - rb[k]);
        rzp[k] = rz[k];
        rz[k] = rfi[k] >= 0 ? x : fminf(fmaxf(x, rlo[k]), rhi[k]);
        if (valid >> k & 1u) sz[row0 + gl * kGroup + m] = rz[k];
      }
      if (C > 1)
        cluster.sync();
      else
        __syncthreads();
#pragma unroll
      for (int k = 0; k < GW; ++k) {
        if (rfi[k] >= 0) {
          const int c = rfi[k] / nl;
          const float zn = C > 1 ? cluster.map_shared_rank(sz, c)[rfi[k]] : sz[rfi[k]];
          const float bound = rmu[k] * fmaxf(zn, 0.0f);
          rz[k] = fminf(fmaxf(rz[k], -bound), bound);
        }
        ry[k] = rz[k] + beta * (rz[k] - rzp[k]);
        load_group(f, group_rows(group_of(k)), lane);
        group_accumulate(f, last ? rz[k] : ry[k], up);
      }
    }
    if (!last || kPolish) {
      wide_reduce<R, true, false>(up, 0.0f, part, xch, par, C, cluster);
#pragma unroll
      for (int j = 0; j < NJ; ++j) u[j] = up[j];
    }
  }

  if constexpr (kPolish) {
#pragma unroll
    for (int k = 0; k < GW; ++k)
      if (valid >> k & 1u) first(sz)[row0 + (warp + kWideWarps * k) * kGroup + m] = rz[k];
    if (C > 1)
      cluster.sync();
    else
      __syncthreads();
    if (rank == 0 && warp == 0) {
      if (layout == 2)
        wide_polish<R, true>(u, sF, sz, srow, scode, sgram, n, nl, C, pgs_sweeps, cfm,
                             cluster);
      else
        wide_polish<R, false>(u, sF, sz, srow, scode, sgram, n, nl, C, pgs_sweeps, cfm,
                              cluster);
    }
    if (C > 1)
      cluster.sync();  // the other CTAs' F stays until the polish ends
    else
      __syncthreads();
    if (rank == 0)
      for (int i = tid; i < n; i += kWideThreads) z_out[(size_t)i * B + w] = sz[i];
  } else {
#pragma unroll
    for (int k = 0; k < GW; ++k)
      if (valid >> k & 1u)
        z_out[(size_t)(row0 + (warp + kWideWarps * k) * kGroup + m) * B + w] = rz[k];
    if (C > 1) cluster.sync();  // no CTA leaves while another reads it
  }
}

cudaLaunchConfig_t wide_config(int B, int C, size_t smem, cudaStream_t stream,
                               cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * C));
  cfg.blockDim = dim3(kWideThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int R, bool kPolish>
cudaError_t launch_wide(const float* F, const float* b, const float* mu,
                        const float* z0, float* z, const int* isf,
                        const int* fidx, const float* lo, const float* hi,
                        int n, int r, int B, int iterations, int pgs_sweeps,
                        float cfm, int C, int nl, int layout, size_t smem,
                        cudaStream_t stream) {
  auto kernel = apgd_wide_kernel<R, kPolish>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = wide_config(B, C, smem, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, kernel, F, b, mu, z0, z, isf, fidx, lo, hi, n, r,
                           B, iterations, pgs_sweeps, cfm, C, nl, layout);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// CTAs of the kernel resident on the whole card at once (clusters of C).
template <int R, bool kPolish>
int occupancy_wide(int C, size_t smem) {
  auto kernel = apgd_wide_kernel<R, kPolish>;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return -1;
  int device = 0, sms = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return -1;
  if (C == 1) {
    int blocks = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      kWideThreads, smem) !=
        cudaSuccess)
      return -1;
    return blocks * sms;
  }
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = wide_config(sms, C, smem, nullptr, &attr);
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg) != cudaSuccess) return -1;
  return clusters * C;
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

// CTAs of the wide tier resident on the whole card at rank width
// `rank_width`, clusters of `cluster` CTAs and `smem` bytes of shared
// memory a CTA (cudaOccupancyMaxActiveBlocksPerMultiprocessor times the
// SMs, or cudaOccupancyMaxActiveClusters times the cluster); -1 on an
// unknown width or a CUDA error.
int apgd_wide_occupancy(int rank_width, int polish, int cluster, size_t smem) {
#define WIDE_CASE(R)                                               \
  if (rank_width == R)                                             \
    return polish ? occupancy_wide<R, true>(cluster, smem)         \
                  : occupancy_wide<R, false>(cluster, smem);
  WIDE_INSTANCES(WIDE_CASE)
#undef WIDE_CASE
  return -1;
}

// The wide tier: F (n, r, B), b/mu/z0/z (n, B) as apgd_seed_f32; n <= 1024,
// r <= rank_width (32, 64 or 128). A cluster of `cluster` CTAs (1, 2 or
// 4) of 256 threads per world, each holding rows_per_cta rows (a multiple
// of 12, at most 288, cluster * rows_per_cta >= n) of F in its shared memory;
// smem >= 4 wide_smem_floats(rank_width, cluster, rows_per_cta) bytes.
// layout: 2 only if the friction rows are the assembler's contact triples
// (rows 3 c + 1 and 3 c + 2 bounded by row 3 c, for a prefix of the rows),
// 1 only if every friction row's normal lies in its aligned group of 6
// rows, else 0. Returns cudaGetLastError() after the launch (0 = launched).
int apgd_wide_f32(const float* F, const float* b, const float* mu,
                  const float* z0, float* z, const int* is_friction,
                  const int* findex, const float* lo, const float* hi, int n,
                  int r, int B, int iterations, int pgs_sweeps, float cfm,
                  int rank_width, int cluster, int rows_per_cta, int layout,
                  size_t smem, void* stream) {
  if (n <= 0 || n > 1024 || B <= 0 || r < 1 || r > rank_width ||
      iterations < 0 || pgs_sweeps < 0 ||
      (cluster != 1 && cluster != 2 && cluster != kMaxCluster) ||
      rows_per_cta <= 0 || rows_per_cta > kCtaRows || rows_per_cta % kBlock ||
      cluster * rows_per_cta < n || layout < 0 || layout > 2 ||
      smem < sizeof(float) * wide_smem_floats(rank_width, cluster, rows_per_cta))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define WIDE_CASE(R)                                                          \
  if (rank_width == R)                                                        \
    return (int)(pgs_sweeps > 0                                               \
                     ? launch_wide<R, true>(F, b, mu, z0, z, is_friction,     \
                                            findex, lo, hi, n, r, B,          \
                                            iterations, pgs_sweeps, cfm,      \
                                            cluster, rows_per_cta, layout,    \
                                            smem, s)                          \
                     : launch_wide<R, false>(F, b, mu, z0, z, is_friction,    \
                                             findex, lo, hi, n, r, B,         \
                                             iterations, 0, cfm, cluster,     \
                                             rows_per_cta, layout, smem, s));
  WIDE_INSTANCES(WIDE_CASE)
#undef WIDE_CASE
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
