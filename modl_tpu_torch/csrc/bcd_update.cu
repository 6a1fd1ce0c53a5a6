// Sequential block coordinate descent on a (k, s) dictionary block, for
// Hopper (sm_90a).
//
// Replaces modl_tpu/ops/bcd_pallas.py::_panel_kernel (launched by
// _bcd_update_ordered). Per atom j of the visit order:
//   R_j  = grad_j - sum_i C[j,i] D_cur[i] + C[j,j] D_j
//   D_j' = R_j / C[j,j] (kept when C[j,j] <= 1e-20), clamped at 0 with
//          comp_pos, projected on the enet ball of radius
//          budget_j = comp_norm_j + enet_norm(D_j)
//   comp_norm_j' = budget_j - enet_norm(D_j')
// with the projection of bcd_pallas._project_rows: closed-form l2 scale,
// 6 steps of bracketed Newton + feasibility scale for the l1 ball, 30
// bisection steps for the general elastic-net ball.
//
// Design. The TPU kernel keeps the whole block in one core's 16 MB VMEM;
// one SM has 227 KB, so here the work is sequential over atoms and
// parallel over columns. A persistent cooperative grid of one block per
// SM splits the columns into slabs; each block keeps its slab of D and
// of the residual R = grad - C D in shared memory and runs the
// right-looking recurrence locally (solve, clamp, and the rank-1 update
// R[:, slab] -= C[:, j] (D_j' - D_j)), which equals the TPU's
// delayed-update form up to summation order. The only cross-block work is
// the projection's row reductions (the norm and max of the candidate row,
// each Newton or bisection probe, the feasibility norm): each is a
// per-block partial in global scratch, a grid barrier, and a sum of all
// partials in one fixed order by every block, so every block holds the
// bitwise-identical threshold and the result is deterministic. Old row
// norms are reduced for all atoms in one pass at the start; the final
// norms that only feed comp_norm are reduced once at the end.
//
// Bound. At the main path's shapes (70 x 17,655 and 256 x 10,780) a
// block's per-atom work is a few hundred elements, so the kernel is
// bound by the grid barriers (one per atom without shrinkage, ~9 for a
// shrinking l1 row, 31 for the elastic-net ball), not by bytes or flops:
// D and grad are read once and D written once. The design keeps every
// barrier it can off the critical path (budgets and final norms are
// batched); fewer barriers, clusters with distributed shared memory and
// wgmma for the initial residual are later work.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;          // ops/bcd.py::THREADS
constexpr int NWARPS = THREADS / 32;
constexpr int NEWTON_ITERS = 6;
constexpr int PROJ_ITERS = 30;
constexpr float TINY = 1e-30f;
constexpr unsigned FULL = 0xffffffffu;

enum { MODE_L2 = 0, MODE_L1 = 1, MODE_ENET = 2 };

struct Params {
  const float* D_in;     // (k, s)
  float* D_out;          // (k, s), may alias D_in
  const float* grad;     // (k, s)
  const float* C;        // (k, k)
  const float* cn_in;    // (k,)
  float* cn_out;         // (k,)
  const int* order;      // (k,) visit order, or null for row order
  float* scratch;        // (4 + 2k) * gridDim.x floats
  int k, s, w;           // rows, columns, columns per block
  float count;           // l1 bracket's element count (ops/bcd.py)
  float l1_ratio, gamma, half_gamma;
  int comp_pos;
};

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(FULL, x, off));
  return x;
}

// Grid-wide reduction of two per-thread values: (sum, sum) or, with
// MAX2, (sum, max). Every block returns the same bits: the block
// partials are combined by warp 0 of each block in one fixed order.
// `part` is double-buffered by `phase`: a block reads buffer p only
// between barrier p and barrier p + 1, and buffer p is written again
// only after barrier p + 1.
template <bool MAX2>
__device__ float2 grid_reduce(float a, float b, float* red, float* part,
                              int& phase, const cg::grid_group& grid) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = gridDim.x;
  a = warp_sum(a);
  b = MAX2 ? warp_max(b) : warp_sum(b);
  if (lane == 0) { red[warp] = a; red[NWARPS + warp] = b; }
  __syncthreads();
  float* buf = part + (phase & 1) * 2 * G;
  if (tid == 0) {
    float x = 0.f, y = 0.f;
    for (int q = 0; q < NWARPS; ++q) {
      x += red[q];
      y = MAX2 ? fmaxf(y, red[NWARPS + q]) : y + red[NWARPS + q];
    }
    buf[blockIdx.x] = x;
    buf[G + blockIdx.x] = y;
  }
  ++phase;
  grid.sync();
  if (warp == 0) {
    float x = 0.f, y = 0.f;
    for (int g = lane; g < G; g += 32) {
      x += __ldcg(buf + g);
      const float yy = __ldcg(buf + G + g);
      y = MAX2 ? fmaxf(y, yy) : y + yy;
    }
    x = warp_sum(x);
    y = MAX2 ? warp_max(y) : warp_sum(y);
    if (lane == 0) { red[2 * NWARPS] = x; red[2 * NWARPS + 1] = y; }
  }
  __syncthreads();
  return make_float2(red[2 * NWARPS], red[2 * NWARPS + 1]);
}

template <int MODE>
__global__ void __launch_bounds__(THREADS, 1) bcd_kernel(const Params p) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  const int k = p.k, w = p.w, s = p.s, G = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = blockIdx.x * w;
  const int wc = max(0, min(w, s - c0));       // live columns of the slab
  float* Ds = smem;                            // [k][w] D slab
  float* Rs = Ds + (size_t)k * w;              // [k][w] residual slab
  float* V = Rs + (size_t)k * w;               // [w] row being solved
  float* budget = V + w;                       // [k]
  float* red = budget + k;                     // [2 * NWARPS + 2]
  float* part = p.scratch;                     // [2][2][G]
  float* pnorm = part + 4 * G;                 // [k][G] old-norm partials
  float* pfin = pnorm + (size_t)k * G;         // [k][G] new-norm partials
  const float l1 = p.l1_ratio, l2c = 1.f - p.l1_ratio;
  int phase = 0;

  // slab of D and grad; dead columns past s are zero, a fixed point
  for (int e = tid; e < k * w; e += THREADS) {
    const int i = e / w, c = e - i * w;
    const size_t g = (size_t)i * s + c0 + c;
    const bool live = c < wc;
    Ds[e] = live ? p.D_in[g] : 0.f;
    Rs[e] = live ? p.grad[g] : 0.f;
  }
  __syncthreads();
  // R = grad - C D on the slab
  for (int e = tid; e < k * w; e += THREADS) {
    const int i = e / w, c = e - i * w;
    const float* Ci = p.C + (size_t)i * k;
    float acc = 0.f;
    for (int l = 0; l < k; ++l) acc = fmaf(__ldg(Ci + l), Ds[l * w + c], acc);
    Rs[e] -= acc;
  }
  // old enet norms of every row: partials, one barrier, fixed-order sums
  for (int i = warp; i < k; i += NWARPS) {
    float a = 0.f;
    for (int c = lane; c < w; c += 32) {
      const float x = fabsf(Ds[i * w + c]);
      a += x * (l1 + l2c * x);
    }
    a = warp_sum(a);
    if (lane == 0) pnorm[(size_t)i * G + blockIdx.x] = a;
  }
  grid.sync();
  for (int i = warp; i < k; i += NWARPS) {
    float a = 0.f;
    for (int g = lane; g < G; g += 32) a += __ldcg(pnorm + (size_t)i * G + g);
    a = warp_sum(a);
    if (lane == 0) budget[i] = p.cn_in[i] + a;
  }
  __syncthreads();

  for (int t = 0; t < k; ++t) {
    const int j = p.order ? __ldg(p.order + t) : t;
    const float cjj = __ldg(p.C + (size_t)j * k + j);
    const bool good = cjj > 1e-20f;
    const float inv = 1.f / (good ? cjj : 1.f);
    const float radius = budget[j];
    float* Dj = Ds + (size_t)j * w;
    const float* Rj = Rs + (size_t)j * w;

    // candidate row and its first statistics
    float a0 = 0.f, a1 = 0.f;
    for (int c = tid; c < w; c += THREADS) {
      const float d = Dj[c];
      float v = good ? (Rj[c] + cjj * d) * inv : d;
      if (p.comp_pos) v = fmaxf(v, 0.f);
      V[c] = v;
      const float b = fabsf(v);
      if (MODE == MODE_L2) {
        a0 += v * v;
      } else if (MODE == MODE_L1) {
        a0 += b;
        a1 = fmaxf(a1, b);
      } else {
        a0 += b * (1.f + p.half_gamma * b);
        a1 = fmaxf(a1, b);
      }
    }
    const float2 r0 = grid_reduce<MODE != MODE_L2>(a0, a1, red, part,
                                                   phase, grid);
    // every branch below is uniform over the grid: its operands are
    // bitwise identical in every block
    if (!(radius > 0.f)) {
      for (int c = tid; c < w; c += THREADS) V[c] = 0.f;
    } else if (MODE == MODE_L2) {
      const float norm2 = r0.x;
      const float scale =
          norm2 <= radius ? 1.f : sqrtf(norm2 / fmaxf(radius, TINY));
      for (int c = tid; c < w; c += THREADS) V[c] = V[c] / scale;
    } else if (MODE == MODE_L1 && !(r0.x <= radius)) {
      // bracketed Newton on g(lam) = sum relu(|v| - lam) = radius
      const float hi0 = r0.y;
      float lo = fmaxf((r0.x - radius) / p.count, 0.f);
      float x0 = 0.f, x1 = 0.f;
      for (int c = tid; c < w; c += THREADS) {
        const float tt = fabsf(V[c]) - lo;
        if (tt > 0.f) { x0 += tt; x1 += 1.f; }
      }
      float2 gn = grid_reduce<false>(x0, x1, red, part, phase, grid);
      float glo = gn.x, nlo = fmaxf(gn.y, 1.f);
      float hi = fminf(fmaxf(lo + (glo - radius) * (hi0 - lo)
                                      / fmaxf(glo, TINY), lo), hi0);
      for (int it = 0; it < NEWTON_ITERS; ++it) {
        const float newton = lo + (glo - radius) / nlo;
        const float tp = fminf(fmaxf(fmaxf(newton, 0.5f * (lo + hi)), lo),
                               hi);
        x0 = 0.f; x1 = 0.f;
        for (int c = tid; c < w; c += THREADS) {
          const float tt = fabsf(V[c]) - tp;
          if (tt > 0.f) { x0 += tt; x1 += 1.f; }
        }
        gn = grid_reduce<false>(x0, x1, red, part, phase, grid);
        const float g = gn.x, n = fmaxf(gn.y, 1.f);
        const float sec = lo + (glo - radius) * (tp - lo)
                                   / fmaxf(glo - g, TINY);
        if (g >= radius) { lo = tp; glo = g; nlo = n; }
        else { hi = fminf(tp, sec); }
      }
      const float lam = fmaxf(lo + (glo - radius) / nlo, 0.f);
      x0 = 0.f;
      for (int c = tid; c < w; c += THREADS)
        x0 += fmaxf(fabsf(V[c]) - lam, 0.f);
      const float norm_w =
          grid_reduce<false>(x0, 0.f, red, part, phase, grid).x;
      const float scale =
          norm_w > radius ? radius / fmaxf(norm_w, TINY) : 1.f;
      for (int c = tid; c < w; c += THREADS)
        V[c] = copysignf(fmaxf(fabsf(V[c]) - lam, 0.f), V[c]) * scale;
    } else if (MODE == MODE_ENET && !(r0.x <= radius / l1)) {
      // bisection on the scaled elastic-net norm of the shrunk row
      const float rr = radius / l1;
      float lo = 0.f, hi = r0.y;
      for (int it = 0; it < PROJ_ITERS; ++it) {
        const float mid = 0.5f * (lo + hi);
        const float den = 1.f + mid * p.gamma;
        float x0 = 0.f;
        for (int c = tid; c < w; c += THREADS) {
          const float ww = fmaxf(fabsf(V[c]) - mid, 0.f) / den;
          x0 += ww * (1.f + p.half_gamma * ww);
        }
        const float sn =
            grid_reduce<false>(x0, 0.f, red, part, phase, grid).x;
        if (sn > rr) lo = mid; else hi = mid;
      }
      const float lam = 0.5f * (lo + hi);
      const float den = 1.f + lam * p.gamma;
      for (int c = tid; c < w; c += THREADS)
        V[c] = copysignf(fmaxf(fabsf(V[c]) - lam, 0.f) / den, V[c]);
    }

    // new row: its norm partial (summed once at the end), the delta
    // kept in V for the rank-1 update, and the row written to the slab
    float fa = 0.f;
    for (int c = tid; c < w; c += THREADS) {
      const float o = V[c];
      const float x = fabsf(o);
      fa += x * (l1 + l2c * x);
      V[c] = o - Dj[c];
      Dj[c] = o;
    }
    fa = warp_sum(fa);
    if (lane == 0) red[warp] = fa;
    __syncthreads();
    if (tid == 0) {
      float x = 0.f;
      for (int q = 0; q < NWARPS; ++q) x += red[q];
      pfin[(size_t)j * G + blockIdx.x] = x;
    }
    // right-looking residual update R -= C[:, j] (D_j' - D_j)
    for (int e = tid; e < k * w; e += THREADS) {
      const int i = e / w, c = e - i * w;
      Rs[e] = fmaf(-__ldg(p.C + (size_t)i * k + j), V[c], Rs[e]);
    }
    __syncthreads();
  }

  for (int e = tid; e < k * w; e += THREADS) {
    const int i = e / w, c = e - i * w;
    if (c < wc) p.D_out[(size_t)i * s + c0 + c] = Ds[e];
  }
  grid.sync();
  for (int j = blockIdx.x * NWARPS + warp; j < k; j += G * NWARPS) {
    float a = 0.f;
    for (int g = lane; g < G; g += 32) a += __ldcg(pfin + (size_t)j * G + g);
    a = warp_sum(a);
    if (lane == 0) p.cn_out[j] = budget[j] - a;
  }
}

}  // namespace

// Launch on `stream` as a cooperative grid of `grid` blocks of THREADS
// threads with slabs of `w` columns. Allocates nothing and does not
// synchronise; returns the launch's error code (cudaSuccess = 0).
extern "C" cudaError_t modl_bcd_update_f32(
    const float* D_in, float* D_out, const float* grad, const float* C,
    const float* cn_in, float* cn_out, const int* order, float* scratch,
    int k, int s, int w, int grid, int count, int mode, float l1_ratio,
    float gamma, float half_gamma, int comp_pos, void* stream) {
  Params p{D_in, D_out, grad, C, cn_in, cn_out, order, scratch,
           k, s, w, (float)count, l1_ratio, gamma, half_gamma, comp_pos};
  const size_t smem =
      sizeof(float) * ((size_t)2 * k * w + w + k + 2 * NWARPS + 2);
  void (*kern)(const Params) = mode == MODE_L2   ? bcd_kernel<MODE_L2>
                               : mode == MODE_L1 ? bcd_kernel<MODE_L1>
                                                 : bcd_kernel<MODE_ENET>;
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, n_sm = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, (const void*)kern, THREADS, smem)) != cudaSuccess)
    return err;
  if (grid > per_sm * n_sm) return cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel((const void*)kern, dim3(grid),
                                    dim3(THREADS), args, smem,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
