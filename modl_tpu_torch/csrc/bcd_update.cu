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
// Bound on an H100 SXM. D and grad are read once and D written once
// (12 k s bytes), and the work is 2 k^2 s flops for the first residual
// plus 2 k^2 s for the rank-1 updates: at 70 x 17,655 that is 14.8 MB and
// 0.35 GFLOP (~5 us at 67 TFLOP/s of f32), at 256 x 10,780 33 MB and 2.8
// GFLOP (~42 us). The recurrence is sequential over atoms, so what bounds
// the kernel is the latency of each atom's step: its exchange across the
// card and the threshold search's passes over the row.
//
// Design. The TPU kernel keeps the whole block in one core's 16 MB VMEM;
// one SM has 227 KB. A persistent cooperative grid of one block per SM
// splits the columns into slabs; each block keeps its slab of D and of
// the residual R = grad - C D in shared memory and runs the right-looking
// recurrence on it (solve, clamp, and the rank-1 update
// R[:, slab] -= C[:, j] (D_j' - D_j)), which equals the TPU's
// delayed-update form up to summation order. Only the projection's
// threshold couples the columns, and each atom makes one grid-wide
// exchange for it:
//   publish  one warp of each block writes its slab of the candidate row
//            into a row buffer in global memory (two, by atom parity),
//            with the slab's sum and max of |v|, and arrives at the
//            barrier (a counter: a release add, an acquire spin);
//   fetch    after the barrier every block copies the whole row into
//            shared memory (cp.async.cg, through L2; rows too wide to
//            stage beside the slabs are read from L2 on every pass) while
//            one warp sums the blocks' statistics;
//   solve    where the statistics show the row must shrink, every block
//            runs the whole threshold search on its copy with its own warp
//            reductions. The thread-to-element map and the reduction tree
//            are the same in every block, so every block holds the
//            bitwise-identical threshold and branches alike; a row that
//            keeps its norm is neither waited for nor searched;
//   apply    each block shrinks its slab; the warp that owns the next
//            atom's residual row folds the delta into it and publishes
//            the next candidate at once, while the other warps update the
//            other k - 1 residual rows and the slower blocks catch up.
// The start-of-call reduction of the old row norms into budgets rides on
// the first atom's exchange, so a call makes k exchanges in all (one per
// probe would be ~9 a shrinking l1 atom and 31 an enet atom).
// The new row's norm follows from the search's own sums; block t mod G
// writes comp_norm_j'. Column j of C, the next atom and its diagonal entry
// are loaded while the exchange is in flight; the first residual reads C
// through the staged row's room.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "grid_barrier.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 512;          // ops/bcd.py::THREADS
constexpr int NWARPS = THREADS / 32;  // a power of 2, at most 32
constexpr int NEWTON_ITERS = 6;
constexpr int PROJ_ITERS = 30;
constexpr float TINY = 1e-30f;
constexpr int DL_REGS = 8;            // slab columns / 32 a lane holds
constexpr int RES_COLS = 5;           // column chunks of the first residual
constexpr int RANK1_ROWS = 8;         // rows a warp's rank-1 update batches
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
  float* rows;           // [2][s4] candidate rows, zero past s
  float* pnorm;          // [k][gridDim.x] old-norm partials
  float* pstat;          // [2][2][gridDim.x] candidate rows' statistics
  unsigned* counter;     // barrier arrivals, zero at launch
  int k, s, s4, w;       // rows, columns, s rounded up to 4, slab width
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

// Block sums of two per-thread values, returned to every thread. `red`
// ([2][2 * NWARPS]) is double-buffered by the block's reduction count:
// buffer b is rewritten only after the next reduction's __syncthreads,
// which every reader of b has passed.
__device__ __forceinline__ float2 block_sum2(float a, float b, float* red,
                                             int& nred) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  a = warp_sum(a);
  b = warp_sum(b);
  float* r = red + (nred++ & 1) * 2 * NWARPS;
  if (lane == 0) { r[warp] = a; r[NWARPS + warp] = b; }
  __syncthreads();
  // the NWARPS partials, repeated across the lanes, in log2(NWARPS)
  // steps: the same bits as a warp sum with zeros past NWARPS
  float x = r[lane % NWARPS], y = r[NWARPS + lane % NWARPS];
  for (int off = NWARPS / 2; off; off >>= 1) {
    x += __shfl_xor_sync(FULL, x, off);
    y += __shfl_xor_sync(FULL, y, off);
  }
  return make_float2(x, y);
}

// Sum (and, with MAXB, max of the second half) of G per-block partials
// at pa (pa + G), loaded at once and combined in one fixed order by every
// warp that calls it.
template <bool MAXB>
__device__ __forceinline__ float2 sum_partials(const float* pa, int G) {
  constexpr int SLOTS = 5;                     // G <= 160 in one load
  const int lane = threadIdx.x & 31;
  float x[SLOTS], y[SLOTS];
#pragma unroll
  for (int m = 0; m < SLOTS; ++m) {
    const int g = lane + 32 * m;
    x[m] = g < G ? __ldcg(pa + g) : 0.f;
    y[m] = MAXB && g < G ? __ldcg(pa + G + g) : 0.f;
  }
  float a = 0.f, b = 0.f;
#pragma unroll
  for (int m = 0; m < SLOTS; ++m) {
    a += x[m];
    b = fmaxf(b, y[m]);
  }
  for (int g = lane + 32 * SLOTS; g < G; g += 32) {
    a += __ldcg(pa + g);
    if (MAXB) b = fmaxf(b, __ldcg(pa + G + g));
  }
  return make_float2(warp_sum(a), MAXB ? warp_max(b) : 0.f);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

// The candidate row as the search reads it: staged in shared memory, or
// (rows too wide to stage) read from L2 on every pass.
template <bool STAGED>
struct RowView {
  const float* p;
  __device__ __forceinline__ float4 ld4(int q) const {
    const float4* v = reinterpret_cast<const float4*>(p);
    return STAGED ? v[q] : __ldcg(v + q);
  }
  __device__ __forceinline__ float ld(int i) const {
    return STAGED ? p[i] : __ldcg(p + i);
  }
};

// Sums of f(x) and g(x) over the whole row, taken in the same order in
// every block.
template <bool STAGED, class F, class G>
__device__ __forceinline__ float2 row_sums(const RowView<STAGED>& row, int n4,
                                           F f, G g, float* red, int& nred) {
  float a = 0.f, b = 0.f;
  auto take = [&](float v) {
    a += f(v);
    b += g(v);
  };
  for (int q = threadIdx.x; q < n4; q += THREADS) {
    const float4 x = row.ld4(q);
    take(x.x); take(x.y); take(x.z); take(x.w);
  }
  return block_sum2(a, b, red, nred);
}

// max(t, 0) / den for den >= 1, bitwise; a zero numerator (most entries
// of a deep-shrinkage row) skips the division's slow path
__device__ __forceinline__ float enet_shrunk(float t, float den) {
  return t > 0.f ? t / den : 0.f;
}

// The projection a solve settles on, applied element by element, and the
// enet norm of the row it makes.
struct Shrink {
  int kind;                     // 0 zero, 1 keep, 2 scale, 3 l1, 4 enet
  float lam, scale, den, norm;
  __device__ __forceinline__ float operator()(float v) const {
    switch (kind) {
      case 0: return 0.f;
      case 1: return v;
      case 2: return v / scale;
      case 3: return copysignf(fmaxf(fabsf(v) - lam, 0.f), v) * scale;
      default: return copysignf(enet_shrunk(fabsf(v) - lam, den), v);
    }
  }
};

// The threshold search of bcd_pallas._project_rows on the whole row
// (zeros past s change none of its sums), probe for probe as the Pallas
// kernel runs it. The first statistics r0 (the l2 mode's sum of squares;
// otherwise the sum of |v|, or of |v| (1 + hg |v|), and the max of |v|)
// come with the row. The new row's norm comes from the search's own sums
// (one more pass for a shrunk elastic-net row); the elastic-net probe
// sums t = |v| - mid and t^2 over t > 0 and divides once, so the pass has
// no division.
template <int MODE, bool STAGED>
__device__ Shrink solve(const RowView<STAGED>& row, int n4, float radius,
                        float2 r0, const Params& p, float* red, int& nred) {
  const float hg = p.half_gamma;
  const Shrink zero{0, 0.f, 1.f, 1.f, 0.f};
  if constexpr (MODE == MODE_L2) {
    const float norm2 = r0.x;
    if (!(radius > 0.f)) return zero;
    const float scale =
        norm2 <= radius ? 1.f : sqrtf(norm2 / fmaxf(radius, TINY));
    return Shrink{2, 0.f, scale, 1.f, norm2 / (scale * scale)};
  } else if constexpr (MODE == MODE_L1) {
    if (!(radius > 0.f)) return zero;
    if (r0.x <= radius) return Shrink{1, 0.f, 1.f, 1.f, r0.x};
    // bracketed Newton on g(lam) = sum relu(|v| - lam) = radius
    const float hi0 = r0.y;
    float lo = fmaxf((r0.x - radius) / p.count, 0.f);
    // g(tp) and the count of entries above tp
    auto probe = [&](float tp) {
      return row_sums(
          row, n4, [tp](float v) { return fmaxf(fabsf(v) - tp, 0.f); },
          [tp](float v) { return fabsf(v) - tp > 0.f ? 1.f : 0.f; }, red,
          nred);
    };
    float2 gn = probe(lo);
    float glo = gn.x, nlo = fmaxf(gn.y, 1.f);
    float hi = fminf(fmaxf(lo + (glo - radius) * (hi0 - lo)
                                    / fmaxf(glo, TINY), lo), hi0);
    for (int it = 0; it < NEWTON_ITERS; ++it) {
      const float newton = lo + (glo - radius) / nlo;
      const float tp = fminf(fmaxf(fmaxf(newton, 0.5f * (lo + hi)), lo),
                             hi);
      gn = probe(tp);
      const float g = gn.x, n = fmaxf(gn.y, 1.f);
      const float sec = lo + (glo - radius) * (tp - lo)
                                 / fmaxf(glo - g, TINY);
      if (g >= radius) { lo = tp; glo = g; nlo = n; }
      else { hi = fminf(tp, sec); }
    }
    const float lam = fmaxf(lo + (glo - radius) / nlo, 0.f);
    const float norm_w = probe(lam).x;
    const float scale = norm_w > radius ? radius / fmaxf(norm_w, TINY) : 1.f;
    return Shrink{3, lam, scale, 1.f, norm_w * scale};
  } else {
    const float l1 = p.l1_ratio;
    if (!(radius > 0.f)) return zero;
    // bisection on the scaled elastic-net norm of the shrunk row
    const float rr = radius / l1;
    if (r0.x <= rr) return Shrink{1, 0.f, 1.f, 1.f, l1 * r0.x};
    // sum ww (1 + hg ww) for ww = relu(|v| - tp) / den
    auto scaled_norm = [&](float tp, float den) {
      const float2 st = row_sums(
          row, n4, [tp](float v) { return fmaxf(fabsf(v) - tp, 0.f); },
          [tp](float v) {
            const float t = fmaxf(fabsf(v) - tp, 0.f);
            return t * t;
          },
          red, nred);
      return (st.x + hg * st.y / den) / den;
    };
    float lo = 0.f, hi = r0.y;
    for (int it = 0; it < PROJ_ITERS; ++it) {
      const float mid = 0.5f * (lo + hi);
      if (scaled_norm(mid, 1.f + mid * p.gamma) > rr) lo = mid; else hi = mid;
    }
    const float lam = 0.5f * (lo + hi);
    const float den = 1.f + lam * p.gamma;
    return Shrink{4, lam, 1.f, den, l1 * scaled_norm(lam, den)};
  }
}

// R[:, slab] -= C[:, l0:l0 + nl] D[l0:l0 + nl, slab], where row i of C's
// chunk is at Cc + i * ldc: a copy in shared memory (SMEM) or C itself.
// A warp takes 4 rows by up to RES_COLS column chunks of 32; each C value
// it reads serves them all.
template <bool SMEM>
__device__ __forceinline__ void residual_chunk(float* Rs, const float* Ds,
                                               const float* Cc, int ldc,
                                               int nl, int k, int w, int l0,
                                               int warp, int lane) {
  for (int cb = 0; cb < w; cb += 32 * RES_COLS) {
    const int nq = min(RES_COLS, (w - cb + 31) / 32);
    for (int i0 = 4 * warp; i0 < k; i0 += 4 * NWARPS) {
      const float* Cr[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        Cr[r] = Cc + (size_t)min(i0 + r, k - 1) * ldc + (SMEM ? 0 : l0);
      const float* Dl = Ds + (size_t)l0 * w + cb + lane;
      float acc[4][RES_COLS] = {};
#pragma unroll 2
      for (int l = 0; l < nl; ++l, Dl += w) {
        float cv[4], d[RES_COLS];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = SMEM ? Cr[r][l] : __ldg(Cr[r] + l);
#pragma unroll
        for (int q = 0; q < RES_COLS; ++q)
          d[q] = q < nq && cb + lane + 32 * q < w ? Dl[32 * q] : 0.f;
#pragma unroll
        for (int q = 0; q < RES_COLS; ++q)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[r][q] = fmaf(cv[r], d[q], acc[r][q]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < RES_COLS; ++q) {
          const int c = cb + lane + 32 * q;
          if (i0 + r < k && q < nq && c < w) Rs[(i0 + r) * w + c] -= acc[r][q];
        }
    }
  }
}

template <int MODE, bool STAGED>
__global__ void __launch_bounds__(THREADS, 1) bcd_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int k = p.k, w = p.w, s = p.s, G = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = blockIdx.x * w;
  const int wc = max(0, min(w, s - c0));       // live columns of the slab
  const int n4 = p.s4 / 4;
  float* V = smem;                             // [s4] staged row
  float* Ds = V + (STAGED ? p.s4 : 0);         // [k][w] D slab
  float* Rs = Ds + (size_t)k * w;              // [k][w] residual slab
  // the atom's delta [w] and the reductions' buffers [2][2 * NWARPS]
  // share max(w, 4 * NWARPS) floats: a barrier parts the last reduction
  // of an atom from the delta's first write
  float* dl = Rs + (size_t)k * w;
  float* red = dl;
  float* budget = dl + max(w, 4 * NWARPS);     // [k]
  float* r0s = budget + k;                     // [2] the row's statistics
  const float l1 = p.l1_ratio, l2c = 1.f - p.l1_ratio;
  int nred = 0;
  unsigned exchanges = 0;

  // slab of D and grad; dead columns past s are zero, a fixed point
  for (int i = warp; i < k; i += NWARPS)
    for (int c = lane; c < w; c += 32) {
      const size_t g = (size_t)i * s + c0 + c;
      const bool live = c < wc;
      Ds[i * w + c] = live ? p.D_in[g] : 0.f;
      Rs[i * w + c] = live ? p.grad[g] : 0.f;
    }
  if (blockIdx.x == G - 1)                     // the rows' pad past s
    for (int c = s + tid; c < p.s4; c += THREADS)
      p.rows[c] = p.rows[p.s4 + c] = 0.f;
  __syncthreads();
  // R = grad - C D on the slab. C goes through the staged row's room in
  // chunks of L of its columns (or, unstaged, is read from L2).
  const int L = STAGED ? min(k, p.s4 / k) : 0;
  if (L > 0) {
    for (int l0 = 0; l0 < k; l0 += L) {
      const int nl = min(L, k - l0);
      __syncthreads();                           // the last chunk is used
      for (int i = warp; i < k; i += NWARPS)
        for (int l = lane; l < nl; l += 32)
          cp_async4(V + i * nl + l, p.C + (size_t)i * k + l0 + l);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      __syncthreads();
      residual_chunk<true>(Rs, Ds, V, nl, nl, k, w, l0, warp, lane);
    }
  } else {
    residual_chunk<false>(Rs, Ds, p.C, k, k, k, w, 0, warp, lane);
  }
  // old enet norms of every row: partials, summed after the first exchange
  for (int i = warp; i < k; i += NWARPS) {
    float a = 0.f;
    for (int c = lane; c < w; c += 32) {
      const float x = fabsf(Ds[i * w + c]);
      a += x * (l1 + l2c * x);
    }
    a = warp_sum(a);
    if (lane == 0) p.pnorm[(size_t)i * G + blockIdx.x] = a;
  }
  __syncthreads();

  // Candidate slab of row j into the row buffer of this parity, with the
  // slab's first statistics of it (the search's r0), by the warp that
  // owns row j, which first folds the last atom's delta into the row's
  // residual (`fold`, with cn = C[j][last atom]).
  const float hg = p.half_gamma;
  auto publish = [&](int j, int parity, float cjj, bool fold, float cn) {
    if (warp == j % NWARPS) {
      const bool good = cjj > 1e-20f;
      const float inv = 1.f / (good ? cjj : 1.f);
      const float* Dj = Ds + (size_t)j * w;
      float* Rj = Rs + (size_t)j * w;
      float* buf = p.rows + parity * p.s4 + c0;
      float a = 0.f, b = 0.f;
      for (int c = lane; c < wc; c += 32) {
        float r = Rj[c];
        if (fold) Rj[c] = r = fmaf(-cn, dl[c], r);
        float v = good ? (r + cjj * Dj[c]) * inv : Dj[c];
        if (p.comp_pos) v = fmaxf(v, 0.f);
        buf[c] = v;
        const float x = fabsf(v);
        if (MODE == MODE_L2) a += v * v;
        else if (MODE == MODE_L1) a += x;
        else a += x * (1.f + hg * x);
        b = fmaxf(b, x);
      }
      a = warp_sum(a);
      b = warp_max(b);
      __syncwarp();
      if (lane == 0) {
        p.pstat[(2 * parity) * G + blockIdx.x] = a;
        p.pstat[(2 * parity + 1) * G + blockIdx.x] = b;
        arrive(p.counter);
      }
    }
    ++exchanges;
  };

  int j = p.order ? __ldg(p.order) : 0;
  publish(j, 0, __ldg(p.C + (size_t)j * (k + 1)), false, 0.f);
  // Right-looking residual update R -= C[:, j] (D_j' - D_j) with the
  // delta in dl, on every row but `skip` (the next atom's, folded in its
  // publish), while the slower blocks catch up. Row i is updated by warp
  // i mod NWARPS, whose lane i / NWARPS holds C[i][j] in cij
  // (k <= 32 NWARPS); RANK1_ROWS rows at a time, their loads ahead of
  // their stores.
  auto rank1 = [&](float cij, int skip) {
    float dr[DL_REGS];                           // the delta, for w <= 256
#pragma unroll
    for (int q = 0; q < DL_REGS; ++q)
      dr[q] = lane + 32 * q < w ? dl[lane + 32 * q] : 0.f;
    for (int m0 = 0; warp + NWARPS * m0 < k; m0 += RANK1_ROWS) {
      float ci[RANK1_ROWS];
      float* Ri[RANK1_ROWS];
      bool on[RANK1_ROWS];
#pragma unroll
      for (int r = 0; r < RANK1_ROWS; ++r) {
        const int i = warp + NWARPS * (m0 + r);
        ci[r] = -__shfl_sync(FULL, cij, (m0 + r) & 31);
        on[r] = i < k && i != skip;
        Ri[r] = Rs + (size_t)min(i, k - 1) * w;
      }
      if (w <= 32 * DL_REGS) {
#pragma unroll
        for (int q = 0; q < DL_REGS; ++q) {
          const int c = lane + 32 * q;
          if (c >= w) break;
          float x[RANK1_ROWS];
#pragma unroll
          for (int r = 0; r < RANK1_ROWS; ++r) x[r] = Ri[r][c];
#pragma unroll
          for (int r = 0; r < RANK1_ROWS; ++r)
            if (on[r]) Ri[r][c] = fmaf(ci[r], dr[q], x[r]);
        }
      } else {
        for (int c = lane; c < w; c += 32) {
          const float d = dl[c];
#pragma unroll
          for (int r = 0; r < RANK1_ROWS; ++r)
            if (on[r]) Ri[r][c] = fmaf(ci[r], d, Ri[r][c]);
        }
      }
    }
  };
  const int ic = warp + NWARPS * lane;
  for (int t = 0; t < k; ++t) {
    // loaded while the exchange is in flight: the next atom, its
    // diagonal entry and column j of C
    const int jn =
        t + 1 < k ? (p.order ? __ldg(p.order + t + 1) : t + 1) : j;
    const float cjj_next = __ldg(p.C + (size_t)jn * (k + 1));
    const float cij = ic < k ? __ldg(p.C + (size_t)ic * k + j) : 0.f;
    const float* buf = p.rows + (t & 1) * p.s4;
    grid_wait(p.counter, exchanges * G);
    // the row is fetched while its statistics are summed, and waited for
    // only where the search needs it (the l2 scale never does)
    if (STAGED && MODE != MODE_L2) {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");  // last row's
      for (int q = tid; q < n4; q += THREADS)
        cp_async16(V + 4 * q, buf + 4 * q);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    // the row's first statistics from the blocks' partials, summed by
    // warp 0 in one fixed order while the row is in flight
    if (warp == 0) {
      const float2 r = sum_partials<true>(p.pstat + 2 * (t & 1) * G, G);
      if (lane == 0) { r0s[0] = r.x; r0s[1] = r.y; }
    }
    if (t == 0)
      for (int i = warp; i < k; i += NWARPS) {
        const float a = sum_partials<false>(p.pnorm + (size_t)i * G, G).x;
        if (lane == 0) budget[i] = p.cn_in[i] + a;
      }
    __syncthreads();
    const float2 r0 = make_float2(r0s[0], r0s[1]);
    const float radius = budget[j];
    // whether the solve searches the row (solve's own early returns)
    const bool search =
        radius > 0.f &&
        (MODE == MODE_L1     ? !(r0.x <= radius)
         : MODE == MODE_ENET ? !(r0.x <= radius / p.l1_ratio)
                             : false);
    if (STAGED && search) asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    const RowView<STAGED> row{STAGED ? V : buf};
    const Shrink f = solve<MODE>(row, n4, radius, r0, p, red, nred);
    // the new row's norm is known to every block; one writes it
    if (tid == 0 && blockIdx.x == t % G) p.cn_out[j] = radius - f.norm;
    __syncthreads();                           // red, under dl, is read
    // the new slab of row j and its delta
    float* Dj = Ds + (size_t)j * w;
    for (int c = tid; c < w; c += THREADS) {
      const float v =
          c >= wc ? 0.f : search ? row.ld(c0 + c) : __ldcg(buf + c0 + c);
      const float o = c < wc ? f(v) : 0.f;
      dl[c] = o - Dj[c];
      Dj[c] = o;
    }
    __syncthreads();
    if (t + 1 == k) break;
    // the next atom's residual row first, in its publish, then the rest
    publish(jn, (t + 1) & 1, cjj_next, true,
            __shfl_sync(FULL, cij, jn / NWARPS));
    rank1(cij, jn);
    j = jn;
  }
  if (STAGED) asm volatile("cp.async.wait_group 0;\n" ::: "memory");

  for (int i = warp; i < k; i += NWARPS)
    for (int c = lane; c < wc; c += 32)
      p.D_out[(size_t)i * s + c0 + c] = Ds[i * w + c];
}

// N grid barriers alone: cooperative groups' grid.sync (hand = 0) or the
// arrive/wait counter of bcd_kernel (hand = 1).
__global__ void __launch_bounds__(THREADS, 1)
    barrier_probe_kernel(int n, int hand, unsigned* counter) {
  if (!hand) {
    cg::grid_group grid = cg::this_grid();
    for (int i = 0; i < n; ++i) grid.sync();
    return;
  }
  for (int i = 1; i <= n; ++i) {
    __syncthreads();
    if (threadIdx.x == 0) arrive(counter);
    grid_wait(counter, (unsigned)i * gridDim.x);
  }
}

cudaError_t launch(const void* kern, int grid, size_t smem, void** args,
                   void* stream) {
  return launch_cooperative(kern, grid, THREADS, smem, args, stream);
}

}  // namespace

// Launch on `stream` as a cooperative grid of `grid` blocks of THREADS
// threads with slabs of `w` columns and the `smem` bytes of dynamic shared
// memory of ops/bcd.py::_plan; `staged` stages the row in shared memory.
// `scratch` holds 2 * s4 + (k + 4) * grid floats and then the barrier
// counter, which must be zero. Allocates nothing and does not
// synchronise; returns the launch's error code (cudaSuccess = 0).
extern "C" cudaError_t modl_bcd_update_f32(
    const float* D_in, float* D_out, const float* grad, const float* C,
    const float* cn_in, float* cn_out, const int* order, float* scratch,
    int k, int s, int w, int grid, int smem, int staged, int count,
    int mode, float l1_ratio, float gamma, float half_gamma, int comp_pos,
    void* stream) {
  if (mode < 0 || mode > 2) return cudaErrorInvalidValue;
  const int s4 = (s + 3) / 4 * 4;
  float* pnorm = scratch + 2 * (size_t)s4;
  float* pstat = pnorm + (size_t)k * grid;
  Params p{D_in, D_out, grad, C, cn_in, cn_out, order, scratch, pnorm,
           pstat, reinterpret_cast<unsigned*>(pstat + 4 * grid),
           k, s, s4, w, (float)count, l1_ratio, gamma, half_gamma,
           comp_pos};
  using Kern = void (*)(const Params);
  static const Kern kerns[2][3] = {
      {bcd_kernel<MODE_L2, false>, bcd_kernel<MODE_L1, false>,
       bcd_kernel<MODE_ENET, false>},
      {bcd_kernel<MODE_L2, true>, bcd_kernel<MODE_L1, true>,
       bcd_kernel<MODE_ENET, true>}};
  void* args[] = {&p};
  return launch((const void*)kerns[staged ? 1 : 0][mode], grid, smem, args,
                stream);
}

// `n` grid barriers on a cooperative grid of `grid` blocks of THREADS
// threads: grid.sync (hand = 0) or the kernel's own counter barrier
// (hand = 1; `counter` must be zero).
extern "C" cudaError_t modl_bcd_barrier_probe(int n, int hand, int grid,
                                              unsigned* counter,
                                              void* stream) {
  void* args[] = {&n, &hand, &counter};
  return launch((const void*)barrier_probe_kernel, grid, 0, args, stream);
}
