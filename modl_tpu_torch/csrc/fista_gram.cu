// FISTA on the Gram formulation, for Hopper (sm_90a): a batch's whole
// code solve as one persistent cooperative grid.
//
// Replaces modl_tpu/ops/solvers.py:163 (fista_gram), a lax.while_loop
// with the duality-gap test as a lax.cond every 5 iterations inside the
// jitted step (not a Pallas kernel). For each row i of the batch it
// minimises 1/2 w^T Q_i w - q_i^T w + l1 ||w||_1 + l2/2 ||w||_2^2 from
// w = z = prox(w0), with 1/L from 16 power iterations:
//   grad = Q z - q + l2 z;   w' = prox(z - grad / L);
//   t' = (1 + sqrt(1 + 4 t^2)) / 2;   z = w' + ((t - 1) / t') (w' - w);
// after every 5th iteration the duality gap of every row, and the solve
// stops when every row's gap is below tol * ||x_i||^2, or at max_iter.
// ops/fista.py::fista_gram_reference computes the same thing; every
// rounding step below is the one PyTorch takes there (no contraction, t
// in double, the factor applied as a float), only the sums run in
// another order.
//
// Bound on an H100 SXM: the operations, iterations * 2 b k^2 for Q z and
// one more product (2 b k^2) a check, at f32 67 TFLOP/s: at b = 200,
// k = 128 and ~130 iterations ~1 GFLOP, ~15 us. The rows are independent
// but the iterations sequential, and one iteration is only b k^2 = 3.3 M
// multiply-adds spread over the card: the latency of an iteration on a
// block's rows and of a grid barrier a check bound the kernel, not its
// flops. Where Q is read from shared memory once a multiply-add (one or
// two rows a block), those reads set the pace of an iteration (~2.4 us
// at the image shape); the register path below reads Q from registers.
//
// Design. The TPU keeps the loop on the device inside the jitted step;
// here one launch runs it whole and reads nothing back:
//   grid     one block per multiprocessor (fewer for a small batch), each
//            owning tiles of consecutive rows (ops/fista.py::_plan spreads
//            the batch over the card); where a block holds one tile its
//            state stays on the chip for the whole launch, else it is
//            loaded and stored once a check period;
//   registers a shared Q with k <= 128 (the image fit, its NMF, the l1
//            codes at ADHD-70 width, transform and score): a thread owns
//            column j of Q, read from device memory into registers once a
//            launch, and the elements (r, j) of R rows of the tile (a row
//            takes ceil(k / 32) warps; R = 1, 2 or 4 rows a thread for a
//            large batch, so that one register of Q feeds R multiply-
//            adds). A product reads only the rows' z from shared memory,
//            a broadcast float4 at a time, and sums each output in four
//            interleaved FMA chains (i = 0, 1, 2, 3 mod 4) added as
//            (c0 + c1) + (c2 + c3). The thread keeps z, w and q of its
//            elements in registers, applies the gradient step, the prox
//            and the momentum there and writes the new z into the other
//            half of a double-buffered row: one block barrier an
//            iteration. t's chain of double operations runs beside the
//            product's multiply-adds. At a check a row's sums are warp
//            sums, then the row's warps in order;
//   shared Q (k > 128) staged in shared memory where it fits beside the
//            tile (k up to ~225), else read through L2 by tiles of 8
//            rows, which share each read (4 MB at k = 1,024), 64 rows of
//            Q in flight a warp. The tile's z, w, q and product live in
//            shared memory; a warp owns 32 columns of the product for a
//            group of rows: it reads a row of Q once for all of them and
//            sums each output as one FMA chain over i;
//   per-row Q (G_agg='average') the tile's rows' Grams staged in shared
//            memory where one row's fits (k up to 238; 128 KB for two rows
//            at k = 128, as many rows a tile as fit), at a row stride of
//            k + 1 so that a warp's 32 outputs of a row read distinct
//            banks, each output one FMA chain over j; else (from k alone,
//            never from the batch's size) read from device memory, a warp
//            an output with its lanes reading Q_r[i, :] coalesced, then a
//            butterfly sum; the rest of an iteration, the power
//            iteration's norms and the gap's reductions run a warp a row;
//   L        the power iteration runs in the kernel: for a shared Q every
//            block computes it alone, with the same sums in the same
//            order, so all hold the same L; per row, the block that owns
//            the row;
//   stop     at each check every block adds 2^32 (its arrival) and its
//            count of unconverged rows to the check's 64-bit slot in one
//            atomic, and spins until the slot shows every block's
//            arrival; the count in that final value is the batch's, the
//            same for every block: one round trip through L2 a check and
//            no grid barrier an iteration;
//   chunks   with sync = 0 a launch runs the iterations it0 + 1 .. it_end
//            (one check, where a batch's rows are split over ranks that
//            agree on the stop) with no barrier; w, z and 1/L stay in
//            device memory between launches, t0 comes from the host.
// A row's arithmetic depends neither on the block that holds it nor on
// the batch's size (the path and, on the register path, the order of
// every sum follow from k alone; a shared Q's products sum in one order
// from shared memory or L2, whatever the tile; per-row Grams are staged
// or not by k alone), so ranks that solve part of a batch get the codes
// of the whole batch's solve.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "grid_barrier.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int MAX_TILE = 8;     // ops/fista.py::MAX_TILE (<= NWARPS)
constexpr int CHECK_EVERY = 5;  // ops/fista.py::CHECK_EVERY
constexpr int POWER_ITERS = 16;
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  const float* w0;     // (b, k) warm start
  const float* Q;      // (k, k) shared or (b, k, k) per row
  const float* q;      // (b, k)
  const float* y2;     // (b,) ||x_i||^2
  float* w;            // (b, k) codes
  float* z;            // (b, k) extrapolated point
  float* inv_L;        // (b,) 1 / L; [0] for a shared Q
  // [n_checks] at each check 2^32 a block that reached it plus the
  // unconverged rows; zero at a solve's first launch
  unsigned long long* counts;
  int* iters;          // the iteration the launch ended at
  int b, k, rt;
  float l1, l2, half_l2, tol;
  int positive, it0, it_end, sync;
  double t0;
};

// A tile's buffers in shared memory: z, w, q and the product mv, [rt][k]
// each; 1 / L and ||x||^2 of its rows; the block's count of unconverged
// rows and the stop flag.
struct Tile {
  float *z, *w, *q, *mv, *inv_L, *y2;
  unsigned* cnt;
  int* stop;
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

// t' = 0.5 (1 + sqrt(1 + 4 t t)), rounded as Python rounds it.
__device__ __forceinline__ double next_t(double t) {
  return __dmul_rn(0.5, __dadd_rn(1.0, __dsqrt_rn(__dadd_rn(
                                           1.0, __dmul_rn(__dmul_rn(4.0, t),
                                                          t)))));
}

// sign(x) max(|x| - thr, 0), then max(., 0) when positive.
__device__ __forceinline__ float prox(float x, float thr, int positive) {
  const float a = fmaxf(__fsub_rn(fabsf(x), thr), 0.f);
  const float out = x > 0.f ? a : x < 0.f ? -a : 0.f;
  return positive ? fmaxf(out, 0.f) : out;
}

// mv[r][j] = sum_i X[r][i] Q[i][j] for the nr rows of a tile and a shared
// Q: a warp owns 32 columns and the rows g, g + ng, ... (at most R), and
// sums each output as one FMA chain over i, in order. From L2 it reads U
// rows of Q ahead, in flight together, and the rows of X four at a time
// where they lie on 16-byte boundaries (from shared memory both are
// slower than one element at a time).
template <bool QSMEM, int R>
__device__ __forceinline__ void product_shared_rows(const float* Q,
                                                    const float* X,
                                                    float* mv, int k,
                                                    int nr, int ng) {
  constexpr int U = 64;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nc = (k + 31) >> 5;
  const bool vec = !QSMEM && (k & 3) == 0;
  for (int pr = warp; pr < nc * ng; pr += NWARPS) {
    const int j = ((pr % nc) << 5) + lane, g = pr / nc;
    const float* Qj = Q + (j < k ? j : 0);
    float acc[R];
#pragma unroll
    for (int u = 0; u < R; ++u) acc[u] = 0.f;
    int i = 0;
    if (vec) {
      for (; i + U <= k; i += U) {
        float qv[U];
#pragma unroll
        for (int d = 0; d < U; ++d)
          qv[d] = QSMEM ? Qj[(size_t)(i + d) * k]
                        : __ldg(Qj + (size_t)(i + d) * k);
#pragma unroll
        for (int u = 0; u < R; ++u) {
          const int r = g + u * ng;
          if (r < nr) {
#pragma unroll
            for (int c = 0; c < U; c += 4) {
              const float4 x =
                  *reinterpret_cast<const float4*>(X + r * k + i + c);
              acc[u] = fmaf(x.x, qv[c], acc[u]);
              acc[u] = fmaf(x.y, qv[c + 1], acc[u]);
              acc[u] = fmaf(x.z, qv[c + 2], acc[u]);
              acc[u] = fmaf(x.w, qv[c + 3], acc[u]);
            }
          }
        }
      }
    }
    for (; i < k; ++i) {
      const float qv = QSMEM ? Qj[(size_t)i * k] : __ldg(Qj + (size_t)i * k);
#pragma unroll
      for (int u = 0; u < R; ++u) {
        const int r = g + u * ng;
        if (r < nr) acc[u] = fmaf(X[r * k + i], qv, acc[u]);
      }
    }
    if (j < k) {
#pragma unroll
      for (int u = 0; u < R; ++u) {
        const int r = g + u * ng;
        if (r < nr) mv[r * k + j] = acc[u];
      }
    }
  }
}

template <bool QSMEM>
__device__ __forceinline__ void product_shared(const float* Q,
                                               const float* X, float* mv,
                                               int k, int nr) {
  const int nc = (k + 31) >> 5;
  const int ng = max(1, min(nr, NWARPS / nc));
  const int R = (nr + ng - 1) / ng;
  if (R <= 1)
    product_shared_rows<QSMEM, 1>(Q, X, mv, k, nr, ng);
  else if (R <= 2)
    product_shared_rows<QSMEM, 2>(Q, X, mv, k, nr, ng);
  else if (R <= 4)
    product_shared_rows<QSMEM, 4>(Q, X, mv, k, nr, ng);
  else
    product_shared_rows<QSMEM, MAX_TILE>(Q, X, mv, k, nr, ng);
}

// mv[r][i] = sum_j Q_r[i][j] X[r][j] for the nr rows of a tile whose
// Grams are staged in shared memory at a row stride of k + 1 (lanes on
// consecutive i read distinct banks): a warp owns 32 outputs of one row
// and sums each as one FMA chain over j, in order.
__device__ __forceinline__ void product_rows_staged(const float* Qs,
                                                    const float* X,
                                                    float* mv, int k,
                                                    int nr) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nc = (k + 31) >> 5;
  const bool vec = (k & 3) == 0;
  for (int pr = warp; pr < nc * nr; pr += NWARPS) {
    const int r = pr / nc, i = ((pr % nc) << 5) + lane;
    const float* Qi = Qs + ((size_t)r * k + (i < k ? i : 0)) * (k + 1);
    const float* Xr = X + r * k;
    float acc = 0.f;
    int j = 0;
    if (vec) {
      for (; j < k; j += 4) {
        const float4 x = *reinterpret_cast<const float4*>(Xr + j);
        acc = fmaf(Qi[j], x.x, acc);
        acc = fmaf(Qi[j + 1], x.y, acc);
        acc = fmaf(Qi[j + 2], x.z, acc);
        acc = fmaf(Qi[j + 3], x.w, acc);
      }
    }
    for (; j < k; ++j) acc = fmaf(Qi[j], Xr[j], acc);
    if (i < k) mv[r * k + i] = acc;
  }
}

// The same from per-row Grams in device memory (too large to stage): a
// warp an output (r, i), lanes over j, then a butterfly sum.
__device__ __forceinline__ void product_rows(const float* Q, const float* X,
                                             float* mv, int k, int nr,
                                             int row0) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int pr = warp; pr < nr * k; pr += NWARPS) {
    const int r = pr / k, i = pr - r * k;
    const float* Qi = Q + ((size_t)(row0 + r) * k + i) * k;
    float acc = 0.f;
    for (int j = lane; j < k; j += 32)
      acc = fmaf(__ldg(Qi + j), X[r * k + j], acc);
    acc = warp_sum(acc);
    if (lane == 0) mv[r * k + i] = acc;
  }
}

// Q X for the tile into mv: a shared Q (in shared memory or L2), or the
// rows' own Grams (staged in shared memory or read from device memory).
template <bool SHARED, bool QSMEM>
__device__ __forceinline__ void product(const Params& p, const float* Qs,
                                        const float* X, float* mv, int row0,
                                        int nr) {
  if (SHARED)
    product_shared<QSMEM>(Qs, X, mv, p.k, nr);
  else if (QSMEM)
    product_rows_staged(Qs, X, mv, p.k, nr);
  else
    product_rows(p.Q, X, mv, p.k, nr, row0);
  __syncthreads();
}

// 1 / L of the nr rows (one for a shared Q) into t.inv_L: 16 power
// iterations from ones, L = v.Qv / v.v, then (max(L, 1e-12) + l2) * 1.01.
// Uses z and mv as scratch.
template <bool SHARED, bool QSMEM>
__device__ void lipschitz(const Params& p, const float* Qs, Tile& t,
                          int row0, int nr) {
  const int k = p.k, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int x = threadIdx.x; x < nr * k; x += THREADS) t.z[x] = 1.f;
  __syncthreads();
  for (int n = 0; n <= POWER_ITERS; ++n) {
    product<SHARED, QSMEM>(p, Qs, t.z, t.mv, row0, nr);
    if (warp < nr) {
      float* v = t.z + warp * k;
      const float* m = t.mv + warp * k;
      if (n < POWER_ITERS) {
        float s = 0.f;
        for (int j = lane; j < k; j += 32)
          s = __fadd_rn(s, __fmul_rn(m[j], m[j]));
        const float d = fmaxf(sqrtf(warp_sum(s)), 1e-30f);
        for (int j = lane; j < k; j += 32) v[j] = __fdiv_rn(m[j], d);
      } else {
        float num = 0.f, den = 0.f;
        for (int j = lane; j < k; j += 32) {
          num = __fadd_rn(num, __fmul_rn(v[j], m[j]));
          den = __fadd_rn(den, __fmul_rn(v[j], v[j]));
        }
        num = warp_sum(num);
        den = warp_sum(den);
        const float L = __fmul_rn(
            __fadd_rn(fmaxf(__fdiv_rn(num, fmaxf(den, 1e-30f)), 1e-12f),
                      p.l2),
            1.01f);
        if (lane == 0) t.inv_L[warp] = __fdiv_rn(1.f, L);
      }
    }
    __syncthreads();
  }
}

// The tile's q, ||x||^2 and 1 / L, and w and z: prox(w0) on a launch's
// first visit of a solve (init), else the state in device memory. Rows
// past nr are zeros.
template <bool SHARED, bool QSMEM>
__device__ void load_tile(const Params& p, float* Qs, Tile& t, int row0,
                          int nr, bool init, float inv_L_shared) {
  const int k = p.k, tid = threadIdx.x, n = nr * k, all = p.rt * k;
  const size_t base = (size_t)row0 * k;
  if (!SHARED && QSMEM) {
    // the rows' Grams, at a row stride of k + 1
    const float* Qg = p.Q + base * k;
    for (int x = tid; x < n * k; x += THREADS) {
      const int ri = x / k;
      Qs[(size_t)ri * (k + 1) + (x - ri * k)] = __ldg(Qg + x);
    }
    __syncthreads();
  }
  for (int x = tid; x < all; x += THREADS)
    t.q[x] = x < n ? __ldg(p.q + base + x) : 0.f;
  if (tid < MAX_TILE) t.y2[tid] = tid < nr ? __ldg(p.y2 + row0 + tid) : 0.f;
  if (init) {
    if (SHARED) {
      if (tid < MAX_TILE) t.inv_L[tid] = inv_L_shared;
    } else {
      lipschitz<false, QSMEM>(p, Qs, t, row0, nr);
      if (tid < nr) p.inv_L[row0 + tid] = t.inv_L[tid];
    }
    __syncthreads();
    for (int x = tid; x < all; x += THREADS) {
      const float v =
          x < n ? prox(__ldg(p.w0 + base + x),
                       __fmul_rn(p.l1, t.inv_L[x / k]), p.positive)
                : 0.f;
      t.w[x] = v;
      t.z[x] = v;
    }
  } else {
    if (tid < MAX_TILE)
      t.inv_L[tid] = SHARED ? inv_L_shared
                            : tid < nr ? p.inv_L[row0 + tid] : 0.f;
    for (int x = tid; x < all; x += THREADS) {
      t.w[x] = x < n ? p.w[base + x] : 0.f;
      t.z[x] = x < n ? p.z[base + x] : 0.f;
    }
  }
  __syncthreads();
}

__device__ void store_tile(const Params& p, const Tile& t, int row0,
                           int nr) {
  const size_t base = (size_t)row0 * p.k;
  for (int x = threadIdx.x; x < nr * p.k; x += THREADS) {
    p.w[base + x] = t.w[x];
    p.z[base + x] = t.z[x];
  }
}

// Adds the block's arrival (2^32) and its count of unconverged rows to a
// check's slot, in one relaxed atomic: the slot is all that blocks
// exchange. Where `wait`, spins until all gridDim.x blocks have added
// theirs and returns whether no row of the batch is left, read from the
// slot's final value, which every block reads alike: one round trip
// through L2 a check. Thread 0 only; a wait that never completes traps
// (a launch error) after ~2^32 cycles instead of hanging the card.
__device__ __forceinline__ bool check_slot(unsigned long long* slot,
                                           unsigned cnt, bool wait) {
  const unsigned long long mine = (1ull << 32) | cnt;
  unsigned long long seen = atomicAdd(slot, mine) + mine;
  if (!wait) return false;
  long long t0 = -1;
  while ((seen >> 32) < gridDim.x) {
    asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n"
                 : "=l"(seen) : "l"(slot) : "memory");
    if (t0 < 0) t0 = clock64();
    else if (clock64() - t0 > (1ll << 32)) __trap();
  }
  return (unsigned)seen == 0u;
}

// One iteration on the tile from its product mv = Q z; f = (t - 1) / t'.
__device__ __forceinline__ void step(const Params& p, Tile& t, int nr,
                                     float f) {
  const int k = p.k, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (warp < nr) {
    const float iL = t.inv_L[warp], thr = __fmul_rn(p.l1, iL);
    for (int j = lane; j < k; j += 32) {
      const int x = warp * k + j;
      const float zj = t.z[x], wj = t.w[x];
      const float g =
          __fadd_rn(__fsub_rn(t.mv[x], t.q[x]), __fmul_rn(p.l2, zj));
      const float wn =
          prox(__fsub_rn(zj, __fmul_rn(g, iL)), thr, p.positive);
      t.z[x] = __fadd_rn(wn, __fmul_rn(f, __fsub_rn(wn, wj)));
      t.w[x] = wn;
    }
  }
  __syncthreads();
}

// Whether a row's duality gap (ops/fista.py::_duality_gap) is below
// tol * ||x||^2, from its sums q.w, w.Qw, |w|_1 and w.w, its dual norm
// max_j (q - Qw - l2 w)_j (of the absolute values unless positive) and
// y2 = ||x||^2.
__device__ __forceinline__ bool gap_below_tol(const Params& p, float qdw,
                                              float wH, float l1n, float ww,
                                              float dn, float y2) {
  const float R = __fsub_rn(__fadd_rn(y2, wH), __fmul_rn(2.f, qdw));
  const bool over = dn > p.l1;
  const float sc = over ? __fdiv_rn(p.l1, dn != 0.f ? dn : 1.f) : 1.f;
  const float s2 = __fmul_rn(sc, sc);
  float gap = over ? __fmul_rn(0.5f, __fadd_rn(R, __fmul_rn(R, s2))) : R;
  gap = __fadd_rn(
      gap, __fadd_rn(__fadd_rn(__fsub_rn(__fmul_rn(p.l1, l1n),
                                         __fmul_rn(sc, y2)),
                               __fmul_rn(sc, qdw)),
                     __fmul_rn(__fmul_rn(p.half_l2, __fadd_rn(1.f, s2)),
                               ww)));
  return gap < __fmul_rn(p.tol, y2);
}

// Adds the tile's rows whose duality gap (ops/fista.py::_duality_gap,
// with H = mv = Q w) is not below tol * ||x||^2 to the block's count.
__device__ __forceinline__ void count_gaps(const Params& p, Tile& t,
                                           int nr) {
  const int k = p.k, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (warp >= nr) return;
  float qdw = 0.f, wH = 0.f, l1n = 0.f, ww = 0.f, dn = -INFINITY;
  for (int j = lane; j < k; j += 32) {
    const int x = warp * k + j;
    const float wj = t.w[x], qj = t.q[x], hj = t.mv[x];
    qdw = __fadd_rn(qdw, __fmul_rn(wj, qj));
    wH = __fadd_rn(wH, __fmul_rn(wj, hj));
    l1n = __fadd_rn(l1n, fabsf(wj));
    ww = __fadd_rn(ww, __fmul_rn(wj, wj));
    const float xta = __fsub_rn(__fsub_rn(qj, hj), __fmul_rn(p.l2, wj));
    dn = fmaxf(dn, p.positive ? xta : fabsf(xta));
  }
  qdw = warp_sum(qdw);
  wH = warp_sum(wH);
  l1n = warp_sum(l1n);
  ww = warp_sum(ww);
  dn = warp_max(dn);
  if (lane == 0 && !gap_below_tol(p, qdw, wH, l1n, ww, dn, t.y2[warp]))
    atomicAdd(t.cnt, 1u);
}

template <bool SHARED, bool QSMEM>
__global__ void __launch_bounds__(THREADS, 1) fista_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int k = p.k, rt = p.rt, tid = threadIdx.x;
  const float* Qs = QSMEM ? smem : p.Q;
  Tile t;
  t.z = smem + (!QSMEM ? 0 : SHARED ? (size_t)k * k
                                    : (size_t)rt * k * (k + 1));
  t.w = t.z + rt * k;
  t.q = t.w + rt * k;
  t.mv = t.q + rt * k;
  t.inv_L = t.mv + rt * k;
  t.y2 = t.inv_L + MAX_TILE;
  t.cnt = reinterpret_cast<unsigned*>(t.y2 + MAX_TILE);
  t.stop = reinterpret_cast<int*>(t.cnt + 1);

  if (SHARED && QSMEM) {
    for (int x = tid; x < k * k; x += THREADS) smem[x] = __ldg(p.Q + x);
    __syncthreads();
  }
  float inv_L_shared = 0.f;
  if (SHARED) {
    if (p.it0 == 0) {
      lipschitz<true, QSMEM>(p, Qs, t, 0, 1);
      inv_L_shared = t.inv_L[0];
      if (blockIdx.x == 0 && tid == 0) p.inv_L[0] = inv_L_shared;
    } else {
      inv_L_shared = p.inv_L[0];
    }
  }

  const int ntiles = (p.b + rt - 1) / rt;
  const bool resident = ntiles <= (int)gridDim.x;  // one tile a block
  int it = p.it0;
  double t_run = p.t0;
  for (bool first = true;; first = false) {
    const int end = min((it / CHECK_EVERY + 1) * CHECK_EVERY, p.it_end);
    const bool check = end > it && end % CHECK_EVERY == 0;
    if (tid == 0) *t.cnt = 0;
    double t_end = t_run;  // every tile runs the same iterations
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const int row0 = tile * rt, nr = min(rt, p.b - row0);
      if (first || !resident)
        load_tile<SHARED, QSMEM>(p, smem, t, row0, nr,
                                 first && p.it0 == 0, inv_L_shared);
      double tt = t_run;
      for (int i = it; i < end; ++i) {
        const double tn = next_t(tt);
        const float f = __double2float_rn(__ddiv_rn(__dsub_rn(tt, 1.0), tn));
        tt = tn;
        product<SHARED, QSMEM>(p, Qs, t.z, t.mv, row0, nr);
        step(p, t, nr, f);
      }
      t_end = tt;
      if (check) {
        product<SHARED, QSMEM>(p, Qs, t.w, t.mv, row0, nr);
        count_gaps(p, t, nr);
      }
      if (!resident) {
        __syncthreads();
        store_tile(p, t, row0, nr);
        __syncthreads();
      }
    }
    t_run = t_end;
    it = end;
    if (check) {
      __syncthreads();
      const bool wait = p.sync && end < p.it_end;
      if (tid == 0)
        *t.stop = check_slot(p.counts + end / CHECK_EVERY - 1, *t.cnt, wait);
      if (wait) {
        __syncthreads();
        if (*t.stop) break;
      }
    }
    if (it >= p.it_end) break;
  }
  if (resident) {
    __syncthreads();
    store_tile(p, t, blockIdx.x * rt, min(rt, p.b - (int)blockIdx.x * rt));
  }
  if (blockIdx.x == 0 && tid == 0) *p.iters = it;
}

// ---- The register path: a shared Q with k <= REG_K ----------------------
//
// A row takes NC = ceil(k / 32) warps, so a pass holds P = NWARPS / NC rows
// (warps past P * NC idle) and a tile P * R rows: the thread of warp w and
// lane l is in row group g = w / NC, owns column j = 32 (w % NC) + l and
// the tile's rows u P + g, u < R. Rows and columns past the batch and k
// are zeros, which change no sum.

constexpr int REG_K = 128;    // ops/fista.py::REG_K
constexpr int GAP_SUMS = 5;   // q.w, w.Qw, |w|_1, w.w and the dual norm

// m[u] = sum_i Z_u[i] qc[i] for the thread's R rows, whose z lie at
// Z + u * STRIDE in shared memory: four interleaved FMA chains over i, one
// for each of i = 0, 1, 2, 3 mod 4, added as (c0 + c1) + (c2 + c3). Every
// lane of a warp reads the same float4 of a row (a broadcast).
template <int KP, int R, int STRIDE>
__device__ __forceinline__ void product_regs(const float (&qc)[KP],
                                             const float* Z,
                                             float (&m)[R]) {
  float a[R][4];
#pragma unroll
  for (int u = 0; u < R; ++u)
#pragma unroll
    for (int s = 0; s < 4; ++s) a[u][s] = 0.f;
#pragma unroll
  for (int i = 0; i < KP; i += 4) {
#pragma unroll
    for (int u = 0; u < R; ++u) {
      const float4 x = *reinterpret_cast<const float4*>(Z + u * STRIDE + i);
      a[u][0] = fmaf(x.x, qc[i], a[u][0]);
      a[u][1] = fmaf(x.y, qc[i + 1], a[u][1]);
      a[u][2] = fmaf(x.z, qc[i + 2], a[u][2]);
      a[u][3] = fmaf(x.w, qc[i + 3], a[u][3]);
    }
  }
#pragma unroll
  for (int u = 0; u < R; ++u)
    m[u] = __fadd_rn(__fadd_rn(a[u][0], a[u][1]),
                     __fadd_rn(a[u][2], a[u][3]));
}

// The sums of NV values (the last one's max where MAX) over the threads of
// each of the thread's R rows: a butterfly in each warp, then the row's
// NC warps' results added in order. Every thread of an active row group
// gets its rows' totals. Called by the whole block (one barrier); `red`
// holds NWARPS * R * NV floats, and the caller puts a block barrier
// between these reads of it and the next call's writes.
template <int NC, int R, int NV, bool MAX>
__device__ __forceinline__ void row_reduce(float (&v)[R][NV], float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int u = 0; u < R; ++u)
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      v[u][n] = MAX && n == NV - 1 ? warp_max(v[u][n]) : warp_sum(v[u][n]);
      if (lane == 0) red[(warp * R + u) * NV + n] = v[u][n];
    }
  __syncthreads();
  if (warp / NC >= NWARPS / NC) return;
  const int w0 = warp - warp % NC;
#pragma unroll
  for (int u = 0; u < R; ++u)
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      float s = red[(w0 * R + u) * NV + n];
#pragma unroll
      for (int c = 1; c < NC; ++c) {
        const float x = red[((w0 + c) * R + u) * NV + n];
        s = MAX && n == NV - 1 ? fmaxf(s, x) : __fadd_rn(s, x);
      }
      v[u][n] = s;
    }
}

// 1 / L of the shared Q as lipschitz() defines it, from Q's column in
// registers: each row group runs the power iteration on its own row v
// (its z row of the first buffer), so that every active thread ends with
// the same value, as every block does.
template <int NC>
__device__ __forceinline__ float lipschitz_regs(const Params& p,
                                               const float (&qc)[32 * NC],
                                               float* v, float* red, int j,
                                               bool active) {
  constexpr int KP = 32 * NC;
  if (active) v[j] = j < p.k ? 1.f : 0.f;
  __syncthreads();
  float inv_L = 0.f;
  for (int n = 0; n <= POWER_ITERS; ++n) {
    float m[1] = {0.f};
    if (active) product_regs<KP, 1, 0>(qc, v, m);
    if (n < POWER_ITERS) {
      float s[1][1] = {{__fmul_rn(m[0], m[0])}};
      row_reduce<NC, 1, 1, false>(s, red);
      const float d = fmaxf(sqrtf(s[0][0]), 1e-30f);
      if (active) v[j] = __fdiv_rn(m[0], d);
      __syncthreads();
    } else {
      const float vj = active ? v[j] : 0.f;
      float s[1][2] = {{__fmul_rn(vj, m[0]), __fmul_rn(vj, vj)}};
      row_reduce<NC, 1, 2, false>(s, red);
      const float L = __fmul_rn(
          __fadd_rn(fmaxf(__fdiv_rn(s[0][0], fmaxf(s[0][1], 1e-30f)),
                          1e-12f),
                    p.l2),
          1.01f);
      inv_L = __fdiv_rn(1.f, L);
    }
  }
  return inv_L;
}

// The thread's elements of the tile at row0 (nr rows): q, ||x||^2 and w
// and z, prox(w0) on a launch's first visit of a solve (init), else the
// state in device memory; z also into the tile's rows of Z.
template <int NC, int R>
__device__ __forceinline__ void load_regs(const Params& p, float* Z,
                                          int row0, int nr, bool init,
                                          float thr, int g, int j,
                                          bool active, float (&z)[R],
                                          float (&w)[R], float (&q)[R],
                                          float (&y2)[R]) {
  constexpr int P = NWARPS / NC, KP = 32 * NC;
#pragma unroll
  for (int u = 0; u < R; ++u) {
    const int rr = u * P + g;
    const bool in = active && rr < nr && j < p.k;
    const size_t x = (size_t)(row0 + rr) * p.k + j;
    q[u] = in ? __ldg(p.q + x) : 0.f;
    y2[u] = active && rr < nr ? __ldg(p.y2 + row0 + rr) : 0.f;
    if (init) {
      w[u] = z[u] = in ? prox(__ldg(p.w0 + x), thr, p.positive) : 0.f;
    } else {
      w[u] = in ? p.w[x] : 0.f;
      z[u] = in ? p.z[x] : 0.f;
    }
    if (active) Z[rr * KP + j] = z[u];
  }
}

template <int NC, int R>
__device__ __forceinline__ void store_regs(const Params& p, int row0,
                                           int nr, int g, int j,
                                           bool active, const float (&z)[R],
                                           const float (&w)[R]) {
  constexpr int P = NWARPS / NC;
#pragma unroll
  for (int u = 0; u < R; ++u) {
    const int rr = u * P + g;
    if (active && rr < nr && j < p.k) {
      const size_t x = (size_t)(row0 + rr) * p.k + j;
      p.w[x] = w[u];
      p.z[x] = z[u];
    }
  }
}

template <int NC, int R>
__global__ void __launch_bounds__(THREADS, 1)
    fista_kernel_registers(const Params p) {
  constexpr int KP = 32 * NC, P = NWARPS / NC, RT = P * R;
  extern __shared__ __align__(16) float smem[];
  float* zs = smem;                         // [2][RT][KP] z, double-buffered
  float* ws = zs + 2 * RT * KP;             // [RT][KP] w at a check
  float* red = ws + RT * KP;                // [NWARPS][R][GAP_SUMS]
  // the block's count of unconverged rows, and the stop
  unsigned* cnt = reinterpret_cast<unsigned*>(red + NWARPS * R * GAP_SUMS);
  const int k = p.k, tid = threadIdx.x, warp = tid >> 5;
  const int g = warp / NC, j = (warp % NC) * 32 + (tid & 31);
  const bool active = g < P, lead = active && warp % NC == 0 && !(tid & 31);

  float qc[KP];
#pragma unroll
  for (int i = 0; i < KP; ++i)
    qc[i] = active && i < k && j < k ? __ldg(p.Q + (size_t)i * k + j) : 0.f;
  if (tid == 0) *cnt = 0;
  float inv_L;
  if (p.it0 == 0) {
    inv_L = lipschitz_regs<NC>(p, qc, zs + g * KP, red, j, active);
    if (blockIdx.x == 0 && tid == 0) p.inv_L[0] = inv_L;
  } else {
    inv_L = p.inv_L[0];
  }
  const float thr = __fmul_rn(p.l1, inv_L);

  const int ntiles = (p.b + RT - 1) / RT;
  const bool resident = ntiles <= (int)gridDim.x;  // one tile a block
  float z[R], w[R], q[R], y2[R];
  int it = p.it0, cur = 0;
  double t_run = p.t0;
  for (bool first = true;; first = false) {
    const int end = min((it / CHECK_EVERY + 1) * CHECK_EVERY, p.it_end);
    const bool check = end > it && end % CHECK_EVERY == 0;
    double t_end = t_run;  // every tile runs the same iterations
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const int row0 = tile * RT, nr = min(RT, p.b - row0);
      if (first || !resident) {
        load_regs<NC, R>(p, zs + cur * RT * KP, row0, nr,
                         first && p.it0 == 0, thr, g, j, active, z, w, q,
                         y2);
        __syncthreads();
      }
      double tt = t_run;
      for (int i = it; i < end; ++i) {
        if (active) {
          // t' and the factor in the product's basic block, where their
          // chain of double operations overlaps its multiply-adds
          const double tn = next_t(tt);
          float mz[R];
          product_regs<KP, R, P * KP>(qc, zs + (cur * RT + g) * KP, mz);
          const float f =
              __double2float_rn(__ddiv_rn(__dsub_rn(tt, 1.0), tn));
          tt = tn;
          float* zn = zs + ((cur ^ 1) * RT + g) * KP + j;
          const bool keep_w = check && i + 1 == end;
#pragma unroll
          for (int u = 0; u < R; ++u) {
            const float gr = __fadd_rn(__fsub_rn(mz[u], q[u]),
                                       __fmul_rn(p.l2, z[u]));
            const float wn = prox(__fsub_rn(z[u], __fmul_rn(gr, inv_L)),
                                  thr, p.positive);
            z[u] = __fadd_rn(wn, __fmul_rn(f, __fsub_rn(wn, w[u])));
            w[u] = wn;
            zn[u * P * KP] = z[u];
            if (keep_w) ws[(u * P + g) * KP + j] = wn;
          }
        }
        cur ^= 1;
        __syncthreads();
      }
      t_end = tt;
      if (check) {
        float v[R][GAP_SUMS];
#pragma unroll
        for (int u = 0; u < R; ++u)
#pragma unroll
          for (int n = 0; n < GAP_SUMS; ++n) v[u][n] = 0.f;
        if (active) {
          float mw[R];
          product_regs<KP, R, P * KP>(qc, ws + g * KP, mw);
#pragma unroll
          for (int u = 0; u < R; ++u) {
            const float wj = w[u], qj = q[u], hj = mw[u];
            const float xta =
                __fsub_rn(__fsub_rn(qj, hj), __fmul_rn(p.l2, wj));
            v[u][0] = __fmul_rn(wj, qj);
            v[u][1] = __fmul_rn(wj, hj);
            v[u][2] = fabsf(wj);
            v[u][3] = __fmul_rn(wj, wj);
            v[u][4] = j < k ? (p.positive ? xta : fabsf(xta)) : -INFINITY;
          }
        }
        row_reduce<NC, R, GAP_SUMS, true>(v, red);
        if (lead) {
#pragma unroll
          for (int u = 0; u < R; ++u)
            if (u * P + g < nr && !gap_below_tol(p, v[u][0], v[u][1],
                                                 v[u][2], v[u][3], v[u][4],
                                                 y2[u]))
              atomicAdd(cnt, 1u);
        }
      }
      if (!resident) store_regs<NC, R>(p, row0, nr, g, j, active, z, w);
    }
    t_run = t_end;
    it = end;
    if (check) {
      __syncthreads();
      const bool wait = p.sync && end < p.it_end;
      if (tid == 0) {
        cnt[1] = check_slot(p.counts + end / CHECK_EVERY - 1, cnt[0], wait);
        cnt[0] = 0;
      }
      if (wait) {
        __syncthreads();
        if (cnt[1]) break;
      }
    }
    if (it >= p.it_end) break;
  }
  if (resident && (int)blockIdx.x < ntiles)
    store_regs<NC, R>(p, blockIdx.x * RT, min(RT, p.b - (int)blockIdx.x * RT),
                      g, j, active, z, w);
  if (blockIdx.x == 0 && tid == 0) *p.iters = it;
}

}  // namespace

// Dynamic shared memory of the register path's kernel: z twice and w
// for the rt rows of a tile at the padded width, the row sums' slots and
// the block's count (ops/fista.py::_reg_smem).
static int reg_smem(int rt, int nc, int r) {
  return 4 * (3 * rt * 32 * nc + NWARPS * r * GAP_SUMS + 2);
}

// Launch on `stream` as a cooperative grid of `grid` blocks of THREADS
// threads, tiles of `rt` rows and the `smem` bytes of dynamic shared
// memory of ops/fista.py::_plan, on its `path`: 2, a shared Q in
// registers (k <= 128; rt a multiple of the rows a pass holds, 1, 2 or 4
// rows a thread); 1, Q or the tile's rows' Grams staged in shared memory;
// 0, read from L2 or device memory (rt <= 8 on both).
// `scratch` holds z (b k floats), 1/L (b), from the next 8-byte boundary
// the `n_checks` 64-bit slots of the checks (2^32 an arrival plus the
// unconverged rows: the low 32 bits are the count), then the iteration
// count as a 32-bit integer; the slots must be zero at a solve's first
// launch.
// sync = 1 runs iterations it0 + 1 .. it_end with the stop test on the
// grid; sync = 0 runs them with no barrier (it_end - it0 <= 5 where a
// check falls). Allocates nothing and does not synchronise; returns the
// launch's error code (cudaSuccess = 0).
extern "C" cudaError_t modl_fista_gram_f32(
    const float* w0, const float* Q, const float* q, const float* y2,
    float* w, float* scratch, int b, int k, int shared, int rt, int grid,
    int smem, int path, float l1, float l2, float half_l2, float tol,
    int positive, int it0, int it_end, double t0, int sync, int n_checks,
    void* stream) {
  if (b < 1 || k < 1 || rt < 1 || grid < 1 || grid > (b + rt - 1) / rt ||
      it0 < 0 || it_end < it0 || n_checks < it_end / CHECK_EVERY ||
      path < 0 || path > 2)
    return cudaErrorInvalidValue;
  using Kern = void (*)(const Params);
  const void* kern;
  if (path == 2) {
    const int nc = (k + 31) / 32, r = rt / (NWARPS / nc);
    const int ri = r == 1 ? 0 : r == 2 ? 1 : r == 4 ? 2 : -1;
    if (!shared || k > REG_K || ri < 0 || rt != r * (NWARPS / nc) ||
        smem < reg_smem(rt, nc, r))
      return cudaErrorInvalidValue;
    static const Kern kerns[4][3] = {
        {fista_kernel_registers<1, 1>, fista_kernel_registers<1, 2>,
         fista_kernel_registers<1, 4>},
        {fista_kernel_registers<2, 1>, fista_kernel_registers<2, 2>,
         fista_kernel_registers<2, 4>},
        {fista_kernel_registers<3, 1>, fista_kernel_registers<3, 2>,
         fista_kernel_registers<3, 4>},
        {fista_kernel_registers<4, 1>, fista_kernel_registers<4, 2>,
         fista_kernel_registers<4, 4>}};
    kern = (const void*)kerns[nc - 1][ri];
  } else {
    if (rt > MAX_TILE) return cudaErrorInvalidValue;
    static const Kern kerns[2][2] = {
        {fista_kernel<false, false>, fista_kernel<false, true>},
        {fista_kernel<true, false>, fista_kernel<true, true>}};
    kern = (const void*)kerns[shared ? 1 : 0][path];
  }
  float* z = scratch;
  float* inv_L = z + (size_t)b * k;
  auto* counts = reinterpret_cast<unsigned long long*>(
      scratch + ((size_t)b * k + b + 1) / 2 * 2);
  Params p{w0, Q, q, y2, w, z, inv_L, counts,
           reinterpret_cast<int*>(counts + n_checks), b, k, rt, l1, l2,
           half_l2, tol, positive, it0, it_end, sync, t0};
  void* args[] = {&p};
  return launch_cooperative(kern, grid, THREADS, smem, args, stream);
}
