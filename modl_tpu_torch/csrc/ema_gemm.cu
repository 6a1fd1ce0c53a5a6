// In-place EMA-GEMM  B <- pi * B + SC^T X  for the deferred-B segment end.
//
// Replaces modl_tpu/ops/ema_gemm.py::_kernel (a Pallas TPU kernel that
// streams (k, 256) column tiles of B and (m, 256) tiles of X through
// VMEM with SC^T resident). Shapes on the main path: B (k, n) with
// n = n_features + window pad (~2.1e5), SC (m, k), X (m, n), m = L * b
// rows of one segment (200 at ADHD-70, 1,200 at HCP-1024), k = 70 or
// 1,024. All float32, row-major, contiguous.
//
// What bounds it on an H100: at HCP-1024 the product is 2 k m n = 518
// GFLOP against ~2 GB of traffic (X read once, B read and written once),
// so float32 arithmetic (67 TFLOP/s outside the tensor cores) bounds it;
// at ADHD-70 (6 GFLOP, 0.3 GB) the two bounds are close. The port keeps
// float32 in and float32 accumulation (TF32 off), as its plain path does,
// so the tensor cores are not used; the TPU kernel's single bf16 pass was
// a Mosaic limitation and is not carried over.
//
// Design (simple and right first): one block of 256 threads per
// (BM = 64) x (BN = 128) tile of B. The reduction over m walks in steps
// of BK = 16 rows: the SC tile (BK, BM) and the X tile (BK, BN) are
// loaded from global memory with coalesced scalar loads (rows of SC and
// of X are contiguous along k and n), staged in registers one step
// ahead of the shared-memory copy the block computes on, and each thread
// accumulates an 8 x 4 register tile with float32 FMAs. The epilogue
// reads each element of B once and writes it once. Ragged k, m and n are
// masked (zero-filled tiles, guarded stores); offsets are 64-bit
// (k * n ~ 2.2e8 at HCP-1024).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;    // rows of B (atoms) per block
constexpr int BN = 128;   // columns of B per block
constexpr int BK = 16;    // rows of SC / X per reduction step
constexpr int TM = 8;     // rows of B per thread
constexpr int TN = 4;     // columns of B per thread (one float4)
constexpr int THREADS = (BM / TM) * (BN / TN);          // 256
constexpr int A_LOADS = BK * BM / THREADS;              // 4
constexpr int B_LOADS = BK * BN / THREADS;              // 8

__global__ void __launch_bounds__(THREADS)
ema_gemm_kernel(float* __restrict__ B, const float* __restrict__ SC,
                const float* __restrict__ X, int k, int64_t n, int m,
                float pi) {
    // SC tile As[r][i] = SC[m0 + r, i0 + i]; X tile Bs[r][j] = X[m0 + r,
    // j0 + j]. Aligned for the 16-byte reads of the inner loop: a warp
    // reads one broadcast row slice of As and 512 contiguous bytes of Bs.
    __shared__ __align__(16) float As[BK][BM];
    __shared__ __align__(16) float Bs[BK][BN];

    const int tid = threadIdx.x;
    const int tx = tid % (BN / TN);     // column group: 32 per warp
    const int ty = tid / (BN / TN);     // row group: one per warp
    const int i0 = blockIdx.y * BM;
    const int64_t j0 = (int64_t)blockIdx.x * BN;

    float acc[TM][TN];
#pragma unroll
    for (int a = 0; a < TM; ++a)
#pragma unroll
        for (int c = 0; c < TN; ++c) acc[a][c] = 0.f;

    float a_reg[A_LOADS], b_reg[B_LOADS];
    auto load = [&](int m0) {
#pragma unroll
        for (int q = 0; q < A_LOADS; ++q) {
            const int e = tid + q * THREADS;
            const int r = e / BM, i = e % BM;
            const bool ok = (m0 + r < m) && (i0 + i < k);
            a_reg[q] = ok ? SC[(int64_t)(m0 + r) * k + i0 + i] : 0.f;
        }
#pragma unroll
        for (int q = 0; q < B_LOADS; ++q) {
            const int e = tid + q * THREADS;
            const int r = e / BN, j = e % BN;
            const bool ok = (m0 + r < m) && (j0 + j < n);
            b_reg[q] = ok ? X[(int64_t)(m0 + r) * n + j0 + j] : 0.f;
        }
    };
    auto store = [&]() {
#pragma unroll
        for (int q = 0; q < A_LOADS; ++q) {
            const int e = tid + q * THREADS;
            As[e / BM][e % BM] = a_reg[q];
        }
#pragma unroll
        for (int q = 0; q < B_LOADS; ++q) {
            const int e = tid + q * THREADS;
            Bs[e / BN][e % BN] = b_reg[q];
        }
    };

    load(0);
    for (int m0 = 0; m0 < m; m0 += BK) {
        store();
        __syncthreads();
        if (m0 + BK < m) load(m0 + BK);   // next step's loads in flight
#pragma unroll
        for (int r = 0; r < BK; ++r) {
            const float4 a0 = *reinterpret_cast<const float4*>(
                &As[r][ty * TM]);
            const float4 a1 = *reinterpret_cast<const float4*>(
                &As[r][ty * TM + 4]);
            const float4 b0 = *reinterpret_cast<const float4*>(
                &Bs[r][tx * TN]);
            const float av[TM] = {a0.x, a0.y, a0.z, a0.w,
                                  a1.x, a1.y, a1.z, a1.w};
            const float bv[TN] = {b0.x, b0.y, b0.z, b0.w};
#pragma unroll
            for (int a = 0; a < TM; ++a)
#pragma unroll
                for (int c = 0; c < TN; ++c)
                    acc[a][c] = fmaf(av[a], bv[c], acc[a][c]);
        }
        __syncthreads();
    }

#pragma unroll
    for (int a = 0; a < TM; ++a) {
        const int i = i0 + ty * TM + a;
        if (i >= k) break;
        float* row = B + (int64_t)i * n;
#pragma unroll
        for (int c = 0; c < TN; ++c) {
            const int64_t j = j0 + tx * TN + c;
            if (j < n) row[j] = pi * row[j] + acc[a][c];
        }
    }
}

}  // namespace

// B (k, n), SC (m, k), X (m, n): float32, row-major, contiguous. Launches
// on ``stream`` and returns the launch's cudaError_t (0 on success).
extern "C" int modl_ema_accumulate_f32(float* B, const float* SC,
                                       const float* X, int k, int64_t n,
                                       int m, float pi, void* stream) {
    if (k <= 0 || n <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
    const int64_t col_tiles = (n + BN - 1) / BN;
    const int row_tiles = (k + BM - 1) / BM;
    if (col_tiles > 0x7fffffff || row_tiles > 65535)
        return (int)cudaErrorInvalidValue;
    dim3 grid((unsigned)col_tiles, (unsigned)row_tiles);
    ema_gemm_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        B, SC, X, k, n, m, pi);
    return (int)cudaGetLastError();
}
