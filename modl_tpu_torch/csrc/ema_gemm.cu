// In-place EMA-GEMM  B <- pi * B + SC^T X  for the deferred-B segment end,
// on the H100's tensor cores in 3xTF32.
//
// Replaces modl_tpu/ops/ema_gemm.py::_kernel (a Pallas TPU kernel that
// streams (k, 256) column tiles of B and (m, 256) tiles of X through
// VMEM with SC^T resident, one bf16 pass on the MXU). Shapes on the main
// path: B (k, n) with n = n_features + window pad (210,780 at HCP-1024,
// 217,655 at ADHD-70: odd, so rows are not 16-byte aligned), SC (m, k),
// X (m, n), m = L * b rows of one segment (200 or 700 at ADHD-70, 1,200
// at HCP-1024), k = 70 or 1,024. All float32, row-major, contiguous.
//
// What bounds it on an H100: at HCP-1024 the product is 2 k m n = 518
// GFLOP against ~2.8 GB of traffic (X read once, B read and written
// once): compute-bound. Float32 outside the tensor cores peaks at 67
// TFLOP/s (cuBLAS's f32 GEMM, the plain version, runs at ~49), 3xTF32 on
// the tensor cores at ~165. At ADHD-70 (k = 70: 6.1 GFLOP against 296 MB
// at m = 200) it is bound by HBM bandwidth (3.35 TB/s). Measured on an
// H100 80GB HBM3 at 700 W: ~6.3 ms at HCP-1024 (~82 TFLOP/s of the
// 3xTF32 product; each 128-feature block re-reads the split SC^T from
// L2, ~16 GB in all, and each of the 8 atom tiles re-reads X, ~8 GB).
// The loads and the products each take ~4-5 ms alone: they overlap only
// in part. ~0.16 ms at the fMRI ADHD-70 segment end (~1.8 TB/s; rows that
// are not 16-byte aligned cost ~14% against an aligned width).
//
// Precision: 3xTF32. Each float32 operand x is split into hi = x with its
// low 13 mantissa bits cleared (a TF32 value) and lo = (x - hi) truncated
// the same way; x - hi is exact in float32. The tensor cores take three
// TF32 products per k-step, the small terms first: hi*lo, lo*hi, hi*hi.
// The dropped lo*lo term and the truncation of lo leave a relative error
// of at most ~3 * 2^-20 a product (2^-20 ~ 1e-6), against 2^-10 for one
// TF32 pass; a product of two TF32 values is exact in float32. So the
// result keeps ~21 bits, at or above the JAX package's 3-pass bf16
// 'high', and the port's "no single-pass TF32" rule (ops/precision.py)
// holds. The tensor cores' float32 accumulation does not round to
// nearest: one accumulator over all of m lost precision in proportion to
// m (~9e-6 of max |ref| at m = 1,200 on the card, against cuBLAS's
// ~1.2e-6). So each window of WIN stages (16 or 64 rows of m) starts a
// fresh wgmma accumulator, which is added into a float32 sum with
// round-to-nearest adds once its wgmma's are done: ~5e-7 at m = 1,200.
// tests/test_torch_ema_gemm.py emulates the split in numpy and bounds
// its error at the segment-end shapes.
//
// Design. The product is computed transposed, B^T (n, k) = X^T (n, m) SC,
// so that the atoms sit on wgmma's N side (any multiple of 8: k = 70
// pads to 72, not to a 128-row tile) and the contraction axis m is
// wgmma's K. wgmma takes TF32 operands from shared memory only K-major,
// and X (m, n) is row-major, i.e. MN-major; so X^T is the A operand, read
// from shared memory into registers by each warp (mma.sync would need
// the same fragments at a lower rate). The hi/lo split of X happens
// there, in registers: no second copy of X exists. SC is transposed and
// split once per call by ema_split_sc into two small scratch arrays (hi,
// lo; 2 x 4.9 MB at HCP-1024) laid out as the wgmma B operand's 8-row x
// 16-byte core matrices, tile by tile, so one stage of each is one
// contiguous block for a bulk copy.
//
// A block of two warpgroups owns 128 features x BN atoms (BN <= 128, a
// multiple of 8; 64 features a warpgroup) and walks m in stages of BK
// rows through a STAGES-deep ring in dynamic shared memory, so the loads
// of the next stages overlap the products of this one (Cfg: the tiling
// by width). Every thread copies X with cp.async; one thread issues the
// two bulk (TMA) copies of SC^T's tiles, which an mbarrier a slot
// tracks: that took ~8% off HCP-1024 against copying SC^T with cp.async
// too, whose issue competed with the products. Rows of X and B start at
// any float offset when n is odd (n = 217,655 at ADHD-70: 3 rows in 4
// are not 16-byte aligned), so each row's piece is copied as the 16-byte
// segments that hold it, starting at the aligned address below the row
// start, and lands shifted by that misalignment; the fragment reads and
// the epilogue add the shift back. Every copy of X and B is 16 bytes,
// and nothing is copied to a padded layout. The X tile's row stride (136
// floats) keeps the transposed fragment reads free of bank conflicts
// (two-way at most with shifts). wgmma groups are double-buffered on the
// A registers (wait_group 1). B's tile is read ahead into shared memory
// while the product runs; the epilogue adds pi * B to the sum there (row
// stride 132: conflict-free) and writes B back along contiguous rows, 16
// bytes a thread where the row allows it. Blocks are numbered atom tile
// first, so the k / BN blocks that read one X slab run side by side and
// the slab comes from L2 after the first read. Offsets are 64-bit (k * n
// ~ 2.2e8 at HCP-1024).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NWG = 2;              // warpgroups per block
constexpr int THREADS = 128 * NWG;
constexpr int BM = 64 * NWG;        // features per block (128)
constexpr int LDX = BM + 8;         // X tile row stride (floats)
constexpr int LDC = BM + 4;         // B tile row stride (floats)
constexpr int MAX_BN = 128;         // atoms per block, at most
constexpr int SMALL_BN = 72;
constexpr uint32_t TF32_MASK = 0xFFFFE000u;

// Tiling by the width of the atom tile, from sweeps on the card. Narrow
// tiles (k <= 72: bound by HBM) run two blocks an SM with short stages
// and windows; wide ones (bound by the tensor cores and L2) run stages of
// 32 rows of m and windows of 64.
template <int BN>
struct Cfg {
    static constexpr bool small = BN <= SMALL_BN;
    static constexpr int BK = small ? 16 : 32;      // rows of m a stage
    static constexpr int STAGES = small ? 4 : 3;    // ring depth
    static constexpr int AHEAD = STAGES - 2;        // tiles in flight ahead
    static constexpr int WIN = small ? 1 : 2;       // stages a window
    static constexpr int MINB = small ? 2 : 1;      // blocks an SM
    static constexpr int SMEM =     // + STAGES mbarriers and pi (8 bytes)
        (STAGES * (BK * LDX + 2 * BN * BK) + BN * LDC) * 4 + STAGES * 8 + 8;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Wait for the phase of ``bar`` with the given parity to complete. A
// phase that never completes traps (a launch error) after ~2^32 cycles
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    uint32_t done;
    long long t0 = -1;
    for (;;) {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
        if (done) return;
        if (t0 < 0) t0 = clock64();
        else if (clock64() - t0 > (1ll << 32)) __trap();
    }
}

// Bulk (TMA) copy of ``bytes`` (a multiple of 16, both addresses 16-byte
// aligned) from global to shared memory, completing on ``bar``.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];\n"
        :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
        : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keep the compiler from moving accumulator accesses across wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// Shared-memory matrix descriptor, no swizzle: K-major core matrices of
// 8 rows x 16 bytes, ``lbo`` bytes apart along K and ``sbo`` bytes apart
// along N.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
    return (uint64_t)((addr & 0x3FFFF) >> 4)
           | ((uint64_t)(lbo >> 4) << 16)
           | ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
    hi = __float_as_uint(x) & TF32_MASK;
    lo = __float_as_uint(x - __uint_as_float(hi)) & TF32_MASK;
}

// wgmma.mma_async m64nWk8, d = A * B + (scale_d ? d : 0), f32 from tf32,
// A (4 registers a thread) from registers, B from shared memory through
// ``desc``.
__device__ __forceinline__ void wgmma_n8(float* d, const uint32_t* a,
        uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %8, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3"
        "}, {%4, %5, %6, %7}, %9, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(scale_d),
          "l"(desc));
}

__device__ __forceinline__ void wgmma_n16(float* d, const uint32_t* a,
        uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %12, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %13, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(scale_d),
          "l"(desc));
}

__device__ __forceinline__ void wgmma_n32(float* d, const uint32_t* a,
        uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %20, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %21, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(scale_d),
          "l"(desc));
}

__device__ __forceinline__ void wgmma_n64(float* d, const uint32_t* a,
        uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %36, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %37, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(scale_d),
          "l"(desc));
}

__device__ __forceinline__ void wgmma_n128(float* d, const uint32_t* a,
        uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %68, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55,"
        " %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %69, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(scale_d),
          "l"(desc));
}


// acc[OFF / 2 ..] = A * B[:, OFF : OFF + REM] + (scale_d ? acc : 0), as
// wgmma's of width 128, 64, 32, 16, 8 (largest first). The B tile of BN
// atoms holds core matrices [BN / 8][BK / 4][8 atoms][4 rows of m]; k-step
// q reads core matrices 2q and 2q + 1 of each atom group.
template <int BK, int REM, int OFF>
__device__ __forceinline__ void wgmma_span(float* acc, const uint32_t* a,
                                           uint32_t tile, int q,
                                           int scale_d) {
    if constexpr (REM > 0) {
        constexpr int W = REM >= 128 ? 128 : REM >= 64 ? 64
                          : REM >= 32 ? 32 : REM >= 16 ? 16 : 8;
        constexpr uint32_t core = 128, sbo = (BK / 4) * core;
        const uint64_t desc = make_desc(
            tile + ((OFF / 8) * (BK / 4) + 2 * q) * core, core, sbo);
        if constexpr (W == 128) wgmma_n128(acc + OFF / 2, a, desc, scale_d);
        else if constexpr (W == 64) wgmma_n64(acc + OFF / 2, a, desc, scale_d);
        else if constexpr (W == 32) wgmma_n32(acc + OFF / 2, a, desc, scale_d);
        else if constexpr (W == 16) wgmma_n16(acc + OFF / 2, a, desc, scale_d);
        else wgmma_n8(acc + OFF / 2, a, desc, scale_d);
        wgmma_span<BK, REM - W, OFF + W>(acc, a, tile, q, scale_d);
    }
}

// SC (m, k) -> hi, lo: per (atom tile j, m tile s), a contiguous bn x bk
// block of core matrices [bn / 8][bk / 4][8 atoms][4 rows of m], zero
// beyond k and m.
__global__ void ema_split_sc(const float* __restrict__ SC,
                             float* __restrict__ hi, float* __restrict__ lo,
                             int k, int m, int bn, int bk, int m_tiles,
                             int64_t total) {
    const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= total) return;
    const int tile_size = bn * bk;
    const int64_t tile = idx / tile_size;
    const int e = (int)(idx % tile_size);
    const int j = (int)(tile / m_tiles), s = (int)(tile % m_tiles);
    const int c = e & 3, r = (e >> 2) & 7, rest = e >> 5;
    const int kg = rest % (bk / 4), grp = rest / (bk / 4);
    const int atom = j * bn + grp * 8 + r, mm = s * bk + kg * 4 + c;
    const float v = (atom < k && mm < m) ? SC[(int64_t)mm * k + atom] : 0.f;
    uint32_t h, l;
    split_tf32(v, h, l);
    hi[idx] = __uint_as_float(h);
    lo[idx] = __uint_as_float(l);
}

// Float offset of p within its 16-byte segment (0 where AL: every row of
// the matrix starts on a 16-byte boundary).
template <bool AL>
__device__ __forceinline__ int misalign(const float* p) {
    return AL ? 0 : (int)((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

// Copy 16-byte segment i of those that hold row[0 : BM] (row = &M[r, f0]
// of a row-major matrix that ends at ``end``) to dst[4 i : 4 i + 4): row[f]
// lands at dst[misalign(row) + f]. Reads stop at ``end``; the rest is zero.
template <bool AL>
__device__ __forceinline__ void copy_row_piece(float* dst, const float* row,
                                               const float* end, int i) {
    const float* base = row - misalign<AL>(row);
    const int64_t left = end - (base + 4 * i);
    const int bytes = left >= 4 ? 16 : left > 0 ? (int)left * 4 : 0;
    cp_async16(dst + 4 * i, bytes ? base + 4 * i : base, bytes);
}

// One block: features [f0, f0 + BM) x atoms [atom0, atom0 + BN).
template <int BN, bool AL>
__global__ void __launch_bounds__(THREADS, Cfg<BN>::MINB)
ema_gemm_tf32x3(float* __restrict__ B, const float* __restrict__ X,
                const float* __restrict__ sc_hi,
                const float* __restrict__ sc_lo, int k, int64_t n, int m,
                int atom_tiles, const float* __restrict__ pi) {
    using C = Cfg<BN>;
    constexpr int BK = C::BK, STAGES = C::STAGES, AHEAD = C::AHEAD;
    constexpr int CH = AL ? BM / 4 : BM / 4 + 1;  // 16-byte pieces a row
    extern __shared__ __align__(128) unsigned char smem[];
    float* xs = reinterpret_cast<float*>(smem);    // [STAGES][BK][LDX]
    float* bs = xs + STAGES * BK * LDX;            // [STAGES][hi, lo][BN*BK]
    float* bt = bs + STAGES * 2 * BN * BK;         // [BN][LDC]: B's tile
    uint64_t* full = reinterpret_cast<uint64_t*>(bt + BN * LDC);  // [STAGES]
    // pi from device memory (a captured launch reads each epoch's): one
    // load a block, read by every thread after the barriers below
    float* pi_s = reinterpret_cast<float*>(full + STAGES);

    const int tid = threadIdx.x;
    const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int row = 64 * wg + 16 * warp + g;     // this thread's feature
    const int atom_tile = blockIdx.x % atom_tiles;
    const int atom0 = atom_tile * BN;
    const int atoms = min(BN, k - atom0);
    const int64_t f0 = (int64_t)(blockIdx.x / atom_tiles) * BM;
    const int m_tiles = (m + BK - 1) / BK;
    const int64_t tile_off = (int64_t)atom_tile * m_tiles * BN * BK;
    const float* x_end = X + (int64_t)m * n;
    const float* b_end = B + (int64_t)k * n;
    // rows of X and B start at any float offset (n may be odd): a row's
    // piece sits in shared memory shifted by the row start's misalignment
    const int n4 = AL ? 0 : (int)(n & 3);
    const int x_shift = misalign<AL>(X + f0), b_shift = misalign<AL>(B + f0);

    auto load_tile = [&](int s) {
        const int slot = s % STAGES;
        float* xd = xs + slot * BK * LDX;
        const int r0 = s * BK;
        for (int e = tid; e < BK * CH; e += THREADS) {
            const int r = e / CH, i = e % CH;
            if (r0 + r < m)
                copy_row_piece<AL>(xd + r * LDX,
                                   X + (int64_t)(r0 + r) * n + f0, x_end, i);
            else
                cp_async16(xd + r * LDX + 4 * i, X, 0);
        }
        // SC^T's hi and lo tiles: two bulk copies, completing on full[slot]
        if (tid == 0) {
            constexpr uint32_t bytes = BN * BK * 4;
            float* bd = bs + slot * 2 * BN * BK;
            const int64_t off = tile_off + (int64_t)s * BN * BK;
            mbar_expect_tx(full + slot, 2 * bytes);
            bulk_copy(bd, sc_hi + off, bytes, full + slot);
            bulk_copy(bd + BN * BK, sc_lo + off, bytes, full + slot);
        }
    };

    if (tid == 0) {
        *pi_s = *pi;
        for (int i = 0; i < STAGES; ++i) mbar_init(full + i, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    // B's tile, read ahead into bt while the product runs
    for (int e = tid; e < atoms * CH; e += THREADS) {
        const int a = e / CH, i = e % CH;
        copy_row_piece<AL>(bt + a * LDC, B + (int64_t)(atom0 + a) * n + f0,
                           b_end, i);
    }
    cp_async_commit();
#pragma unroll
    for (int s = 0; s < AHEAD; ++s) {
        if (s < m_tiles) load_tile(s);
        cp_async_commit();
    }

    // Each window of WIN stages lands in a fresh wgmma accumulator that is
    // added into ``sum`` with round-to-nearest float32 adds once its
    // wgmma's are done: the tensor cores' float32 accumulation does not
    // round to nearest, and one accumulator over all of m lost precision
    // in proportion to m (~9e-6 of max |ref| at m = 1,200 on the card).
    float sum[BN / 2], acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) sum[i] = acc[i] = 0.f;
    // A fragments, double-buffered across k-steps: [buffer][4]
    uint32_t ahi[2][4], alo[2][4];

    for (int s = 0; s < m_tiles; ++s) {
        // this warpgroup's products of tile s - 1 but its last group are
        // done, so the slot of tile s - 2 can be refilled
        wgmma_wait<1>();
        cp_async_wait<AHEAD - 1>();            // tile s of X has landed
        __syncthreads();
        if (s + AHEAD < m_tiles) load_tile(s + AHEAD);
        cp_async_commit();
        mbar_wait(full + s % STAGES, (s / STAGES) & 1);  // and of SC^T

        const float* xt = xs + (s % STAGES) * BK * LDX + row;
        const uint32_t b_hi = smem_u32(bs + (s % STAGES) * 2 * BN * BK);
        const uint32_t b_lo = b_hi + BN * BK * 4;
        const bool fresh = s % C::WIN == 0;
#pragma unroll
        for (int q = 0; q < BK / 8; ++q) {
            const int p = q % 2;
            if (q > 0) wgmma_wait<1>();    // frees A buffer p
            const int r = s * BK + 8 * q + t;      // rows r and r + 4 of X
            const float* x0 = xt + (8 * q + t) * LDX
                              + ((x_shift + r * n4) & 3);
            const float* x1 = xt + (8 * q + t + 4) * LDX
                              + ((x_shift + (r + 4) * n4) & 3);
            split_tf32(x0[0], ahi[p][0], alo[p][0]);
            split_tf32(x0[8], ahi[p][1], alo[p][1]);
            split_tf32(x1[0], ahi[p][2], alo[p][2]);
            split_tf32(x1[8], ahi[p][3], alo[p][3]);
            wgmma_fence();
            // the small terms first; a window's first product overwrites
            const int keep = q > 0 || !fresh;
            wgmma_span<BK, BN, 0>(acc, ahi[p], b_lo, q, keep);
            wgmma_span<BK, BN, 0>(acc, alo[p], b_hi, q, 1);
            wgmma_span<BK, BN, 0>(acc, ahi[p], b_hi, q, 1);
            wgmma_commit();
        }
        if ((s + 1) % C::WIN == 0 || s + 1 == m_tiles) {
            wgmma_wait<0>();
            fence_regs<BN / 2>(acc);
#pragma unroll
            for (int i = 0; i < BN / 2; ++i) sum[i] += acc[i];
        }
    }
    cp_async_wait<0>();
    __syncthreads();

    // epilogue: bt[atom][feature] = pi * B + sum, then bt -> B by rows
    const float pi_v = *pi_s;
#pragma unroll
    for (int c = 0; c < BN / 8; ++c) {
        const int a = 8 * c + 2 * t;
        float* o0 = bt + a * LDC + ((b_shift + (atom0 + a) * n4) & 3) + row;
        float* o1 = bt + (a + 1) * LDC
                    + ((b_shift + (atom0 + a + 1) * n4) & 3) + row;
        o0[0] = fmaf(pi_v, o0[0], sum[4 * c]);
        o1[0] = fmaf(pi_v, o1[0], sum[4 * c + 1]);
        o0[8] = fmaf(pi_v, o0[8], sum[4 * c + 2]);
        o1[8] = fmaf(pi_v, o1[8], sum[4 * c + 3]);
    }
    __syncthreads();
    const int64_t f_end = f0 + BM < n ? f0 + BM : n;
    for (int e = tid; e < atoms * CH; e += THREADS) {
        const int a = e / CH, i = e % CH;
        float* rowp = B + (int64_t)(atom0 + a) * n;
        const int sh = misalign<AL>(rowp + f0);
        const int64_t f = f0 - sh + 4 * i;         // feature of element 0
        const float* src = bt + a * LDC + 4 * i;
        if (f >= f0 && f + 4 <= f_end) {
            *reinterpret_cast<float4*>(rowp + f) =
                *reinterpret_cast<const float4*>(src);
        } else {
#pragma unroll
            for (int u = 0; u < 4; ++u)
                if (f + u >= f0 && f + u < f_end) rowp[f + u] = src[u];
        }
    }
}

// atoms per block: k split into ceil(k / 128) tiles of equal width,
// rounded up to a multiple of 8
int block_atoms(int k) {
    const int tiles = (k + MAX_BN - 1) / MAX_BN;
    return ((k + tiles - 1) / tiles + 7) / 8 * 8;
}

template <int BN, bool AL>
int launch(float* B, const float* SC, const float* X, float* scratch, int k,
           int64_t n, int m, const float* pi, cudaStream_t stream) {
    using C = Cfg<BN>;
    auto kernel = ema_gemm_tf32x3<BN, AL>;
    // set on every call: the attribute belongs to the current device
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return (int)err;
    const int atom_tiles = (k + BN - 1) / BN;
    const int m_tiles = (m + C::BK - 1) / C::BK;
    const int64_t half = (int64_t)atom_tiles * m_tiles * BN * C::BK;
    float* hi = scratch;
    float* lo = scratch + half;
    ema_split_sc<<<(unsigned)((half + 255) / 256), 256, 0, stream>>>(
        SC, hi, lo, k, m, BN, C::BK, m_tiles, half);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int64_t blocks = (n + BM - 1) / BM * atom_tiles;
    if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
    kernel<<<(unsigned)blocks, THREADS, C::SMEM, stream>>>(
        B, X, hi, lo, k, n, m, atom_tiles, pi);
    return (int)cudaGetLastError();
}

#define MODL_EMA_WIDTHS(X) \
    X(8) X(16) X(24) X(32) X(40) X(48) X(56) X(64) X(72) X(80) X(88) X(96) \
    X(104) X(112) X(120) X(128)

int64_t scratch_floats(int k, int m) {
    const int bn = block_atoms(k);
    int bk = 0;
#define MODL_EMA_BK(W) \
    if (bn == W) bk = Cfg<W>::BK;
    MODL_EMA_WIDTHS(MODL_EMA_BK)
#undef MODL_EMA_BK
    const int64_t tiles = (k + bn - 1) / bn;
    return 2 * tiles * ((m + bk - 1) / bk) * bn * bk;
}

}  // namespace

// Floats of scratch that modl_ema_accumulate_f32 needs for (k, m): the
// split SC^T, hi and lo.
extern "C" int64_t modl_ema_scratch_floats(int k, int m) {
    return k > 0 && m > 0 ? scratch_floats(k, m) : 0;
}

// B (k, n), SC (m, k), X (m, n): float32, row-major, contiguous; pi one
// float in device memory, read by the kernel (so a launch captured in a
// graph takes the value it finds there at each replay); scratch holds
// modl_ema_scratch_floats(k, m) floats. Launches the split and the
// product on ``stream`` and returns the first cudaError_t (0 on success).
extern "C" int modl_ema_accumulate_f32(float* B, const float* SC,
                                       const float* X, int k, int64_t n,
                                       int m, const float* pi,
                                       float* scratch,
                                       void* stream) {
    if (k <= 0 || n <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    // every row of X and B starts on a 16-byte boundary
    const bool al = n % 4 == 0 && reinterpret_cast<uintptr_t>(B) % 16 == 0
                    && reinterpret_cast<uintptr_t>(X) % 16 == 0;
    switch (block_atoms(k)) {
#define MODL_EMA_CASE(W)                                                \
    case W:                                                             \
        return al ? launch<W, true>(B, SC, X, scratch, k, n, m, pi, st) \
                  : launch<W, false>(B, SC, X, scratch, k, n, m, pi, st);
        MODL_EMA_WIDTHS(MODL_EMA_CASE)
#undef MODL_EMA_CASE
    }
    return (int)cudaErrorInvalidValue;
}
