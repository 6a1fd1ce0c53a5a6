// Launch-overhead probe: D <- scale * D + alpha * G, in place, over
// panels of 64 rows.
//
// Replaces benchmarks/pallas_call_overhead.py::_kernel, the trivial
// streamed-grid kernel that measured the fixed cost of one pallas_call
// at the BCD block driver's operand shapes (D, G: n_blocks * 2,048 rows
// of 1,360 float32 columns; one grid step per 64-row panel, 32 panels
// per 256-atom block). The work is an elementwise pass: 12 bytes of
// traffic per element and two flops, so device memory bandwidth bounds
// it (~3.35 TB/s on an H100 SXM: ~10 us for one block's 11 MB x 3), and
// at one to four blocks per launch the launch and ramp-up cost is a
// visible share of it, which is what the benchmark reads.
//
// One CUDA block per panel (the TPU grid step), 256 threads, 16-byte
// loads and stores; the wrapper guarantees 16-byte alignment and a
// panel size that is a multiple of 4 elements. The products and the
// sum are rounded separately (__fmul_rn, __fadd_rn), as the plain
// PyTorch version rounds them, so the two agree bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
launch_overhead_kernel(float4* __restrict__ D, const float4* __restrict__ G,
                       int64_t panel_vec, float scale, float alpha) {
    const int64_t base = (int64_t)blockIdx.x * panel_vec;
    for (int64_t v = threadIdx.x; v < panel_vec; v += THREADS) {
        float4 d = D[base + v];
        const float4 g = G[base + v];
        d.x = __fadd_rn(__fmul_rn(scale, d.x), __fmul_rn(alpha, g.x));
        d.y = __fadd_rn(__fmul_rn(scale, d.y), __fmul_rn(alpha, g.y));
        d.z = __fadd_rn(__fmul_rn(scale, d.z), __fmul_rn(alpha, g.z));
        d.w = __fadd_rn(__fmul_rn(scale, d.w), __fmul_rn(alpha, g.w));
        D[base + v] = d;
    }
}

}  // namespace

// D, G: n_panels * panel_elems float32 elements each, contiguous and
// 16-byte aligned; panel_elems a multiple of 4. Returns the launch's
// cudaError_t (0 on success).
extern "C" int modl_launch_overhead_f32(float* D, const float* G,
                                        int n_panels, int64_t panel_elems,
                                        float scale, float alpha,
                                        void* stream) {
    if (n_panels <= 0 || panel_elems <= 0 || panel_elems % 4 != 0)
        return (int)cudaErrorInvalidValue;
    launch_overhead_kernel<<<n_panels, THREADS, 0, (cudaStream_t)stream>>>(
        reinterpret_cast<float4*>(D), reinterpret_cast<const float4*>(G),
        panel_elems / 4, scale, alpha);
    return (int)cudaGetLastError();
}
