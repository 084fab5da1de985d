// intensity_hist for Hopper.
//
// Replaces the TPU kernel `_hist_kernel` / `_hist_call` in
// tmlibrary_tpu/ops/fused_measure.py (API `intensity_hist`).  Same
// function: per site and object id 1..M the count of its pixels in each
// of `bins` gray-level buckets, each object's range stretched over the
// buckets by tm_quantize (quantize_per_object's expression); pixels with
// a label outside 1..M are dropped, as the TPU kernel's padded one-hot
// columns drop them.
//
// Design: one thread per pixel on a grid of (pixel chunks, sites).  The
// thread looks up its object's lo/span in the (B, M+1) bounds tables,
// quantises, and adds 1.0f straight into the zeroed float32 output with
// atomicAdd: one memset and one launch per call.  Whole numbers below
// 2^24 add exactly in any order (a 256x256 site has 65,536 pixels), so
// the result is bit-identical to the plain version and run-to-run
// deterministic.  The table is (M x bins) float32 per site (M=256,
// bins=256: 256 KB), above the 227 KB a block may use, so it lives in
// L2/HBM.
//
// Bound: bytes.  Each pixel's label and value are read once (8 B) and
// the count table written once (4 B a cell); the work is a handful of
// operations a pixel.  Same-object pixels with similar values contend
// on one counter; a shared-memory table per object range is later work.
#include "common.cuh"

#define TM_HIST_THREADS 256

__global__ void __launch_bounds__(TM_HIST_THREADS)
intensity_hist_kernel(const int* __restrict__ labels, const float* __restrict__ img,
                      const float* __restrict__ lo_full,
                      const float* __restrict__ span_full, float* counts, int n, int M,
                      int bins) {
    int p = blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= n) return;
    size_t site = blockIdx.y;
    int l = labels[site * n + p];
    if (l < 1 || l > M) return;
    size_t row = site * (M + 1) + l;
    int q = tm_quantize(img[site * n + p], lo_full[row], span_full[row], bins);
    atomicAdd(&counts[((site * M) + (l - 1)) * bins + q], 1.0f);
}

extern "C" int tm_intensity_hist(const void* labels, const void* img, const void* lo_full,
                                 const void* span_full, void* out, int B, int H, int W,
                                 int M, int bins, void* stream) {
    if (B < 1 || M < 1 || bins < 2 || B > 65535) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    int n = H * W;
    size_t cells = (size_t)B * M * bins;
    cudaError_t err = cudaMemsetAsync(out, 0, cells * sizeof(float), s);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((n + TM_HIST_THREADS - 1) / TM_HIST_THREADS, B);
    intensity_hist_kernel<<<grid, TM_HIST_THREADS, 0, s>>>(
        (const int*)labels, (const float*)img, (const float*)lo_full,
        (const float*)span_full, (float*)out, n, M, bins);
    return (int)cudaGetLastError();
}
