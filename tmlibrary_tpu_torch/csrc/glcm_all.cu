// glcm_all for Hopper.
//
// Replaces the TPU kernel `_glcm_kernel` / `_glcm_call` in
// tmlibrary_tpu/ops/fused_measure.py (API `glcm_all`).  Same function:
// for each of up to 4 offsets (dy, dx) and each object id 1..M, the
// gray-level co-occurrence counts of pixel pairs p = (y, x) and
// p' = (y - dy, x - dx) that both lie in the image and carry the same
// label, both pixels quantised with the object's own bounds by
// tm_quantize (quantize_per_object's expression); then symmetrised,
// c + c^T, as the JAX wrapper does after its kernel.  The partner
// follows from the reference's lab2 = shift_with_fill(labels, -dy, -dx),
// i.e. lab2[y, x] = labels[y - dy, x - dx].
//
// Design: one thread per pixel on a grid of (pixel chunks, sites).  The
// thread quantises its own pixel once, reads each direction's partner
// straight from the label and image planes (no shifted copies of the
// batch, unlike the TPU wrapper), and adds 1.0f at both [q1][q2] and
// [q2][q1] of the zeroed float32 output (B, D, M, L, L) with atomicAdd,
// which is c + c^T directly: one memset and one launch per call.  Whole
// numbers below 2^24 add exactly in any order (a cell gets at most 2 per
// pixel), so the result is bit-identical to the plain version and
// run-to-run deterministic.  At M=256, L=16 the table is 1 MB per site,
// so it lives in L2/HBM.
//
// Bound: bytes.  Labels and values are read once (8 B a pixel; the
// partners are neighbours, served from L1/L2) and the table written once
// (4 B a cell, 4 x M x L x L cells a site).
#include "common.cuh"

#define TM_GLCM_THREADS 256
#define TM_GLCM_MAX_DIRS 4

struct GlcmOffsets {
    int dy[TM_GLCM_MAX_DIRS];
    int dx[TM_GLCM_MAX_DIRS];
};

__global__ void __launch_bounds__(TM_GLCM_THREADS)
glcm_pairs_kernel(const int* __restrict__ labels, const float* __restrict__ img,
                  const float* __restrict__ lo_full, const float* __restrict__ span_full,
                  float* counts, int H, int W, int M, int L, int D, GlcmOffsets off) {
    int n = H * W;
    int p = blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= n) return;
    size_t site = blockIdx.y;
    const int* lab = labels + site * n;
    const float* val = img + site * n;
    int l = lab[p];
    if (l < 1 || l > M) return;
    size_t row = site * (M + 1) + l;
    float lo = lo_full[row], span = span_full[row];
    int q1 = tm_quantize(val[p], lo, span, L);
    int y = p / W, x = p - y * W;
    for (int d = 0; d < D; ++d) {
        int y2 = y - off.dy[d], x2 = x - off.dx[d];
        if (y2 < 0 || y2 >= H || x2 < 0 || x2 >= W) continue;
        int p2 = y2 * W + x2;
        if (lab[p2] != l) continue;
        int q2 = tm_quantize(val[p2], lo, span, L);
        float* glcm = counts + (((site * D + d) * M + (l - 1)) * L) * L;
        atomicAdd(&glcm[q1 * L + q2], 1.0f);
        atomicAdd(&glcm[q2 * L + q1], 1.0f);
    }
}

extern "C" int tm_glcm_all(const void* labels, const void* img, const void* lo_full,
                           const void* span_full, void* out, int B, int H, int W, int M,
                           int L, int D, int dy0, int dx0, int dy1, int dx1, int dy2,
                           int dx2, int dy3, int dx3, void* stream) {
    if (B < 1 || B > 65535 || M < 1 || L < 2 || D < 1 || D > TM_GLCM_MAX_DIRS)
        return (int)cudaErrorInvalidValue;
    GlcmOffsets off = {{dy0, dy1, dy2, dy3}, {dx0, dx1, dx2, dx3}};
    cudaStream_t s = (cudaStream_t)stream;
    int n = H * W;
    size_t cells = (size_t)B * D * M * L * L;
    cudaError_t err = cudaMemsetAsync(out, 0, cells * sizeof(float), s);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((n + TM_GLCM_THREADS - 1) / TM_GLCM_THREADS, B);
    glcm_pairs_kernel<<<grid, TM_GLCM_THREADS, 0, s>>>(
        (const int*)labels, (const float*)img, (const float*)lo_full,
        (const float*)span_full, (float*)out, H, W, M, L, D, off);
    return (int)cudaGetLastError();
}
