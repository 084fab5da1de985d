// grouped_stats for Hopper.
//
// Replaces the TPU kernel `_stats_kernel` / `_stats_call` in
// tmlibrary_tpu/ops/fused_measure.py (API `grouped_stats`).  Same
// function: per object id 1..K (K = max_objects, background and ids
// outside 1..K dropped) the sum, min and max of each of C pixel
// channels; absent objects give (0, +inf, -inf).
//
// Design: one block of 1024 threads per site, two phases.
//   1. Every pixel with a label in 1..K widens its object's bounding box
//      (shared-memory integer atomicMin/atomicMax: exact, order-free).
//   2. One thread per object walks its bounding box in row-major pixel
//      order and accumulates its own pixels sequentially.
// So each object's sum is the left-to-right float32 sum in pixel order:
// the same order as the reference's scatter-add on the CPU, bit for bit,
// and run-to-run deterministic (no float atomics).  Counts and integer
// valued sums are exact; min and max are exact in any order.  A row
// depends only on its own object's pixels, so rows 1..n do not depend on
// K (the capacity-invariance contract of ops/reduction.py).
//
// Bound: one read of the labels (4 B) and the C channels (4 B each) per
// pixel.  Phase 2 reads each object's bounding box once more; it is
// latency-bound with one thread per object and one block per site.
#include "common.cuh"

#define TM_MAX_CHANNELS 8

__global__ void __launch_bounds__(TM_BLOCK)
grouped_stats_kernel(const int* __restrict__ labels, const float* __restrict__ values,
                     float* sums, float* mins, float* maxs, int H, int W, int C,
                     int K) {
    extern __shared__ int box[];  // 4 * K: ymin, ymax, xmin, xmax
    int* ymin = box;
    int* ymax = box + K;
    int* xmin = box + 2 * K;
    int* xmax = box + 3 * K;
    const int n = H * W;
    const int* lab = labels + (size_t)blockIdx.x * n;
    const float* val = values + (size_t)blockIdx.x * C * n;

    for (int k = threadIdx.x; k < K; k += blockDim.x) {
        ymin[k] = H;
        ymax[k] = -1;
        xmin[k] = W;
        xmax[k] = -1;
    }
    __syncthreads();
    for (int p = threadIdx.x; p < n; p += blockDim.x) {
        int l = lab[p];
        if (l < 1 || l > K) continue;
        int y = p / W, x = p - y * W;
        atomicMin(&ymin[l - 1], y);
        atomicMax(&ymax[l - 1], y);
        atomicMin(&xmin[l - 1], x);
        atomicMax(&xmax[l - 1], x);
    }
    __syncthreads();

    for (int k = threadIdx.x; k < K; k += blockDim.x) {
        float s[TM_MAX_CHANNELS], lo[TM_MAX_CHANNELS], hi[TM_MAX_CHANNELS];
        for (int c = 0; c < C; ++c) {
            s[c] = 0.0f;
            lo[c] = INFINITY;
            hi[c] = -INFINITY;
        }
        for (int y = ymin[k]; y <= ymax[k]; ++y) {
            for (int x = xmin[k]; x <= xmax[k]; ++x) {
                int p = y * W + x;
                if (lab[p] != k + 1) continue;
                for (int c = 0; c < C; ++c) {
                    float v = val[(size_t)c * n + p];
                    s[c] = __fadd_rn(s[c], v);
                    lo[c] = fminf(lo[c], v);
                    hi[c] = fmaxf(hi[c], v);
                }
            }
        }
        size_t row = ((size_t)blockIdx.x * K + k) * C;
        for (int c = 0; c < C; ++c) {
            sums[row + c] = s[c];
            mins[row + c] = lo[c];
            maxs[row + c] = hi[c];
        }
    }
}

extern "C" int tm_grouped_stats(const void* labels, const void* values, void* sums,
                                void* mins, void* maxs, int B, int H, int W, int C,
                                int K, void* stream) {
    if (C < 1 || C > TM_MAX_CHANNELS) return (int)cudaErrorInvalidValue;
    size_t smem = 4 * (size_t)K * sizeof(int);
    if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
    grouped_stats_kernel<<<B, TM_BLOCK, smem, (cudaStream_t)stream>>>(
        (const int*)labels, (const float*)values, (float*)sums, (float*)mins,
        (float*)maxs, H, W, C, K);
    return (int)cudaGetLastError();
}
