// Shared helpers for the port's hand-written Hopper kernels.
//
// Layout convention: every kernel takes a batch of sites laid out as
// (B, H, W) contiguous arrays and launches one block per site
// (grid = B).  A 256x256 int32 site is 256 KB, more than the 227 KB of
// shared memory one block can use, so the fixpoint kernels iterate over
// the site in global memory; a batch of 64 sites with two 256 KB planes
// each is ~33 MB and stays resident in the 50 MB L2.  Keeping a site on
// chip (a narrower label type, or a thread-block cluster sharing
// distributed shared memory) is later work.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define TM_BLOCK 1024

// "no label yet" in min-propagation (tmlibrary_tpu/ops/pallas_kernels.py BIG)
#define TM_BIG (1 << 30)

// Neighbour j's offset: j < 4 is the 4-neighbourhood (up, down, left,
// right), j < 8 adds the diagonals.
__device__ __forceinline__ int tm_dy(int j) {
    return j == 0 ? -1 : j == 1 ? 1 : j < 4 ? 0 : j < 6 ? -1 : 1;
}
__device__ __forceinline__ int tm_dx(int j) {
    return j < 2 ? 0 : j == 2 ? -1 : j == 3 ? 1 : (j & 1) ? 1 : -1;
}

// Whether the 3-D offset (dz, dy, dx) is a neighbour at `connectivity`
// 6 (faces), 18 (faces and edges) or 26 (the full cube).
__device__ __forceinline__ bool tm_neighbour3(int dz, int dy, int dx, int connectivity) {
    int nonzero = (dz != 0) + (dy != 0) + (dx != 0);
    return nonzero > 0 && (connectivity == 26 || nonzero < 2 ||
                           (connectivity == 18 && nonzero == 2));
}

// Pixel visited by thread `t` at step `k` of a sweep.  Odd sweeps walk
// the site backwards, so in-place floods travel both ways quickly.
__device__ __forceinline__ int tm_sweep_pixel(int k, int t, int n, int sweep) {
    int i = k + t;
    return (sweep & 1) ? n - 1 - i : i;
}

// Per-object gray-level stretch, the expression of quantize_per_object
// (tmlibrary_tpu/ops/measure.py:835) and of the TPU kernels
// _hist_kernel / _glcm_kernel:
//     floor((v - lo) * (levels - 1) / max(span, 1e-6)), clipped to
//     [0, levels - 1].
// Rounded intrinsics keep the operation order (subtract, multiply,
// divide) and forbid contraction, so every bucket is bit-identical to
// the CPU's.
__device__ __forceinline__ int tm_quantize(float v, float lo, float span, int levels) {
    float top = (float)(levels - 1);
    float q = floorf(__fdiv_rn(__fmul_rn(__fsub_rn(v, lo), top), fmaxf(span, 1e-6f)));
    return (int)fminf(fmaxf(q, 0.0f), top);
}
