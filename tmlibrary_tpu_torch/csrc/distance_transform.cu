// distance_transform for Hopper.
//
// Replaces the TPU kernel `_distance_kernel` / `distance_transform` in
// tmlibrary_tpu/ops/pallas_kernels.py (API `distance_transform`, the
// fixpoint of `distance_transform_approx`).  Same function: erosion
// counting with out-of-image pixels as foreground, at most
// `max_distance` erosions.  In closed form, a foreground pixel gets
//     dist = min(D, max_distance + 1)
// where D is the chessboard distance to the nearest background pixel
// inside the image (infinite if there is none); background gets 0.
// The output is float32, bit-exact (small whole numbers).
//
// Design: one block of 1024 threads per site, the site at one byte per
// pixel.  Background starts at 0 and foreground at the cap
// max_distance + 1; each sweep sets every foreground pixel to
// min(itself, 1 + the least of its in-image 8-neighbours).  Values only
// fall and never below the answer, whose min-plus fixpoint is unique, so
// the updates go in place and alternate direction; a sweep that changes
// nothing (__syncthreads_or) ends the loop, after about max D + 1 sweeps.
// (A read that misses a write of the same sweep only delays the fixpoint:
// a quiet sweep saw no write, so it read the state it proves fixed.)  One
// pass then writes float32.  Two routes, picked from the shape
// (ops/kernels.py `distance_plan`):
//   on chip (`tm_distance_transform`): the plane in dynamic shared memory,
//     for sites of at most 232,448 pixels (a 256x256 site is 64 KB);
//   global (`tm_distance_transform_global`): the same sweeps on a plane
//     of the wrapper's scratch in global memory (L2), for larger sites.
//
// Bound: one read of the 1-byte mask and one write of the 4-byte
// distance per pixel; on chip every sweep stays in shared memory.
#include "common.cuh"

// The sweeps of one site whose plane `d` holds 0 and the cap.
__device__ __forceinline__ void distance_sweeps(uint8_t* d, int H, int W) {
    const int n = H * W;
    for (int sweep = 0;; ++sweep) {
        int changed = 0;
        for (int k = 0; k < n; k += blockDim.x) {
            if (k + (int)threadIdx.x >= n) break;
            int p = tm_sweep_pixel(k, threadIdx.x, n, sweep);
            int cur = d[p];
            if (cur == 0) continue;
            int y = p / W, x = p - y * W;
            int least = cur;
            for (int j = 0; j < 8; ++j) {
                int yy = y + tm_dy(j), xx = x + tm_dx(j);
                if (yy < 0 || yy >= H || xx < 0 || xx >= W) continue;
                least = min(least, (int)d[yy * W + xx]);
            }
            if (least + 1 < cur) {
                d[p] = (uint8_t)(least + 1);
                changed = 1;
            }
        }
        if (!__syncthreads_or(changed)) break;
    }
}

// One site: the plane `d` (shared or global) from the mask, the sweeps,
// the float32 output.
__device__ __forceinline__ void distance_site(const uint8_t* __restrict__ mask,
                                              float* __restrict__ out, uint8_t* d, int H,
                                              int W, int cap) {
    const int n = H * W;
    for (int p = threadIdx.x; p < n; p += blockDim.x)
        d[p] = mask[p] ? (uint8_t)cap : (uint8_t)0;
    __syncthreads();
    distance_sweeps(d, H, W);
    for (int p = threadIdx.x; p < n; p += blockDim.x) out[p] = (float)d[p];
}

__global__ void __launch_bounds__(TM_BLOCK)
distance_kernel(const uint8_t* __restrict__ mask, float* __restrict__ out, int H, int W,
                int cap) {
    extern __shared__ uint8_t d[];
    const size_t base = (size_t)blockIdx.x * H * W;
    distance_site(mask + base, out + base, d, H, W, cap);
}

__global__ void __launch_bounds__(TM_BLOCK)
distance_global_kernel(const uint8_t* __restrict__ mask, uint8_t* __restrict__ plane,
                       float* __restrict__ out, int H, int W, int cap) {
    const size_t base = (size_t)blockIdx.x * H * W;
    distance_site(mask + base, out + base, plane + base, H, W, cap);
}

extern "C" int tm_distance_transform(const void* mask, void* out, int B, int H, int W,
                                     int max_distance, void* stream) {
    const int smem = H * W;
    cudaError_t err = cudaFuncSetAttribute(
        distance_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    distance_kernel<<<B, TM_BLOCK, smem, (cudaStream_t)stream>>>(
        (const uint8_t*)mask, (float*)out, H, W, max_distance + 1);
    return (int)cudaGetLastError();
}

extern "C" int tm_distance_transform_global(const void* mask, void* plane, void* out, int B,
                                            int H, int W, int max_distance, void* stream) {
    distance_global_kernel<<<B, TM_BLOCK, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)mask, (uint8_t*)plane, (float*)out, H, W, max_distance + 1);
    return (int)cudaGetLastError();
}
