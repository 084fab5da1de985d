// fill_holes_flood for Hopper.
//
// Replaces the TPU kernel `_fill_kernel` / `_fill_holes_jit` in
// tmlibrary_tpu/ops/pallas_kernels.py (API `fill_holes_flood`).  Same
// function: background pixels reached from the image border through
// `connectivity`-connected background stay background; every other
// pixel is foreground (scipy `binary_fill_holes` at connectivity 4).
//
// Design: one block of 1024 threads per site.  The "reached" flags live
// in a (B, H, W) uint8 scratch plane in global memory (L2-resident, see
// common.cuh).  The reached set is a unique fixpoint (the set grows
// monotonically), so sweeps update it in place (Gauss-Seidel) and
// alternate direction; a sweep in which no thread changed a flag
// (__syncthreads_or) ends the loop.
//
// Bound: the function must read the mask and write the output once,
// 2 bytes a pixel; the sweep count (about the longest background path
// from the border divided by the in-place reach of one sweep) multiplies
// the L2 traffic, which is what bounds this first design.
#include "common.cuh"

__global__ void __launch_bounds__(TM_BLOCK)
fill_holes_kernel(const uint8_t* __restrict__ mask, uint8_t* __restrict__ out,
                  uint8_t* reach, int H, int W, int n_neigh) {
    const int n = H * W;
    const size_t base = (size_t)blockIdx.x * n;
    const uint8_t* m = mask + base;
    uint8_t* r = reach + base;
    uint8_t* o = out + base;

    for (int p = threadIdx.x; p < n; p += blockDim.x) {
        int y = p / W, x = p - y * W;
        bool border = y == 0 || y == H - 1 || x == 0 || x == W - 1;
        r[p] = (!m[p] && border) ? 1 : 0;
    }
    __syncthreads();

    for (int sweep = 0;; ++sweep) {
        int changed = 0;
        for (int k = 0; k < n; k += blockDim.x) {
            if (k + (int)threadIdx.x >= n) break;
            int p = tm_sweep_pixel(k, threadIdx.x, n, sweep);
            if (m[p] || r[p]) continue;
            int y = p / W, x = p - y * W;
            for (int j = 0; j < n_neigh; ++j) {
                int yy = y + tm_dy(j), xx = x + tm_dx(j);
                if (yy < 0 || yy >= H || xx < 0 || xx >= W) continue;
                if (r[yy * W + xx]) {
                    r[p] = 1;
                    changed = 1;
                    break;
                }
            }
        }
        if (!__syncthreads_or(changed)) break;
    }

    for (int p = threadIdx.x; p < n; p += blockDim.x)
        o[p] = (m[p] || !r[p]) ? 1 : 0;
}

extern "C" int tm_fill_holes(const void* mask, void* out, void* reach,
                             int B, int H, int W, int connectivity,
                             void* stream) {
    fill_holes_kernel<<<B, TM_BLOCK, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)mask, (uint8_t*)out, (uint8_t*)reach, H, W,
        connectivity == 8 ? 8 : 4);
    return (int)cudaGetLastError();
}
