// cc_min_propagate for Hopper.
//
// Replaces the TPU kernel `_cc_kernel` / `_cc_min_propagate_jit` in
// tmlibrary_tpu/ops/pallas_kernels.py (API `cc_min_propagate`).  Same
// function: every foreground pixel gets the minimum linear index of its
// `connectivity`-connected component, background gets TM_BIG (2**30).
// The compaction to scipy label order stays in PyTorch, as it stays in
// XLA in the JAX package (ops/label.py:182-188).
//
// Design: one block of 1024 threads per site; labels live in the output
// plane in global memory (L2-resident, see common.cuh).  Each sweep
// takes, for every foreground pixel, the minimum label of itself and
// its neighbours, follows label pointers to that label's root
// (union-find "find": a label is always the index of a pixel of the same
// component, never above the pixel's own index) and links the pixel's
// old root to the new one.  Every write is an atomicMin, so labels only
// decrease, and the in-place (Gauss-Seidel) updates still land on the
// unique fixpoint, the component's minimum index; a sweep that changes
// nothing (__syncthreads_or) ends the loop.  Pointer jumping makes the
// sweep count grow with the log of a component's extent rather than
// with its path length (the serpentine case of the TPU tests).
//
// Bound: one read of the 1-byte mask and one write of the 4-byte
// labels per pixel; every extra sweep re-reads the plane from L2.
#include "common.cuh"

__device__ __forceinline__ int cc_find(const int* lab, int r) {
    for (;;) {
        int up = lab[r];
        if (up >= r) return r;
        r = up;
    }
}

__global__ void __launch_bounds__(TM_BLOCK)
cc_kernel(const uint8_t* __restrict__ mask, int* lab_all, int H, int W,
          int n_neigh) {
    const int n = H * W;
    const size_t base = (size_t)blockIdx.x * n;
    const uint8_t* m = mask + base;
    int* lab = lab_all + base;

    for (int p = threadIdx.x; p < n; p += blockDim.x) lab[p] = m[p] ? p : TM_BIG;
    __syncthreads();

    for (int sweep = 0;; ++sweep) {
        int changed = 0;
        for (int k = 0; k < n; k += blockDim.x) {
            if (k + (int)threadIdx.x >= n) break;
            int p = tm_sweep_pixel(k, threadIdx.x, n, sweep);
            if (!m[p]) continue;
            int cur = lab[p];
            int best = cur;
            int y = p / W, x = p - y * W;
            for (int j = 0; j < n_neigh; ++j) {
                int yy = y + tm_dy(j), xx = x + tm_dx(j);
                if (yy < 0 || yy >= H || xx < 0 || xx >= W) continue;
                best = min(best, lab[yy * W + xx]);  // background is TM_BIG
            }
            int root = cc_find(lab, best);
            if (root < cur && atomicMin(&lab[p], root) > root) changed = 1;
            int old_root = cc_find(lab, cur);
            if (root < old_root && atomicMin(&lab[old_root], root) > root) changed = 1;
        }
        if (!__syncthreads_or(changed)) break;
    }
}

extern "C" int tm_cc_min_propagate(const void* mask, void* labels, int B, int H,
                                   int W, int connectivity, void* stream) {
    cc_kernel<<<B, TM_BLOCK, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)mask, (int*)labels, H, W, connectivity == 4 ? 4 : 8);
    return (int)cudaGetLastError();
}
