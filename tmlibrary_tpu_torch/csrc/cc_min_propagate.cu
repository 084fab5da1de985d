// cc_min_propagate for Hopper.
//
// Replaces the TPU kernel `_cc_kernel` / `_cc_min_propagate_jit` in
// tmlibrary_tpu/ops/pallas_kernels.py (API `cc_min_propagate`).  Same
// function: every foreground pixel gets the minimum linear index of its
// `connectivity`-connected component, background gets TM_BIG (2**30).
// The compaction to scipy label order stays in PyTorch, as it stays in
// XLA in the JAX package (ops/label.py:182-188).
//
// Design: block union-find (cc_union_find.cuh), a site being a volume of
// one plane cut into 32x32 tiles: a 256x256 site is 64 tiles, a batch of
// 64 sites 4,096 blocks over every SM (the first design ran 64).
// Connectivity 4 is the 3-D face neighbourhood (6) on one plane, 8 the
// full one (26).  Phase 1, 512 threads a tile, starts each pixel at the
// first pixel of its run along the row (a warp ballot a row) and unions
// N (skipped where W and NW are foreground) and at 8 NW and NE (skipped
// where N is foreground) inside the tile in shared memory; phase 2
// unions the pairs that face each other across a tile edge or corner in
// global memory; phase 3 points every pixel at its root.
//
// Invariants (argued in full in cc_union_find.cuh): parent[p] <= p and
// in p's component; every label write while unions run is an atomicMin on
// a node found to be a root, and finds write nothing then, so no write
// raises a label or loses a concurrent union; phase 2 reads only what
// phase 1 wrote (a launch boundary); each component ends with one root,
// its minimum index, in whatever order the blocks run.
//
// Bound: one read of the 1-byte mask and one write of the 4-byte labels
// per pixel.
//
// `tm_cc_min_propagate_original` keeps the first design for the
// A/B harness alone: one block of 1024 threads a site, Gauss-Seidel
// sweeps of neighbour minima and pointer jumps over the plane in global
// memory until a sweep changes nothing; it writes each site's sweep
// count to `sweeps`.
#include "cc_union_find.cuh"

extern "C" int tm_cc_min_propagate(const void* mask, void* labels, int B, int H, int W,
                                   int connectivity, int phases, void* stream) {
    return tm_cc_union_find<1, 32, 32, 512>(mask, labels, B, 1, H, W, connectivity == 4 ? 6 : 26,
                                       phases, (cudaStream_t)stream);
}

// ------------------------------------------------------- the first design
__device__ __forceinline__ int cc_find_original(const int* lab, int r) {
    for (;;) {
        int up = lab[r];
        if (up >= r) return r;
        r = up;
    }
}

__global__ void __launch_bounds__(TM_BLOCK)
cc_kernel_original(const uint8_t* __restrict__ mask, int* sweeps, int* lab_all, int H, int W,
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
            int root = cc_find_original(lab, best);
            if (root < cur && atomicMin(&lab[p], root) > root) changed = 1;
            int old_root = cc_find_original(lab, cur);
            if (root < old_root && atomicMin(&lab[old_root], root) > root) changed = 1;
        }
        if (!__syncthreads_or(changed)) {
            if (threadIdx.x == 0) sweeps[blockIdx.x] = sweep + 1;
            break;
        }
    }
}

extern "C" int tm_cc_min_propagate_original(const void* mask, void* sweeps, void* labels, int B,
                                            int H, int W, int connectivity, void* stream) {
    if (B <= 0) return (int)cudaGetLastError();
    cc_kernel_original<<<B, TM_BLOCK, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)mask, (int*)sweeps, (int*)labels, H, W, connectivity == 4 ? 4 : 8);
    return (int)cudaGetLastError();
}
