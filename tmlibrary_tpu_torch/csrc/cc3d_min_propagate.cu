// cc3d_min_propagate for Hopper.
//
// Replaces the TPU kernel `_cc3d_kernel` / `_cc3d_min_propagate_jit` in
// tmlibrary_tpu/ops/pallas_kernels.py (API `cc3d_min_propagate`).  Same
// function: every foreground voxel of a (Z, H, W) volume gets the
// minimum linear index of its `connectivity`-connected component (6, 18
// or 26), background gets TM_BIG (2**30).  The compaction to scipy label
// order stays in PyTorch (tmlibrary_tpu_torch/ops/volume.py), as it
// stays in XLA in the JAX package (ops/volume.py:152-157).
//
// Design: the 3-D case of cc_min_propagate.cu.  One block of 1024
// threads per volume; labels live in the output volume in global memory
// (a 16x128x128 int32 volume is 1 MB, a batch of 16 stays in L2).  Each
// sweep takes, for every foreground voxel, the minimum label of itself
// and its neighbours, follows label pointers to that label's root
// (union-find "find": a label is always the index of a voxel of the same
// component, never above the voxel's own index) and links the voxel's
// old root to the new one.  Every write is an atomicMin, so labels only
// fall and the in-place sweeps land on the unique fixpoint; a sweep that
// changes nothing (__syncthreads_or) ends the loop.
//
// Bound: one read of the 1-byte mask and one write of the 4-byte labels
// per voxel; every extra sweep re-reads the volume from L2.  One block
// per volume keeps 16 of 132 SMs busy at a batch of 16.
#include "common.cuh"

__device__ __forceinline__ int cc3d_find(const int* lab, int r) {
    for (;;) {
        int up = lab[r];
        if (up >= r) return r;
        r = up;
    }
}

__global__ void __launch_bounds__(TM_BLOCK)
cc3d_kernel(const uint8_t* __restrict__ mask, int* lab_all, int Z, int H, int W,
            int connectivity) {
    const int plane = H * W;
    const int n = Z * plane;
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
            int z = p / plane, r = p - z * plane;
            int y = r / W, x = r - y * W;
            for (int dz = -1; dz <= 1; ++dz) {
                int zz = z + dz;
                if (zz < 0 || zz >= Z) continue;
                for (int dy = -1; dy <= 1; ++dy) {
                    int yy = y + dy;
                    if (yy < 0 || yy >= H) continue;
                    for (int dx = -1; dx <= 1; ++dx) {
                        int xx = x + dx;
                        if (xx < 0 || xx >= W || !tm_neighbour3(dz, dy, dx, connectivity))
                            continue;
                        best = min(best, lab[(zz * H + yy) * W + xx]);  // background is TM_BIG
                    }
                }
            }
            int root = cc3d_find(lab, best);
            if (root < cur && atomicMin(&lab[p], root) > root) changed = 1;
            int old_root = cc3d_find(lab, cur);
            if (root < old_root && atomicMin(&lab[old_root], root) > root) changed = 1;
        }
        if (!__syncthreads_or(changed)) break;
    }
}

extern "C" int tm_cc3d_min_propagate(const void* mask, void* labels, int B, int Z,
                                     int H, int W, int connectivity, void* stream) {
    cc3d_kernel<<<B, TM_BLOCK, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)mask, (int*)labels, Z, H, W, connectivity);
    return (int)cudaGetLastError();
}
