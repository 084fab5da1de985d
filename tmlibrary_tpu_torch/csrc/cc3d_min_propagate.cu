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
// Design: block union-find (cc_union_find.cuh) over tiles of 2x16x32
// voxels: a 16x128x128 volume is 256 tiles, the volume path's batch of 16
// is 4,096 blocks over every SM (the first design ran 16).  Phase 1, 256
// threads a tile, starts each voxel at the first voxel of its run along
// x (a warp ballot a tile row) and unions the other 2, 8 or 12 backward
// neighbours inside the tile in shared memory (two 16-byte loads a tile
// row where W % 16 == 0); phase 2 unions the voxels that face each
// other across a tile face, edge or corner in global memory; phase 3
// points every voxel at its root.  Where the voxel below is foreground,
// the other neighbours in the plane below are implied and skipped.
//
// Invariants (argued in full in cc_union_find.cuh): parent[p] <= p and
// in p's component; every label write while unions run is an atomicMin on
// a node found to be a root, and finds write nothing then, so no write
// raises a label or loses a concurrent union; phase 2 reads only what
// phase 1 wrote (a launch boundary); each component ends with one root,
// its minimum index, in whatever order the blocks run.
//
// Bound: one read of the 1-byte mask and one write of the 4-byte labels
// per voxel.
//
// `tm_cc3d_min_propagate_original` keeps the first design for the
// A/B harness alone: one block of 1024 threads a volume, Gauss-Seidel
// sweeps of neighbour minima and pointer jumps in global memory until a
// sweep changes nothing; it writes each volume's sweep count to
// `sweeps`.
#include "cc_union_find.cuh"

extern "C" int tm_cc3d_min_propagate(const void* mask, void* labels, int B, int Z, int H,
                                     int W, int connectivity, int phases, void* stream) {
    return tm_cc_union_find<2, 16, 32, 256>(mask, labels, B, Z, H, W, connectivity, phases,
                                       (cudaStream_t)stream);
}

// ------------------------------------------------------- the first design
__device__ __forceinline__ int cc3d_find_original(const int* lab, int r) {
    for (;;) {
        int up = lab[r];
        if (up >= r) return r;
        r = up;
    }
}

__global__ void __launch_bounds__(TM_BLOCK)
cc3d_kernel_original(const uint8_t* __restrict__ mask, int* sweeps, int* lab_all, int Z, int H,
                     int W, int connectivity) {
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
            int root = cc3d_find_original(lab, best);
            if (root < cur && atomicMin(&lab[p], root) > root) changed = 1;
            int old_root = cc3d_find_original(lab, cur);
            if (root < old_root && atomicMin(&lab[old_root], root) > root) changed = 1;
        }
        if (!__syncthreads_or(changed)) {
            if (threadIdx.x == 0) sweeps[blockIdx.x] = sweep + 1;
            break;
        }
    }
}

extern "C" int tm_cc3d_min_propagate_original(const void* mask, void* sweeps, void* labels,
                                              int B, int Z, int H, int W, int connectivity,
                                              void* stream) {
    if (B <= 0) return (int)cudaGetLastError();
    cc3d_kernel_original<<<B, TM_BLOCK, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)mask, (int*)sweeps, (int*)labels, Z, H, W, connectivity);
    return (int)cudaGetLastError();
}
