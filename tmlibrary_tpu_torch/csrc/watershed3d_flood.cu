// watershed3d_flood for Hopper.
//
// Replaces the TPU kernel `_watershed3d_kernel` / `_watershed3d_flood_jit`
// in tmlibrary_tpu/ops/pallas_kernels.py (API `watershed3d_flood`).  Same
// function as watershed_flood.cu on a (Z, H, W) volume with the full
// 26-neighbourhood: with mask' = mask | seeds > 0 and lo/hi the min/max
// of the intensity over mask', at each of `n_levels` descending levels
//     level_i = hi - span * (float)(i + 1) / n_levels   (f32, left to right)
// every unlabeled voxel of mask' with intensity >= level_i adopts the
// maximum label among its neighbours, repeated to convergence; then one
// more flood admits all of mask' (the mop-up).  Seeds keep their labels;
// the output is zero outside mask'.
//
// Design: one block of 1024 threads per volume.  The flood stays
// synchronous (Jacobi): each step reads the previous step's labels, or a
// tie between two growing labels would resolve differently from the
// reference.  Labels are double-buffered in global memory (the output
// volume and a scratch volume, 1 MB each at 16x128x128, L2-resident for
// a batch of 16); every thread swaps its two pointers after each step,
// and a step that changed no label (__syncthreads_or) ends the level.
// The level expression uses explicitly rounded intrinsics so no
// contraction can move a band edge.
//
// Bound: one read of intensity (4 B), seeds (4 B) and mask (1 B) and one
// write of the labels (4 B) per voxel; every Jacobi step re-reads and
// re-writes the label volumes in L2.  One block per volume keeps 16 of
// 132 SMs busy at a batch of 16.
#include "common.cuh"

__global__ void __launch_bounds__(TM_BLOCK)
watershed3d_kernel(const float* __restrict__ intensity, const int* __restrict__ seeds,
                   const uint8_t* __restrict__ mask, int* out_all, int* scratch_all,
                   int Z, int H, int W, int n_levels) {
    __shared__ float s_lo[TM_BLOCK / 32], s_hi[TM_BLOCK / 32];
    const int plane = H * W;
    const int n = Z * plane;
    const size_t base = (size_t)blockIdx.x * n;
    const float* I = intensity + base;
    const int* S = seeds + base;
    const uint8_t* M = mask + base;
    int* cur = out_all + base;
    int* nxt = scratch_all + base;

    float lo = INFINITY, hi = -INFINITY;
    for (int p = threadIdx.x; p < n; p += blockDim.x) {
        cur[p] = S[p];
        if (M[p] || S[p] > 0) {
            lo = fminf(lo, I[p]);
            hi = fmaxf(hi, I[p]);
        }
    }
    for (int off = 16; off > 0; off >>= 1) {
        lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, off));
        hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, off));
    }
    if ((threadIdx.x & 31) == 0) {
        s_lo[threadIdx.x >> 5] = lo;
        s_hi[threadIdx.x >> 5] = hi;
    }
    __syncthreads();
    lo = INFINITY;
    hi = -INFINITY;
    for (int i = 0; i < (int)(blockDim.x >> 5); ++i) {
        lo = fminf(lo, s_lo[i]);
        hi = fmaxf(hi, s_hi[i]);
    }
    const float span = fmaxf(__fsub_rn(hi, lo), 1e-6f);

    for (int li = 0; li <= n_levels; ++li) {
        const bool mop_up = li == n_levels;
        const float level = mop_up ? 0.0f
            : __fsub_rn(hi, __fdiv_rn(__fmul_rn(span, (float)(li + 1)), (float)n_levels));
        for (;;) {
            int changed = 0;
            for (int p = threadIdx.x; p < n; p += blockDim.x) {
                int l = cur[p];
                if (l == 0 && (M[p] || S[p] > 0) && (mop_up || I[p] >= level)) {
                    int z = p / plane, r = p - z * plane;
                    int y = r / W, x = r - y * W;
                    for (int dz = -1; dz <= 1; ++dz) {
                        int zz = z + dz;
                        if (zz < 0 || zz >= Z) continue;
                        for (int dy = -1; dy <= 1; ++dy) {
                            int yy = y + dy;
                            if (yy < 0 || yy >= H) continue;
                            const int* row = cur + (zz * H + yy) * W;
                            for (int dx = -1; dx <= 1; ++dx) {
                                int xx = x + dx;
                                if (xx < 0 || xx >= W) continue;
                                l = max(l, row[xx]);  // the voxel itself holds 0
                            }
                        }
                    }
                    changed |= l != 0;
                }
                nxt[p] = l;
            }
            int* t = cur;
            cur = nxt;
            nxt = t;
            if (!__syncthreads_or(changed)) break;
        }
    }

    int* out = out_all + base;
    for (int p = threadIdx.x; p < n; p += blockDim.x)
        out[p] = (M[p] || S[p] > 0) ? cur[p] : 0;
}

extern "C" int tm_watershed3d_flood(const void* intensity, const void* seeds,
                                    const void* mask, void* out, void* scratch, int B,
                                    int Z, int H, int W, int n_levels, void* stream) {
    watershed3d_kernel<<<B, TM_BLOCK, 0, (cudaStream_t)stream>>>(
        (const float*)intensity, (const int*)seeds, (const uint8_t*)mask, (int*)out,
        (int*)scratch, Z, H, W, n_levels);
    return (int)cudaGetLastError();
}
