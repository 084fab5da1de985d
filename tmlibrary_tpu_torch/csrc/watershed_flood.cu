// watershed_flood for Hopper.
//
// Replaces the TPU kernel `_watershed_kernel` / `_watershed_flood_jit` in
// tmlibrary_tpu/ops/pallas_kernels.py (API `watershed_flood`).  Same
// function: with mask' = mask | seeds > 0 and lo/hi the min/max of the
// intensity over mask', at each of `n_levels` descending levels
//     level_i = hi - span * (float)(i + 1) / n_levels   (f32, left to right)
// every unlabeled pixel of mask' with intensity >= level_i adopts the
// maximum label among its neighbours, repeated to convergence; then one
// more flood admits all of mask' (the mop-up).  Seeds keep their labels;
// the output is zero outside mask'.
//
// Design: one block of 1024 threads per site.  The flood must stay
// synchronous (Jacobi): each step reads the previous step's labels, or a
// tie between two growing labels would resolve differently from the
// reference.  So labels are double-buffered in global memory (the output
// plane and a scratch plane, L2-resident, see common.cuh); every thread
// swaps its two pointers after each step, and a step that changed no
// label (__syncthreads_or) ends the level.  The level expression uses
// explicitly rounded intrinsics so no contraction can move a band edge.
//
// Bound: one read of intensity (4 B), seeds (4 B) and mask (1 B) and one
// write of the labels (4 B) per pixel; every Jacobi step re-reads and
// re-writes the label planes in L2, and the step count is the sum over
// levels of how far each band grows, plus one quiet step per level.
#include "common.cuh"

__global__ void __launch_bounds__(TM_BLOCK)
watershed_kernel(const float* __restrict__ intensity, const int* __restrict__ seeds,
                 const uint8_t* __restrict__ mask, int* out_all, int* scratch_all,
                 int H, int W, int n_levels, int n_neigh) {
    __shared__ float s_lo[TM_BLOCK / 32], s_hi[TM_BLOCK / 32];
    const int n = H * W;
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
                    int y = p / W, x = p - y * W;
                    for (int j = 0; j < n_neigh; ++j) {
                        int yy = y + tm_dy(j), xx = x + tm_dx(j);
                        if (yy < 0 || yy >= H || xx < 0 || xx >= W) continue;
                        l = max(l, cur[yy * W + xx]);
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

extern "C" int tm_watershed_flood(const void* intensity, const void* seeds,
                                  const void* mask, void* out, void* scratch,
                                  int B, int H, int W, int n_levels,
                                  int connectivity, void* stream) {
    watershed_kernel<<<B, TM_BLOCK, 0, (cudaStream_t)stream>>>(
        (const float*)intensity, (const int*)seeds, (const uint8_t*)mask,
        (int*)out, (int*)scratch, H, W, n_levels, connectivity == 4 ? 4 : 8);
    return (int)cudaGetLastError();
}
