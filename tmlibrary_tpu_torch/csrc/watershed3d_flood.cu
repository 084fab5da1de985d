// watershed3d_flood for Hopper.
//
// Replaces the TPU kernel `_watershed3d_kernel` / `_watershed3d_flood_jit`
// in tmlibrary_tpu/ops/pallas_kernels.py (API `watershed3d_flood`).  Same
// function as watershed_flood.cu on a (Z, H, W) volume with the full
// 26-neighbourhood: with mask' = mask | seeds > 0 and lo/hi the min/max
// of the intensity over mask' (NaN propagating), at each of `n_levels`
// descending levels
//     level_i = hi - span * (float)(i + 1) / n_levels   (f32, left to right)
// every unlabeled voxel of mask' with intensity >= level_i adopts the
// maximum label among its neighbours, repeated to convergence (Jacobi: a
// tie between two growing labels goes to the larger); then one more flood
// admits all of mask' (the mop-up).  Seeds keep their labels, a negative
// seed never spreads; the output is zero outside mask'.  The level
// expression uses explicitly rounded intrinsics so no contraction can
// move a band edge.
//
// Two routes; the wrapper picks one from n_levels (ops/volume.py
// `watershed3d_plan`).
//
// Cluster (`tm_watershed3d_flood`): one thread-block cluster of 8 blocks
// of 512 threads per volume (128 of the 132 SMs' worth of blocks at a
// batch of 16), the labels in place in the int32 output and a band byte a
// voxel (its first eligible level, n_levels for the mop-up, 255 for
// never) in global memory, read and written through L2 (__ldcg/__stcg),
// with a cluster barrier between phases.  This is the frontier flood of
// watershed_flood.cu's on-chip route: two passes over the inputs (lo/hi,
// then the bands by binary search over the levels); a level starts with
// one scan for its newly eligible voxels (16 band bytes a thread a load
// where the volume allows); then, within the level, Jacobi
// step t+1 labels exactly the unlabeled eligible voxels next to a voxel
// labelled at step t, each claimed by the listed voxel its largest label
// comes from (no atomics on labels): the claim sets it to PENDING (read as
// 0), stores the direction of that neighbour in its band byte and lists
// it; after a barrier every claimed voxel copies that neighbour's label.
// A voxel is claimed at most once (it leaves 0 for good), so a step never
// lists more voxels than the volume holds: each of the two lists in
// global memory is as long as the volume and never overflows.  Labels
// stay int32, so any seed id runs on this route.
//
// Global (`tm_watershed3d_flood_global`): the first design, for more than
// 254 levels (the band byte holds 0..254 and 255) -- one block of 1024
// threads per volume, labels double-buffered in global memory, every step
// a scan of the whole volume; a step that changed no label
// (__syncthreads_or) ends the level.
//
// Bound: one read of intensity (4 B), seeds (4 B) and mask (1 B) and one
// write of the labels (4 B) per voxel.  The cluster route reads the inputs
// twice, one band byte a voxel a level, and then only the frontier: what
// remains is its serial chain of two cluster barriers a step.
#include <climits>
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

#define W3_CLUSTER 8
#define W3_THREADS 512
#define W3_PENDING INT_MIN
#define W3_NEVER 0xFF
#define W3_MAX_LEVELS 254
// per-volume words of `misc`: 3 list counts, then lo/hi of each block
#define W3_MISC 32
#define W3_PART 8

// Neighbour j (0..25) of the 26-neighbourhood: the offsets (dz, dy, dx)
// in lexicographic order without (0, 0, 0).  The opposite of j is 25 - j.
__device__ __forceinline__ void w3_offset(int j, int& dz, int& dy, int& dx) {
    const int i = j < 13 ? j : j + 1;
    dz = i / 9 - 1;
    dy = (i / 3) % 3 - 1;
    dx = i % 3 - 1;
}

struct W3Volume {
    int Z, H, W, n, plane;
    const float* I;
    const int* S;
    const uint8_t* M;
    int* lab;
    uint8_t* band;
    int* lists;  // 2 * n
    int* misc;
};

// First level i in [0, n) with v >= level[i] (levels never rise), else n.
__device__ __forceinline__ int w3_band(float v, const float* level, int n) {
    int a = 0, b = n;
    while (a < b) {
        int mid = (a + b) >> 1;
        if (v >= level[mid])
            b = mid;
        else
            a = mid + 1;
    }
    return a;
}

// Largest label among the neighbours of voxel p at (z, y, x) (PENDING and
// negative seeds count as 0) and the direction of the first holding it.
__device__ __forceinline__ int w3_best(const W3Volume& v, int p, int z, int y, int x,
                                       int* dir) {
    int best = 0;
    for (int j = 0; j < 26; ++j) {
        int dz, dy, dx;
        w3_offset(j, dz, dy, dx);
        const int zz = z + dz, yy = y + dy, xx = x + dx;
        if (zz < 0 || zz >= v.Z || yy < 0 || yy >= v.H || xx < 0 || xx >= v.W) continue;
        const int l = __ldcg(v.lab + p + (dz * v.H + dy) * v.W + dx);
        if (l > best) {
            best = l;
            *dir = j;
        }
    }
    return best;
}

// List q, one atomic for the lanes of a warp that append at this point.
__device__ __forceinline__ void w3_append(int q, int* list, int* count) {
    const cg::coalesced_group lanes = cg::coalesced_threads();
    int first = 0;
    if (lanes.thread_rank() == 0) first = atomicAdd(count, (int)lanes.size());
    __stcg(list + lanes.shfl(first, 0) + (int)lanes.thread_rank(), q);
}

__device__ __forceinline__ void w3_claim(const W3Volume& v, int q, int dir, int* list,
                                         int* count) {
    __stcg(v.lab + q, W3_PENDING);
    __stcg(v.band + q, (uint8_t)dir);
    w3_append(q, list, count);
}

// Claim every unlabeled voxel of band `li` that has a labelled neighbour
// (the start of level li); the cluster's threads split the volume.
__device__ __forceinline__ void w3_scan_voxel(const W3Volume& v, int p, int* list, int* count) {
    if (__ldcg(v.lab + p) != 0) return;
    const int z = p / v.plane, r = p - z * v.plane, y = r / v.W, x = r - y * v.W;
    int dir = 0;
    if (w3_best(v, p, z, y, x, &dir) > 0) w3_claim(v, p, dir, list, count);
}

__device__ void w3_claim_scan(const W3Volume& v, int rank_thread, int* list, int* count,
                              int li) {
    if ((v.n & 15) == 0 && ((uintptr_t)v.band & 15) == 0) {
        const uint32_t key = 0x01010101u * (uint32_t)li;
        for (int g = rank_thread; g < (v.n >> 4); g += W3_CLUSTER * W3_THREADS) {
            const uint4 w4 = __ldcg((const uint4*)v.band + g);
            const uint32_t words[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                uint32_t hit = __vcmpeq4(words[q], key);
                while (hit) {
                    const int i = (__ffs(hit) - 1) >> 3;
                    hit &= ~(0xffu << (8 * i));
                    w3_scan_voxel(v, 16 * g + 4 * q + i, list, count);
                }
            }
        }
        return;
    }
    for (int p = rank_thread; p < v.n; p += W3_CLUSTER * W3_THREADS) {
        if (__ldcg(v.band + p) != li) continue;
        w3_scan_voxel(v, p, list, count);
    }
}

// Claim the eligible unlabeled neighbours of the `n_front` listed voxels
// that the listed voxel owns: every labelled neighbour of such a voxel q
// was labelled at the last step, so the listed voxel that q's largest
// label comes from (the first in direction order) claims it, and no two
// threads claim one voxel.
__device__ void w3_claim_front(const W3Volume& v, int rank_thread, const int* front,
                               int n_front, int* list, int* count, int li) {
    for (int i = rank_thread; i < n_front; i += W3_CLUSTER * W3_THREADS) {
        const int f = __ldcg(front + i);
        const int fz = f / v.plane, fr = f - fz * v.plane, fy = fr / v.W, fx = fr - fy * v.W;
        for (int j = 0; j < 26; ++j) {
            int dz, dy, dx;
            w3_offset(j, dz, dy, dx);
            const int z = fz + dz, y = fy + dy, x = fx + dx;
            if (z < 0 || z >= v.Z || y < 0 || y >= v.H || x < 0 || x >= v.W) continue;
            const int q = f + (dz * v.H + dy) * v.W + dx;
            if (__ldcg(v.band + q) > li || __ldcg(v.lab + q) != 0) continue;
            int dir = 0;
            w3_best(v, q, z, y, x, &dir);
            if (dir == 25 - j) w3_claim(v, q, dir, list, count);
        }
    }
}

// Give every listed voxel the label of the neighbour its band byte names.
__device__ void w3_resolve(const W3Volume& v, int rank_thread, const int* list, int count) {
    for (int i = rank_thread; i < count; i += W3_CLUSTER * W3_THREADS) {
        const int q = __ldcg(list + i);
        const int j = __ldcg(v.band + q);
        int dz, dy, dx;
        w3_offset(j, dz, dy, dx);
        __stcg(v.lab + q, __ldcg(v.lab + q + (dz * v.H + dy) * v.W + dx));
    }
}

__global__ void __launch_bounds__(W3_THREADS)
w3_cluster_kernel(const float* __restrict__ intensity, const int* __restrict__ seeds,
                  const uint8_t* __restrict__ mask, int* out_all, uint8_t* band_all,
                  int* lists_all, int* misc_all, int Z, int H, int W, int n_levels) {
    __shared__ float s_level[W3_MAX_LEVELS];
    __shared__ float s_lo[W3_THREADS / 32], s_hi[W3_THREADS / 32];
    cg::cluster_group cl = cg::this_cluster();
    const int rank = (int)cl.block_rank();
    const int vol = blockIdx.x / W3_CLUSTER;
    const int rt = rank * W3_THREADS + threadIdx.x;  // thread within the cluster
    const int stride = W3_CLUSTER * W3_THREADS;
    W3Volume v;
    v.Z = Z;
    v.H = H;
    v.W = W;
    v.plane = H * W;
    v.n = Z * v.plane;
    const size_t base = (size_t)vol * v.n;
    v.I = intensity + base;
    v.S = seeds + base;
    v.M = mask + base;
    v.lab = out_all + base;
    v.band = band_all + base;
    v.lists = lists_all + (size_t)vol * 2 * v.n;
    v.misc = misc_all + (size_t)vol * W3_MISC;

    // pass 1: the seeds as starting labels; lo/hi over mask'
    float lo = INFINITY, hi = -INFINITY;
#pragma unroll 4
    for (int p = rt; p < v.n; p += stride) {
        const int s = v.S[p];
        __stcg(v.lab + p, s);
        if (v.M[p] || s > 0) {
            lo = tm_nanmin(lo, v.I[p]);
            hi = tm_nanmax(hi, v.I[p]);
        }
    }
    for (int off = 16; off > 0; off >>= 1) {
        lo = tm_nanmin(lo, __shfl_xor_sync(0xffffffffu, lo, off));
        hi = tm_nanmax(hi, __shfl_xor_sync(0xffffffffu, hi, off));
    }
    if ((threadIdx.x & 31) == 0) {
        s_lo[threadIdx.x >> 5] = lo;
        s_hi[threadIdx.x >> 5] = hi;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        for (int i = 1; i < W3_THREADS / 32; ++i) {
            lo = tm_nanmin(lo, s_lo[i]);
            hi = tm_nanmax(hi, s_hi[i]);
        }
        __stcg(v.misc + W3_PART + 2 * rank, __float_as_int(lo));
        __stcg(v.misc + W3_PART + 2 * rank + 1, __float_as_int(hi));
        if (rank == 0) {
            __stcg(v.misc + 0, 0);
            __stcg(v.misc + 1, 0);
            __stcg(v.misc + 2, 0);
        }
    }
    cl.sync();
    lo = INFINITY;
    hi = -INFINITY;
    for (int r = 0; r < W3_CLUSTER; ++r) {
        lo = tm_nanmin(lo, __int_as_float(__ldcg(v.misc + W3_PART + 2 * r)));
        hi = tm_nanmax(hi, __int_as_float(__ldcg(v.misc + W3_PART + 2 * r + 1)));
    }
    const float span = tm_span(hi, lo);
    for (int i = threadIdx.x; i < n_levels; i += W3_THREADS)
        s_level[i] = __fsub_rn(hi, __fdiv_rn(__fmul_rn(span, (float)(i + 1)), (float)n_levels));
    __syncthreads();

    // pass 2: the bands
#pragma unroll 4
    for (int p = rt; p < v.n; p += stride) {
        const bool free = v.S[p] == 0 && v.M[p];
        __stcg(v.band + p, (uint8_t)(free ? w3_band(v.I[p], s_level, n_levels) : W3_NEVER));
    }
    cl.sync();

    // the flood: step s fills list s & 1 and count s % 3, and zeroes count
    // (s + 1) % 3, which every thread read two barriers before
    int* cnt = v.misc;
    int step = 0;
    for (int li = 0; li <= n_levels; ++li) {
        ++step;
        w3_claim_scan(v, rt, v.lists + (step & 1) * v.n, cnt + step % 3, li);
        if (rt == 0) __stcg(cnt + (step + 1) % 3, 0);
        cl.sync();
        int count = __ldcg(cnt + step % 3);
        while (count > 0) {
            w3_resolve(v, rt, v.lists + (step & 1) * v.n, count);
            cl.sync();
            ++step;
            w3_claim_front(v, rt, v.lists + ((step - 1) & 1) * v.n, count,
                           v.lists + (step & 1) * v.n, cnt + step % 3, li);
            if (rt == 0) __stcg(cnt + (step + 1) % 3, 0);
            cl.sync();
            count = __ldcg(cnt + step % 3);
        }
    }

    for (int p = rt; p < v.n; p += stride)
        if (!(v.M[p] || v.S[p] > 0)) __stcg(v.lab + p, 0);
}

extern "C" int tm_watershed3d_flood(const void* intensity, const void* seeds, const void* mask,
                                    void* band, void* lists, void* misc, void* out, int B,
                                    int Z, int H, int W, int n_levels, void* stream) {
    if (B < 1 || n_levels < 1 || n_levels > W3_MAX_LEVELS)
        return (int)cudaErrorInvalidValue;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(W3_CLUSTER * B);
    cfg.blockDim = dim3(W3_THREADS);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = (cudaStream_t)stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = W3_CLUSTER;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    cudaError_t err = cudaLaunchKernelEx(
        &cfg, w3_cluster_kernel, (const float*)intensity, (const int*)seeds,
        (const uint8_t*)mask, (int*)out, (uint8_t*)band, (int*)lists, (int*)misc, Z, H, W,
        n_levels);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

// ------------------------------------------------------------ global route
// The first design (one block per volume, double-buffered labels, whole-
// volume Jacobi scans), with the NaN-propagating lo/hi and span.
__global__ void __launch_bounds__(TM_BLOCK)
w3_global_kernel(const float* __restrict__ intensity, const int* __restrict__ seeds,
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
            lo = tm_nanmin(lo, I[p]);
            hi = tm_nanmax(hi, I[p]);
        }
    }
    for (int off = 16; off > 0; off >>= 1) {
        lo = tm_nanmin(lo, __shfl_xor_sync(0xffffffffu, lo, off));
        hi = tm_nanmax(hi, __shfl_xor_sync(0xffffffffu, hi, off));
    }
    if ((threadIdx.x & 31) == 0) {
        s_lo[threadIdx.x >> 5] = lo;
        s_hi[threadIdx.x >> 5] = hi;
    }
    __syncthreads();
    lo = INFINITY;
    hi = -INFINITY;
    for (int i = 0; i < (int)(blockDim.x >> 5); ++i) {
        lo = tm_nanmin(lo, s_lo[i]);
        hi = tm_nanmax(hi, s_hi[i]);
    }
    const float span = tm_span(hi, lo);

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

extern "C" int tm_watershed3d_flood_global(const void* intensity, const void* seeds,
                                    const void* mask, void* scratch, void* out, int B,
                                    int Z, int H, int W, int n_levels, void* stream) {
    w3_global_kernel<<<B, TM_BLOCK, 0, (cudaStream_t)stream>>>(
        (const float*)intensity, (const int*)seeds, (const uint8_t*)mask, (int*)out,
        (int*)scratch, Z, H, W, n_levels);
    return (int)cudaGetLastError();
}
