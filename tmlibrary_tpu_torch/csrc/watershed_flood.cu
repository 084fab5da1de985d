// watershed_flood for Hopper.
//
// Replaces the TPU kernel `_watershed_kernel` / `_watershed_flood_jit` in
// tmlibrary_tpu/ops/pallas_kernels.py (API `watershed_flood`).  Same
// function: with mask' = mask | seeds > 0 and lo/hi the min/max of the
// intensity over mask', at each of `n_levels` descending levels
//     level_i = hi - span * (float)(i + 1) / n_levels   (f32, left to right)
// every unlabeled pixel of mask' with intensity >= level_i adopts the
// maximum label among its neighbours, repeated to convergence (Jacobi:
// each step reads the previous step's labels, so a tie between two
// growing labels goes to the larger); then one more flood admits all of
// mask' (the mop-up).  Seeds keep their labels; the output is zero outside
// mask'.  A negative seed keeps its value and never spreads.  The level
// expression uses explicitly rounded intrinsics so no contraction can move
// a band edge.  A NaN intensity in mask' makes lo, hi, the span and every
// level NaN (tm_nanmin/tm_nanmax/tm_span), as in the reference, so no
// pixel is eligible before the mop-up: its band comes out n_levels.
//
// Two routes; the wrapper picks one from the shapes and n_levels
// (ops/kernels.py `watershed_plan`).
//
// On chip (`tm_watershed_flood`): one block per site, the site in shared
// memory -- labels in 16 bits and each pixel's band, the first level at
// which it is eligible (level_i only falls as i grows, so eligibility is
// monotone), n_levels for the mop-up, 255 for never; 192 KB for 256x256.
// Three passes over the inputs (16-byte loads where the planes allow)
// take lo/hi and the seeds, find each band by binary search over the
// levels, and write the labels.  The flood follows the frontier: within
// a level, Jacobi step t+1 labels exactly the unlabeled eligible pixels
// next to a pixel labelled at step t, each with the largest label among
// its neighbours -- all of which were labelled at step t.  So each such
// pixel is claimed by the listed pixel its largest label comes from
// (no atomics on the labels): the claim sets it to PENDING (which every
// reader takes as 0), stores in its band byte the direction of that
// neighbour and lists it; after a barrier every claimed pixel copies
// that neighbour's label, which no later step changes.  One label plane
// thus keeps the flood Jacobi.  A level starts with one scan for its
// newly eligible pixels (at the end of a level no unlabeled eligible
// pixel has a labelled neighbour); a thread tests four band bytes at
// once.  A step whose list overflows its capacity scans the whole site
// instead, which gives the same labels.  A site whose largest seed id
// exceeds 65534 runs the global route's loop in the same launch;
// `site_route` records 0 (on chip) or 1 (global) for every site.
//
// Global (`tm_watershed_flood_global`): the first design, for sites the on-
// chip route cannot hold -- one block of 1024 threads per site, labels
// double-buffered in global memory (L2-resident), every step a scan of the
// whole site.  The planes a step reads and writes are distinct, so both
// are __restrict__.
//
// Bound: one read of intensity (4 B), seeds (4 B) and mask (1 B) and one
// write of the labels (4 B) per pixel.  On chip the inputs are read three
// times (from L2 after the first) and the labels written once; the flood
// runs in shared memory, and what remains is its serial chain: two
// barriers a step and one scan a level, on 64 of the card's 132 SMs.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

#define WS_PENDING 0xFFFFu
#define WS_MAX_ID 65534
#define WS_NEVER 0xFF
#define WS_MAX_LEVELS 254

// Byte offsets of the band plane and of the two frontier lists in the
// on-chip kernel's dynamic shared memory (ops/kernels.py `watershed_plan`
// mirrors them).
__host__ __device__ __forceinline__ int ws_band_offset(int n) { return 2 * ((n + 7) & ~7); }
__host__ __device__ __forceinline__ int ws_list_offset(int n) {
    return ws_band_offset(n) + ((n + 15) & ~15);
}

// Block-wide min of `lo`, max of `hi` and max of `top`; every thread
// returns with the results.  Called once per kernel.
__device__ __forceinline__ void ws_block_reduce(float& lo, float& hi, int& top) {
    __shared__ float s_lo[TM_BLOCK / 32], s_hi[TM_BLOCK / 32];
    __shared__ int s_top[TM_BLOCK / 32];
    for (int off = 16; off > 0; off >>= 1) {
        lo = tm_nanmin(lo, __shfl_xor_sync(0xffffffffu, lo, off));
        hi = tm_nanmax(hi, __shfl_xor_sync(0xffffffffu, hi, off));
        top = max(top, __shfl_xor_sync(0xffffffffu, top, off));
    }
    if ((threadIdx.x & 31) == 0) {
        s_lo[threadIdx.x >> 5] = lo;
        s_hi[threadIdx.x >> 5] = hi;
        s_top[threadIdx.x >> 5] = top;
    }
    __syncthreads();
    lo = INFINITY;
    hi = -INFINITY;
    top = 0;
    for (int i = 0; i < (int)(blockDim.x >> 5); ++i) {
        lo = tm_nanmin(lo, s_lo[i]);
        hi = tm_nanmax(hi, s_hi[i]);
        top = max(top, s_top[i]);
    }
}

__device__ __forceinline__ float ws_level(float hi, float span, int i, int n_levels) {
    return __fsub_rn(hi, __fdiv_rn(__fmul_rn(span, (float)(i + 1)), (float)n_levels));
}

// ------------------------------------------------------------ global route
// One Jacobi step over the whole site, from `cur` into `nxt`; returns
// whether this thread labelled a pixel.
__device__ __forceinline__ int ws_global_step(const int* __restrict__ cur, int* __restrict__ nxt,
                                              const float* __restrict__ I,
                                              const int* __restrict__ S,
                                              const uint8_t* __restrict__ M, int H, int W,
                                              bool mop_up, float level, int n_neigh) {
    const int n = H * W;
    int changed = 0;
    for (int p = threadIdx.x; p < n; p += blockDim.x) {
        int l = cur[p];
        if (l == 0 && (M[p] || S[p] > 0) && (mop_up || I[p] >= level)) {
            const int y = p / W, x = p - y * W;
            for (int j = 0; j < n_neigh; ++j) {
                int yy = y + tm_dy(j), xx = x + tm_dx(j);
                if (yy < 0 || yy >= H || xx < 0 || xx >= W) continue;
                l = max(l, cur[yy * W + xx]);
            }
            changed |= l != 0;
        }
        nxt[p] = l;
    }
    return changed;
}

// The global route's flood of one site whose seeds are already in `out`.
__device__ void ws_global_flood(const float* __restrict__ I, const int* __restrict__ S,
                                const uint8_t* __restrict__ M, int* out, int* scratch,
                                int H, int W, int n_levels, int n_neigh, float lo, float hi) {
    const int n = H * W;
    const float span = tm_span(hi, lo);
    int* cur = out;
    int* nxt = scratch;
    for (int li = 0; li <= n_levels; ++li) {
        const bool mop_up = li == n_levels;
        const float level = mop_up ? 0.0f : ws_level(hi, span, li, n_levels);
        for (;;) {
            const int changed = ws_global_step(cur, nxt, I, S, M, H, W, mop_up, level, n_neigh);
            int* t = cur;
            cur = nxt;
            nxt = t;
            if (!__syncthreads_or(changed)) break;
        }
    }
    for (int p = threadIdx.x; p < n; p += blockDim.x)
        out[p] = (M[p] || S[p] > 0) ? cur[p] : 0;
}

__global__ void __launch_bounds__(TM_BLOCK)
ws_global_kernel(const float* __restrict__ intensity, const int* __restrict__ seeds,
                 const uint8_t* __restrict__ mask, int* out_all, int* scratch_all,
                 int* __restrict__ site_route, int H, int W, int n_levels, int n_neigh) {
    const int n = H * W;
    const size_t base = (size_t)blockIdx.x * n;
    const float* I = intensity + base;
    const int* S = seeds + base;
    const uint8_t* M = mask + base;
    int* out = out_all + base;
    float lo = INFINITY, hi = -INFINITY;
    int top = 0;
    for (int p = threadIdx.x; p < n; p += blockDim.x) {
        out[p] = S[p];
        if (M[p] || S[p] > 0) {
            lo = tm_nanmin(lo, I[p]);
            hi = tm_nanmax(hi, I[p]);
        }
    }
    ws_block_reduce(lo, hi, top);
    if (threadIdx.x == 0) site_route[blockIdx.x] = 1;
    ws_global_flood(I, S, M, out, scratch_all + base, H, W, n_levels, n_neigh, lo, hi);
}

// ----------------------------------------------------------- on-chip route
// First level i in [0, n) with v >= level[i] (levels never rise), else n.
__device__ __forceinline__ int ws_band(float v, const float* level, int n) {
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

// List q, claimed by this thread, with one shared atomic for all the
// lanes of its warp that claim at this point (a full list only counts).
__device__ __forceinline__ void ws_append(int q, uint16_t* list, int* count, int cap) {
    const cg::coalesced_group lanes = cg::coalesced_threads();
    int first = 0;
    if (lanes.thread_rank() == 0) first = atomicAdd(count, (int)lanes.size());
    const int k = lanes.shfl(first, 0) + (int)lanes.thread_rank();
    if (k < cap) list[k] = (uint16_t)q;
}

// Largest label among the neighbours of (y, x) (PENDING and negative
// seeds count as 0) and the direction of the first neighbour holding it.
template <int NN>
__device__ __forceinline__ int ws_best(const uint16_t* lab, int y, int x, int H, int W,
                                       int* dir) {
    int best = 0;
#pragma unroll
    for (int j = 0; j < NN; ++j) {
        int yy = y + tm_dy(j), xx = x + tm_dx(j);
        if (yy < 0 || yy >= H || xx < 0 || xx >= W) continue;
        int v = lab[yy * W + xx];
        if (v == (int)WS_PENDING) v = 0;
        if (v > best) {
            best = v;
            *dir = j;
        }
    }
    return best;
}

// p / W for 0 <= p < 2^16 and 1 <= W <= 2^16, with magic = ceil(2^32 / W):
// the error p * (magic - 2^32 / W) / 2^32 stays below 1 / W.
__device__ __forceinline__ int ws_div(int p, unsigned long long magic) {
    return (int)(((unsigned long long)p * magic) >> 32);
}

// Scan the whole site for unlabeled pixels of band `li` (`exact`) or of
// any band <= li that have a labelled neighbour, and claim them.  A
// thread tests four band bytes at once and visits only the bytes that
// match.
template <int NN>
__device__ __forceinline__ void ws_claim_scan(uint16_t* lab, uint8_t* band, uint16_t* list,
                                              int* count, int cap, int H, int W,
                                              unsigned long long magic, int li, bool exact) {
    const int groups = (H * W + 3) >> 2;  // band bytes past the site are WS_NEVER
    const uint32_t* band4 = (const uint32_t*)band;
    const uint32_t key = 0x01010101u * (uint32_t)li;
    for (int g = threadIdx.x; g < groups; g += blockDim.x) {
        uint32_t hit = exact ? __vcmpeq4(band4[g], key) : __vcmpleu4(band4[g], key);
        while (hit) {
            const int i = (__ffs(hit) - 1) >> 3, p = 4 * g + i;
            hit &= ~(0xffu << (8 * i));
            if (lab[p] != 0) continue;
            const int y = ws_div(p, magic), x = p - y * W;
            int dir = 0;
            if (ws_best<NN>(lab, y, x, H, W, &dir) > 0) {
                lab[p] = (uint16_t)WS_PENDING;
                band[p] = (uint8_t)dir;
                ws_append(p, list, count, cap);
            }
        }
    }
}

// Claim the eligible unlabeled neighbours of the `n_front` listed pixels,
// one thread a listed pixel.  Every labelled neighbour of such a pixel q
// was labelled at the last step, so the listed pixel that q's largest
// label comes from (the first in direction order) claims it, and no two
// threads claim one pixel.  The thread loads the 5x5 labels around its
// pixel and the bands of the 3x3 at once and decides all eight from
// registers: a PENDING it missed, set meanwhile by another thread, reads
// as 0 either way, and a pixel it does not own it leaves alone.
template <int NN>
__device__ __forceinline__ void ws_claim_front(uint16_t* lab, uint8_t* band,
                                               const uint16_t* front, int n_front,
                                               uint16_t* list, int* count, int cap, int H,
                                               int W, unsigned long long magic, int li) {
    for (int i = threadIdx.x; i < n_front; i += blockDim.x) {
        const int f = front[i], fy = ws_div(f, magic), fx = f - fy * W;
        int win[5][5];  // labels around f, 0 outside the site; raw at the 3x3
        int bnd[3][3];  // bands of the 3x3, WS_NEVER outside the site
#pragma unroll
        for (int r = 0; r < 5; ++r)
#pragma unroll
            for (int c = 0; c < 5; ++c) {
                const int y = fy + r - 2, x = fx + c - 2;
                const bool in = y >= 0 && y < H && x >= 0 && x < W;
                win[r][c] = in ? (int)lab[y * W + x] : 0;
                if (r >= 1 && r <= 3 && c >= 1 && c <= 3)
                    bnd[r - 1][c - 1] = in ? (int)band[y * W + x] : WS_NEVER;
            }
#pragma unroll
        for (int j = 0; j < NN; ++j) {
            const int r = 2 + tm_dy(j), c = 2 + tm_dx(j);
            if (win[r][c] != 0 || bnd[r - 1][c - 1] > li) continue;
            int best = 0, dir = 0;
#pragma unroll
            for (int k = 0; k < NN; ++k) {
                int v = win[r + tm_dy(k)][c + tm_dx(k)];
                if (v == (int)WS_PENDING) v = 0;
                if (v > best) {
                    best = v;
                    dir = k;
                }
            }
            if (dir != (j < 4 ? (j ^ 1) : 11 - j)) continue;  // q's owner is another pixel
            const int q = (fy + tm_dy(j)) * W + fx + tm_dx(j);
            lab[q] = (uint16_t)WS_PENDING;
            band[q] = (uint8_t)dir;
            ws_append(q, list, count, cap);
        }
    }
}

// Give every claimed pixel the label of the neighbour its band byte
// names: from the list, or by a scan of the site when it overflowed.
__device__ __forceinline__ void ws_resolve(uint16_t* lab, const uint8_t* band,
                                           const uint16_t* list, int count, int cap, int n,
                                           int W) {
    if (count <= cap) {
        for (int i = threadIdx.x; i < count; i += blockDim.x) {
            const int q = list[i], j = band[q];
            lab[q] = lab[q + tm_dy(j) * W + tm_dx(j)];
        }
    } else {
        for (int p = threadIdx.x; p < n; p += blockDim.x) {
            if (lab[p] != WS_PENDING) continue;
            const int j = band[p];
            lab[p] = lab[p + tm_dy(j) * W + tm_dx(j)];
        }
    }
}

// Pass 1 for one pixel: its 16-bit starting label, and lo/hi/top updated.
__device__ __forceinline__ uint32_t ws_first(int s, uint8_t m, float v, float& lo, float& hi,
                                             int& top) {
    if (m || s > 0) {
        lo = tm_nanmin(lo, v);
        hi = tm_nanmax(hi, v);
    }
    top = max(top, s);
    return (uint32_t)(s > 0 ? min(s, WS_MAX_ID) : 0);
}

__device__ __forceinline__ uint32_t ws_band_of(int s, uint8_t m, float v, const float* level,
                                               int n_levels) {
    return (s == 0 && m) ? (uint32_t)ws_band(v, level, n_levels) : (uint32_t)WS_NEVER;
}

__device__ __forceinline__ int ws_out(int s, uint8_t m, uint32_t l) {
    return (m || s > 0) ? (s != 0 ? s : (int)l) : 0;
}

template <int NN>
__global__ void __launch_bounds__(TM_BLOCK)
ws_onchip_kernel(const float* __restrict__ intensity, const int* __restrict__ seeds,
                 const uint8_t* __restrict__ mask, int* __restrict__ out_all,
                 int* __restrict__ scratch_all, int* __restrict__ site_route, int H, int W,
                 int n_levels, int cap) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ float s_level[WS_MAX_LEVELS];
    __shared__ int s_count[2];
    const int n = H * W;
    const size_t base = (size_t)blockIdx.x * n;
    const float* I = intensity + base;
    const int* S = seeds + base;
    const uint8_t* M = mask + base;
    int* out = out_all + base;
    uint16_t* lab = (uint16_t*)smem;
    uint8_t* band = smem + ws_band_offset(n);
    uint16_t* lists = (uint16_t*)(smem + ws_list_offset(n));

    // 16-byte loads of four pixels where every plane allows them
    const bool vec = (n & 3) == 0 &&
                     ((((uintptr_t)I | (uintptr_t)S | (uintptr_t)out) & 15) |
                      ((uintptr_t)M & 3)) == 0;
    float lo = INFINITY, hi = -INFINITY;
    int top = 0;
    if (vec) {
        for (int g = threadIdx.x; g < (n >> 2); g += blockDim.x) {
            const int4 s4 = ((const int4*)S)[g];
            const uchar4 m4 = ((const uchar4*)M)[g];
            const float4 v4 = ((const float4*)I)[g];
            const uint32_t l0 = ws_first(s4.x, m4.x, v4.x, lo, hi, top);
            const uint32_t l1 = ws_first(s4.y, m4.y, v4.y, lo, hi, top);
            const uint32_t l2 = ws_first(s4.z, m4.z, v4.z, lo, hi, top);
            const uint32_t l3 = ws_first(s4.w, m4.w, v4.w, lo, hi, top);
            ((uint2*)lab)[g] = make_uint2(l0 | (l1 << 16), l2 | (l3 << 16));
        }
    } else {
        for (int p = threadIdx.x; p < n; p += blockDim.x)
            lab[p] = ws_first(S[p], M[p], I[p], lo, hi, top);
    }
    ws_block_reduce(lo, hi, top);
    if (top > WS_MAX_ID) {  // ids beyond 16 bits: the global loop, same launch
        if (threadIdx.x == 0) site_route[blockIdx.x] = 1;
        for (int p = threadIdx.x; p < n; p += blockDim.x) out[p] = S[p];
        __syncthreads();
        ws_global_flood(I, S, M, out, scratch_all + base, H, W, n_levels, NN, lo, hi);
        return;
    }
    if (threadIdx.x == 0) site_route[blockIdx.x] = 0;
    const float span = tm_span(hi, lo);
    for (int i = threadIdx.x; i < n_levels; i += blockDim.x)
        s_level[i] = ws_level(hi, span, i, n_levels);
    __syncthreads();
    if (vec) {
        for (int g = threadIdx.x; g < (((n + 15) & ~15) >> 2); g += blockDim.x) {
            uint32_t word = 0xffffffffu;
            if (4 * g < n) {
                const int4 s4 = ((const int4*)S)[g];
                const uchar4 m4 = ((const uchar4*)M)[g];
                const float4 v4 = ((const float4*)I)[g];
                word = ws_band_of(s4.x, m4.x, v4.x, s_level, n_levels) |
                       ws_band_of(s4.y, m4.y, v4.y, s_level, n_levels) << 8 |
                       ws_band_of(s4.z, m4.z, v4.z, s_level, n_levels) << 16 |
                       ws_band_of(s4.w, m4.w, v4.w, s_level, n_levels) << 24;
            }
            ((uint32_t*)band)[g] = word;
        }
    } else {
        for (int p = threadIdx.x; p < ((n + 15) & ~15); p += blockDim.x)
            band[p] = p < n ? ws_band_of(S[p], M[p], I[p], s_level, n_levels) : WS_NEVER;
    }

    const unsigned long long magic = ((1ull << 32) + max(W, 1) - 1) / max(W, 1);
    int par = 0;  // the list (and count) the current step fills
    for (int li = 0; li <= n_levels; ++li) {
        if (threadIdx.x == 0) s_count[par] = 0;
        __syncthreads();
        ws_claim_scan<NN>(lab, band, lists + par * cap, &s_count[par], cap, H, W, magic, li,
                          true);
        __syncthreads();
        int count = s_count[par];
        while (count > 0) {
            ws_resolve(lab, band, lists + par * cap, count, cap, n, W);
            if (threadIdx.x == 0) s_count[par ^ 1] = 0;
            __syncthreads();
            if (count <= cap)
                ws_claim_front<NN>(lab, band, lists + par * cap, count, lists + (par ^ 1) * cap,
                                   &s_count[par ^ 1], cap, H, W, magic, li);
            else
                ws_claim_scan<NN>(lab, band, lists + (par ^ 1) * cap, &s_count[par ^ 1], cap,
                                  H, W, magic, li, false);
            __syncthreads();
            par ^= 1;
            count = s_count[par];
        }
    }

    if (vec) {
        for (int g = threadIdx.x; g < (n >> 2); g += blockDim.x) {
            const int4 s4 = ((const int4*)S)[g];
            const uchar4 m4 = ((const uchar4*)M)[g];
            const uint2 l2 = ((const uint2*)lab)[g];
            ((int4*)out)[g] =
                make_int4(ws_out(s4.x, m4.x, l2.x & 0xffffu), ws_out(s4.y, m4.y, l2.x >> 16),
                          ws_out(s4.z, m4.z, l2.y & 0xffffu), ws_out(s4.w, m4.w, l2.y >> 16));
        }
    } else {
        for (int p = threadIdx.x; p < n; p += blockDim.x) out[p] = ws_out(S[p], M[p], lab[p]);
    }
}

extern "C" int tm_watershed_flood(const void* intensity, const void* seeds, const void* mask,
                                  void* scratch, void* site_route, void* out, int B, int H,
                                  int W, int n_levels, int connectivity, int cap,
                                  void* stream) {
    const int n = H * W;
    if (n > 65536 || n_levels < 1 || n_levels > WS_MAX_LEVELS || cap < 1)
        return (int)cudaErrorInvalidValue;
    const int smem = ws_list_offset(n) + 4 * cap;
    auto kernel = connectivity == 4 ? ws_onchip_kernel<4> : ws_onchip_kernel<8>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<B, TM_BLOCK, smem, (cudaStream_t)stream>>>(
        (const float*)intensity, (const int*)seeds, (const uint8_t*)mask, (int*)out,
        (int*)scratch, (int*)site_route, H, W, n_levels, cap);
    return (int)cudaGetLastError();
}

extern "C" int tm_watershed_flood_global(const void* intensity, const void* seeds,
                                         const void* mask, void* scratch, void* site_route,
                                         void* out, int B, int H, int W, int n_levels,
                                         int connectivity, void* stream) {
    ws_global_kernel<<<B, TM_BLOCK, 0, (cudaStream_t)stream>>>(
        (const float*)intensity, (const int*)seeds, (const uint8_t*)mask, (int*)out,
        (int*)scratch, (int*)site_route, H, W, n_levels, connectivity == 4 ? 4 : 8);
    return (int)cudaGetLastError();
}
