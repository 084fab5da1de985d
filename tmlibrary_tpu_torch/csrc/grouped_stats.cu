// grouped_stats for Hopper.
//
// Replaces the TPU kernel `_stats_kernel` / `_stats_call` in
// tmlibrary_tpu/ops/fused_measure.py (API `grouped_stats`).  Same
// function: per object id 1..K (K = max_objects, background and ids
// outside 1..K dropped) the sum, min and max of each of C pixel
// channels; absent objects give (0, +inf, -inf).  Min and max propagate
// NaN (tm_nanmin/tm_nanmax), as the reference's scatter min/max does.
//
// Each object's sum is the left-to-right float32 sum of its pixels in
// row-major pixel order: the order of the reference's scatter-add on the
// CPU, bit for bit, and run-to-run deterministic (no float atomics).  A
// reordered float32 sum would leave the rtol=1e-6 tier on objects of a
// few thousand pixels, so the chain of adds stays in pixel order; the
// design changes how the pixels reach it.  A row depends only on its own
// object's pixels, so rows 1..n do not depend on K.
//
// Design: three launches in one entry point.
//   1. `gs_box_init`: every object's box (z, y, x ranges) to empty.
//   2. `gs_boxes`: a grid of (bands, B) blocks, each a band of a site's
//      pixels; the lanes of a warp that hold one label pool their z/y/x
//      ranges with warp reductions (__match_any_sync, __reduce_*_sync)
//      and one lane widens the box in the global table with integer
//      atomics, so any K runs.  Integer min/max is exact in any order.
//      (A block table in shared memory, flushed once, was no faster: the
//      warp pooling leaves about one atomic a label a warp.)
//   3. `gs_walk`: one block of 256 threads per (object, site), so a
//      site's objects spread over all SMs.  The block walks its object's
//      box in (z, y, x) order -- with the volume's Z, a 3-D object's box
//      skips the rows of other planes -- as row segments of 32 pixels,
//      eight segments (one a warp) to a tile.  Every warp loads its
//      segment's labels and, for the object's own pixels only, the C
//      channels (coalesced 128-byte rows) into registers, stores them in
//      shared memory, and loads the next tile while warp 0 runs the
//      chain: lane c adds channel c of the tile's pixels in pixel order,
//      each segment that holds an object pixel (a ballot of the labels)
//      as 32 unrolled steps that add the pixel's value or +0.0 (an
//      identity here: a sum that starts at +0.0 never becomes -0.0), so
//      the 32 shared-memory loads issue ahead of the adds; channel rows
//      padded to 257 floats keep the lanes on distinct banks.  All
//      channels of a call (up to 32) share one launch, so the labels are
//      read once.  The walk reads each channel where the caller keeps it
//      (a pointer and a site stride a channel, 0 for a channel shared by
//      every site), so no stacked copy of the channels is made.
//
// Bound: one read of the labels (4 B) and the C channels (4 B each) per
// pixel and one write of 3 * C floats an object.  The walk reads each
// box's labels again and only the object's own channel values; what
// remains is each object's serial chain of adds (its pixel count, four
// cycles an add) and one round trip to L2 a tile.
#include "common.cuh"

#define GS_THREADS 256
#define GS_SEG 32
#define GS_TILE_SEGS (GS_THREADS / GS_SEG)
#define GS_STRIDE (GS_THREADS + 1)
#define GS_BOX_THREADS 512
#define GS_EMPTY 0x7fffffff
// with the object's box: z0, z1, y0, y1, x0, x1
#define GS_BOX 6
#define TM_MAX_CHANNELS 32
#define TM_PHASE_WALK 2

// Channel c of site s starts at p[c] + s * site[c].
struct GsChannels {
    const float* p[TM_MAX_CHANNELS];
    long long site[TM_MAX_CHANNELS];
};

__global__ void gs_box_init(int* __restrict__ box, int total) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < total) box[i] = (i & 1) ? -1 : GS_EMPTY;  // mins empty, maxs -1
}

__global__ void __launch_bounds__(GS_BOX_THREADS)
gs_boxes(const int* __restrict__ labels, int* __restrict__ box_all, int Z, int H, int W,
         int K) {
    const int n = Z * H * W;
    const int site = blockIdx.y;
    const int* lab = labels + (size_t)site * n;
    int* box = box_all + (size_t)site * K * GS_BOX;
    const int per = (n + gridDim.x - 1) / gridDim.x;
    const int start = blockIdx.x * per, end = min(n, start + per);
    for (int base = start; base < end; base += blockDim.x) {
        const int p = base + threadIdx.x;
        int key = 0, z = 0, y = 0, x = 0;
        if (p < end) {
            const int l = lab[p];
            if (l >= 1 && l <= K) {
                key = l;
                const int r = p / W;
                x = p - r * W;
                z = r / H;
                y = r - z * H;
            }
        }
        const unsigned g = __match_any_sync(0xffffffffu, key);
        const int z0 = __reduce_min_sync(g, z), z1 = __reduce_max_sync(g, z);
        const int y0 = __reduce_min_sync(g, y), y1 = __reduce_max_sync(g, y);
        const int x0 = __reduce_min_sync(g, x), x1 = __reduce_max_sync(g, x);
        if (key != 0 && (int)(threadIdx.x & 31) == __ffs(g) - 1) {
            int* b = box + (key - 1) * GS_BOX;
            atomicMin(b + 0, z0);
            atomicMax(b + 1, z1);
            atomicMin(b + 2, y0);
            atomicMax(b + 3, y1);
            atomicMin(b + 4, x0);
            atomicMax(b + 5, x1);
        }
    }
}

template <int MAXC>
__global__ void __launch_bounds__(GS_THREADS)
gs_walk(const int* __restrict__ labels, const __grid_constant__ GsChannels ch,
        const int* __restrict__ box_all, float* __restrict__ sums, float* __restrict__ mins,
        float* __restrict__ maxs, int Z, int H, int W, int C, int K) {
    __shared__ int s_lab[GS_THREADS];
    __shared__ float s_val[MAXC * GS_STRIDE];
    __shared__ const float* s_chan[MAXC];  // channel c of this site
    const int k = blockIdx.x + 1, site = blockIdx.y;
    const int n = Z * H * W;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int* lab = labels + (size_t)site * n;
    const int* b = box_all + ((size_t)site * K + k - 1) * GS_BOX;
    const size_t row = ((size_t)site * K + k - 1) * C;
    const int z0 = b[0], z1 = b[1], y0 = b[2], y1 = b[3], x0 = b[4], x1 = b[5];
    if (z1 < 0) {  // absent
        for (int c = threadIdx.x; c < C; c += blockDim.x) {
            sums[row + c] = 0.0f;
            mins[row + c] = INFINITY;
            maxs[row + c] = -INFINITY;
        }
        return;
    }
    if (threadIdx.x < C) s_chan[threadIdx.x] = ch.p[threadIdx.x] + site * ch.site[threadIdx.x];
    __syncthreads();  // z1 is the block's: every thread reaches this barrier
    const int ny = y1 - y0 + 1;
    const int per_row = (x1 - x0 + GS_SEG) / GS_SEG;  // segments a box row
    const int segs = (z1 - z0 + 1) * ny * per_row;
    const int tiles = (segs + GS_TILE_SEGS - 1) / GS_TILE_SEGS;

    int rl = 0;
    float rv[MAXC];
    auto load = [&](int t) {
        rl = 0;
        const int seg = t * GS_TILE_SEGS + warp;
        if (seg >= segs) return;
        const int r = seg / per_row, xs = seg - r * per_row;
        const int zz = z0 + r / ny, yy = y0 + r % ny;
        const int x = x0 + xs * GS_SEG + lane;
        if (x > x1) return;
        const int p = (zz * H + yy) * W + x;
        if (__ldg(lab + p) != k) return;
        rl = k;
#pragma unroll
        for (int c = 0; c < MAXC; ++c)
            if (c < C) rv[c] = __ldg(s_chan[c] + p);
    };

    float s = 0.0f, lo = INFINITY, hi = -INFINITY;  // lane c: channel c
    load(0);
    for (int t = 0; t < tiles; ++t) {
        __syncthreads();  // warp 0 is done with the last tile
        s_lab[threadIdx.x] = rl;
        if (rl == k) {
#pragma unroll
            for (int c = 0; c < MAXC; ++c)
                if (c < C) s_val[c * GS_STRIDE + threadIdx.x] = rv[c];
        }
        __syncthreads();
        if (t + 1 < tiles) load(t + 1);
        if (warp == 0) {
#pragma unroll 1
            for (int j = 0; j < GS_TILE_SEGS; ++j) {
                const unsigned m = __ballot_sync(0xffffffffu, s_lab[j * GS_SEG + lane] == k);
                if (m == 0 || lane >= C) continue;
                const float* v = s_val + lane * GS_STRIDE + j * GS_SEG;
#pragma unroll
                for (int i = 0; i < GS_SEG; ++i) {
                    const float x = v[i];
                    const bool on = (m >> i) & 1u;
                    s = __fadd_rn(s, on ? x : 0.0f);
                    lo = on ? tm_nanmin(lo, x) : lo;
                    hi = on ? tm_nanmax(hi, x) : hi;
                }
            }
        }
    }
    if (warp == 0 && lane < C) {
        sums[row + lane] = s;
        mins[row + lane] = lo;
        maxs[row + lane] = hi;
    }
}

template <int MAXC>
static cudaError_t gs_walk_launch(const int* labels, const GsChannels& ch, const int* box,
                                  float* sums, float* mins, float* maxs, int B, int Z, int H,
                                  int W, int C, int K, cudaStream_t s) {
    gs_walk<MAXC><<<dim3(K, B), GS_THREADS, 0, s>>>(labels, ch, box, sums, mins, maxs, Z, H,
                                                    W, C, K);
    return cudaGetLastError();
}

// labels (B, Z*H*W) int32, box (B, K, 6) int32 scratch, outputs (B, K, C)
// f32; `channels` and `site_strides`, host arrays of C entries: channel c
// of site s is Z*H*W f32 at channels[c] + s * site_strides[c] (elements).
extern "C" int tm_grouped_stats(const void* labels, void* box, void* sums, void* mins,
                                void* maxs, const void* const* channels,
                                const long long* site_strides, int B, int Z, int H, int W,
                                int C, int K, int bands, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (C < 1 || C > TM_MAX_CHANNELS || K < 1 || B < 1 || B > 65535 || bands < 1 ||
        bands > 65535)
        return (int)cudaErrorInvalidValue;
    const int total = B * K * GS_BOX;
    gs_box_init<<<(total + 255) / 256, 256, 0, s>>>((int*)box, total);
    gs_boxes<<<dim3(bands, B), GS_BOX_THREADS, 0, s>>>((const int*)labels, (int*)box, Z, H, W,
                                                       K);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    GsChannels ch = {};
    for (int c = 0; c < C; ++c) {
        ch.p[c] = (const float*)channels[c];
        ch.site[c] = site_strides[c];
    }
    const int* l = (const int*)labels;
    const int* bx = (const int*)box;
    float *su = (float*)sums, *mn = (float*)mins, *mx = (float*)maxs;
    if (C <= 4) return (int)gs_walk_launch<4>(l, ch, bx, su, mn, mx, B, Z, H, W, C, K, s);
    if (C <= 8) return (int)gs_walk_launch<8>(l, ch, bx, su, mn, mx, B, Z, H, W, C, K, s);
    if (C <= 16) return (int)gs_walk_launch<16>(l, ch, bx, su, mn, mx, B, Z, H, W, C, K, s);
    return (int)gs_walk_launch<32>(l, ch, bx, su, mn, mx, B, Z, H, W, C, K, s);
}

// --------------------------------------------------- the first design
// Kept for the A/B harness (tmlibrary_tpu_torch/shootout.py `original`),
// with the NaN-propagating min/max: one block of 1024 threads per site,
// (1) every labelled pixel widens its object's box with four shared
// atomics, (2) one thread per object walks its box in pixel order with
// dependent global loads.  `phases` & TM_PHASE_WALK runs phase 2 (1: the
// boxes alone).
#define TM_ORIGINAL_MAX_CHANNELS 8

__global__ void __launch_bounds__(TM_BLOCK)
grouped_stats_original_kernel(const int* __restrict__ labels, const float* __restrict__ values,
                     float* sums, float* mins, float* maxs, int H, int W, int C,
                     int K, int phases) {
    extern __shared__ int box[];  // 4 * K: ymin, ymax, xmin, xmax
    int* ymin = box;
    int* ymax = box + K;
    int* xmin = box + 2 * K;
    int* xmax = box + 3 * K;
    const int n = H * W;
    const int* lab = labels + (size_t)blockIdx.x * n;
    const float* val = values + (size_t)blockIdx.x * C * n;

    for (int k = threadIdx.x; k < K; k += blockDim.x) {
        ymin[k] = H;
        ymax[k] = -1;
        xmin[k] = W;
        xmax[k] = -1;
    }
    __syncthreads();
    for (int p = threadIdx.x; p < n; p += blockDim.x) {
        int l = lab[p];
        if (l < 1 || l > K) continue;
        int y = p / W, x = p - y * W;
        atomicMin(&ymin[l - 1], y);
        atomicMax(&ymax[l - 1], y);
        atomicMin(&xmin[l - 1], x);
        atomicMax(&xmax[l - 1], x);
    }
    __syncthreads();
    if (!(phases & TM_PHASE_WALK)) return;

    for (int k = threadIdx.x; k < K; k += blockDim.x) {
        float s[TM_ORIGINAL_MAX_CHANNELS], lo[TM_ORIGINAL_MAX_CHANNELS], hi[TM_ORIGINAL_MAX_CHANNELS];
        for (int c = 0; c < C; ++c) {
            s[c] = 0.0f;
            lo[c] = INFINITY;
            hi[c] = -INFINITY;
        }
        for (int y = ymin[k]; y <= ymax[k]; ++y) {
            for (int x = xmin[k]; x <= xmax[k]; ++x) {
                int p = y * W + x;
                if (lab[p] != k + 1) continue;
                for (int c = 0; c < C; ++c) {
                    float v = val[(size_t)c * n + p];
                    s[c] = __fadd_rn(s[c], v);
                    lo[c] = tm_nanmin(lo[c], v);
                    hi[c] = tm_nanmax(hi[c], v);
                }
            }
        }
        size_t row = ((size_t)blockIdx.x * K + k) * C;
        for (int c = 0; c < C; ++c) {
            sums[row + c] = s[c];
            mins[row + c] = lo[c];
            maxs[row + c] = hi[c];
        }
    }
}

extern "C" int tm_grouped_stats_original(const void* labels, const void* values, void* sums,
                                void* mins, void* maxs, int B, int H, int W, int C,
                                int K, int phases, void* stream) {
    if (C < 1 || C > TM_ORIGINAL_MAX_CHANNELS) return (int)cudaErrorInvalidValue;
    size_t smem = 4 * (size_t)K * sizeof(int);
    if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
    grouped_stats_original_kernel<<<B, TM_BLOCK, smem, (cudaStream_t)stream>>>(
        (const int*)labels, (const float*)values, (float*)sums, (float*)mins,
        (float*)maxs, H, W, C, K, phases);
    return (int)cudaGetLastError();
}
