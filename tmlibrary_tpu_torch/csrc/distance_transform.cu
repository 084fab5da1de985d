// distance_transform for Hopper.
//
// Replaces the TPU kernel `_distance_kernel` / `distance_transform` in
// tmlibrary_tpu/ops/pallas_kernels.py (API `distance_transform`, the
// fixpoint of `distance_transform_approx`).  Same function: erosion
// counting with out-of-image pixels as foreground, at most
// `max_distance` erosions.  In closed form, a foreground pixel gets
//     dist = min(D, max_distance + 1)
// where D is the chessboard distance to the nearest background pixel
// inside the image (infinite if there is none); background gets 0.
// The output is float32 and bit-exact: whole numbers below 2**24, the
// value at which the reference's float32 sum of ones stops growing (the
// wrapper passes `cap` = min(max_distance, 2**24 - 1) + 1).
//
// Design: the chessboard distance is separable.  With g(y, x) the
// vertical distance to the nearest background pixel of column x (none:
// infinite),
//     D(y, x) = min_k max(|k|, g(y, x + k)),
// the smallest r >= 0 with min_{|k| <= r} g(y, x + k) <= r (at that r
// some |k| <= r has max(|k|, g) <= r; any k with g = s > |k| gives
// r <= s).  Everything is integer: no fixpoint, no iteration count, no
// atomics.  Two launches on one stream:
//   pass 1, columns (`dt_columns`): a block per (strip of 32 columns,
//     site), 512 blocks at 64 sites of 256x256.  It loads the strip's mask
//     rows 16 bytes at a time into shared memory, in chunks of 256 rows,
//     takes the distance down and up each column and writes min(g, reach)
//     to the wrapper's scratch in the narrowest type that holds `reach`
//     (8 bits at path D's cap of 64; 16, or 32 past 65,535), rows padded
//     to 16 entries with `reach`.  8 warps each take 32 rows of the
//     chunk, a lane a column, as a word of background bits: each row's
//     distance comes from the word and the values the segment inherits
//     from above and below, with no chain from row to row.  A column
//     longer than a chunk first sweeps its chunks bottom to top for the
//     values from below.
//   pass 2, rows (`dt_rows`): a block per (band of 8 rows, site), a warp
//     a row, 2,048 blocks at 64 sites.  The warp copies its row of g
//     into shared memory with 16-byte loads (rows too long for shared
//     memory are read from L2), and each lane takes 4 neighbouring
//     pixels, growing r until each pixel's window minimum is <= r; the 4
//     windows share their ends, so a step loads 2 entries.  A pixel takes
//     min(D, cap) + 1 steps, background none; a row whose every g
//     reaches `reach` is written at the cap at once (D >= min g).  Float4
//     stores where the row allows.
// `reach` = min(cap, max(H, W)) is the sentinel for "no background in
// reach": no in-image D reaches max(H, W), so an r of `reach` means
// D >= cap (or no background at all), written as `cap`; g is stored
// saturated at `reach` and every test r < reach reads it exactly.
// Entries past a row's ends read as `reach`: pixels beyond the image are
// foreground.
//
// Bound: one read of the 1-byte mask and one write of the 4-byte
// distance per pixel; g (a byte a pixel, 4 MB at 64 sites of 256x256)
// is written once and read once, in L2.
//
// `tm_distance_transform_original` keeps the first design for the A/B
// harness alone: one block of 1024 threads a site, a byte plane in
// shared memory swept until a sweep changes nothing, which caps
// max_distance at 254; it writes each site's sweep count.
#include "common.cuh"

#define DT_STRIP 32                    // columns of a pass-1 block, a lane each
#define DT_SEGS 8                      // warps of a pass-1 block, a segment of rows each
#define DT_SEG 32                      // rows of a segment
#define DT_CHUNK (DT_SEGS * DT_SEG)    // rows of a pass-1 chunk in shared memory
#define DT_ROWS 8                      // rows of a pass-2 block, a warp each
// shared memory a pass-2 block may take for its rows of g
#define DT_ROW_SMEM (200 * 1024)
#define DT_COLUMNS 1
#define DT_ROW_PASS 2

static inline bool dt_aligned16(const void* p) {
    return ((uintptr_t)p & 15) == 0;
}

// -------------------------------------------------------------- pass 1
// Rows [y0, y0 + rows) of the strip's mask into `sm`, by the whole block;
// columns past the image read as foreground.  16-byte loads where
// W % 16 == 0 on an aligned batch (`vec`), a byte a thread otherwise.
__device__ __forceinline__ void dt_load_mask(const uint8_t* __restrict__ m,
                                             uint8_t (*sm)[DT_STRIP], int y0, int rows, int x0,
                                             int cols, int W, bool vec) {
    if (vec) {
        const int nv = cols >> 4;  // whole vectors of the strip in the image
        for (int i = threadIdx.x; i < 2 * rows; i += blockDim.x) {
            const int r = i >> 1, h = i & 1;
            uint4 q = make_uint4(0x01010101u, 0x01010101u, 0x01010101u, 0x01010101u);
            if (h < nv)
                q = __ldg(reinterpret_cast<const uint4*>(m + (size_t)(y0 + r) * W + x0) + h);
            *reinterpret_cast<uint4*>(&sm[r][16 * h]) = q;
        }
    } else {
        for (int i = threadIdx.x; i < rows * DT_STRIP; i += blockDim.x) {
            const int r = i / DT_STRIP, c = i % DT_STRIP;
            sm[r][c] = c < cols ? m[(size_t)(y0 + r) * W + x0 + c] : (uint8_t)1;
        }
    }
}

// Rows of the strip from shared memory to g, by the whole block, 16 bytes
// at a time (`gcols` entries a row, a multiple of 16).
template <typename T>
__device__ __forceinline__ void dt_store_g(T* gs, T (*sg)[DT_STRIP], int y0, int rows, int x0,
                                           int gcols, int Wp) {
    constexpr int FULL = DT_STRIP * (int)sizeof(T) / 16;
    const int per = gcols * (int)sizeof(T) / 16;
    for (int i = threadIdx.x; i < rows * FULL; i += blockDim.x) {
        const int r = i / FULL, k = i - r * FULL;
        if (k < per)
            reinterpret_cast<uint4*>(gs + (size_t)(y0 + r) * Wp + x0)[k] =
                reinterpret_cast<const uint4*>(sg[r])[k];
    }
}

// A block per (strip of 32 columns, site); warp `seg` takes rows
// [32 seg, 32 seg + 32) of each chunk, a lane a column, as a 32-bit word
// of its background rows.  The word gives the segment's last and first
// background rows in one instruction each, and each row's distance to
// the nearest one above and below inside the segment; a row with none on
// a side adds its offset to the value entering the segment from that
// side, folded over the segments beyond it: one with a background pixel
// passes on its distance from its last (first) one, one without adds its
// length.  Chunks go top to bottom, the value from above carried along;
// the value from below, where a column has more than one chunk, is left
// first by a bottom-to-top sweep of folds in the first row of g of the
// chunk beneath, which the main sweep reads before it writes that row.
template <typename T>
__global__ void __launch_bounds__(DT_STRIP * DT_SEGS)
dt_columns(const uint8_t* __restrict__ mask, T* g, int H, int W, int Wp, int reach, bool vec) {
    __shared__ __align__(16) uint8_t sm[DT_CHUNK][DT_STRIP];
    __shared__ __align__(16) T sg[DT_CHUNK][DT_STRIP];
    __shared__ int last[DT_SEGS][DT_STRIP], first[DT_SEGS][DT_STRIP];  // rows in a segment, or -1
    __shared__ int carry[DT_STRIP];  // the value at the last row of the chunk above
    const int lane = threadIdx.x % DT_STRIP, seg = threadIdx.x / DT_STRIP;
    const int strips = (W + DT_STRIP - 1) / DT_STRIP;
    const int site = blockIdx.x / strips, x0 = (blockIdx.x - site * strips) * DT_STRIP;
    const uint8_t* m = mask + (size_t)site * H * W;
    T* gs = g + (size_t)site * H * Wp;
    const int cols = min(DT_STRIP, W - x0), gcols = min(DT_STRIP, Wp - x0);
    const int chunks = (H + DT_CHUNK - 1) / DT_CHUNK;
    const int r0 = seg * DT_SEG;
    // the background word of the chunk in `sm`: bit i, row r0 + i of the
    // segment's n rows; its first and last bits to the other warps
    auto background = [&](int rows) {
        const int n = max(0, min(DT_SEG, rows - r0));
        uint32_t bits = 0;
#pragma unroll
        for (int i = 0; i < DT_SEG; ++i)
            if (i < n && !sm[r0 + i][lane]) bits |= 1u << i;
        first[seg][lane] = bits ? __ffs(bits) - 1 : -1;
        last[seg][lane] = bits ? 31 - __clz(bits) : -1;
        return bits;
    };
    // the value from below folded up to the top of segment `to`
    auto fold_up = [&](int up, int rows, int to) {
        for (int j = (rows - 1) / DT_SEG; j >= to; --j) {
            const int e = first[j][lane];
            up = e >= 0 ? min(e, reach) : min(up + min(DT_SEG, rows - j * DT_SEG), reach);
        }
        return up;
    };

    int up = reach;  // bottom to top: the value at each chunk's first row
    for (int c = chunks - 1; c > 0; --c) {
        const int y0 = c * DT_CHUNK, rows = min(DT_CHUNK, H - y0);
        dt_load_mask(m, sm, y0, rows, x0, cols, W, vec);
        __syncthreads();
        background(rows);
        __syncthreads();
        if (seg == 0) {
            up = fold_up(up, rows, 0);
            if (lane < gcols) gs[(size_t)y0 * Wp + x0 + lane] = (T)up;
        }
        __syncthreads();
    }
    if (threadIdx.x < DT_STRIP) carry[threadIdx.x] = reach;
    for (int c = 0; c < chunks; ++c) {
        const int y0 = c * DT_CHUNK, rows = min(DT_CHUNK, H - y0);
        const int n = max(0, min(DT_SEG, rows - r0));
        const int below = c < chunks - 1 && lane < gcols
                              ? (int)gs[(size_t)(y0 + rows) * Wp + x0 + lane] : reach;
        dt_load_mask(m, sm, y0, rows, x0, cols, W, vec);
        __syncthreads();
        const uint32_t bits = background(rows);
        __syncthreads();
        int down = carry[lane];  // at the row above the segment
        for (int j = 0; j < seg; ++j) {  // the segments above are whole
            const int e = last[j][lane];
            down = e >= 0 ? min(DT_SEG - 1 - e, reach) : min(down + DT_SEG, reach);
        }
        const int up_in = fold_up(below, rows, seg + 1);  // at the row below the segment
#pragma unroll
        for (int i = 0; i < DT_SEG; ++i) {
            if (i >= n) break;
            const uint32_t above = bits & (0xffffffffu >> (31 - i)), beneath = bits >> i;
            const int d = above ? i - (31 - __clz(above)) : down + i + 1;
            const int u = beneath ? __ffs(beneath) - 1 : up_in + n - i;
            sg[r0 + i][lane] = (T)min(min(d, u), reach);
        }
        __syncthreads();
        if (n > 0 && r0 + n == rows)  // the chunk's last row
            carry[lane] = min(bits ? n - 1 - (31 - __clz(bits)) : down + n, reach);
        dt_store_g(gs, sg, y0, rows, x0, gcols, Wp);
        __syncthreads();
    }
}

// -------------------------------------------------------------- pass 2
// Entry i of a row of g; past either end, `reach`.
template <typename T>
__device__ __forceinline__ int dt_at(const T* row, int i, int W, int reach) {
    return (i >= 0 && i < W) ? (int)row[i] : reach;
}

// One row: lane by lane, 4 pixels at a time, out[x] = min(D, cap) from
// the row's g.
template <typename T>
__device__ __forceinline__ void dt_row(const T* row, float* __restrict__ o, int W, int reach,
                                       float cap, bool vec4, int lane) {
    int least = reach;
    for (int x = lane; x < W; x += 32) least = min(least, (int)row[x]);
    for (int s = 16; s > 0; s >>= 1) least = min(least, __shfl_xor_sync(0xffffffffu, least, s));
    const int nq = (W + 3) >> 2;
    for (int q = lane; q < nq; q += 32) {
        const int x0 = 4 * q;
        float v0 = cap, v1 = cap, v2 = cap, v3 = cap;
        if (least < reach) {
            // a_j = g[x0 + j - r] and b_j = g[x0 + j + r]: the ends of
            // pixel j's window at step r; m_j its minimum so far
            int a0 = dt_at(row, x0, W, reach), a1 = dt_at(row, x0 + 1, W, reach);
            int a2 = dt_at(row, x0 + 2, W, reach), a3 = dt_at(row, x0 + 3, W, reach);
            int b0 = a0, b1 = a1, b2 = a2, b3 = a3;
            int m0 = a0, m1 = a1, m2 = a2, m3 = a3;
            // r found for each pixel (-1: not yet); pixels past the row are done
            int r0 = m0 == 0 ? 0 : -1, r1 = (m1 == 0 || x0 + 1 >= W) ? 0 : -1;
            int r2 = (m2 == 0 || x0 + 2 >= W) ? 0 : -1, r3 = (m3 == 0 || x0 + 3 >= W) ? 0 : -1;
            for (int r = 1; (r0 | r1 | r2 | r3) < 0; ++r) {  // ends by r = reach: m_j <= reach
                a3 = a2; a2 = a1; a1 = a0; a0 = dt_at(row, x0 - r, W, reach);
                b0 = b1; b1 = b2; b2 = b3; b3 = dt_at(row, x0 + 3 + r, W, reach);
                m0 = min(m0, min(a0, b0)); m1 = min(m1, min(a1, b1));
                m2 = min(m2, min(a2, b2)); m3 = min(m3, min(a3, b3));
                if (r0 < 0 && m0 <= r) r0 = r;
                if (r1 < 0 && m1 <= r) r1 = r;
                if (r2 < 0 && m2 <= r) r2 = r;
                if (r3 < 0 && m3 <= r) r3 = r;
            }
            v0 = r0 < reach ? (float)r0 : cap; v1 = r1 < reach ? (float)r1 : cap;
            v2 = r2 < reach ? (float)r2 : cap; v3 = r3 < reach ? (float)r3 : cap;
        }
        if (vec4 && x0 + 4 <= W) {
            *reinterpret_cast<float4*>(o + x0) = make_float4(v0, v1, v2, v3);
        } else {
            const float v[4] = {v0, v1, v2, v3};
#pragma unroll
            for (int j = 0; j < 4; ++j)
                if (x0 + j < W) o[x0 + j] = v[j];
        }
    }
}

template <typename T, bool SMEM>
__global__ void __launch_bounds__(32 * DT_ROWS)
dt_rows(const T* __restrict__ g, float* __restrict__ out, int H, int W, int Wp, int reach,
        float cap, bool vec4) {
    extern __shared__ __align__(16) unsigned char dt_smem[];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int bands = (H + DT_ROWS - 1) / DT_ROWS;
    const int site = blockIdx.x / bands, y = (blockIdx.x - site * bands) * DT_ROWS + warp;
    if (y >= H) return;  // no block-wide barrier below: a warp a row
    const T* src = g + ((size_t)site * H + y) * Wp;
    float* o = out + ((size_t)site * H + y) * W;
    if (SMEM) {
        T* s = reinterpret_cast<T*>(dt_smem) + (size_t)warp * Wp;
        const int nv = Wp * (int)sizeof(T) / 16;
        for (int i = lane; i < nv; i += 32)
            reinterpret_cast<uint4*>(s)[i] = __ldcg(reinterpret_cast<const uint4*>(src) + i);
        __syncwarp();
        dt_row(s, o, W, reach, cap, vec4, lane);
    } else {
        dt_row(src, o, W, reach, cap, vec4, lane);
    }
}

template <typename T>
int dt_launch(const uint8_t* mask, T* g, float* out, int B, int H, int W, int cap, int reach,
              int phases, cudaStream_t stream) {
    const int Wp = (W + 15) & ~15;
    if (phases & DT_COLUMNS) {
        const bool vec = (W & 15) == 0 && dt_aligned16(mask);
        dt_columns<T><<<B * ((W + DT_STRIP - 1) / DT_STRIP), DT_STRIP * DT_SEGS, 0, stream>>>(
            mask, g, H, W, Wp, reach, vec);
        cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    if (phases & DT_ROW_PASS) {
        const bool vec4 = (W & 3) == 0 && dt_aligned16(out);
        const int grid = B * ((H + DT_ROWS - 1) / DT_ROWS);
        const size_t smem = (size_t)DT_ROWS * Wp * sizeof(T);
        if (smem <= DT_ROW_SMEM) {
            if (smem > 48 * 1024) {
                cudaError_t err = cudaFuncSetAttribute(
                    dt_rows<T, true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
                if (err != cudaSuccess) return (int)err;
            }
            dt_rows<T, true><<<grid, 32 * DT_ROWS, smem, stream>>>(g, out, H, W, Wp, reach,
                                                                  (float)cap, vec4);
        } else {
            dt_rows<T, false><<<grid, 32 * DT_ROWS, 0, stream>>>(g, out, H, W, Wp, reach,
                                                                (float)cap, vec4);
        }
    }
    return (int)cudaGetLastError();
}

// mask (B, H, W) bytes; g the scratch, (B, H, round_up(W, 16)) entries of
// 8 bits (16 where reach > 255, 32 where reach > 65535); out (B, H, W)
// float32; cap = min(max_distance, 2**24 - 1) + 1 and reach = min(cap,
// max(H, W)) from the wrapper; phases 1 (columns), 2 (rows) or both.
extern "C" int tm_distance_transform(const void* mask, void* g, void* out, int B, int H, int W,
                                     int cap, int reach, int phases, void* stream) {
    if (B <= 0 || H <= 0 || W <= 0) return (int)cudaGetLastError();
    if (reach > 65535)
        return dt_launch((const uint8_t*)mask, (uint32_t*)g, (float*)out, B, H, W, cap, reach,
                         phases, (cudaStream_t)stream);
    if (reach > 255)
        return dt_launch((const uint8_t*)mask, (uint16_t*)g, (float*)out, B, H, W, cap, reach,
                         phases, (cudaStream_t)stream);
    return dt_launch((const uint8_t*)mask, (uint8_t*)g, (float*)out, B, H, W, cap, reach,
                     phases, (cudaStream_t)stream);
}

// ------------------------------------------------ the rival for the A/B harness
// The first design.  Background starts at 0 and foreground at the cap
// max_distance + 1 (at most 255: a byte a pixel); each sweep sets every
// foreground pixel to min(itself, 1 + the least of its in-image
// 8-neighbours), in place, alternating direction, until a sweep changes
// nothing (__syncthreads_or), after about max D + 1 sweeps.  Sites of at
// most 232,448 pixels.
__global__ void __launch_bounds__(TM_BLOCK)
dt_original(const uint8_t* __restrict__ mask, int* sweeps, float* __restrict__ out, int H, int W,
            int cap) {
    extern __shared__ uint8_t d[];
    const int n = H * W;
    const size_t base = (size_t)blockIdx.x * n;
    for (int p = threadIdx.x; p < n; p += blockDim.x)
        d[p] = mask[base + p] ? (uint8_t)cap : (uint8_t)0;
    __syncthreads();
    for (int sweep = 0;; ++sweep) {
        int changed = 0;
        for (int k = 0; k < n; k += blockDim.x) {
            if (k + (int)threadIdx.x >= n) break;
            int p = tm_sweep_pixel(k, threadIdx.x, n, sweep);
            int cur = d[p];
            if (cur == 0) continue;
            int y = p / W, x = p - y * W;
            int least = cur;
            for (int j = 0; j < 8; ++j) {
                int yy = y + tm_dy(j), xx = x + tm_dx(j);
                if (yy < 0 || yy >= H || xx < 0 || xx >= W) continue;
                least = min(least, (int)d[yy * W + xx]);
            }
            if (least + 1 < cur) {
                d[p] = (uint8_t)(least + 1);
                changed = 1;
            }
        }
        if (!__syncthreads_or(changed)) {
            if (threadIdx.x == 0) sweeps[blockIdx.x] = sweep + 1;
            break;
        }
    }
    for (int p = threadIdx.x; p < n; p += blockDim.x) out[base + p] = (float)d[p];
}

extern "C" int tm_distance_transform_original(const void* mask, void* sweeps, void* out, int B,
                                              int H, int W, int max_distance, void* stream) {
    if (B <= 0) return (int)cudaGetLastError();
    const int smem = H * W;
    cudaError_t err =
        cudaFuncSetAttribute(dt_original, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    dt_original<<<B, TM_BLOCK, smem, (cudaStream_t)stream>>>(
        (const uint8_t*)mask, (int*)sweeps, (float*)out, H, W, max_distance + 1);
    return (int)cudaGetLastError();
}
