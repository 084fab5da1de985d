// glcm_all for Hopper.
//
// Replaces the TPU kernel `_glcm_kernel` / `_glcm_call` in
// tmlibrary_tpu/ops/fused_measure.py (API `glcm_all`).  Same function:
// for each of up to 4 offsets (dy, dx) and each object id 1..M, the
// gray-level co-occurrence counts of pixel pairs p = (y, x) and
// p' = (y - dy, x - dx) that both lie in the image and carry the same
// label, both pixels quantised with the object's own bounds by
// tm_quantize (quantize_per_object's expression); then symmetrised,
// c + c^T, as the JAX wrapper does after its kernel.  The partner
// follows from the reference's lab2 = shift_with_fill(labels, -dy, -dx),
// i.e. lab2[y, x] = labels[y - dy, x - dx].
//
// The kernel takes the raw per-object (min, max) and derives each
// object's lo and span itself (tm_object_bounds), so the call launches no
// PyTorch op around it.
//
// Design (count_table.cuh): one cluster of 2 blocks per site; the table
// is cut into windows of objects, an object's row holding its L x L block
// for every direction, each padded to L x (L + 1) words (M=256, L=16, 4
// directions: windows of 26 objects, a 111 KB replica per block; one
// window holds the main path's ids).  Each block reads half the site a
// quad of pixels a thread at a time, quantises every pixel of an id in
// the window once with the window's staged lo and span, takes each pair's
// partner from the planes, and adds c[q1][q2] once per pair into its own
// replica with shared-memory atomics.  For Haralick's four offsets at
// distance 1 (STD: (0,1), (1,0), (1,1), (1,-1), as compile-time
// positions) a thread loads its quad's row and the row above as 16-byte
// loads (all labels first, then the values of the warps that count) and
// gets the pixels left and right of the quad from its neighbour lanes
// (__shfl_up/down_sync), so a partner costs no load of its own and no
// second quantisation.  Any other offsets, odd widths and planes that are
// not 16-byte aligned go a pixel a thread: it loads each partner's label,
// then the values of the partners with the same id.  No shifted copies of
// the batch, unlike the TPU wrapper.  The replicas are then summed
// through distributed shared memory and every cell written once as
// c[a][b] + c[b][a] (the padding keeps the transposed read free of bank
// conflicts); rows of ids above the site's largest are written as zeros.
// Where one object's row exceeds a block's shared memory (FLAT: L above
// 120 with 4 directions), windows are flat ranges of the site's cells and
// each pair adds at [q1][q2] and [q2][q1], so the table holds c + c^T
// directly.
//
// Bound: bytes.  Labels and values are read once (8 B a pixel; the
// partners are neighbours, served from L1/L2) and the table written once
// (4 B a cell, D x M x L x L cells a site).
//
// `tm_glcm_all_atomic` keeps the first design (one thread per pixel,
// float atomicAdd of 1.0f at [q1][q2] and [q2][q1] of the memset output
// in global memory) as the baseline of the interleaved A/B harness
// (tmlibrary_tpu_torch/shootout.py); no other caller reaches it.
#include "count_table.cuh"

#define TM_GLCM_MAX_DIRS 4

struct GlcmOffsets {
    int dy[TM_GLCM_MAX_DIRS];
    int dx[TM_GLCM_MAX_DIRS];
};

// lo and span of id `l` for a window of ids id_lo..id_hi: staged (rows)
// or read from the raw bounds (FLAT)
template <bool FLAT>
__device__ __forceinline__ void glcm_bounds(int l, int id_lo, const float* s_lo,
                                            const float* s_span, const float* site_lo,
                                            const float* site_hi, float* lo, float* span) {
    if constexpr (FLAT) {
        tm_object_bounds(site_lo, site_hi, l, lo, span);
    } else {
        *lo = s_lo[l - id_lo], *span = s_span[l - id_lo];
    }
}

template <bool FLAT, bool STD>
__global__ void __launch_bounds__(TM_TABLE_THREADS)
glcm_table_kernel(const int* __restrict__ labels, const float* __restrict__ img,
                  const float* __restrict__ raw_lo, const float* __restrict__ raw_hi,
                  float* __restrict__ out, int H, int W, int M, int L, int D, GlcmOffsets off,
                  int R, int windows) {
    extern __shared__ __align__(16) unsigned tbl[];
    __shared__ int kmax_slot;
    const int S = L * (L + 1);  // a padded block
    // the replica, then (rows only) the window's staged lo and span, R of each
    float* s_lo = reinterpret_cast<float*>(tbl + tm_table_words(FLAT ? R : R * D * S));
    float* s_span = s_lo + R;
    cg::cluster_group cl = cg::this_cluster();
    const int C = (int)cl.num_blocks();
    const int rank = (int)cl.block_rank();
    const size_t site = blockIdx.y;
    const int n = H * W;
    const int LL = L * L;
    const long long cells = (long long)D * M * LL;  // the site's table, (D, M, L, L)
    float* o = out + site * cells;
    const int* lab = labels + site * n;
    const float* val = img + site * n;
    const float* site_lo = raw_lo + site * M;
    const float* site_hi = raw_hi + site * M;
    int start, end;
    tm_table_share(n, rank, C, STD, &start, &end);
    const int lane = threadIdx.x & 31;
    constexpr int V = STD ? 4 : 1;  // pixels a thread: a quad, or one

    int K = M;  // the site's largest id, found by window 0's scan
    if (threadIdx.x == 0) kmax_slot = 0;
    for (int w = 0; w < windows; ++w) {
        // FLAT: the window's cells [f0, f1).  Otherwise ids id_lo..id_hi,
        // counted into a replica of `stride` objects
        long long f0 = 0, f1 = 0;
        int id_lo = 1, id_hi = M;
        if constexpr (FLAT) {
            f0 = (long long)w * R;
            f1 = min(cells, f0 + R);
        } else {
            if (w * R >= K) break;  // ids above K do not occur
            id_lo = w * R + 1, id_hi = min(w * R + R, K);
        }
        const bool find_k = !FLAT && w == 0;
        const int stride = id_hi - id_lo + 1;
        tm_table_zero(tbl, FLAT ? (int)(f1 - f0) : D * stride * S);
        if constexpr (!FLAT) {
            for (int i = threadIdx.x; i < stride; i += blockDim.x)
                tm_object_bounds(site_lo, site_hi, id_lo + i, s_lo + i, s_span + i);
        }
        __syncthreads();
        auto in_window = [&](int l) { return l >= id_lo && l <= id_hi; };
        auto quantize = [&](int l, float v) {  // 0 for ids outside the window
            if (!in_window(l)) return 0;
            float lo, span;
            glcm_bounds<FLAT>(l, id_lo, s_lo, s_span, site_lo, site_hi, &lo, &span);
            return tm_quantize(v, lo, span, L);
        };

        int seen = 0;  // find_k: the largest id in 1..M among this thread's pixels
        for (int base = start + (int)(threadIdx.x - lane) * V; base < end;
             base += (int)blockDim.x * V) {
            const int p = base + lane * V;
            const int y = p / W, x = p - y * W;  // STD: the quad lies in one row (W % 4 == 0)
            // labels first: the quad's, and (STD) the row above it and the two
            // pixels beside the warp (rows y and y - 1), which no lane holds
            int l[V], q[V], la[4] = {}, el[2] = {};
            float v[V] = {}, va[4] = {}, ev[2] = {};
            const int xe = lane == 0 ? x - 1 : x + 4;
            const bool edge = STD && (lane == 0 || lane == 31) && p < n && xe >= 0 && xe < W;
            if constexpr (STD) {
                // a partner of the lanes beside, even past the block's share
                int4 l4 = p < n ? *reinterpret_cast<const int4*>(lab + p) : make_int4(0, 0, 0, 0);
                l[0] = l4.x, l[1] = l4.y, l[2] = l4.z, l[3] = l4.w;
                if (p < n && y > 0) {
                    int4 t = *reinterpret_cast<const int4*>(lab + p - W);
                    la[0] = t.x, la[1] = t.y, la[2] = t.z, la[3] = t.w;
                }
                if (edge) {
                    el[1] = lab[y * W + xe];
                    if (y > 0) el[0] = lab[(y - 1) * W + xe];
                }
            } else {
                l[0] = p < n ? lab[p] : 0;
            }
            bool any = false;
#pragma unroll
            for (int k = 0; k < V; ++k) {
                any |= p + k < end && in_window(l[k]);
                if (find_k && p + k < end && l[k] <= M) seen = max(seen, l[k]);
            }
            if (!__any_sync(TM_FULL_MASK, any)) continue;  // no id of the window here
            // then the values of the warps that count (and of their partners)
            if (p < n) {
                if constexpr (STD) {
                    float4 v4 = *reinterpret_cast<const float4*>(val + p);
                    v[0] = v4.x, v[1] = v4.y, v[2] = v4.z, v[3] = v4.w;
                } else {
                    v[0] = val[p];
                }
            }
            if constexpr (STD) {
                if (p < n && y > 0) {
                    float4 t = *reinterpret_cast<const float4*>(val + p - W);
                    va[0] = t.x, va[1] = t.y, va[2] = t.z, va[3] = t.w;
                }
                if (edge) {
                    ev[1] = val[y * W + xe];
                    if (y > 0) ev[0] = val[(y - 1) * W + xe];
                }
            }
#pragma unroll
            for (int k = 0; k < V; ++k) q[k] = quantize(l[k], v[k]);

            // each pair's partner: its label pl and quantised value pq
            int pl[V][TM_GLCM_MAX_DIRS], pq[V][TM_GLCM_MAX_DIRS];
            if constexpr (STD) {
                // rows y - 1 and y at columns x - 1 .. x + 4: this lane's quads,
                // the lanes beside (shuffles) and the pixels beside the warp
                int wl[2][6], wq[2][6];
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    wl[1][k + 1] = l[k], wq[1][k + 1] = q[k];
                    wl[0][k + 1] = la[k], wq[0][k + 1] = quantize(la[k], va[k]);
                }
#pragma unroll
                for (int r = 0; r < 2; ++r) {
                    wl[r][0] = __shfl_up_sync(TM_FULL_MASK, wl[r][4], 1);
                    wq[r][0] = __shfl_up_sync(TM_FULL_MASK, wq[r][4], 1);
                    wl[r][5] = __shfl_down_sync(TM_FULL_MASK, wl[r][1], 1);
                    wq[r][5] = __shfl_down_sync(TM_FULL_MASK, wq[r][1], 1);
                    if (edge) {
                        const int c = lane == 0 ? 0 : 5;
                        wl[r][c] = el[r], wq[r][c] = quantize(el[r], ev[r]);
                    }
                }
                // (0, 1): (y, x - 1); (1, 0): (y - 1, x); (1, 1): (y - 1, x - 1);
                // (1, -1): (y - 1, x + 1); out of the image: no partner
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    const bool left = x + k > 0, right = x + k + 1 < W, up = y > 0;
                    pl[k][0] = left ? wl[1][k] : 0, pq[k][0] = wq[1][k];
                    pl[k][1] = up ? wl[0][k + 1] : 0, pq[k][1] = wq[0][k + 1];
                    pl[k][2] = up && left ? wl[0][k] : 0, pq[k][2] = wq[0][k];
                    pl[k][3] = up && right ? wl[0][k + 2] : 0, pq[k][3] = wq[0][k + 2];
                }
            } else {
                // every partner label, then the values of the partners that match
#pragma unroll
                for (int k = 0; k < V; ++k) {
#pragma unroll
                    for (int d = 0; d < TM_GLCM_MAX_DIRS; ++d) {
                        const int y2 = y - off.dy[d], x2 = x + k - off.dx[d];
                        pl[k][d] = d < D && in_window(l[k]) && y2 >= 0 && y2 < H && x2 >= 0 &&
                                           x2 < W
                                       ? lab[y2 * W + x2] : 0;
                    }
                }
#pragma unroll
                for (int k = 0; k < V; ++k) {
#pragma unroll
                    for (int d = 0; d < TM_GLCM_MAX_DIRS; ++d) {
                        const int p2 = p + k - off.dy[d] * W - off.dx[d];
                        pq[k][d] = pl[k][d] == l[k] && in_window(l[k]) ? quantize(l[k], val[p2])
                                                                       : 0;
                    }
                }
            }

#pragma unroll
            for (int k = 0; k < V; ++k) {
                const int lk = l[k];
                const bool valid = p + k < end && in_window(lk);
#pragma unroll
                for (int d = 0; d < TM_GLCM_MAX_DIRS; ++d) {
                    if (d >= D) break;
                    int key = -1, mirror_key = -1;
                    if (valid && pl[k][d] == lk) {
                        const int q1 = q[k], q2 = pq[k][d];
                        if constexpr (FLAT) {
                            const long long blk = ((long long)d * M + lk - 1) * LL;
                            const long long f = blk + q1 * L + q2, mf = blk + q2 * L + q1;
                            if (f >= f0 && f < f1) key = (int)(f - f0);
                            if (mf >= f0 && mf < f1) mirror_key = (int)(mf - f0);
                        } else {
                            key = (d * stride + lk - id_lo) * S + q1 * (L + 1) + q2;
                        }
                    }
                    tm_table_add(tbl, key);
                    if constexpr (FLAT) tm_table_add(tbl, mirror_key);
                }
            }
        }
        if (find_k) tm_block_max(seen, &kmax_slot);
        cl.sync();  // every replica is complete (and every block's largest id posted)
        int live = stride;  // objects of the window at or below K
        if (find_k) {  // rows above K: zeros; window 0 keeps its objects up to K
            K = tm_cluster_max(&kmax_slot, C);
            for (int d = 0; d < D; ++d)
                tm_zero_share(o + ((long long)d * M + K) * LL, (long long)(M - K) * LL, rank, C);
            live = max(0, min(stride, K - id_lo + 1));
        }

        if constexpr (FLAT) {
            const long long share = ((f1 - f0 + C - 1) / C + 3) & ~3LL;
            const long long s0 = min(f1, f0 + rank * share), s1 = min(f1, s0 + share);
            for (long long i = s0 + threadIdx.x; i < s1; i += blockDim.x)
                o[i] = (float)tm_replica_sum(tbl, (int)(i - f0), C);
        } else {
            // block `rank` writes the live (direction, object) blocks [p0, p1)
            const int pairs = D * live, per = (pairs + C - 1) / C;
            const int p0 = min(pairs, rank * per), p1 = min(pairs, p0 + per);
            const int step = (int)blockDim.x % LL == 0 ? (int)blockDim.x / LL : 0;
            const int cell0 = threadIdx.x % LL, a0 = cell0 / L, c0 = cell0 - a0 * L;
            for (long long i = step ? p0 + threadIdx.x / LL : (long long)p0 * LL + threadIdx.x;
                 step ? i < p1 : i < (long long)p1 * LL; i += step ? step : blockDim.x) {
                const int pair = step ? (int)i : (int)(i / LL);
                const int cell = step ? cell0 : (int)(i - (long long)pair * LL);
                const int a = step ? a0 : cell / L, c = step ? c0 : cell % L;
                const int d = pair / live, obj = pair - d * live;
                const int b = (d * stride + obj) * S;
                unsigned sum = 0;
                for (int j = 0; j < C; ++j) {
                    const unsigned* t = cl.map_shared_rank(tbl, j) + b;
                    sum += t[a * (L + 1) + c] + t[c * (L + 1) + a];
                }
                o[((long long)d * M + id_lo - 1 + obj) * LL + cell] = (float)sum;
            }
        }
        cl.sync();  // no block rezeroes or leaves while a partner reads its replica
    }
}

template <bool FLAT, bool STD>
static cudaError_t launch_glcm(const void* labels, const void* img, const void* raw_lo,
                               const void* raw_hi, void* out, int B, int H, int W, int M, int L,
                               int D, GlcmOffsets off, int R, int windows, cudaStream_t s) {
    // the replica, then (rows only) the window's staged lo and span
    const long long words = FLAT ? (long long)R : (long long)R * D * L * (L + 1);
    if (words > TM_TABLE_MAX_SMEM / 4) return cudaErrorInvalidValue;
    const long long smem = (tm_table_words((int)words) + (FLAT ? 0LL : 2LL * R)) * 4;
    if (smem > TM_TABLE_MAX_SMEM) return cudaErrorInvalidValue;
    return tm_table_launch(glcm_table_kernel<FLAT, STD>, TM_TABLE_THREADS, B, (int)smem, s,
                           (const int*)labels, (const float*)img, (const float*)raw_lo,
                           (const float*)raw_hi, (float*)out, H, W, M, L, D, off, R, windows);
}

template <bool STD>
static cudaError_t launch_glcm_flat(bool flat, const void* labels, const void* img,
                                    const void* raw_lo, const void* raw_hi, void* out, int B,
                                    int H, int W, int M, int L, int D, GlcmOffsets off, int R,
                                    int windows, cudaStream_t s) {
    if (flat)
        return launch_glcm<true, STD>(labels, img, raw_lo, raw_hi, out, B, H, W, M, L, D, off, R,
                                      windows, s);
    return launch_glcm<false, STD>(labels, img, raw_lo, raw_hi, out, B, H, W, M, L, D, off, R,
                                   windows, s);
}

// raw_lo, raw_hi: the raw per-object (min, max), (B, M) float32.  The
// window plan: R objects (cells when `flat`) a window, `windows` windows
// a site.
extern "C" int tm_glcm_all(const void* labels, const void* img, const void* raw_lo,
                           const void* raw_hi, void* out, int B, int H, int W, int M, int L,
                           int D, int dy0, int dx0, int dy1, int dx1, int dy2, int dx2, int dy3,
                           int dx3, int R, int windows, int flat, void* stream) {
    const int n = H * W;
    const long long need = flat ? (long long)D * M * L * L : (long long)M;
    if (M < 1 || L < 2 || D < 1 || D > TM_GLCM_MAX_DIRS || n < 1 || R < 1 || windows < 1 ||
        (long long)R * windows < need)
        return (int)cudaErrorInvalidValue;
    GlcmOffsets off = {{dy0, dy1, dy2, dy3}, {dx0, dx1, dx2, dx3}};
    cudaStream_t s = (cudaStream_t)stream;
    // Haralick's offsets (0,1), (1,0), (1,1), (1,-1) on whole quads (each in
    // one row) of 16-byte aligned planes
    const bool std4 = W % 4 == 0 && tm_aligned16(labels) && tm_aligned16(img) && D == 4 &&
                      dy0 == 0 && dx0 == 1 && dy1 == 1 && dx1 == 0 && dy2 == 1 && dx2 == 1 &&
                      dy3 == 1 && dx3 == -1;
    cudaError_t err =
        std4 ? launch_glcm_flat<true>(flat, labels, img, raw_lo, raw_hi, out, B, H, W, M, L, D,
                                      off, R, windows, s)
             : launch_glcm_flat<false>(flat, labels, img, raw_lo, raw_hi, out, B, H, W, M, L, D,
                                       off, R, windows, s);
    return (int)err;
}

// ------------------------------------------ the first design (A/B baseline)
#define TM_ATOMIC_THREADS 256
// `phases` of tm_*_atomic: the memset of the output, the counting kernel
#define TM_PHASE_MEMSET 1
#define TM_PHASE_KERNEL 2

__global__ void __launch_bounds__(TM_ATOMIC_THREADS)
glcm_atomic_kernel(const int* __restrict__ labels, const float* __restrict__ img,
                   const float* __restrict__ lo_full, const float* __restrict__ span_full,
                   float* counts, int H, int W, int M, int L, int D, GlcmOffsets off) {
    int n = H * W;
    int p = blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= n) return;
    size_t site = blockIdx.y;
    const int* lab = labels + site * n;
    const float* val = img + site * n;
    int l = lab[p];
    if (l < 1 || l > M) return;
    size_t row = site * (M + 1) + l;
    float lo = lo_full[row], span = span_full[row];
    int q1 = tm_quantize(val[p], lo, span, L);
    int y = p / W, x = p - y * W;
    for (int d = 0; d < D; ++d) {
        int y2 = y - off.dy[d], x2 = x - off.dx[d];
        if (y2 < 0 || y2 >= H || x2 < 0 || x2 >= W) continue;
        int p2 = y2 * W + x2;
        if (lab[p2] != l) continue;
        int q2 = tm_quantize(val[p2], lo, span, L);
        float* glcm = counts + (((site * D + d) * M + (l - 1)) * L) * L;
        atomicAdd(&glcm[q1 * L + q2], 1.0f);
        atomicAdd(&glcm[q2 * L + q1], 1.0f);
    }
}

extern "C" int tm_glcm_all_atomic(const void* labels, const void* img, const void* lo_full,
                                  const void* span_full, void* out, int B, int H, int W, int M,
                                  int L, int D, int dy0, int dx0, int dy1, int dx1, int dy2,
                                  int dx2, int dy3, int dx3, int phases, void* stream) {
    if (B < 1 || B > 65535 || M < 1 || L < 2 || D < 1 || D > TM_GLCM_MAX_DIRS)
        return (int)cudaErrorInvalidValue;
    GlcmOffsets off = {{dy0, dy1, dy2, dy3}, {dx0, dx1, dx2, dx3}};
    cudaStream_t s = (cudaStream_t)stream;
    int n = H * W;
    if (phases & TM_PHASE_MEMSET) {
        cudaError_t err =
            cudaMemsetAsync(out, 0, (size_t)B * D * M * L * L * sizeof(float), s);
        if (err != cudaSuccess) return (int)err;
    }
    if (phases & TM_PHASE_KERNEL) {
        dim3 grid((n + TM_ATOMIC_THREADS - 1) / TM_ATOMIC_THREADS, B);
        glcm_atomic_kernel<<<grid, TM_ATOMIC_THREADS, 0, s>>>(
            (const int*)labels, (const float*)img, (const float*)lo_full,
            (const float*)span_full, (float*)out, H, W, M, L, D, off);
    }
    return (int)cudaGetLastError();
}
