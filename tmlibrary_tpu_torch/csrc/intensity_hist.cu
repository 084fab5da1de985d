// intensity_hist for Hopper.
//
// Replaces the TPU kernel `_hist_kernel` / `_hist_call` in
// tmlibrary_tpu/ops/fused_measure.py (API `intensity_hist`).  Same
// function: per site and object id 1..M the count of its pixels in each
// of `bins` gray-level buckets, each object's range stretched over the
// buckets by tm_quantize (quantize_per_object's expression); pixels with
// a label outside 1..M are dropped, as the TPU kernel's padded one-hot
// columns drop them.  A pixel whose object the bounds call absent (lo 0,
// span 1) is counted like any other, as the reference counts it.
//
// The kernel takes the raw per-object (min, max) and derives each
// object's lo and span itself (tm_object_bounds), so the call launches no
// PyTorch op around it.
//
// Design (count_table.cuh): one cluster of 2 blocks per site (64 sites
// fill the card's 132 SMs in one wave); the (M x bins) table is cut into
// windows of whole rows (M=256, bins=256: windows of 86 rows, an 87 KB
// replica per block; one window holds the main path's ids).  Each block
// reads half the site, two quads of pixels a thread at a time (16-byte
// loads of both quads' labels, then of the values of both where a label is
// in the window, 3% of the main path's pixels: a thread waits on two
// loads, not one for each quad), quantises those pixels with the
// window's staged lo and span and adds them into its own replica with
// shared-memory atomics; the replicas are then summed through distributed
// shared memory, and rows of ids above the site's largest are written as
// zeros.
//
// Bound: bytes.  Each pixel's label and value are read once (8 B) and
// the count table written once (4 B a cell); the work is a handful of
// operations a pixel.
//
// `tm_intensity_hist_atomic` keeps the first design (one thread per
// pixel, float atomicAdd of 1.0f into the memset output in global
// memory) as the baseline of the interleaved A/B harness
// (tmlibrary_tpu_torch/shootout.py); no other caller reaches it.
#include "count_table.cuh"

// quads of pixels a thread loads before it counts any of them
#define TM_HIST_QUADS 2

// FLAT: windows of R cells of the flat (M x bins) table (one row exceeds
// a block's shared memory); otherwise windows of R rows.
template <bool VEC, bool FLAT>
__global__ void __launch_bounds__(TM_TABLE_THREADS)
hist_table_kernel(const int* __restrict__ labels, const float* __restrict__ img,
                  const float* __restrict__ raw_lo, const float* __restrict__ raw_hi,
                  float* __restrict__ out, int n, int M, int bins, int R, int windows) {
    extern __shared__ __align__(16) unsigned tbl[];
    __shared__ int kmax_slot;
    // the replica, then (rows only) the window's staged lo and span, R of each
    float* s_lo = reinterpret_cast<float*>(tbl + tm_table_words(FLAT ? R : R * bins));
    float* s_span = s_lo + R;
    cg::cluster_group cl = cg::this_cluster();
    const int C = (int)cl.num_blocks();
    const int rank = (int)cl.block_rank();
    const size_t site = blockIdx.y;
    const long long cells = (long long)M * bins;
    float* o = out + site * cells;
    const int* lab = labels + site * n;
    const float* val = img + site * n;
    const float* site_lo = raw_lo + site * M;
    const float* site_hi = raw_hi + site * M;
    int start, end;
    tm_table_share(n, rank, C, VEC, &start, &end);
    const int lane = threadIdx.x & 31;
    constexpr int V = VEC ? 4 : 1, Q = VEC ? TM_HIST_QUADS : 1;

    int K = M;  // the site's largest id, found by window 0's scan
    if (threadIdx.x == 0) kmax_slot = 0;
    for (int w = 0; w < windows; ++w) {
        // the window's cells [f0, f1) and the ids whose counts land there
        long long f0, f1;
        int id_lo, id_hi;
        if constexpr (FLAT) {
            f0 = (long long)w * R;
            f1 = min(cells, f0 + R);
            id_lo = (int)(f0 / bins) + 1, id_hi = (int)((f1 - 1) / bins) + 1;
        } else {
            if (w * R >= K) break;  // ids above K do not occur
            id_lo = w * R + 1, id_hi = min(w * R + R, K);
            f0 = (long long)(id_lo - 1) * bins, f1 = (long long)id_hi * bins;
        }
        const bool find_k = !FLAT && w == 0;
        tm_table_zero(tbl, (int)(f1 - f0));
        if constexpr (!FLAT) {
            for (int i = threadIdx.x; i <= id_hi - id_lo; i += blockDim.x)
                tm_object_bounds(site_lo, site_hi, id_lo + i, s_lo + i, s_span + i);
        }
        __syncthreads();

        int seen = 0;  // find_k: the largest id in 1..M among this thread's pixels
        for (int base = start + (int)(threadIdx.x - lane) * V * Q; base < end;
             base += (int)blockDim.x * V * Q) {
            int l[Q][V];
#pragma unroll
            for (int j = 0; j < Q; ++j) {  // the labels of every quad first
                const int p = base + (j * 32 + lane) * V;
                if constexpr (VEC) {
                    int4 l4 = p < end ? *reinterpret_cast<const int4*>(lab + p)
                                      : make_int4(0, 0, 0, 0);
                    l[j][0] = l4.x, l[j][1] = l4.y, l[j][2] = l4.z, l[j][3] = l4.w;
                } else {
                    l[j][0] = p < end ? lab[p] : 0;
                }
            }
            bool here[Q], any = false;  // an id of the window in quad j, in any
#pragma unroll
            for (int j = 0; j < Q; ++j) {
                here[j] = false;
#pragma unroll
                for (int k = 0; k < V; ++k) {
                    here[j] |= l[j][k] >= id_lo && l[j][k] <= id_hi;
                    if (find_k && l[j][k] <= M) seen = max(seen, l[j][k]);
                }
                any |= here[j];
            }
            if (!any) continue;
            float v[Q][V];
#pragma unroll
            for (int j = 0; j < Q; ++j) {  // values only where they count, all in flight
                const int p = base + (j * 32 + lane) * V;
                if constexpr (VEC) {
                    float4 v4 = here[j] ? *reinterpret_cast<const float4*>(val + p)
                                        : make_float4(0, 0, 0, 0);
                    v[j][0] = v4.x, v[j][1] = v4.y, v[j][2] = v4.z, v[j][3] = v4.w;
                } else {
                    v[j][0] = here[j] ? val[p] : 0.0f;
                }
            }
#pragma unroll
            for (int j = 0; j < Q; ++j) {
#pragma unroll
                for (int k = 0; k < V; ++k) {
                    const int lk = l[j][k];
                    if (lk < id_lo || lk > id_hi) continue;
                    float lo, span;
                    if constexpr (FLAT) {
                        tm_object_bounds(site_lo, site_hi, lk, &lo, &span);
                    } else {
                        lo = s_lo[lk - id_lo], span = s_span[lk - id_lo];
                    }
                    const long long f =
                        (long long)(lk - 1) * bins + tm_quantize(v[j][k], lo, span, bins);
                    if (f >= f0 && f < f1) tm_table_add(tbl, (int)(f - f0));
                }
            }
        }
        if (find_k) tm_block_max(seen, &kmax_slot);
        cl.sync();  // every replica is complete (and every block's largest id posted)
        if (find_k) {  // rows above K: zeros; window 0 keeps its rows up to K
            K = tm_cluster_max(&kmax_slot, C);
            tm_zero_share(o + (long long)K * bins, cells - (long long)K * bins, rank, C);
            id_hi = min(id_hi, K);
            f1 = max(f0, (long long)id_hi * bins);
        }

        const long long share = ((f1 - f0 + C - 1) / C + 3) & ~3LL;  // cells a block writes
        const long long s0 = min(f1, f0 + rank * share), s1 = min(f1, s0 + share);
        if (cells % 4 == 0 && f0 % 4 == 0 && f1 % 4 == 0) {
            float4* o4 = reinterpret_cast<float4*>(o);
            for (long long i = s0 / 4 + threadIdx.x; i < s1 / 4; i += blockDim.x) {
                uint4 c = make_uint4(0, 0, 0, 0);
                for (int j = 0; j < C; ++j) {
                    uint4 r =
                        reinterpret_cast<const uint4*>(cl.map_shared_rank(tbl, j))[i - f0 / 4];
                    c.x += r.x, c.y += r.y, c.z += r.z, c.w += r.w;
                }
                o4[i] = make_float4((float)c.x, (float)c.y, (float)c.z, (float)c.w);
            }
        } else {
            for (long long i = s0 + threadIdx.x; i < s1; i += blockDim.x)
                o[i] = (float)tm_replica_sum(tbl, (int)(i - f0), C);
        }
        cl.sync();  // no block rezeroes or leaves while a partner reads its replica
    }
}

template <bool VEC, bool FLAT>
static cudaError_t launch_hist(const void* labels, const void* img, const void* raw_lo,
                               const void* raw_hi, void* out, int B, int n, int M, int bins,
                               int R, int windows, cudaStream_t s) {
    // the replica, then (rows only) the window's staged lo and span
    const long long words = FLAT ? (long long)R : (long long)R * bins;
    if (words > TM_TABLE_MAX_SMEM / 4) return cudaErrorInvalidValue;
    const long long smem = (tm_table_words((int)words) + (FLAT ? 0LL : 2LL * R)) * 4;
    if (smem > TM_TABLE_MAX_SMEM) return cudaErrorInvalidValue;
    return tm_table_launch(hist_table_kernel<VEC, FLAT>, TM_TABLE_THREADS, B, (int)smem, s,
                           (const int*)labels, (const float*)img, (const float*)raw_lo,
                           (const float*)raw_hi, (float*)out, n, M, bins, R, windows);
}

// raw_lo, raw_hi: the raw per-object (min, max), (B, M) float32.  The
// window plan: R rows (cells when `flat`) a window, `windows` windows a
// site.
extern "C" int tm_intensity_hist(const void* labels, const void* img, const void* raw_lo,
                                 const void* raw_hi, void* out, int B, int H, int W, int M,
                                 int bins, int R, int windows, int flat, void* stream) {
    const int n = H * W;
    const long long need = flat ? (long long)M * bins : (long long)M;
    if (M < 1 || bins < 2 || n < 1 || R < 1 || windows < 1 || (long long)R * windows < need)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    // 16-byte loads: whole quads in every site, from 16-byte aligned planes
    const bool vec = n % 4 == 0 && tm_aligned16(labels) && tm_aligned16(img);
    cudaError_t err;
    if (vec && !flat)
        err = launch_hist<true, false>(labels, img, raw_lo, raw_hi, out, B, n, M, bins, R,
                                       windows, s);
    else if (vec)
        err = launch_hist<true, true>(labels, img, raw_lo, raw_hi, out, B, n, M, bins, R,
                                      windows, s);
    else if (!flat)
        err = launch_hist<false, false>(labels, img, raw_lo, raw_hi, out, B, n, M, bins, R,
                                        windows, s);
    else
        err = launch_hist<false, true>(labels, img, raw_lo, raw_hi, out, B, n, M, bins, R,
                                       windows, s);
    return (int)err;
}

// ------------------------------------------ the first design (A/B baseline)
#define TM_ATOMIC_THREADS 256
// `phases` of tm_*_atomic: the memset of the output, the counting kernel
#define TM_PHASE_MEMSET 1
#define TM_PHASE_KERNEL 2

__global__ void __launch_bounds__(TM_ATOMIC_THREADS)
hist_atomic_kernel(const int* __restrict__ labels, const float* __restrict__ img,
                   const float* __restrict__ lo_full, const float* __restrict__ span_full,
                   float* counts, int n, int M, int bins) {
    int p = blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= n) return;
    size_t site = blockIdx.y;
    int l = labels[site * n + p];
    if (l < 1 || l > M) return;
    size_t row = site * (M + 1) + l;
    int q = tm_quantize(img[site * n + p], lo_full[row], span_full[row], bins);
    atomicAdd(&counts[((site * M) + (l - 1)) * bins + q], 1.0f);
}

extern "C" int tm_intensity_hist_atomic(const void* labels, const void* img,
                                        const void* lo_full, const void* span_full, void* out,
                                        int B, int H, int W, int M, int bins, int phases,
                                        void* stream) {
    if (B < 1 || M < 1 || bins < 2 || B > 65535) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    int n = H * W;
    if (phases & TM_PHASE_MEMSET) {
        cudaError_t err = cudaMemsetAsync(out, 0, (size_t)B * M * bins * sizeof(float), s);
        if (err != cudaSuccess) return (int)err;
    }
    if (phases & TM_PHASE_KERNEL) {
        dim3 grid((n + TM_ATOMIC_THREADS - 1) / TM_ATOMIC_THREADS, B);
        hist_atomic_kernel<<<grid, TM_ATOMIC_THREADS, 0, s>>>(
            (const int*)labels, (const float*)img, (const float*)lo_full,
            (const float*)span_full, (float*)out, n, M, bins);
    }
    return (int)cudaGetLastError();
}
