// Per-site count tables in shared memory: the common part of the
// intensity_hist and glcm_all kernels.
//
// A site's table has one row of counters per object (its `bins` buckets,
// or its L x L block for every GLCM direction), in the output's order.
// Sites hold few objects (about a dozen of the 256 slots on the main
// path), so most rows stay zero.  One cluster of TM_TABLE_REPLICAS blocks
// handles a site (grid (C, B), cluster (C, 1, 1)): 64 sites in clusters of
// 2 fill the card's 132 SMs in one wave.  The table is cut into windows of
// R rows, and each block reads 1/C of the site's pixels:
//
// 1. Window 0 (ids 1..R): every block zeroes its replica of the window,
//    stages the window's per-object lo and span, reads its pixels (the
//    labels of several quads in flight, values only where a label is in
//    the window; warps with no such label skip the counting) and adds the
//    counts into its own replica with shared-memory atomics.  While
//    reading it finds its largest id in 1..M; after a cluster barrier the
//    cluster's largest, K, comes from the other blocks' through
//    distributed shared memory: from the labels, never from the bounds.
// 2. Rows of ids above K hold no count: the blocks write them as zeros
//    (16-byte stores, like a memset).  Block r sums its share of the
//    window's rows up to K over the C replicas through distributed shared
//    memory (map_shared_rank) and writes them once as float32: whole
//    numbers below 2^24 are exact in any order.
// 3. A site with ids above R counts its next windows the same way,
//    reading its pixels once more for each.
//
// No memset of the output and no global atomic.  Where one row exceeds a
// block's shared memory (bins above 58,000, or a GLCM object above L = 120
// with 4 directions), windows are flat ranges of the site's cells instead
// (FLAT): every window is counted, and the GLCM adds each pair at [q1][q2]
// and [q2][q1] so the table holds c + c^T directly.  The window plan comes
// from the Python planner (fused_measure.plan_hist / plan_glcm).
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

#define TM_TABLE_THREADS 1024
// blocks (replicas) of the cluster that counts a site's table
#define TM_TABLE_REPLICAS 2
// dynamic shared memory one block may use on Hopper (227 KB)
#define TM_TABLE_MAX_SMEM 232448
#define TM_FULL_MASK 0xffffffffu

// Words of shared memory a block allocates for `cap` counters (a
// multiple of 4, so the table is zeroed with 16-byte stores).
__host__ __device__ __forceinline__ int tm_table_words(int cap) { return (cap + 3) & ~3; }

__device__ __forceinline__ void tm_table_zero(unsigned* tbl, int words) {
    uint4* t4 = reinterpret_cast<uint4*>(tbl);
    for (int i = threadIdx.x; i < words / 4; i += blockDim.x) t4[i] = make_uint4(0, 0, 0, 0);
    for (int i = (words & ~3) + threadIdx.x; i < words; i += blockDim.x) tbl[i] = 0;
}

// Add one count at `key` of this block's replica; a negative key adds
// nothing.
__device__ __forceinline__ void tm_table_add(unsigned* tbl, int key) {
    if (key >= 0) atomicAdd(tbl + key, 1u);
}

// Whether `p` may be read or written 16 bytes at a time.  A tensor's
// storage is, but a view that starts inside it may not be.
__host__ __device__ __forceinline__ bool tm_aligned16(const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Zeros at out[0, count): 16-byte stores where out is 16-byte aligned.
__device__ __forceinline__ void tm_zero_fill(float* out, long long count, int tid, int nthreads) {
    long long head = 0;
    if (tm_aligned16(out)) {
        float4* o4 = reinterpret_cast<float4*>(out);
        for (long long i = tid; i < count / 4; i += nthreads) o4[i] = make_float4(0, 0, 0, 0);
        head = count & ~3LL;
    }
    for (long long i = head + tid; i < count; i += nthreads) out[i] = 0.0f;
}

// The pixels [start, end) that block `rank` of a C-block cluster reads:
// 1/C of the site, a multiple of 4 pixels where `vec`.
__device__ __forceinline__ void tm_table_share(int n, int rank, int C, bool vec, int* start,
                                               int* end) {
    int chunk = (n + C - 1) / C;
    if (vec) chunk = (chunk + 3) & ~3;
    *start = min(n, rank * chunk);
    *end = min(n, *start + chunk);
}

// Sum of word `i` over the C replicas of the cluster.
__device__ __forceinline__ unsigned tm_replica_sum(unsigned* tbl, int i, int C) {
    cg::cluster_group cl = cg::this_cluster();
    unsigned s = 0;
    for (int j = 0; j < C; ++j) s += cl.map_shared_rank(tbl, j)[i];
    return s;
}

// The largest of `v` over the block (threads >= 32), via `slot`, which
// must hold 0 and be followed by a __syncthreads before it is read.
__device__ __forceinline__ void tm_block_max(int v, int* slot) {
    v = __reduce_max_sync(TM_FULL_MASK, v);
    if ((threadIdx.x & 31) == 0) atomicMax(slot, v);
}

// The largest `*slot` over the cluster's blocks (after a cluster barrier).
__device__ __forceinline__ int tm_cluster_max(int* slot, int C) {
    cg::cluster_group cl = cg::this_cluster();
    int k = 0;
    for (int j = 0; j < C; ++j) k = max(k, *cl.map_shared_rank(slot, j));
    return k;
}

// Block `rank` of C writes its share of out[0, count) (cut in fours).
__device__ __forceinline__ void tm_zero_share(float* out, long long count, int rank, int C) {
    const long long share = ((count + C - 1) / C + 3) & ~3LL;
    const long long s0 = min(count, rank * share), s1 = min(count, s0 + share);
    tm_zero_fill(out + s0, s1 - s0, threadIdx.x, blockDim.x);
}

// `kernel` on grid (TM_TABLE_REPLICAS, B) in clusters of TM_TABLE_REPLICAS
// blocks of `threads`, with `smem` bytes of dynamic shared memory each.
template <typename... Params, typename... Args>
static cudaError_t tm_table_launch(void (*kernel)(Params...), int threads, int B, int smem,
                                   cudaStream_t s, Args... args) {
    const int C = TM_TABLE_REPLICAS;
    if (B < 1 || B > 65535 || smem < 16 || smem > TM_TABLE_MAX_SMEM)
        return cudaErrorInvalidValue;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(C, B);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, args...);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}
