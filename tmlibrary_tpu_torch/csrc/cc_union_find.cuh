// Block union-find connected components, shared by cc_min_propagate.cu
// (2-D sites as volumes of one plane, tiles of 1x32x32) and
// cc3d_min_propagate.cu (volumes, tiles of 2x16x32).
//
// Function: every foreground voxel of a (Z, H, W) volume gets the minimum
// linear index of its connected component, background gets TM_BIG.  The
// neighbourhood is 6, 18 or 26 (2-D 4 is 6 on one plane, 2-D 8 is 26).
//
// Three phases, each a launch over the tiles of every volume of the
// batch, all on one stream:
//   1. local:   a block a tile (THREADS threads, a few voxels each): the
//               tile's mask into shared memory (16-byte rows where the
//               width allows), each voxel to the first voxel of its run
//               of foreground along x (a warp ballot a row), union-find in
//               shared memory over the other backward neighbours inside
//               the tile, then each voxel's local root written to
//               `labels` as a global linear index.
//   2. border:  a block a tile, a thread a voxel on the tile faces that
//               backward offsets leave through: unions, in global memory,
//               with its backward neighbours in other tiles.
//   3. flatten: every foreground voxel gets find(label).
//
// Notation: parent[p] is labels[p] (global) or the shared slot of p's
// local index (phase 1).  Backward offsets are the 13 of the 26 that
// come earlier in linear order: dz = -1 (9), dz = 0, dy = -1 (3), and
// dz = 0, dy = 0, dx = -1 (W); every edge of the component graph is the
// backward offset of exactly one of its ends (its later voxel).
//
// Invariants, and why they hold:
//   (a) parent[p] <= p, and parent[p] lies in p's component.  Phase 1
//       starts p at its run's first voxel, joined to p by W edges, and
//       writes out its local root, the smallest index of a set of voxels
//       joined by edges inside the tile.  Row-major order inside a tile
//       follows the global linear order ((a, b, c) lexicographic is
//       (z, y, x) lexicographic within the tile), so a local index below
//       another maps to a global index below it.  A union links root b
//       under root a only when a < b and a, b are joined by the edge
//       being unioned.
//   (b) Every write to a label while unions run (phase 1's unions, phase
//       2) is an atomicMin on a node the writer found to be a root, so no
//       write raises a label and none undoes a concurrent link.  When the
//       atomicMin finds parent[b] already below b (another thread linked
//       b since our find), it leaves parent[b] = min(old, a) and the loop
//       goes on with (a, old): the tree that held b stays joined to
//       old's, and old's is joined to a's in a later round.  finds write
//       nothing then: path compression during the unions (by atomicMin,
//       along the values the atomics returned) lost unions on the card.
//   (c) Phase 2 reads only labels that phase 1 of both tiles wrote: the
//       phases are separate launches on one stream.  Phase 1's output
//       finds run after a barrier that follows the last local union, and
//       phase 3 after the last border union; phase 3's plain stores write
//       the final root, and a concurrent find that reads either the old
//       pointer or the root ends at the same root.
//   (d) At the end each component has one root, its minimum index: every
//       edge was unioned (a run, phase 1 inside a tile, phase 2 across
//       tiles) or is implied by edges that were (below), so the component
//       is one tree; its minimum m has parent[m] <= m by (a) and
//       parent[m] in the component, so parent[m] = m is the root.
//   Skipped edges.  W edges inside a tile are the runs; across tiles
//   phase 2 unions them, never skipped.  An edge p -> q along an offset
//   o with dx = 0 (N, below, and at 18/26 (-1, +-1, 0)) is skipped where
//   p is not in its tile's first column and p's W and q's W are
//   foreground: p - W(p) and W(q) - q are runs (W(q) lies in q's tile)
//   and W(p) - W(q) is the same offset one voxel west, in the same phase,
//   unioned or skipped in turn, down to the run's first voxel.  An edge
//   p -> p + (-1, dy, dx) other than (-1, 0, 0) is skipped when the voxel
//   below is foreground: p - below is a face edge and below - (p + o)
//   the in-plane edge (0, dy, dx), a neighbour at 18 and 26 wherever o
//   is one.  An edge p -> p + (0, -1, +-1) is skipped when north is
//   foreground: p - north is a face edge and north - (p + o) a W edge.
//   Every chain of implications ends at unioned edges: W edges, and face
//   edges at a run's first voxel or in a tile's first column.
//
// Bound: one read of the 1-byte mask and one write of the 4-byte labels
// per voxel.  Phase 1 reads the mask once; phases 2 and 3 re-read the
// tile faces' masks and the labels from L2.
#pragma once

#include "common.cuh"

namespace {

// Backward offset j (0..12) of the 26-neighbourhood; 12 is W.
__device__ __forceinline__ void uf_offset(int j, int& dz, int& dy, int& dx) {
    if (j < 9) {
        dz = -1;
        dy = j / 3 - 1;
        dx = j % 3 - 1;
    } else if (j < 12) {
        dz = 0;
        dy = -1;
        dx = j - 10;
    } else {
        dz = 0;
        dy = 0;
        dx = -1;
    }
}

// Whether the edge along backward offset (dz, dy, dx) is implied by face
// edges and in-plane edges (see "Skipped edges" above).
__device__ __forceinline__ bool uf_implied(int dz, int dy, int dx, bool below, bool north) {
    return (dz == -1 && (dy != 0 || dx != 0) && below) ||
           (dz == 0 && dy == -1 && dx != 0 && north);
}

// find: walk to the root, no writes.  Path compression while unions run
// lost unions on the card (an atomicMin that lowers a node met through
// another atomic's return value can cut a tree that a pending union has
// already counted as joined), so the trees are flattened only after the
// last union: phase 1's output and phase 3.
__device__ __forceinline__ int uf_find_shared(const volatile int* s, int x) {
    for (int up; (up = s[x]) != x;) x = up;
    return x;
}

__device__ __forceinline__ void uf_union_shared(int* s, int a, int b) {
    for (;;) {
        a = uf_find_shared(s, a);
        b = uf_find_shared(s, b);
        if (a == b) return;
        if (a > b) {
            int t = a;
            a = b;
            b = t;
        }
        int old = atomicMin(&s[b], a);
        if (old == b) return;
        b = old;  // b was linked meanwhile: join its new parent's tree too
    }
}

// Loads through L2 (`ld.global.cg`): phase 2 links roots with atomics in
// L2, which SMs' L1 caches do not see.  A stale value would still be an
// ancestor (labels only fall), so this costs no correctness, only hops.
__device__ __forceinline__ int uf_find_global(const int* lab, int x) {
    for (int up; (up = __ldcg(lab + x)) != x;) x = up;
    return x;
}

__device__ __forceinline__ void uf_union_global(int* lab, int a, int b) {
    for (;;) {
        a = uf_find_global(lab, a);
        b = uf_find_global(lab, b);
        if (a == b) return;
        if (a > b) {
            int t = a;
            a = b;
            b = t;
        }
        int old = atomicMin(&lab[b], a);
        if (old == b) return;
        b = old;
    }
}

// The tile of block `blockIdx.x`: its volume's offset and its corner.
struct UfTile {
    int z0, y0, x0;
    size_t base;

    template <int TZ, int TY, int TX>
    __device__ __forceinline__ void at(int Z, int H, int W, int nty, int ntx, int per_site) {
        const int site = blockIdx.x / per_site;
        const int tile = blockIdx.x - site * per_site;
        const int tz = tile / (nty * ntx);
        const int rem = tile - tz * nty * ntx;
        const int ty = rem / ntx;
        z0 = tz * TZ;
        y0 = ty * TY;
        x0 = (rem - ty * ntx) * TX;
        base = (size_t)site * Z * H * W;
    }
};

// Phase 1: union-find inside the tile in shared memory, THREADS threads
// a tile, N / THREADS voxels each (local index t = tid + k * THREADS, so
// a warp holds whole tile rows).  Each voxel starts at the first voxel of
// its foreground run along x (a warp ballot a row): the W edges need no
// union.  An edge along an offset with dx = 0 is implied, and skipped,
// where W and the target's W are foreground (W, W's own edge along the
// offset, the target's run); phase 2 does the same across tile faces.
template <int TZ, int TY, int TX, int THREADS>
__global__ void __launch_bounds__(THREADS)
uf_local(const uint8_t* __restrict__ mask, int* __restrict__ labels, int Z, int H, int W,
         int nty, int ntx, int per_site, int connectivity, int rows16) {
    constexpr int N = TZ * TY * TX, PLANE = TY * TX, PT = N / THREADS, VEC = TX / 16;
    static_assert(TX == 16 || TX == 32, "a tile row is a warp or half a warp");
    static_assert(N % THREADS == 0 && THREADS % 32 == 0, "whole warps, whole rows");
    __shared__ __align__(16) uint8_t s_m[N];
    __shared__ int s_l[N];
    UfTile tile;
    tile.at<TZ, TY, TX>(Z, H, W, nty, ntx, per_site);
    const uint8_t* m = mask + tile.base;
    const int tid = threadIdx.x;

    if (rows16) {  // W % 16 == 0 and a 16-byte aligned batch: a row is VEC vectors
        for (int i = tid; i < TZ * TY * VEC; i += THREADS) {
            const int row = i / VEC, k = i - row * VEC;
            const int zz = tile.z0 + row / TY, yy = tile.y0 + row % TY, xx = tile.x0 + 16 * k;
            uint4 q = make_uint4(0, 0, 0, 0);
            if (zz < Z && yy < H && xx < W)
                q = *reinterpret_cast<const uint4*>(m + ((size_t)zz * H + yy) * W + xx);
            *reinterpret_cast<uint4*>(s_m + row * TX + 16 * k) = q;
        }
    } else {
#pragma unroll
        for (int k = 0; k < PT; ++k) {
            const int t = tid + k * THREADS;
            const int z = tile.z0 + t / PLANE, y = tile.y0 + (t / TX) % TY, x = tile.x0 + t % TX;
            s_m[t] = z < Z && y < H && x < W ? m[((size_t)z * H + y) * W + x] : 0;
        }
    }
    __syncthreads();

#pragma unroll
    for (int k = 0; k < PT; ++k) {  // each voxel to the start of its run
        const int t = tid + k * THREADS, c = t % TX;
        unsigned bits = __ballot_sync(0xffffffffu, s_m[t] != 0);
        if (TX == 16) bits = (bits >> (tid & 16)) & 0xffffu;
        const unsigned gaps = ~bits & ((1u << c) - 1u);
        s_l[t] = t - c + (gaps ? 32 - __clz(gaps) : 0);
    }
    __syncthreads();

#pragma unroll
    for (int k = 0; k < PT; ++k) {
        const int t = tid + k * THREADS;
        if (!s_m[t]) continue;
        const int a = t / PLANE, b = (t / TX) % TY, c = t % TX;
        const bool below = a > 0 && s_m[t - PLANE];
        const bool north = b > 0 && s_m[t - TX];
        const bool west = c > 0 && s_m[t - 1];
#pragma unroll
        for (int j = 0; j < 12; ++j) {  // W (j = 12) is the run
            int dz, dy, dx;
            uf_offset(j, dz, dy, dx);
            if (TZ == 1 && dz != 0) continue;
            if (!tm_neighbour3(dz, dy, dx, connectivity) || uf_implied(dz, dy, dx, below, north))
                continue;
            const int bb = b + dy, cc = c + dx;
            if (a + dz < 0 || bb < 0 || bb >= TY || cc < 0 || cc >= TX) continue;
            const int q = t + (dz * TY + dy) * TX + dx;
            if (!s_m[q] || (dx == 0 && west && s_m[q - 1])) continue;
            uf_union_shared(s_l, t, q);
        }
    }
    __syncthreads();

#pragma unroll
    for (int k = 0; k < PT; ++k) {
        const int t = tid + k * THREADS;
        const int z = tile.z0 + t / PLANE, y = tile.y0 + (t / TX) % TY, x = tile.x0 + t % TX;
        if (z >= Z || y >= H || x >= W) continue;
        int out = TM_BIG;
        if (s_m[t]) {
            const int r = uf_find_shared(s_l, t);
            out = ((tile.z0 + r / PLANE) * H + tile.y0 + (r / TX) % TY) * W + tile.x0 + r % TX;
        }
        labels[tile.base + ((size_t)z * H + y) * W + x] = out;
    }
}

// The tile voxels a backward offset can leave the tile from: the first
// plane, and on the others the ring of each plane (x = 0 and x = TX - 1
// for NE-type offsets, y = TY - 1 for offsets into the plane below).  In
// 2-D (TZ = 1) the top row and the first and last columns.
template <int TZ, int TY, int TX>
struct UfFaces {
    static constexpr int RING = 2 * TX + 2 * (TY - 2);
    static constexpr int COUNT = TZ == 1 ? TX + 2 * (TY - 1) : TY * TX + (TZ - 1) * RING;
    static constexpr int THREADS = (COUNT + 31) / 32 * 32;

    __device__ __forceinline__ static void at(int i, int& a, int& b, int& c) {
        if (TZ == 1) {
            a = 0;
            if (i < TX) {
                b = 0;
                c = i;
            } else if (i < TX + TY - 1) {
                b = i - TX + 1;
                c = 0;
            } else {
                b = i - TX - TY + 2;
                c = TX - 1;
            }
            return;
        }
        if (i < TY * TX) {
            a = 0;
            b = i / TX;
            c = i % TX;
            return;
        }
        const int j = i - TY * TX, k = j % RING;
        a = 1 + j / RING;
        if (k < 2 * TX) {
            b = k < TX ? 0 : TY - 1;
            c = k % TX;
        } else {
            b = 1 + (k - 2 * TX) % (TY - 2);
            c = k < 2 * TX + TY - 2 ? 0 : TX - 1;
        }
    }
};

// Phase 2: unions across tile faces in global memory, a thread a face voxel.
template <int TZ, int TY, int TX>
__global__ void __launch_bounds__(UfFaces<TZ, TY, TX>::THREADS)
uf_border(const uint8_t* __restrict__ mask, int* labels, int Z, int H, int W,
          int nty, int ntx, int per_site, int connectivity) {
    using F = UfFaces<TZ, TY, TX>;
    if ((int)threadIdx.x >= F::COUNT) return;
    int a, b, c;
    F::at(threadIdx.x, a, b, c);
    UfTile tile;
    tile.at<TZ, TY, TX>(Z, H, W, nty, ntx, per_site);
    const int z = tile.z0 + a, y = tile.y0 + b, x = tile.x0 + c;
    if (z >= Z || y >= H || x >= W) return;
    const uint8_t* m = mask + tile.base;
    const int g = (z * H + y) * W + x;
    if (!m[g]) return;
    int* lab = labels + tile.base;
    const bool below = z > 0 && m[g - H * W];
    const bool north = y > 0 && m[g - W];
    const bool west = c > 0 && m[g - 1];  // W in this tile: a run
#pragma unroll
    for (int j = 0; j < 13; ++j) {
        int dz, dy, dx;
        uf_offset(j, dz, dy, dx);
        if (TZ == 1 && dz != 0) continue;
        if (!tm_neighbour3(dz, dy, dx, connectivity) || uf_implied(dz, dy, dx, below, north))
            continue;
        const int bb = b + dy, cc = c + dx;
        if (a + dz >= 0 && bb >= 0 && bb < TY && cc >= 0 && cc < TX) continue;  // phase 1's
        const int zz = z + dz, yy = y + dy, xx = x + dx;
        if (zz < 0 || yy < 0 || yy >= H || xx < 0 || xx >= W) continue;
        const int q = (zz * H + yy) * W + xx;
        if (!m[q] || (dx == 0 && west && m[q - 1])) continue;
        uf_union_global(lab, g, q);
    }
}

// Phase 3: every label to its root, over each volume's n voxels in order.
__global__ void __launch_bounds__(256)
uf_flatten(int* labels, int n, int B) {
    const int p = blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= n) return;
    for (int site = blockIdx.y; site < B; site += gridDim.y) {
        int* lab = labels + (size_t)site * n;
        const int l = lab[p];
        if (l == TM_BIG) continue;
        const int r = uf_find_global(lab, l);
        if (r != l) lab[p] = r;
    }
}

}  // namespace

#define TM_CC_LOCAL 1
#define TM_CC_BORDER 2
#define TM_CC_FLATTEN 4

// The three phases (those in `phases`) on a batch of B (Z, H, W) volumes,
// phase 1 with THREADS threads a tile.
template <int TZ, int TY, int TX, int THREADS>
int tm_cc_union_find(const void* mask, void* labels, int B, int Z, int H, int W,
                     int connectivity, int phases, cudaStream_t stream) {
    const int n = Z * H * W;
    if (B <= 0 || n <= 0) return (int)cudaGetLastError();
    const int ntz = (Z + TZ - 1) / TZ, nty = (H + TY - 1) / TY, ntx = (W + TX - 1) / TX;
    const long long per_site = (long long)ntz * nty * ntx, tiles = per_site * B;
    if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const uint8_t* m = (const uint8_t*)mask;
    int* lab = (int*)labels;
    if (phases & TM_CC_LOCAL) {
        const int rows16 = W % 16 == 0 && ((uintptr_t)mask & 15) == 0;
        uf_local<TZ, TY, TX, THREADS><<<(int)tiles, THREADS, 0, stream>>>(
            m, lab, Z, H, W, nty, ntx, (int)per_site, connectivity, rows16);
    }
    if (phases & TM_CC_BORDER)
        uf_border<TZ, TY, TX><<<(int)tiles, UfFaces<TZ, TY, TX>::THREADS, 0, stream>>>(
            m, lab, Z, H, W, nty, ntx, (int)per_site, connectivity);
    if (phases & TM_CC_FLATTEN) {
        dim3 grid((n + 255) / 256, B < 65535 ? B : 65535);
        uf_flatten<<<grid, 256, 0, stream>>>(lab, n, B);
    }
    return (int)cudaGetLastError();
}
