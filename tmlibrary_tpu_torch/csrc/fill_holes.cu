// fill_holes_flood for Hopper.
//
// Replaces the TPU kernel `_fill_kernel` / `_fill_holes_jit` in
// tmlibrary_tpu/ops/pallas_kernels.py (API `fill_holes_flood`).  Same
// function: background pixels reached from the image border through
// `connectivity`-connected background stay background; every other
// pixel is foreground (scipy `binary_fill_holes` at connectivity 4).
//
// The reached set is the least fixpoint of a monotone flood, so any order
// of valid updates, in place, ends at the same set.  Two routes; the
// wrapper picks one from the shapes (ops/kernels.py `fill_plan`).
//
// On chip (`tm_fill_holes`): one block of 1024 threads per site, the
// background and the reached set as bit planes in shared memory, each
// twice: row-major (row y, word k holds columns 32k..32k+31) and
// transposed (the same for the columns); 32 KB for 256x256.  The mask is
// read and the output written 16 bytes a lane where rows are whole words
// (a warp ballot a word otherwise).  A row pass
// gives each row to one thread, which seeds every word from the row above
// and below (and their neighbouring bits at connectivity 8) and carries
// "reached" along whole background runs: within a word by the carry of
// an addition, ((b + s) ^ b) & b | s fills from the seeds s towards the
// high bits of the runs of b, and the same on the bit-reversed words
// towards the low bits; across words by a one-bit carry, left to right
// and back.  A column pass does the same on the transposed planes
// (warp-ballot transposes of 32x32 tiles).  A row pass that changes
// nothing proves the fixpoint: it applies every neighbour relation.  A
// site whose background winds like a spiral costs a pass pair a turn;
// blob masks converge in two or three.
//
// Global (`tm_fill_holes_global`): the first design, for sites whose planes
// do not fit: the reached flags as a (B, H, W) byte plane in global memory
// (L2-resident), updated in place by sweeps that alternate direction until
// one changes nothing.
//
// Bound: the function must read the mask and write the output once, 2
// bytes a pixel.  On chip every pass runs in shared memory; what remains
// is the serial carry chain of a row (8 words for 256 columns) and the
// barriers between passes.
#include "common.cuh"

// ------------------------------------------------------------ global route
__global__ void __launch_bounds__(TM_BLOCK)
fill_global_kernel(const uint8_t* __restrict__ mask, uint8_t* __restrict__ out,
                   uint8_t* reach, int H, int W, int n_neigh) {
    const int n = H * W;
    const size_t base = (size_t)blockIdx.x * n;
    const uint8_t* m = mask + base;
    uint8_t* r = reach + base;
    uint8_t* o = out + base;

    for (int p = threadIdx.x; p < n; p += blockDim.x) {
        int y = p / W, x = p - y * W;
        bool border = y == 0 || y == H - 1 || x == 0 || x == W - 1;
        r[p] = (!m[p] && border) ? 1 : 0;
    }
    __syncthreads();

    for (int sweep = 0;; ++sweep) {
        int changed = 0;
        for (int k = 0; k < n; k += blockDim.x) {
            if (k + (int)threadIdx.x >= n) break;
            int p = tm_sweep_pixel(k, threadIdx.x, n, sweep);
            if (m[p] || r[p]) continue;
            int y = p / W, x = p - y * W;
            for (int j = 0; j < n_neigh; ++j) {
                int yy = y + tm_dy(j), xx = x + tm_dx(j);
                if (yy < 0 || yy >= H || xx < 0 || xx >= W) continue;
                if (r[yy * W + xx]) {
                    r[p] = 1;
                    changed = 1;
                    break;
                }
            }
        }
        if (!__syncthreads_or(changed)) break;
    }

    for (int p = threadIdx.x; p < n; p += blockDim.x)
        o[p] = (m[p] || !r[p]) ? 1 : 0;
}

// ----------------------------------------------------------- on-chip route
// Bits of word k of row y that lie on the image border.
__device__ __forceinline__ uint32_t fill_border_bits(int y, int k, int H, int W) {
    if (y >= H) return 0u;
    if (y == 0 || y == H - 1) return 0xffffffffu;
    uint32_t bits = 0u;
    if (k == 0) bits |= 1u;
    if (k == (W - 1) >> 5) bits |= 1u << ((W - 1) & 31);
    return bits;
}

// Bit i of the result: byte i of the 16 is zero.
__device__ __forceinline__ uint32_t fill_zero_bits(uint4 v) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    uint32_t bits = 0u;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const uint32_t t = __vcmpeq4(w[k], 0u) & 0x01010101u;
        bits |= ((t | (t >> 7) | (t >> 14) | (t >> 21)) & 0xfu) << (4 * k);
    }
    return bits;
}

// Sixteen bytes 0/1 from the low 16 bits of `bits`, byte i from bit i.
__device__ __forceinline__ uint4 fill_bytes_of(uint32_t bits) {
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) w[k] = (((bits >> (4 * k)) & 0xfu) * 0x00204081u) & 0x01010101u;
    return make_uint4(w[0], w[1], w[2], w[3]);
}

// dst = the transpose of src: src has `src_words` words a row and
// 32 * dst_words rows, dst has `dst_words` words a row and 32 * src_words
// rows.  One warp a 32x32 tile: lane i loads row i of the tile, and ballot
// j gathers bit j of every lane, which is row j of the transposed tile.
__device__ __forceinline__ void fill_transpose(const uint32_t* src, uint32_t* dst,
                                               int src_words, int dst_words) {
    const int lane = threadIdx.x & 31;
    for (int t = threadIdx.x >> 5; t < src_words * dst_words; t += blockDim.x >> 5) {
        const int ty = t / src_words, tx = t - ty * src_words;
        const uint32_t w = src[(ty * 32 + lane) * src_words + tx];
        uint32_t mine = 0u;
#pragma unroll
        for (int j = 0; j < 32; ++j) {
            const uint32_t col = __ballot_sync(0xffffffffu, (w >> j) & 1u);
            if (lane == j) mine = col;
        }
        dst[(tx * 32 + lane) * dst_words + ty] = mine;
    }
}

// Reached bits of the runs of b that hold a seed of s (s within b), filled
// from each seed towards the high bits.
__device__ __forceinline__ uint32_t fill_up(uint32_t b, uint32_t s) {
    return (((b + s) ^ b) & b) | s;
}

// Union of the rows above and below at word k (0 beyond the plane).
__device__ __forceinline__ uint32_t fill_vertical(const uint32_t* r, int k, int words,
                                                  bool up, bool down) {
    if (k < 0 || k >= words) return 0u;
    return (up ? r[k - words] : 0u) | (down ? r[k + words] : 0u);
}

// One pass over `rows` rows of `words` words, one thread a row: seed each
// word from the rows above and below (NN 4; NN 8 adds their neighbouring
// bits; NN 0 seeds from the row alone), then fill the background runs
// left to right and back.  Returns whether this thread reached a new bit.
template <int NN>
__device__ __forceinline__ int fill_row_pass(const uint32_t* B, uint32_t* R, int rows,
                                             int words) {
    int changed = 0;
    for (int y = threadIdx.x; y < rows; y += blockDim.x) {
        const uint32_t* b = B + y * words;
        uint32_t* r = R + y * words;
        const bool up = y > 0, down = y + 1 < rows;
        uint32_t carry = 0u;
        for (int k = 0; k < words; ++k) {
            const uint32_t bw = b[k], old = r[k];
            uint32_t s = old | carry;
            if constexpr (NN != 0) {
                const uint32_t v = fill_vertical(r, k, words, up, down);
                s |= v;
                if constexpr (NN == 8)
                    s |= (v << 1) | (v >> 1) |
                         (fill_vertical(r, k - 1, words, up, down) >> 31) |
                         (fill_vertical(r, k + 1, words, up, down) << 31);
            }
            const uint32_t f = fill_up(bw, s & bw);
            carry = f >> 31;
            if (f != old) {
                r[k] = f;
                changed = 1;
            }
        }
        carry = 0u;
        for (int k = words - 1; k >= 0; --k) {
            const uint32_t bw = b[k], old = r[k];
            const uint32_t s = (old | (carry << 31)) & bw;
            const uint32_t f = __brev(fill_up(__brev(bw), __brev(s)));
            carry = f & 1u;
            if (f != old) {
                r[k] = f;
                changed = 1;
            }
        }
    }
    return changed;
}

template <int NN>
__global__ void __launch_bounds__(TM_BLOCK)
fill_onchip_kernel(const uint8_t* __restrict__ mask, uint8_t* __restrict__ out, int H,
                   int W) {
    extern __shared__ uint32_t planes[];
    const int Wd = (W + 31) >> 5, Hd = (H + 31) >> 5;
    const int plane = 32 * Hd * Wd;  // words of one plane, either layout
    uint32_t* Bm = planes;           // background, row-major
    uint32_t* Rm = Bm + plane;       // reached, row-major
    uint32_t* Bt = Rm + plane;       // background, transposed
    uint32_t* Rt = Bt + plane;       // reached, transposed
    const int lane = threadIdx.x & 31;
    const size_t base = (size_t)blockIdx.x * H * W;
    const uint8_t* m = mask + base;

    // 16-byte loads (16 pixels a lane, a word per lane pair) where rows are
    // whole words and the site 16-byte aligned; else a ballot per word
    const bool vec = (W & 31) == 0 && ((uintptr_t)m & 15) == 0 && ((uintptr_t)out & 15) == 0;
    if (vec) {
        for (int i = threadIdx.x; i < 2 * plane; i += blockDim.x) {
            const int wi = i >> 1, y = wi / Wd;
            uint32_t half = 0u;
            if (y < H) half = fill_zero_bits(((const uint4*)m)[i]);
            const uint32_t word = half | (__shfl_down_sync(0xffffffffu, half, 1) << 16);
            if ((i & 1) == 0) {
                Bm[wi] = word;
                Rm[wi] = word & fill_border_bits(y, wi - y * Wd, H, W);
            }
        }
    } else {
        for (int wi = threadIdx.x >> 5; wi < plane; wi += blockDim.x >> 5) {
            const int y = wi / Wd, k = wi - y * Wd, x = 32 * k + lane;
            const bool bg = y < H && x < W && !m[(size_t)y * W + x];
            const uint32_t word = __ballot_sync(0xffffffffu, bg);
            if (lane == 0) {
                Bm[wi] = word;
                Rm[wi] = word & fill_border_bits(y, k, H, W);
            }
        }
    }
    __syncthreads();
    fill_transpose(Bm, Bt, Wd, Hd);
    __syncthreads();

    for (;;) {
        if (!__syncthreads_or(fill_row_pass<NN>(Bm, Rm, H, Wd))) break;
        fill_transpose(Rm, Rt, Wd, Hd);
        __syncthreads();
        fill_row_pass<0>(Bt, Rt, W, Hd);
        __syncthreads();
        fill_transpose(Rt, Rm, Hd, Wd);
        __syncthreads();
    }

    uint8_t* o = out + base;
    if (vec) {
        for (int i = threadIdx.x; i < 2 * H * Wd; i += blockDim.x)
            ((uint4*)o)[i] = fill_bytes_of(~Rm[i >> 1] >> (16 * (i & 1)));
    } else {
        for (int wi = threadIdx.x >> 5; wi < plane; wi += blockDim.x >> 5) {
            const int y = wi / Wd, x = 32 * (wi - y * Wd) + lane;
            if (y < H && x < W) o[(size_t)y * W + x] = ((Rm[wi] >> lane) & 1u) ? 0 : 1;
        }
    }
}

extern "C" int tm_fill_holes(const void* mask, void* out, int B, int H, int W,
                             int connectivity, void* stream) {
    const int smem = 4 * 4 * 32 * ((H + 31) >> 5) * ((W + 31) >> 5);
    auto kernel = connectivity == 8 ? fill_onchip_kernel<8> : fill_onchip_kernel<4>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<B, TM_BLOCK, smem, (cudaStream_t)stream>>>((const uint8_t*)mask, (uint8_t*)out,
                                                        H, W);
    return (int)cudaGetLastError();
}

extern "C" int tm_fill_holes_global(const void* mask, void* reach, void* out, int B, int H,
                                    int W, int connectivity, void* stream) {
    fill_global_kernel<<<B, TM_BLOCK, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)mask, (uint8_t*)out, (uint8_t*)reach, H, W,
        connectivity == 8 ? 8 : 4);
    return (int)cudaGetLastError();
}
