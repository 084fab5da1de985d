"""A/B of the designs the distance transform did not take.

One block a site (``site``): the mask and a 16-bit g of a site in one
block's shared memory, a thread a column for both scans, then the
shipped row pass; it moves no scratch through L2 but takes one SM a site
(64 of 132 at path D's batch).

A doubling window minimum in place of growing r one step at a time.
The shipped row pass (``dt_row`` in ``csrc/distance_transform.cu``)
finds, for each pixel, the smallest r whose window minimum of g over
[x - r, x + r] is <= r by growing r one step at a time: a pixel costs
min(D, cap) + 1 steps.  The lever builds, for each row of g in shared
memory, a table of minima over windows of 2**k entries (levels k = 0 ..
ceil(log2 W)), so any window's minimum is two lookups, and searches r
by halving between 1 and g(x) (the window minimum is monotone in r, and
r = g(x) always passes): log2 g(x) probes a pixel, after a build of
about log2 W passes over the row:

- ``doubling``: every pixel by halving;
- ``hybrid``: the shipped steps up to r = 8, then, in warps where a pixel
  is still open, the table and halving for those pixels.

The three are appended to the shipped source and built beside it under
``build/levers/`` with ``nvcc``, held against the plain version on path
D's masks, the
``shootout.distance_cases`` inputs (all foreground, one background pixel
at the centre at max_distance 254, 45% noise, empty), edge sites and a
ragged 257x130 batch, and timed against the shipped kernel with
:func:`tmlibrary_tpu_torch.shootout.best_of`, whole and row pass alone
(the column pass is shared).

Run on a card from the root of a checkout:
``python3 -m tmlibrary_tpu_torch.levers.distance_designs``.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
OUT = ROOT / "build" / "levers"
#: the shipped pieces the variants build on
NEEDS = ("dt_columns<", "__device__ __forceinline__ void dt_row(", "#define DT_ROWS 8",
         "static inline bool dt_aligned16(")

VARIANTS = r'''
// ------------------------------------------- the lever: one block a site
// The mask (16-byte loads where they fit) and a 16-bit g in shared
// memory, a thread a column for both scans, then a warp a row (the
// shipped `dt_row`).  Sites of at most (227 KB) / 3 bytes a pixel.
__global__ void __launch_bounds__(TM_BLOCK)
dt_site(const uint8_t* __restrict__ mask, float* __restrict__ out, int H, int W, int reach,
        float cap, bool vec, bool vec4) {
    extern __shared__ __align__(16) unsigned char dt_smem[];
    const int Wp = (W + 15) & ~15, n = H * W;
    uint16_t* g = reinterpret_cast<uint16_t*>(dt_smem);
    uint8_t* sm = dt_smem + (size_t)H * Wp * 2;
    const uint8_t* m = mask + (size_t)blockIdx.x * n;
    if (vec) {
        for (int i = threadIdx.x; i < n / 16; i += blockDim.x)
            reinterpret_cast<uint4*>(sm)[i] = __ldg(reinterpret_cast<const uint4*>(m) + i);
    } else {
        for (int i = threadIdx.x; i < n; i += blockDim.x) sm[i] = m[i];
    }
    __syncthreads();
    for (int x = threadIdx.x; x < Wp; x += blockDim.x) {
        int down = reach, up = reach;
        for (int y = 0; y < H; ++y) {
            down = (x >= W || sm[y * W + x]) ? min(down + 1, reach) : 0;
            g[y * Wp + x] = (uint16_t)down;
        }
        for (int y = H - 1; y >= 0; --y) {
            up = (x >= W || sm[y * W + x]) ? min(up + 1, reach) : 0;
            g[y * Wp + x] = (uint16_t)min((int)g[y * Wp + x], up);
        }
    }
    __syncthreads();
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int y = warp; y < H; y += blockDim.x >> 5)
        dt_row(g + y * Wp, out + (size_t)blockIdx.x * n + (size_t)y * W, W, reach, cap, vec4,
               lane);
}

extern "C" int dsg_site(const void* mask, void* out, int B, int H, int W,
                                          int cap, int reach, void* stream) {
    if (B <= 0 || H <= 0 || W <= 0) return (int)cudaGetLastError();
    const int smem = H * ((W + 15) & ~15) * 2 + H * W;
    cudaError_t err =
        cudaFuncSetAttribute(dt_site, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const bool vec = (H * W) % 16 == 0 && dt_aligned16(mask);
    const bool vec4 = (W & 3) == 0 && dt_aligned16(out);
    dt_site<<<B, TM_BLOCK, smem, (cudaStream_t)stream>>>((const uint8_t*)mask, (float*)out, H, W,
                                                        reach, (float)cap, vec, vec4);
    return (int)cudaGetLastError();
}


// ---------------------------------------- the lever: doubling window minima
// levels k = 0..K-1 of the row's table: L_k[x] = min g[x .. x + 2**k - 1]
// (clipped to the row); a window [a, b] is min(L_k[a], L_k[b - 2**k + 1])
// with 2**k <= b - a + 1 < 2**(k+1).
template <typename T>
__device__ __forceinline__ void dbl_build(T* s, int W, int Wp, int levels, int lane, int reach) {
    for (int k = 1; k < levels; ++k) {
        const T* a = s + (size_t)(k - 1) * Wp;
        T* b = s + (size_t)k * Wp;
        const int h = 1 << (k - 1);
        for (int x = lane; x < W; x += 32)
            b[x] = (T)min((int)a[x], x + h < W ? (int)a[x + h] : reach);
        __syncwarp();
    }
}

template <typename T>
__device__ __forceinline__ int dbl_window(const T* s, int Wp, int x, int r, int W) {
    const int a = max(0, x - r), b = min(W - 1, x + r);
    const int k = 31 - __clz(b - a + 1);
    const T* l = s + (size_t)k * Wp;
    return min((int)l[a], (int)l[b - (1 << k) + 1]);
}

// the smallest r in (lo, hi] whose window minimum is <= r (true at hi)
template <typename T>
__device__ __forceinline__ int dbl_search(const T* s, int Wp, int x, int lo, int hi, int W) {
    while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (dbl_window(s, Wp, x, mid, W) <= mid)
            hi = mid;
        else
            lo = mid;
    }
    return hi;
}

template <typename T, bool HYBRID>
__global__ void __launch_bounds__(32 * DT_ROWS)
dbl_rows(const T* __restrict__ g, float* __restrict__ out, int H, int W, int Wp, int reach,
         float cap, int levels) {
    extern __shared__ __align__(16) unsigned char dbl_smem[];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int bands = (H + DT_ROWS - 1) / DT_ROWS;
    const int site = blockIdx.x / bands, y = (blockIdx.x - site * bands) * DT_ROWS + warp;
    if (y >= H) return;
    const T* src = g + ((size_t)site * H + y) * Wp;
    float* o = out + ((size_t)site * H + y) * W;
    T* s = reinterpret_cast<T*>(dbl_smem) + (size_t)warp * levels * Wp;
    for (int i = lane; i < Wp * (int)sizeof(T) / 16; i += 32)
        reinterpret_cast<uint4*>(s)[i] = __ldcg(reinterpret_cast<const uint4*>(src) + i);
    __syncwarp();
    if (!HYBRID) {
        dbl_build(s, W, Wp, levels, lane, reach);
        for (int x = lane; x < W; x += 32) {
            const int gx = s[x];
            const int r = gx == 0 ? 0 : dbl_search(s, Wp, x, 0, gx, W);
            o[x] = r < reach ? (float)r : cap;
        }
        return;
    }
    // the shipped steps up to r = 8 (pixels past the row count as done)
    const int nq = (W + 3) >> 2;
    bool built = false;
    for (int q0 = 0; q0 < nq; q0 += 32) {
        const int q = q0 + lane, x0 = 4 * q;
        int res[4] = {0, 0, 0, 0};
        if (q < nq) {
            int a[4], b[4], m[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                a[j] = b[j] = m[j] = dt_at(s, x0 + j, W, reach);
                res[j] = (m[j] == 0 || x0 + j >= W) ? 0 : -1;
            }
            for (int r = 1; r <= 8 && (res[0] | res[1] | res[2] | res[3]) < 0; ++r) {
                a[3] = a[2]; a[2] = a[1]; a[1] = a[0]; a[0] = dt_at(s, x0 - r, W, reach);
                b[0] = b[1]; b[1] = b[2]; b[2] = b[3]; b[3] = dt_at(s, x0 + 3 + r, W, reach);
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    m[j] = min(m[j], min(a[j], b[j]));
                    if (res[j] < 0 && m[j] <= r) res[j] = r;
                }
            }
        }
        const bool open = (res[0] | res[1] | res[2] | res[3]) < 0;
        if (__any_sync(0xffffffffu, open)) {
            if (!built) dbl_build(s, W, Wp, levels, lane, reach);  // once a row, by the warp
            built = true;
#pragma unroll
            for (int j = 0; j < 4; ++j)
                if (res[j] < 0) res[j] = dbl_search(s, Wp, x0 + j, 8, s[x0 + j], W);
        }
        if (q < nq)
            for (int j = 0; j < 4; ++j)
                if (x0 + j < W) o[x0 + j] = res[j] < reach ? (float)res[j] : cap;
    }
}

template <typename T, bool HYBRID>
int dbl_launch(const uint8_t* mask, T* g, float* out, int B, int H, int W, int cap, int reach,
               int phases, cudaStream_t stream) {
    const int Wp = (W + 15) & ~15;
    int levels = 1;
    while ((1 << (levels - 1)) < W) ++levels;
    if (phases & DT_COLUMNS) {
        int err = dt_launch(mask, g, out, B, H, W, cap, reach, DT_COLUMNS, stream);
        if (err) return err;
    }
    if (phases & DT_ROW_PASS) {
        const int smem = DT_ROWS * levels * Wp * (int)sizeof(T);
        cudaError_t err = cudaFuncSetAttribute(dbl_rows<T, HYBRID>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return (int)err;
        dbl_rows<T, HYBRID><<<B * ((H + DT_ROWS - 1) / DT_ROWS), 32 * DT_ROWS, smem, stream>>>(
            g, out, H, W, Wp, reach, (float)cap, levels);
    }
    return (int)cudaGetLastError();
}

#define DBL_ENTRY(name, hybrid)                                                            \
    extern "C" int name(const void* mask, void* g, void* out, int B, int H, int W, int cap, \
                        int reach, int phases, void* stream) {                             \
        if (reach > 65535) return -1;                                                      \
        if (reach > 255)                                                                   \
            return dbl_launch<uint16_t, hybrid>((const uint8_t*)mask, (uint16_t*)g,        \
                                                (float*)out, B, H, W, cap, reach, phases,  \
                                                (cudaStream_t)stream);                     \
        return dbl_launch<uint8_t, hybrid>((const uint8_t*)mask, (uint8_t*)g, (float*)out, \
                                           B, H, W, cap, reach, phases,                    \
                                           (cudaStream_t)stream);                          \
    }
DBL_ENTRY(dbl_doubling, false)
DBL_ENTRY(dbl_hybrid, true)
'''


def variant_source(csrc: Path) -> str:
    """The shipped source with the three variants and their entry points
    appended (they reuse its row pass, column pass and ``dt_at``)."""
    src = (csrc / "distance_transform.cu").read_text()
    for piece in NEEDS:
        if piece not in src:
            raise SystemExit("distance_transform.cu changed: update the lever")
    return src + VARIANTS


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from tmlibrary_tpu_torch import shootout
    from tmlibrary_tpu_torch.ops import _cuda, kernels

    if not torch.cuda.is_available():
        raise SystemExit("distance_designs: needs a CUDA card")
    print("card:", cs.card_line(), flush=True)
    _cuda.lib()
    OUT.mkdir(parents=True, exist_ok=True)
    src = OUT / "distance_designs.cu"
    src.write_text(variant_source(_cuda.CSRC))
    built = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I", str(_cuda.CSRC), "-shared",
                            str(src), "-o", str(OUT / "libdistance_designs.so")],
                           capture_output=True, text=True)
    if built.returncode:
        raise SystemExit(built.stdout + built.stderr)
    var = ctypes.CDLL(str(OUT / "libdistance_designs.so"))
    for name in ("dbl_doubling", "dbl_hybrid"):
        getattr(var, name).argtypes = _cuda.SIGNATURES["tm_distance_transform"]
    P, I = ctypes.c_void_p, ctypes.c_int
    var.dsg_site.argtypes = [P, P, *[I] * 5, P]

    def site(masks, cap):
        mask = masks.to(torch.bool).contiguous()
        b, h, w = mask.shape
        r = kernels.distance_reach(mask.shape, cap)
        if r.reach > 65535 or h * r.pitch * 2 + h * w > kernels.SMEM_BYTES:
            return None  # a site the variant does not take
        out = torch.empty(mask.shape, dtype=torch.float32, device=mask.device)
        args = (mask.data_ptr(), out.data_ptr(), b, h, w, r.cap, r.reach, _cuda.stream())

        def launch():
            _cuda.check("distance_designs", var.dsg_site(*args))
            return out

        launch.held = (mask, out)
        return launch

    def launcher(fn, masks, cap, phases=kernels.DT_PHASES):
        mask = masks.to(torch.bool).contiguous()
        b, h, w = mask.shape
        r = kernels.distance_reach(mask.shape, cap)
        g = torch.empty((b, h, r.pitch), dtype=r.dtype, device=mask.device)
        out = torch.empty(mask.shape, dtype=torch.float32, device=mask.device)
        args = (mask.data_ptr(), g.data_ptr(), out.data_ptr(), b, h, w, r.cap, r.reach, phases,
                _cuda.stream())

        def launch():
            _cuda.check("distance_designs", fn(*args))
            return out

        launch.held = (mask, g, out)
        return launch

    dev = torch.device("cuda")
    filled = shootout.main_path_inputs(dev, 64, 256, 256, 0)["filled"]
    cases = shootout.distance_cases(filled)
    holds = dict(cases, edge=(cs.edge_sites(torch, dev), 64),
                 ragged=(cs.edge_sites(torch, dev, 257, 130), 300))
    bad = {}
    for name, (m, cap) in holds.items():
        for c in sorted({cap, 2, 254}):
            want = kernels.distance_transform_plain(m, c)
            runs = {who: launcher(getattr(var, who), m, c)
                    for who in ("dbl_doubling", "dbl_hybrid")}
            if site(m, c) is not None:
                runs["site"] = site(m, c)
            for who, run in runs.items():
                bad[(who, name, c)] = int(not torch.equal(run(), want))
    print("holds against the plain version; inputs that differ:",
          {k: v for k, v in bad.items() if v} or "none", flush=True)
    for name, (m, cap) in cases.items():
        variants = {"shipped": kernels.distance_transform_launcher(m, cap),
                    "site": site(m, cap),
                    "original": shootout.distance_original(m, cap),
                    "doubling": launcher(var.dbl_doubling, m, cap),
                    "hybrid": launcher(var.dbl_hybrid, m, cap),
                    "columns": kernels.distance_transform_launcher(
                        m, cap, phases=kernels.DT_COLUMNS)}
        ms = shootout.best_of({k: v for k, v in variants.items() if v is not None}, reps=7)
        print(f"  {name} (max_distance {cap}): " + ", ".join(
            f"{k} {v:.4f}" for k, v in ms.items()) + " ms; row pass alone: " + ", ".join(
            f"{k} {ms[k] - ms['columns']:.4f}" for k in ("shipped", "doubling", "hybrid")),
            flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
