"""A/B of one lever the union-find CC kernels did not take: compare-and-
swap hooks with path compression in the finds (the hook of Anderson and
Woll's concurrent union-find, which never moves a node that is not a
root, so compression cannot split a tree).

It writes a variant of ``csrc/cc_union_find.cuh`` into ``build/levers/``
(the union's atomicMin link becomes ``atomicCAS(&parent[b], b, a)``, and
every find of the union phases lowers the nodes of its path to the root
with atomicMin), builds it beside the shipped kernels with ``nvcc``,
holds both against the plain versions (30 launches in a row on the real
and the noise masks, 3 on the rest) and times both, whole and by phase,
with :func:`tmlibrary_tpu_torch.shootout.best_of` on the main path's
and the volume path's masks, all-foreground masks and noise.

Run on a card from the root of a checkout:
``python3 -m tmlibrary_tpu_torch.levers.cc_cas_hooks``.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
OUT = ROOT / "build" / "levers"

FIND_S = """__device__ __forceinline__ int uf_find_shared(const volatile int* s, int x) {
    for (int up; (up = s[x]) != x;) x = up;
    return x;
}
"""
FIND_G = """__device__ __forceinline__ int uf_find_global(const int* lab, int x) {
    for (int up; (up = __ldcg(lab + x)) != x;) x = up;
    return x;
}
"""
HOOK_S = """        int old = atomicMin(&s[b], a);
        if (old == b) return;
        b = old;  // b was linked meanwhile: join its new parent's tree too
"""
HOOK_G = """        int old = atomicMin(&lab[b], a);
        if (old == b) return;
        b = old;
"""
ENTRIES = '''
extern "C" int cas2d(const void* m, void* l, int B, int H, int W, int c, int ph, void* s) {
    return tm_cc_uf_cas<1, 32, 32, 512>(m, l, B, 1, H, W, c == 4 ? 6 : 26, ph, (cudaStream_t)s);
}
extern "C" int cas3d(const void* m, void* l, int B, int Z, int H, int W, int c, int ph, void* s) {
    return tm_cc_uf_cas<2, 16, 32, 256>(m, l, B, Z, H, W, c, ph, (cudaStream_t)s);
}
'''


def variant_source(csrc: Path) -> str:
    """The shipped header with CAS hooks and compressing finds, and the
    variant's two C entry points (the shipped tiles and threads)."""
    src = (csrc / "cc_union_find.cuh").read_text()
    for piece in (FIND_S, FIND_G, HOOK_S, HOOK_G):
        if piece not in src:
            raise SystemExit("cc_union_find.cuh changed: update the lever's patterns")
    src = (src
           .replace(FIND_S, """__device__ __forceinline__ int uf_root_shared(const volatile int* s, int x) {
    for (int up; (up = s[x]) != x;) x = up;
    return x;
}
__device__ __forceinline__ int uf_find_shared(int* s, int x) {
    const volatile int* vs = s;
    const int r = uf_root_shared(vs, x);
    for (int up = vs[x]; up > r; x = up) up = atomicMin(&s[x], r);
    return r;
}
""")
           .replace(FIND_G, """__device__ __forceinline__ int uf_root_global(const int* lab, int x) {
    for (int up; (up = __ldcg(lab + x)) != x;) x = up;
    return x;
}
__device__ __forceinline__ int uf_find_global(int* lab, int x) {
    const int r = uf_root_global(lab, x);
    for (int up = __ldcg(lab + x); up > r; x = up) up = atomicMin(lab + x, r);
    return r;
}
""")
           .replace(HOOK_S, "        if (atomicCAS(&s[b], b, a) == b) return;  // b still a root\n")
           .replace(HOOK_G, "        if (atomicCAS(&lab[b], b, a) == b) return;\n")
           .replace("const int r = uf_find_shared(s_l, t);", "const int r = uf_root_shared(s_l, t);")
           .replace("        const int r = uf_find_global(lab, l);\n",
                    "        const int r = uf_root_global(lab, l);\n")
           .replace("tm_cc_union_find", "tm_cc_uf_cas"))
    return src + ENTRIES


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from tmlibrary_tpu_torch import shootout
    from tmlibrary_tpu_torch.ops import _cuda, kernels, volume

    if not torch.cuda.is_available():
        raise SystemExit("cc_cas_hooks: needs a CUDA card")
    print("card:", cs.card_line(), flush=True)
    _cuda.lib()
    OUT.mkdir(parents=True, exist_ok=True)
    src = OUT / "cc_cas_hooks.cu"
    src.write_text(variant_source(_cuda.CSRC))
    built = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I", str(_cuda.CSRC), "-shared",
                            str(src), "-o", str(OUT / "libcc_cas_hooks.so")],
                           capture_output=True, text=True)
    if built.returncode:
        raise SystemExit(built.stdout + built.stderr)
    var = ctypes.CDLL(str(OUT / "libcc_cas_hooks.so"))
    P, I = ctypes.c_void_p, ctypes.c_int
    var.cas2d.argtypes = [P, P, *[I] * 5, P]
    var.cas3d.argtypes = [P, P, *[I] * 6, P]

    def launcher(fn, masks, conn, phases=kernels.CC_PHASES):
        mask = masks.to(torch.bool).contiguous()
        out = torch.empty(mask.shape, dtype=torch.int32, device=mask.device)
        args = (mask.data_ptr(), out.data_ptr(), *mask.shape, conn, phases, _cuda.stream())

        def launch():
            _cuda.check("cc_cas_hooks", fn(*args))
            return out

        launch.held = (mask, out)
        return launch

    dev = torch.device("cuda")
    inputs = shootout.main_path_inputs(dev, 64, 256, 256, 0)
    vi = shootout.volume_inputs(dev, 16, 128, 16, 256, 0, 8)
    cases2 = shootout.cc_cases(inputs["dapi_mask"])
    cases2.update(edges=cs.edge_sites(torch, dev), ragged=cs.edge_sites(torch, dev, 257, 130),
                  comb=cs.tile_comb(torch, dev, 1024))
    cases3 = shootout.cc_cases(vi["vmask"])
    cases3.update(edges=cs.edge_volumes(torch, dev), ragged=(torch.rand(
        (2, 17, 100, 37), generator=torch.Generator().manual_seed(3)) < 0.3).to(dev))
    t0 = time.time()
    bad = {}
    for rank, cases, conns in ((2, cases2, (8, 4)), (3, cases3, (26, 18, 6))):
        wrapper = kernels.cc_min_propagate if rank == 2 else volume.cc3d_min_propagate
        plain = kernels.cc_min_propagate_plain if rank == 2 else volume.cc3d_min_propagate_plain
        for name, m in cases.items():
            for conn in conns:
                want = plain(m, conn)
                runs = {"shipped": lambda: wrapper(m, conn),
                        "cas": launcher(var.cas2d if rank == 2 else var.cas3d, m, conn)}
                for _ in range(30 if name in ("noise", "real") else 3):
                    for who, run in runs.items():
                        key = (who, rank, name, conn)
                        bad[key] = bad.get(key, 0) + int(not torch.equal(run(), want))
    print(f"holds ({time.time() - t0:.1f} s); launches that differ from the plain version:",
          {k: v for k, v in bad.items() if v} or "none", flush=True)
    for rank, cases in ((2, cases2), (3, cases3)):
        ship = kernels.cc_min_propagate_launcher if rank == 2 else volume.cc3d_min_propagate_launcher
        fn, conn = (var.cas2d, 8) if rank == 2 else (var.cas3d, 26)
        for case in ("real", "full", "noise"):
            m = cases[case]
            variants = {}
            for tag, phases in (("", kernels.CC_PHASES), ("_local", kernels.CC_LOCAL),
                                ("_border", kernels.CC_LOCAL | kernels.CC_BORDER)):
                variants[f"shipped{tag}"] = ship(m, phases=phases)
                variants[f"cas{tag}"] = launcher(fn, m, conn, phases)
            ms = shootout.best_of(variants, reps=5)
            print(f"  {rank}-D {case}: " + ", ".join(f"{k} {v:.4f}" for k, v in ms.items()),
                  flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
