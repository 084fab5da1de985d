"""The module diff of the two packages, checked.

Both packages are parsed with ``ast`` and neither is imported.  Every
public top-level function and class of ``tmlibrary_tpu/``, and every
public method of a public class, must have a counterpart in
``tmlibrary_tpu_torch/`` under the same module path, or one named in
:data:`RENAMED`; otherwise it stands in :data:`EXCLUDED` with the reason
the port leaves it out, or in :data:`DEFERRED` with the kind of pull
request it waits for.  The tables must stay true: a renamed target
exists, an excluded name has no counterpart, every key names a
reference name.  The port's modules import neither ``jax`` nor the JAX
package.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
REF, PORT = ROOT / "tmlibrary_tpu", ROOT / "tmlibrary_tpu_torch"

#: reference ``module:name`` -> the port's ``module:name``
RENAMED = {
    # the TPU kernels' wrappers: ops/kernels.py and ops/volume.py (ROADMAP B)
    "ops/pallas_kernels.py:fill_holes_flood": "ops/kernels.py:fill_holes_flood",
    "ops/pallas_kernels.py:cc_min_propagate": "ops/kernels.py:cc_min_propagate",
    "ops/pallas_kernels.py:watershed_flood": "ops/kernels.py:watershed_flood",
    "ops/pallas_kernels.py:distance_transform": "ops/kernels.py:distance_transform",
    "ops/pallas_kernels.py:cc3d_min_propagate": "ops/volume.py:cc3d_min_propagate",
    "ops/pallas_kernels.py:watershed3d_flood": "ops/volume.py:watershed3d_flood",
    # the shifts and morphology beside the kernels that use them
    "ops/label.py:shift_with_fill": "ops/kernels.py:shift_with_fill",
    "ops/label.py:binary_dilate": "ops/kernels.py:binary_dilate",
    "ops/label.py:binary_erode": "ops/kernels.py:binary_erode",
    "ops/measure.py:zernike_host_features": "ops/mosaic.py:zernike_host_features",
    "parallel/mesh.py:balanced_shard_order": "workflow/schedule.py:balanced_shard_order",
    # the parallel layer drops the 2-D suffix (its ops take blocks of a mesh)
    "parallel/halo.py:halo_exchange_2d": "parallel/halo.py:halo_exchange",
    "parallel/halo.py:sharded_halo_map_2d": "parallel/halo.py:sharded_halo_map",
    "parallel/halo.py:sharded_gaussian_smooth_2d": "parallel/halo.py:sharded_gaussian_smooth",
    "parallel/label.py:distributed_connected_components_2d":
        "parallel/label.py:distributed_connected_components",
    "parallel/label.py:distributed_watershed_from_seeds_2d":
        "parallel/label.py:distributed_watershed_from_seeds",
    "parallel/label.py:sharded_segment_mosaic_2d": "parallel/label.py:sharded_segment_mosaic",
    # a torch.nn.Module's call
    "nn/unet.py:unet_apply": "nn/unet.py:UNet.forward",
}

_NATIVE = ("the CPU twins of the JAX package's XLA programs; the port's CPU path is each "
           "kernel's *_plain version")
_XLA_EXECUTABLE = ("reads or compiles XLA executables; the port compiles nothing per "
                   "program (perf.instrument_call counts a first call)")
_SPECULATION = "compiles capacity rungs ahead; the port has nothing to compile ahead"
_VMEM = "sizes a Pallas kernel's TPU VMEM; the CUDA kernels plan their own shared memory"
_SHARDING = "a jax.sharding layout; the port's ranks split the batch (parallel/mesh.py)"

#: reference ``module`` or ``module:name`` -> why the port has no counterpart
EXCLUDED = {
    "parallel/compat.py": "a shim over JAX versions' shard_map and axis helpers",
    "parallel/distributed.py:pod_mesh": "a TPU pod's DCN/ICI layout",
    "parallel/distributed.py:batch_spec": _SHARDING,
    "parallel/mesh.py:batch_sharding": _SHARDING,
    "parallel/mesh.py:replicated_sharding": _SHARDING,
    "resilience.py:DeviceHealthGuard": ("pins the JAX backend to the CPU after a dead "
                                        "device; in the port a dead card raises"),
    "resilience.py:DeviceHealthGuard.ensure_backend": "DeviceHealthGuard's",
    "resilience.py:DeviceHealthGuard.healthy": "DeviceHealthGuard's",
    "resilience.py:DeviceHealthGuard.note_watchdog_fire": "DeviceHealthGuard's",
    "utils/__init__.py:enable_compilation_cache": "JAX's persistent compilation cache",
    "capacity.py:requested_object_buckets": ("an ambient bucket spec; the port's is the "
                                             "jterator step's argument (--object-buckets)"),
    "perf.py:instrument_batch_fn": _XLA_EXECUTABLE,
    "perf.py:cost_from_compiled": _XLA_EXECUTABLE,
    "perf.py:abstract_args": _XLA_EXECUTABLE,
    "perf.py:adopt_executable": _XLA_EXECUTABLE,
    "perf.py:speculate_compile": _SPECULATION,
    "aotstore.py:speculation_enabled": _SPECULATION,
    "workflow/steps/jterator.py:ImageAnalysisRunner.speculate_ahead": _SPECULATION,
    "jterator/pipeline.py:cached_batch_fn": ("memoises jit-compiled programs; the jterator "
                                             "step keeps its pipelines per capacity, mesh, "
                                             "identity and strategy"),
    "jterator/pipeline.py:program_digest_extras": ("the compiled-program cache key's "
                                                   "extras; the port has no such cache"),
    "jterator/pipeline.py:donation_enabled": "XLA buffer donation; the port has none",
    "ops/pallas_kernels.py:pallas_enabled": "the Pallas gate; a CUDA tensor launches the "
                                            "kernel, a CPU tensor its plain version",
    "ops/fused_measure.py:fused_chunk": _VMEM,
    "ops/fused_measure.py:vmem_bytes_estimate": _VMEM,
    "models/image.py:Image.tree_flatten": "JAX pytree registration",
    "models/image.py:Image.tree_unflatten": "JAX pytree registration",
    **{f"native.py:{name}": _NATIVE for name in (
        "align_batch", "available", "batch_sites", "bounding_boxes_host", "box_mean_host",
        "callback_vmap_method", "cc_label3d_host", "cc_label_host", "chebyshev_dt_host",
        "cpu_native_enabled", "fill_holes_host", "has_3d_kernels", "has_box_mean",
        "has_site_glcm", "has_site_stats", "hist_counts_host", "hull_pixel_counts_host",
        "mosaic_intensity_host", "mosaic_morph_host", "otsu_hist_host",
        "site_channel_minmax_host", "site_channel_sums_host", "site_glcm_host",
        "site_stats_host", "solidity_host", "tmx_native_env_enabled",
        "trace_boundary_host", "watershed_levels3d_host", "watershed_levels_host")},
}

#: reference ``module:name`` -> the kind of pull request it waits for (none
#: waits: every public name of the JAX package has a counterpart, a rename
#: or a decided exclusion)
DEFERRED: dict[str, str] = {}

#: the kinds of pull request a deferred name may wait for
PR_KINDS = ("benchmark", "bring_up")


def public_names(package: Path) -> dict[str, set[str]]:
    """``{module path: {name, Class.method, ...}}`` of a package's public
    top-level functions and classes and the public methods of those
    classes, from the source."""
    out = {}
    for path in sorted(package.rglob("*.py")):
        names = set()
        for node in ast.parse(path.read_text()).body:
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                continue
            if node.name.startswith("_"):
                continue
            names.add(node.name)
            if isinstance(node, ast.ClassDef):
                names.update(f"{node.name}.{m.name}" for m in node.body
                             if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                             and not m.name.startswith("_"))
        out[path.relative_to(package).as_posix()] = names
    return out


REF_NAMES = public_names(REF)
PORT_NAMES = public_names(PORT)


def _port_has(key: str) -> bool:
    module, name = key.split(":")
    return name in PORT_NAMES.get(module, set())


def missing(module: str) -> list[str]:
    """The reference names of ``module`` that nothing accounts for."""
    if module in EXCLUDED:
        return []
    out = []
    for name in sorted(REF_NAMES[module]):
        key = f"{module}:{name}"
        if name in PORT_NAMES.get(module, set()):
            continue
        if key in RENAMED and _port_has(RENAMED[key]):
            continue
        if key in EXCLUDED or key in DEFERRED:
            continue
        out.append(key)
    return out


@pytest.mark.parametrize("module", sorted(REF_NAMES))
def test_every_public_name_has_a_counterpart(module):
    assert missing(module) == []


def test_the_tables_name_reference_names():
    for key in (*RENAMED, *EXCLUDED, *DEFERRED):
        module, _, name = key.partition(":")
        assert module in REF_NAMES, key
        assert not name or name in REF_NAMES[module], key


def test_renamed_targets_exist():
    for key, target in RENAMED.items():
        assert _port_has(target), f"{key} -> {target}"
        assert not _port_has(key), f"{key} is ported under its own name"


def test_excluded_and_deferred_names_have_no_counterpart():
    for key, reason in EXCLUDED.items():
        assert reason.strip(), key
        if ":" in key:
            assert not _port_has(key), f"{key} is ported; take it out of EXCLUDED"
        else:
            assert key not in PORT_NAMES, f"{key} exists in the port"
    for key, kind in DEFERRED.items():
        assert kind in PR_KINDS, key
        assert not _port_has(key), f"{key} is ported; take it out of DEFERRED"
    assert not set(EXCLUDED) & set(DEFERRED)


def test_the_decided_exclusions_are_listed():
    """ROADMAP's decided exclusions, each with its reason."""
    native = {k for k in EXCLUDED if k.startswith("native.py:")}
    assert len(native) == 29
    for key in ("parallel/compat.py", "parallel/distributed.py:pod_mesh",
                "parallel/distributed.py:batch_spec", "parallel/mesh.py:batch_sharding",
                "parallel/mesh.py:replicated_sharding", "resilience.py:DeviceHealthGuard",
                "utils/__init__.py:enable_compilation_cache",
                "ops/pallas_kernels.py:pallas_enabled", "ops/fused_measure.py:fused_chunk",
                "ops/fused_measure.py:vmem_bytes_estimate", "perf.py:cost_from_compiled",
                "perf.py:speculate_compile", "aotstore.py:speculation_enabled"):
        assert key in EXCLUDED, key


def _imports(path: Path) -> set[str]:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(p.relative_to(ROOT).as_posix()
                                        for p in [*PORT.rglob("*.py"), ROOT / "chip_smoke.py"]))
def test_the_port_imports_no_jax(path):
    assert not _imports(ROOT / path) & {"jax", "jaxlib", "tmlibrary_tpu"}
