"""Ingest through the codecs the containers need, against the JAX
package: a plate of zstd1 (hi-lo) CZIs, a plate of Imaris ``.ims`` files
(contiguous from ``h5py``, chunked and deflated from the port's writer)
and a directory of grey ``.jpg`` sites go through both packages'
metaconfig (``auto``; the JPEGs through ``pattern``, the default
filename style with the ``.jpg`` suffix, as no filename style of either
package takes JPEG by default), imextract and jterator with config 3 on
the CPU.  The manifests, ``file_mapping.json``, ``experiment.ome.xml``,
every stored plane and the nuclei and cell label stacks are equal.
Tolerance: exact.
"""

import json

import cv2
import numpy as np
import pytest
import torch

import test_czi
import test_ims
from test_torch_ingest import assert_same_ingest, ingest
from test_torch_workflow_steps import assert_same_labels, j_capacity_reset
from tmlibrary_tpu.models.store import ExperimentStore as JStore
from tmlibrary_tpu.workflow.registry import get_step as j_get_step
from tmlibrary_tpu.workflow.steps.metaconfig import DEFAULT_PATTERN
from tmlibrary_tpu_torch import benchmarks, capacity, container_writers
from tmlibrary_tpu_torch.models.store import ExperimentStore
from tmlibrary_tpu_torch.workflow import get_step

torch.set_num_threads(1)

SIZE = 64
JTERATOR = {"pipe": "cp.pipe.json", "batch_size": 4, "max_objects": 64}


def sites(n: int) -> dict:
    data = benchmarks.synthetic_cell_painting_batch(n, size=SIZE, n_cells=10, seed=0)
    return {ch: data[ch].astype(np.uint16) for ch in ("DAPI", "Actin")}


def czi_plate(src):
    px = sites(4)
    for i, well in enumerate(("A01", "A02")):
        planes = np.stack([px["DAPI"][2 * i:2 * i + 2], px["Actin"][2 * i:2 * i + 2]], 1)
        test_czi.write_czi(src / f"scan_{well}.czi", planes, compression=6, hilo=True,
                           channel_names=["DAPI", "Actin"])
    return {"handler": "auto"}


def ims_plate(src):
    px = sites(3)
    for i, well in enumerate(("B01", "B02", "C03")):
        planes = np.stack([px["DAPI"][i], px["Actin"][i]])[:, None, None]
        if i == 2:  # Imaris' own layout: chunked and deflated
            container_writers.write_ims(src / f"{well}.ims", planes, ["DAPI", "Actin"],
                                        chunks=(1, 32, 32), compression="gzip")
        else:
            test_ims.write_ims(src / f"{well}.ims", planes, ["DAPI", "Actin"])
    return {"handler": "auto"}


def jpeg_sites(src):
    px = sites(4)
    for i in range(4):
        well, site = ("A01", "A02")[i // 2], i % 2
        for ch in ("DAPI", "Actin"):
            grey = np.clip(px[ch][i] // 16, 0, 255).astype(np.uint8)
            assert cv2.imwrite(str(src / f"{well}_s{site}_{ch}.jpg"), grey)
    return {"pattern": DEFAULT_PATTERN.replace("(?:tif|tiff|png)", "(?:jpg|jpeg)")}


SOURCES = {"czi_zstd1": czi_plate, "ims": ims_plate, "jpeg": jpeg_sites}


def jterator(store, port: bool):
    (store.root / "cp.pipe.json").write_text(json.dumps(benchmarks.CELL_PAINTING_PIPE))
    if port:
        capacity.reset_routing_history()
        step = get_step("jterator")(store, device="cpu")
    else:
        j_capacity_reset()
        step = j_get_step("jterator")(store)
    step.init(dict(JTERATOR))
    for i in step.list_batches():
        step.run(i)
    step.collect()


@pytest.mark.parametrize("case", sorted(SOURCES))
def test_codec_sources_ingest_and_segment_as_the_reference(tmp_path, case):
    src = tmp_path / "src"
    src.mkdir()
    args = {"source_dir": str(src), **SOURCES[case](src)}
    ref = ingest(tmp_path / "ref", args, port=False)
    assert ingest(tmp_path / "port", args, port=True) == ref
    assert_same_ingest(tmp_path / "ref", tmp_path / "port")
    mapping = json.loads((tmp_path / "port" / "workflow" / "metaconfig" /
                          "file_mapping.json").read_text())
    suffix = {"czi_zstd1": ".czi", "ims": ".ims", "jpeg": ".jpg"}[case]
    assert mapping and all(e["path"].endswith(suffix) for e in mapping)
    port, want = ExperimentStore.open(tmp_path / "port"), JStore.open(tmp_path / "ref")
    assert port.read_sites(None, channel=0).max() > 0
    jterator(want, port=False)
    jterator(port, port=True)
    assert_same_labels(port, want)
    assert port.read_labels(None, "nuclei").max() > 0
