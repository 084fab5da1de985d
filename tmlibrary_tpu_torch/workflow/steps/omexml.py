"""Minimal OME-XML read/write for experiment metadata.

Counterpart: ``tmlibrary_tpu/workflow/steps/omexml.py`` (reference
``tmlib/workflow/metaconfig/omexml.py``): a dependency-free subset of the
OME schema (``Image``/``Pixels``/``Channel``/``Plane`` with
``SizeX/Y/Z/C/T``, ``DimensionOrder`` and stage positions) on
``xml.etree.ElementTree``.  metaconfig reads companion ``*.ome.xml``
files with it and writes the merged ``experiment.ome.xml``, the same
text as the JAX package's for the same manifest.  Host-side ingest
code, no device math.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from pathlib import Path

OME_NS = "http://www.openmicroscopy.org/Schemas/OME/2016-06"


def _strip_ns(tag: str) -> str:
    return tag.rsplit("}", 1)[-1]


@dataclass
class OmePlane:
    """One 2-D pixel plane within an image series."""

    the_z: int = 0
    the_t: int = 0
    the_c: int = 0
    position_x: float | None = None
    position_y: float | None = None


@dataclass
class OmeImage:
    """One image series (in HCS data: one site of one well)."""

    name: str
    size_x: int
    size_y: int
    size_z: int = 1
    size_c: int = 1
    size_t: int = 1
    dimension_order: str = "XYZCT"
    pixel_type: str = "uint16"
    channel_names: list[str] = field(default_factory=list)
    planes: list[OmePlane] = field(default_factory=list)


def parse_ome_xml(text: str) -> list[OmeImage]:
    """Parse an OME-XML document into a list of :class:`OmeImage`.

    Namespace-agnostic: accepts any OME schema revision (tags are matched
    by local name), which is what the reference's handler zoo needs since
    vendors pin different schema years.
    """
    from tmlibrary_tpu_torch.errors import MetadataError

    try:
        root = ET.fromstring(text)
    except ET.ParseError as exc:
        raise MetadataError(f"cannot parse OME-XML document: {exc}")
    images: list[OmeImage] = []
    for el in root.iter():
        if _strip_ns(el.tag) != "Image":
            continue
        pixels = None
        for child in el:
            if _strip_ns(child.tag) == "Pixels":
                pixels = child
                break
        if pixels is None:
            continue
        img = OmeImage(
            name=el.get("Name", el.get("ID", "")),
            size_x=int(pixels.get("SizeX", 0)),
            size_y=int(pixels.get("SizeY", 0)),
            size_z=int(pixels.get("SizeZ", 1)),
            size_c=int(pixels.get("SizeC", 1)),
            size_t=int(pixels.get("SizeT", 1)),
            dimension_order=pixels.get("DimensionOrder", "XYZCT"),
            pixel_type=pixels.get("Type", pixels.get("PixelType", "uint16")),
        )
        for sub in pixels:
            tag = _strip_ns(sub.tag)
            if tag == "Channel":
                img.channel_names.append(
                    sub.get("Name") or f"channel_{len(img.channel_names)}"
                )
            elif tag == "Plane":
                px = sub.get("PositionX")
                py = sub.get("PositionY")
                img.planes.append(
                    OmePlane(
                        the_z=int(sub.get("TheZ", 0)),
                        the_t=int(sub.get("TheT", 0)),
                        the_c=int(sub.get("TheC", 0)),
                        position_x=float(px) if px is not None else None,
                        position_y=float(py) if py is not None else None,
                    )
                )
        images.append(img)
    return images


def read_ome_companion(path: Path) -> list[OmeImage]:
    return parse_ome_xml(Path(path).read_text(errors="replace"))


def write_ome_xml(manifest) -> str:
    """Serialise an experiment manifest to an OME-XML document.

    Reference parity artifact: metaconfig's collect phase leaves the merged
    OME metadata on disk; here one ``Image`` element is emitted per site
    with the experiment's channel set and z/t extents.
    """
    ET.register_namespace("", OME_NS)
    root = ET.Element(f"{{{OME_NS}}}OME")
    idx = 0
    for plate in manifest.plates:
        plate_el = ET.SubElement(root, f"{{{OME_NS}}}Plate")
        plate_el.set("ID", f"Plate:{plate.name}")
        plate_el.set("Name", plate.name)
        plate_el.set("Rows", str(max((w.row for w in plate.wells), default=0) + 1))
        plate_el.set(
            "Columns", str(max((w.column for w in plate.wells), default=0) + 1)
        )
        for well in plate.wells:
            well_el = ET.SubElement(plate_el, f"{{{OME_NS}}}Well")
            well_el.set("Row", str(well.row))
            well_el.set("Column", str(well.column))
            for site in well.sites:
                ws = ET.SubElement(well_el, f"{{{OME_NS}}}WellSample")
                ws.set("ID", f"WellSample:{idx}")
                ws.set("ImageRef", f"Image:{idx}")

                img = ET.SubElement(root, f"{{{OME_NS}}}Image")
                img.set("ID", f"Image:{idx}")
                img.set(
                    "Name",
                    f"{plate.name}_r{well.row:02d}c{well.column:02d}"
                    f"_y{site.y}x{site.x}",
                )
                px = ET.SubElement(img, f"{{{OME_NS}}}Pixels")
                px.set("ID", f"Pixels:{idx}")
                px.set("DimensionOrder", "XYZCT")
                px.set("Type", "uint16")
                px.set("SizeX", str(manifest.site_width))
                px.set("SizeY", str(manifest.site_height))
                px.set("SizeZ", str(manifest.n_zplanes))
                px.set("SizeC", str(manifest.n_channels))
                px.set("SizeT", str(manifest.n_tpoints))
                for c in manifest.channels:
                    ch = ET.SubElement(px, f"{{{OME_NS}}}Channel")
                    ch.set("ID", f"Channel:{idx}:{c.index}")
                    ch.set("Name", c.name)
                idx += 1
    return ET.tostring(root, encoding="unicode")
