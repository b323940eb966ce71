"""nlohmann::json-compatible serialization: a copy of
``unetseg_tpu.io.jsonfmt``.

The reference emits two JSON artifacts through nlohmann::json v3.12:

* the size JSON, compact via ``operator<<`` (src/preprocess.cpp:133-134), and
* the labelme-style contour JSON, pretty via ``std::setw(4)``
  (src/mask2polygon.cpp:104-108).

nlohmann's default object storage is ``std::map``, so keys serialize in
alphabetical order; the compact form has no whitespace; the pretty form uses
a 4-space indent with ``": "`` after keys.  ``json.dumps`` with
``sort_keys=True`` and matching separators gives the same bytes for the
value types used here (str, int, null, object, array).  Both writers append
the trailing ``"\\n"`` of the reference's ``std::endl``.

In the port this is the pure path: the served artifacts come from the C++
emitter (``io/native.py``), and the tests and ``chip_smoke.py`` hold its
bytes against this module's and the goldens in ``tests/golden/``.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Sequence, Tuple


def dumps_compact(obj: Any) -> str:
    """nlohmann ``os << j`` equivalent (no trailing newline)."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":"),
                      ensure_ascii=False)


def dumps_pretty(obj: Any, indent: int = 4) -> str:
    """nlohmann ``os << std::setw(4) << j`` equivalent (no trailing
    newline)."""
    return json.dumps(obj, sort_keys=True, indent=indent,
                      separators=(",", ": "), ensure_ascii=False)


def size_json_bytes(filename: str, original_w: int, original_h: int,
                    scaled_w: int = 512, scaled_h: int = 512) -> bytes:
    """The ``{base}_original_sizes.json`` payload
    (src/preprocess.cpp:126-134)."""
    obj = {
        filename: {
            "original_width": original_w,
            "original_height": original_h,
            "scaled_width": scaled_w,
            "scaled_height": scaled_h,
        }
    }
    return (dumps_compact(obj) + "\n").encode()


def _shape(label: int, label_index: int,
           contour: Sequence[Tuple[int, int]]) -> Dict[str, Any]:
    """One labelme shape dict, shared by the standard and the per-class
    emitters (its keys are part of the byte contract)."""
    return {
        "label": int(label),
        "labelIndex": int(label_index),
        "points": [[int(x), int(y)] for (x, y) in contour],
        "shape_type": "polygon",
        "description": "",
        "mask": None,
        "group_id": None,
        "flags": {},
    }


def contour_json_obj(
    contours: Sequence[Sequence[Tuple[int, int]]],
    base_name: str,
    original_width: int,
    original_height: int,
    version: str = "1.0.2.812",
) -> Dict[str, Any]:
    """The labelme-style schema (src/mask2polygon.cpp:68-109)."""
    shapes: List[Dict[str, Any]] = [_shape(1, 0, c) for c in contours]
    return {
        "version": version,
        "imagePath": base_name + ".raw",
        "imageData": None,
        "flags": {},
        "shapes": shapes,
        "imageWidth": original_width,
        "imageHeight": original_height,
    }


def contour_json_bytes(
    contours: Sequence[Sequence[Tuple[int, int]]],
    base_name: str,
    original_width: int,
    original_height: int,
    version: str = "1.0.2.812",
) -> bytes:
    obj = contour_json_obj(contours, base_name, original_width,
                           original_height, version)
    return (dumps_pretty(obj) + "\n").encode()


def contour_json_bytes_labeled(
    labeled: Sequence[Tuple[int, int, Sequence[Tuple[int, int]]]],
    base_name: str,
    original_width: int,
    original_height: int,
    version: str = "1.0.2.812",
) -> bytes:
    """Per-class variant: ``labeled`` = [(label, labelIndex, contour), ...].

    The schema and bytes of :func:`contour_json_bytes` with the reference's
    constant ``label: 1 / labelIndex: 0`` (src/mask2polygon.cpp:86-88)
    replaced by per-shape class ids (BASELINE config 2)."""
    obj = contour_json_obj([], base_name, original_width, original_height,
                           version)
    obj["shapes"] = [_shape(label, idx, contour)
                     for label, idx, contour in labeled]
    return (dumps_pretty(obj) + "\n").encode()
