"""Reference-twin oracle: the C++ pipeline transcribed to numpy and scipy,
the port of ``unetseg_tpu.reference_twin`` without OpenCV.

bench.py grades "polygon IoU >= 0.999 **vs the C++ reference**".  The
reference binary cannot run beside the port, so this module stands in for
it: a framework-independent transcription of the reference's
inference-to-polygon path --

* ``numpy_unet_logits``   -- the UNet forward in float32 numpy (im2col +
  BLAS), the reference's TensorRT engine math (src/process.cpp:147; fp32
  I/O per src/process.cpp:70,224);
* ``reference_argmax``    -- the per-class CMP_GT running-max decode with
  -FLT_MAX init (first max wins on ties), src/process.cpp:157-171;
* ``twin_postprocess``    -- hole fill -> 3x3 MORPH_OPEN -> 8-connected
  area >= 6% filter, src/postprocess.cpp:13-79, with OpenCV's semantics
  rebuilt on ``scipy.ndimage`` (the card's machine has no OpenCV);
* ``twin_polygons``       -- threshold >127 -> findContours(EXTERNAL,
  SIMPLE) through ``io/contours_py`` -> truncating coordinate scale,
  src/mask2polygon.cpp:29-63.

``twin_pipeline`` chains them: checkpoint params in, reference-semantics
polygons out.  ``unetseg_tpu_torch.bench`` runs the served path (the CUDA
kernels, the host C++ cleanup and tracer) and this twin on the same slices
and reports their polygon IoU as ``parity_polygon_iou``.

This module shares no code with the port's ``ops``, ``models``, ``io/native``
or ``csrc``: every stage is an independent implementation, so agreement is
evidence, not tautology.  The params are the JAX-layout tree that
``checkpoint.load`` returns.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from unetseg_tpu_torch.config import ModelConfig


# ---------------------------------------------------------------------------
# float32 NumPy UNet forward (same params pytree as models/unet.py)
# ---------------------------------------------------------------------------

def _conv3x3(x: np.ndarray, w: np.ndarray, b: np.ndarray) -> np.ndarray:
    """SAME 3x3 conv, (H, W, Cin) x (3, 3, Cin, Cout) -> (H, W, Cout)."""
    from numpy.lib.stride_tricks import sliding_window_view

    h, wd, c = x.shape
    xp = np.pad(x, ((1, 1), (1, 1), (0, 0)))
    win = sliding_window_view(xp, (3, 3), axis=(0, 1))     # (H, W, C, 3, 3)
    cols = np.ascontiguousarray(win.transpose(0, 1, 3, 4, 2)).reshape(
        h * wd, 9 * c)
    y = cols @ w.reshape(9 * c, -1) + b
    return y.reshape(h, wd, -1)


def _conv1x1(x: np.ndarray, w: np.ndarray, b: np.ndarray) -> np.ndarray:
    return x @ w[0, 0] + b


def _maxpool2(x: np.ndarray) -> np.ndarray:
    h, w, c = x.shape
    return x.reshape(h // 2, 2, w // 2, 2, c).max(axis=(1, 3))


def _up2(x: np.ndarray, w: np.ndarray, b: np.ndarray) -> np.ndarray:
    """2x2 stride-2 transposed conv (non-overlapping): output pixel
    (2i+di, 2j+dj) = sum_c x[i,j,c] * w[1-di, 1-dj, c, :] + b
    (lax.conv_transpose with transpose_kernel=False mirrors the kernel)."""
    y = np.einsum("hwc,ijcd->hiwjd", x, w[::-1, ::-1])
    h, wd = x.shape[:2]
    return y.reshape(h * 2, wd * 2, -1) + b


def _relu(x: np.ndarray) -> np.ndarray:
    return np.maximum(x, 0.0)


def _f32(p) -> np.ndarray:
    return np.asarray(p, np.float32)


def numpy_unet_logits(params: Dict, x: np.ndarray,
                      cfg: ModelConfig) -> np.ndarray:
    """(H, W) float32 input in [0,1] -> (H, W, num_classes) float32 logits.

    Mirrors models/unet.apply at float32 (the reference engine computes in
    fp32 per its f32 tensor I/O, src/process.cpp:70); supports the stem=2
    slim geometry (space-to-depth in, subpixel head out).
    """
    if cfg.arch != "unet":
        raise ValueError("reference twin covers the serving arch 'unet'")
    x = x.astype(np.float32)[..., None]
    r = cfg.stem
    if r > 1:
        h, w, c = x.shape
        x = (x.reshape(h // r, r, w // r, r, c)
             .transpose(0, 2, 1, 3, 4).reshape(h // r, w // r, r * r * c))

    skips = []
    for stage in params["encoder"]:
        x = _relu(_conv3x3(x, _f32(stage["conv1"]["w"]), _f32(stage["conv1"]["b"])))
        x = _relu(_conv3x3(x, _f32(stage["conv2"]["w"]), _f32(stage["conv2"]["b"])))
        skips.append(x)
        x = _maxpool2(x)

    bn = params["bottleneck"]
    x = _relu(_conv3x3(x, _f32(bn["conv1"]["w"]), _f32(bn["conv1"]["b"])))
    x = _relu(_conv3x3(x, _f32(bn["conv2"]["w"]), _f32(bn["conv2"]["b"])))

    for stage, skip in zip(params["decoder"], reversed(skips)):
        x = _up2(x, _f32(stage["up"]["w"]), _f32(stage["up"]["b"]))
        x = np.concatenate([skip, x], axis=-1)
        x = _relu(_conv3x3(x, _f32(stage["conv1"]["w"]), _f32(stage["conv1"]["b"])))
        x = _relu(_conv3x3(x, _f32(stage["conv2"]["w"]), _f32(stage["conv2"]["b"])))

    logits = _conv1x1(x, _f32(params["head"]["w"]), _f32(params["head"]["b"]))
    if r > 1:
        h, w, c = logits.shape
        logits = (logits.reshape(h, w, r, r, c // (r * r))
                  .transpose(0, 2, 1, 3, 4).reshape(h * r, w * r, c // (r * r)))
    return logits


# ---------------------------------------------------------------------------
# decode + postprocess + polygonize, numpy and scipy
# ---------------------------------------------------------------------------

def reference_argmax(logits: np.ndarray) -> np.ndarray:
    """src/process.cpp:157-171: per-class strict-> running max from -FLT_MAX;
    ties keep the lowest class index."""
    h, w, c = logits.shape
    best = np.full((h, w), -np.finfo(np.float32).max, np.float32)
    mask = np.zeros((h, w), np.uint8)
    for cls in range(c):
        plane = logits[..., cls]
        gt = plane > best           # cv::CMP_GT
        mask[gt] = cls              # masked copyTo
        best = np.where(gt, plane, best)
    return mask


def _min_area(w: int, h: int) -> int:
    # src/postprocess.cpp:9: static_cast<int>(w * h * 0.06f)
    return int(np.float32(w * h) * np.float32(0.06))


def _components(fg: np.ndarray):
    """8-connected components of a bool image: (labels, count, areas
    indexed by label, bounding slices per label - 1), as
    ``cv2.connectedComponentsWithStats(connectivity=8)`` gives them up to
    the numbering of the components."""
    from scipy import ndimage

    labels, n = ndimage.label(fg, structure=np.ones((3, 3), bool))
    areas = np.bincount(labels.ravel(), minlength=n + 1)
    return labels, n, areas, ndimage.find_objects(labels)


def _open3x3(fg: np.ndarray) -> np.ndarray:
    """3x3 rect ``MORPH_OPEN`` with OpenCV's default border: the erosion
    treats pixels outside the image as foreground, the dilation as
    background (``morphologyDefaultBorderValue``)."""
    from scipy import ndimage

    k = np.ones((3, 3), bool)
    eroded = ndimage.binary_erosion(fg, structure=k, border_value=1)
    return ndimage.binary_dilation(eroded, structure=k, border_value=0)


def twin_postprocess(mask: np.ndarray) -> np.ndarray:
    """src/postprocess.cpp:13-79: holes of the foreground (class 2) that
    touch no image border and are smaller than 6% of the image are filled,
    the foreground is opened with a 3x3 rect, and its 8-connected
    components below 6% are dropped; the result is in {0, 2}."""
    m = mask.copy()
    h, w = m.shape
    min_area = _min_area(w, h)

    # fill_holes_inside_foreground (:13-44)
    labels, n, areas, boxes = _components(m != 2)
    for i in range(1, n + 1):
        rows, cols = boxes[i - 1]
        if (cols.start > 0 and rows.start > 0 and cols.stop - 1 < w - 1
                and rows.stop - 1 < h - 1 and areas[i] < min_area):
            m[labels == i] = 2

    # binarize == 2, 3x3 rect open, 8-conn area filter, remap {0,2} (:47-79)
    labels, n, areas, _ = _components(_open3x3(m == 2))
    keep = areas >= min_area
    keep[0] = False
    return np.where(keep[labels], 2, 0).astype(m.dtype)


def mask_to_vis(mask: np.ndarray) -> np.ndarray:
    """src/process.cpp:178-185 LUT: 0->0, 1->128, 2->255."""
    lut = np.array([0, 128, 255], np.uint8)
    return lut[mask]


def twin_polygons(vis: np.ndarray, orig_w: int, orig_h: int
                  ) -> List[List[Tuple[int, int]]]:
    """src/mask2polygon.cpp:29-63: threshold >127 -> findContours(EXTERNAL,
    SIMPLE), traced by ``io/contours_py`` -> x(orig/scaled) truncating int
    scale."""
    from unetseg_tpu_torch.io import contours_py

    scaled_h, scaled_w = vis.shape
    return contours_py.map_contour_points(contours_py.extract_contours(vis),
                                          orig_w / scaled_w,
                                          orig_h / scaled_h)


def twin_pipeline(params: Dict, cfg: ModelConfig, u8: np.ndarray,
                  orig_w: int, orig_h: int) -> List[List[Tuple[int, int]]]:
    """Full reference-semantics slice pipeline: normalized u8 512² in,
    scaled polygon list out (src/process.cpp:188-262 minus file I/O)."""
    x = u8.astype(np.float32) / 255.0      # preprocess_image u8 path (:36-39)
    logits = numpy_unet_logits(params, x, cfg)
    mask = reference_argmax(logits)
    mask = twin_postprocess(mask)
    return twin_polygons(mask_to_vis(mask), orig_w, orig_h)
