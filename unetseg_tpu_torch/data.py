"""Synthetic CT-like slices, the real MR sample and model-ready batches, a
copy of ``unetseg_tpu/data.py`` (numpy only; matplotlib, where present,
only to find its bundled sample).

A noisy background with a bright soft-edged ellipse "organ" (class 2) and a
dimmer distractor blob (class 1), mirroring the reference's class semantics
(src/postprocess.cpp:5-7).  Same generator calls in the same order, so the
same seed gives the same slices as the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def synth_slice(rng: np.random.Generator, size: int = 512,
                r_range: Tuple[float, float] = (0.12, 0.3),
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (raw uint16 (size,size), labels uint8 (size,size) in {0,1,2}).

    ``r_range`` bounds the organ's semi-axes as a fraction of ``size``.
    """
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float64)

    cy, cx = rng.uniform(0.3, 0.7, 2) * size
    ry, rx = rng.uniform(*r_range, 2) * size
    theta = rng.uniform(0, np.pi)
    ct, st = np.cos(theta), np.sin(theta)
    u = ((xx - cx) * ct + (yy - cy) * st) / rx
    v = (-(xx - cx) * st + (yy - cy) * ct) / ry
    organ = (u * u + v * v) <= 1.0

    dcy, dcx = rng.uniform(0.1, 0.9, 2) * size
    dr = rng.uniform(0.04, 0.08) * size
    distract = ((xx - dcx) ** 2 + (yy - dcy) ** 2) <= dr * dr

    img = rng.normal(12000, 1500, (size, size))
    img += organ * rng.uniform(18000, 26000)
    img += distract * rng.uniform(6000, 9000)
    img = np.clip(img, 0, 65535).astype(np.uint16)

    labels = np.zeros((size, size), np.uint8)
    labels[distract] = 1
    labels[organ] = 2
    return img, labels


def synth_batch(rng: np.random.Generator, n: int, size: int = 512):
    """(raws (n,s,s) u16, labels (n,s,s) u8)."""
    raws = np.empty((n, size, size), np.uint16)
    labels = np.empty((n, size, size), np.uint8)
    for i in range(n):
        raws[i], labels[i] = synth_slice(rng, size)
    return raws, labels


def synth_slice_shifted(rng: np.random.Generator, size: int = 512,
                        kind: str = "lobulated",
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Out-of-family anatomy-like slices for distribution-shift evaluation.

    Robustness beyond the training family is probed with shape/texture
    families the models never saw:

    * ``lobulated`` — Fourier-perturbed radius r(θ)=r0(1+Σ a_k cos(kθ+φ_k)):
      lobed organ boundaries (kidney/liver-section-like),
    * ``crescent``  — ellipse minus a shifted ellipse: C-shaped structures
      (stomach/bowel-section-like) with concave boundary segments,
    * ``illum``     — standard ellipse under a strong linear illumination
      gradient + coarse streak noise (scanner artifacts),
    * ``multiorgan`` — 2-3 disjoint bright organs of varying size (paired
      structures / multi-section anatomy): the training family is always
      single-organ, so this probes whether the model segments ALL bright
      structures or has learned a one-organ prior.

    Returns (raw uint16, labels uint8) with the reference's class semantics.
    """
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float64)
    cy, cx = rng.uniform(0.35, 0.65, 2) * size

    if kind == "lobulated":
        r0 = rng.uniform(0.10, 0.25) * size
        theta = np.arctan2(yy - cy, xx - cx)
        rad = np.hypot(yy - cy, xx - cx)
        rr = np.ones_like(theta)
        for k in range(2, 7):
            rr += (rng.uniform(0, 0.15) / (k - 1)) * np.cos(
                k * theta + rng.uniform(0, 2 * np.pi))
        organ = rad <= r0 * rr
    elif kind == "crescent":
        ry, rx = rng.uniform(0.15, 0.28, 2) * size
        u = (xx - cx) / rx
        v = (yy - cy) / ry
        outer = u * u + v * v <= 1.0
        off = rng.uniform(0.3, 0.6) * min(rx, ry)
        ang = rng.uniform(0, 2 * np.pi)
        u2 = (xx - cx - off * np.cos(ang)) / (rx * 0.85)
        v2 = (yy - cy - off * np.sin(ang)) / (ry * 0.85)
        organ = outer & ~(u2 * u2 + v2 * v2 <= 1.0)
    elif kind == "illum":
        ry, rx = rng.uniform(0.12, 0.3, 2) * size
        u = (xx - cx) / rx
        v = (yy - cy) / ry
        organ = u * u + v * v <= 1.0
    elif kind == "multiorgan":
        organ = np.zeros((size, size), bool)
        for _ in range(int(rng.integers(2, 4))):
            ocy, ocx = rng.uniform(0.15, 0.85, 2) * size
            ory, orx = rng.uniform(0.06, 0.16, 2) * size
            th = rng.uniform(0, np.pi)
            ct, st = np.cos(th), np.sin(th)
            u = ((xx - ocx) * ct + (yy - ocy) * st) / orx
            v = (-(xx - ocx) * st + (yy - ocy) * ct) / ory
            organ |= u * u + v * v <= 1.0
    else:
        raise ValueError(f"unknown shift kind {kind!r}")

    dcy, dcx = rng.uniform(0.1, 0.9, 2) * size
    dr = rng.uniform(0.04, 0.08) * size
    distract = ((xx - dcx) ** 2 + (yy - dcy) ** 2) <= dr * dr

    img = rng.normal(12000, 1500, (size, size))
    img += organ * rng.uniform(18000, 26000)
    img += distract * rng.uniform(6000, 9000)
    if kind == "illum":
        gx, gy = rng.uniform(-1, 1, 2)
        ramp = (gx * (xx / size - 0.5) + gy * (yy / size - 0.5))
        # ramp ∈ [-1, 1] when both gradient components max out (corner of a
        # diagonal gradient), so shading reaches ±35%; a single-axis
        # gradient tops out at ±17.5%
        img *= 1.0 + 0.35 * ramp
        streaks = rng.normal(0, 2500, (size, 1)) * np.ones((1, size))
        img += streaks                                  # row-correlated noise
    img = np.clip(img, 0, 65535).astype(np.uint16)

    labels = np.zeros((size, size), np.uint8)
    labels[distract] = 1
    labels[organ] = 2
    return img, labels


def real_mri_slice():
    """A real medical image that needs no download: matplotlib's bundled
    sample ``s1045.ima.gz``, a 256x256 uint16 MR head slice (an actual scan
    shipped with matplotlib for its MRI demos since the mpl 0.x era).

    Returns a (256, 256) uint16 array, or ``None`` when matplotlib (or the
    sample file) is absent.  One slice cannot validate accuracy claims, but
    it is genuine anatomy in exactly the reference's input format
    (headerless little-endian u16 — the reference's src/preprocess.cpp:76),
    so it exercises every pipeline stage on a real intensity distribution
    instead of synthetic phantoms.
    """
    import gzip
    import os

    try:
        import matplotlib
    except Exception:  # matplotlib is optional
        return None
    path = os.path.join(matplotlib.get_data_path(), "sample_data",
                        "s1045.ima.gz")
    if not os.path.exists(path):  # pragma: no cover
        return None
    buf = gzip.open(path, "rb").read()
    if len(buf) != 256 * 256 * 2:  # pragma: no cover
        return None
    return np.frombuffer(buf, np.uint16).reshape(256, 256).copy()


def real_mri_pool():
    """Deterministic real-anatomy evaluation pool from the one real slice.

    Variants of :func:`real_mri_slice` that keep the pixels genuine while
    exercising the pipeline's degrees of freedom:

    * 8 dihedral orientations (rot90 x flip) — anatomy at every layout the
      reference's directory walker could encounter;
    * 3 window/level remaps (percentile clip + u16 rescale) — the contrast
      adjustments MR viewers apply before export;
    * 2 center crops (192², 224²) — non-trivial bilinear resample ratios
      through the truncating 512² preprocess.

    Returns a list of (name, raw_u16) pairs, or ``[]`` when the sample is
    unavailable.
    """
    base = real_mri_slice()
    if base is None:  # pragma: no cover
        return []
    pool = []
    for k in range(4):
        r = np.rot90(base, k)
        pool.append((f"rot{90 * k}", np.ascontiguousarray(r)))
        pool.append((f"rot{90 * k}_flip",
                     np.ascontiguousarray(np.fliplr(r))))
    f = base.astype(np.float64)
    for lo_p, hi_p in ((1.0, 99.0), (5.0, 95.0), (0.5, 99.9)):
        lo, hi = np.percentile(f, (lo_p, hi_p))
        hi = max(hi, lo + 1.0)
        w = np.clip((f - lo) / (hi - lo), 0.0, 1.0) * 65535.0
        pool.append((f"window_{lo_p:g}_{hi_p:g}", w.astype(np.uint16)))
    for c in (192, 224):
        o = (256 - c) // 2
        pool.append((f"crop{c}",
                     np.ascontiguousarray(base[o:o + c, o:o + c])))
    return pool


def real_mri_mosaic(grid: int = 2):
    """A (grid*256)² u16 mosaic of dihedral variants of the real MR slice.

    Every pixel is genuine anatomy (no resampling/synthesis).  NOTE: this is
    a multi-organ frame, and the reference's mask cleanup erases connected
    components below 6% of the FRAME area (src/postprocess.cpp:47-79 via
    MIN_AREA_RATIO) — at grid=2 each head's surviving region (~4% of the
    512² frame) falls below that floor, so the product correctly emits an
    empty mask / no contours.  Used to PIN that semantic
    (benchmarks/eval_real.py stage E); for exercising the sliding-window
    blend on real pixels use :func:`real_mri_512`.  Deterministic; ``None``
    when the sample is unavailable.
    """
    base = real_mri_slice()
    if base is None:  # pragma: no cover
        return None
    variants = []
    for k in range(4):
        r = np.rot90(base, k)
        variants.append(r)
        variants.append(np.fliplr(r))
    rows = [np.concatenate([variants[(r * grid + c) % len(variants)]
                            for c in range(grid)], axis=1)
            for r in range(grid)]
    return np.ascontiguousarray(np.concatenate(rows, axis=0))


def real_mri_512():
    """The real MR slice at 512², via the reference's own resample.

    Bilinear upscale with the truncating float64 grid of
    src/preprocess.cpp:82-115 (the exact transform the product applies to
    every 256² input on its way to the model), rounded back to uint16
    instead of quantized to uint8.  This is the canonical way to get a
    512² real-anatomy image for the native-resolution sliding-window path:
    the content matches what the full-frame serial path infers on, so
    window-blend output is directly comparable to the serial polygons.
    Deterministic; ``None`` when the sample is unavailable.
    """
    base = real_mri_slice()
    if base is None:  # pragma: no cover
        return None
    # truncating bilinear grid (preprocess.cpp:82-83 semantics)
    step = 256 / 512
    f = np.arange(512, dtype=np.float64) * step
    i0 = f.astype(np.int64)
    i1 = np.minimum(i0 + 1, 255)
    d = f - i0
    src = base.astype(np.float64)
    v00 = src[np.ix_(i0, i0)]
    v01 = src[np.ix_(i0, i1)]
    v10 = src[np.ix_(i1, i0)]
    v11 = src[np.ix_(i1, i1)]
    dx, dy = d[None, :], d[:, None]
    v = (((1 - dx) * (1 - dy)) * v00 + (dx * (1 - dy)) * v01
         + ((1 - dx) * dy) * v10 + (dx * dy) * v11)
    return np.floor(v + 0.5).astype(np.uint16)


def training_batch(rng: np.random.Generator, n: int, size: int = 512):
    """Model-ready (imgs (n,s,s,1) f32 in [0,1], labels (n,s,s) i32), a copy
    of ``unetseg_tpu.data.training_batch``: each slice goes through the
    serving pipeline's per-slice min-max + u8 quantize and /255, so the
    calibration (and training) distribution is the served one."""
    from unetseg_tpu_torch.ops.preprocess import preprocess_oracle_u8

    imgs = np.empty((n, size, size, 1), np.float32)
    labels = np.empty((n, size, size), np.int32)
    for i in range(n):
        raw, lab = synth_slice(rng, size)
        u8 = preprocess_oracle_u8(raw, size)  # same size: a pure quantize
        imgs[i, ..., 0] = u8.astype(np.float32) / 255.0
        labels[i] = lab
    return imgs, labels
