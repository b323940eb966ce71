"""Sliding-window inference at native resolution with a Hann overlap blend
(BASELINE config 3; the port of ``unetseg_tpu.parallel.tiles``).

The image is cut into a static grid of square windows with the given
overlap, the last window of each axis clamped flush to the edge; the
windows' logits are blended back with a separable raised-cosine weight, so
every pixel is a convex combination of the windows that cover it, and the
blended logits are decoded (and cleaned on the device) as one image.

JAX runs every window in one model batch.  Here the windows go through the
model in chunks of at most :data:`MODEL_CHUNK`: a 4096² image at window 512
has 225 windows, whose activations at the flagship's first level alone would
take 7.5 GB per 64-channel layer in one batch.  The f32 logits of all
windows are gathered, then blended once, so the result is the JAX
function's.  The blend is plain PyTorch: the overlap-add form on a regular
grid, the padded-stack form (summed in window order) on an irregular one.

With ``mesh=`` (JAX's keyword: the window batch sharded over ``dp``) the
windows split over the mesh's dp devices in contiguous parts of
``ceil(n / dp)`` windows, the last one shorter (``mesh.split_ragged``; JAX's
GSPMD pads an uneven count instead), each part through that device's
replica in passes of :data:`MODEL_CHUNK`; the logits are gathered on the
image's device in window order and blended there.
"""

from __future__ import annotations

import functools
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from unetseg_tpu_torch.config import ModelConfig
from unetseg_tpu_torch.ops import postprocess
from unetseg_tpu_torch.ops.decode import decode_mask
from unetseg_tpu_torch.parallel import mesh as pmesh

#: Windows per model pass: the flagship's serving batch.
MODEL_CHUNK = 32


def window_grid(size: int, window: int, stride: int) -> List[int]:
    """Window origins covering [0, size), the last one clamped flush to the
    edge (every pixel covered, none out of bounds)."""
    if size <= window:
        return [0]
    starts = list(range(0, size - window + 1, stride))
    if starts[-1] != size - window:
        starts.append(size - window)
    return starts


@functools.lru_cache(maxsize=8)
def _hann_weight(window: int) -> np.ndarray:
    """Separable raised-cosine blend weight (window, window), strictly
    positive."""
    r = np.arange(window, dtype=np.float64)
    w1 = 0.5 - 0.5 * np.cos(2.0 * np.pi * (r + 0.5) / window)
    w1 = np.maximum(w1, 1e-3)
    return (w1[:, None] * w1[None, :]).astype(np.float32)


def extract_windows(img: torch.Tensor, window: int, stride: int
                    ) -> torch.Tensor:
    """(H, W) -> (n_windows, window, window), row-major over the grid.
    Needs H >= window and W >= window (:func:`_pad_to_window` first)."""
    h, w = img.shape
    return torch.stack([img[y:y + window, x:x + window]
                        for y in window_grid(h, window, stride)
                        for x in window_grid(w, window, stride)])


def _pad_to_window(img: torch.Tensor, window: int):
    """Edge-pad the trailing (H, W) axes up to the window size; returns
    (padded, ph, pw) so callers crop the result back."""
    h, w = img.shape[-2], img.shape[-1]
    ph, pw = max(0, window - h), max(0, window - w)
    if ph:
        rows = torch.arange(h + ph, device=img.device).clamp_(max=h - 1)
        img = img.index_select(-2, rows)
    if pw:
        cols = torch.arange(w + pw, device=img.device).clamp_(max=w - 1)
        img = img.index_select(-1, cols)
    return img, ph, pw


def _resolve_overlap(window: int, overlap) -> int:
    """None -> window // 2 (the overlap-add default); else validated."""
    ov = window // 2 if overlap is None else int(overlap)
    if not 0 <= ov < window:
        raise ValueError(
            f"overlap must be in [0, window); got overlap={ov}, "
            f"window={window}")
    return ov


@functools.lru_cache(maxsize=32)
def _inv_weight_sum(h: int, w: int, window: int, stride: int) -> np.ndarray:
    """1 / (summed Hann coverage), (h, w, 1) float32."""
    weight = _hann_weight(window)
    wsum = np.zeros((h, w), np.float32)
    for y in window_grid(h, window, stride):
        for x in window_grid(w, window, stride):
            wsum[y:y + window, x:x + window] += weight
    return (1.0 / wsum)[..., None]


def _regular_grid(starts: List[int], stride: int, window: int) -> bool:
    """True when the grid has a uniform stride that divides the window: the
    overlap-add form's preconditions."""
    return (window % stride == 0
            and all(b - a == stride for a, b in zip(starts, starts[1:])))


def _overlap_add(weighted: torch.Tensor, ny: int, nx: int, window: int,
                 stride: int) -> torch.Tensor:
    """(ny*nx, window, window, C) weighted windows -> (h, w, C) canvas sum.

    With a uniform stride s dividing the window (m = window / s chunks),
    chunk j of grid row k lands at canvas row block k + j: the canvas is m
    shifted adds per axis.  Each add goes into a zero canvas in JAX's j
    order, so every sum runs in the order of JAX's padded adds."""
    m = window // stride
    c = weighted.shape[-1]
    t = weighted.reshape(ny, nx, m, stride, window, c)
    ry = weighted.new_zeros((ny + m - 1, nx, stride, window, c))
    for j in range(m):  # y: (ny, ...) -> (ny + m - 1, ...)
        ry[j:j + ny] += t[:, :, j]
    ry = ry.reshape(ny + m - 1, nx, stride, m, stride, c)
    acc = weighted.new_zeros((ny + m - 1, nx + m - 1, stride, stride, c))
    for j in range(m):  # x: (nx, ...) -> (nx + m - 1, ...)
        acc[:, j:j + nx] += ry[:, :, :, j]
    h, w = (ny + m - 1) * stride, (nx + m - 1) * stride
    return acc.permute(0, 2, 1, 3, 4).reshape(h, w, c)


@functools.lru_cache(maxsize=32)
def _blend_constants(h: int, w: int, window: int, stride: int,
                     device: torch.device):
    """The Hann weight (window, window, 1) and the inverse coverage (h, w,
    1) on ``device``, uploaded once per shape."""
    return (torch.from_numpy(_hann_weight(window)).to(device)[..., None],
            torch.from_numpy(_inv_weight_sum(h, w, window, stride)).to(device))


def blend_windows(logit_tiles: torch.Tensor, h: int, w: int, window: int,
                  stride: int) -> torch.Tensor:
    """(n, window, window, C) float32 -> (h, w, C) Hann-blended logits.

    A regular grid (uniform stride dividing the window, as the default
    overlap window/2 gives) takes the overlap-add form; any other grid
    adds each weighted window, zero-padded to the canvas, in window order
    (JAX's padded stack, without holding the stack)."""
    ys = window_grid(h, window, stride)
    xs = window_grid(w, window, stride)
    weight, inv = _blend_constants(h, w, window, stride, logit_tiles.device)
    if (len(ys) > 1 and len(xs) > 1
            and _regular_grid(ys, stride, window)
            and _regular_grid(xs, stride, window)):
        return _overlap_add(logit_tiles * weight, len(ys), len(xs), window,
                            stride) * inv
    canvas = logit_tiles.new_zeros((h, w, logit_tiles.shape[-1]))
    for k, (y, x) in enumerate((y, x) for y in ys for x in xs):
        canvas[y:y + window, x:x + window] += logit_tiles[k] * weight
    return canvas * inv


def chunked_logits(model: nn.Module, x: torch.Tensor,
                   on_pass: Optional[Callable[[], None]] = None
                   ) -> torch.Tensor:
    """``model(x)`` over NHWC ``x`` in passes of at most
    :data:`MODEL_CHUNK` rows, the f32 logits concatenated; ``on_pass`` is
    called once per pass."""
    parts = []
    for i in range(0, x.shape[0], MODEL_CHUNK):
        parts.append(model(x[i:i + MODEL_CHUNK]))
        if on_pass is not None:
            on_pass()
    return parts[0] if len(parts) == 1 else torch.cat(parts)


Models = Union[nn.Module, Sequence[nn.Module]]


def dp_logits(model: Models, mesh: Optional[pmesh.Mesh], split: Callable,
              on_pass: Optional[Callable[[], None]] = None
              ) -> Tuple[Callable[[torch.Tensor], torch.Tensor], ModelConfig]:
    """(x -> f32 logits of NHWC ``x``, the model's config), as the mesh
    forms run a model.  Without a mesh, :func:`chunked_logits` of
    ``model``.  With one, ``model`` is one module a dp device of the mesh,
    module i on dp device i (the engine's replicas,
    ``InferenceEngine.models``): ``split(x, devices)`` (``mesh.split_batch``
    or ``mesh.split_ragged``) cuts x's rows into contiguous parts, part i
    runs through module i in passes of :data:`MODEL_CHUNK`, and the logits
    are gathered on x's device in row order.  ``on_pass`` is called once
    per pass."""
    if mesh is None:
        return (lambda x: chunked_logits(model, x, on_pass)), model.cfg
    devices = pmesh.dp_devices(mesh)
    models = [model] if isinstance(model, nn.Module) else list(model)
    if len(models) != len(devices):
        raise ValueError(f"mesh=: one model a dp device, got {len(models)} "
                         f"for dp={len(devices)}")

    def run(x: torch.Tensor) -> torch.Tensor:
        return pmesh.gather_batch(
            [chunked_logits(m, p, on_pass)
             for m, p in zip(models, split(x, devices))], x.device)
    return run, models[0].cfg


def _window_logits(logits_of: Callable[[torch.Tensor], torch.Tensor],
                   u8: torch.Tensor, window: int, stride: int
                   ) -> torch.Tensor:
    """(H, W) uint8 -> (n, window, window, C) f32 logits by ``logits_of``
    (:func:`dp_logits`' function): windows cut on u8, each cast to u8/255
    after."""
    tiles = extract_windows(u8, window, stride)[..., None]
    return logits_of(tiles.to(torch.float32) / 255.0)


def sliding_window_logits(model: nn.Module, img_f32: torch.Tensor,
                          window: int = 512, overlap=None) -> torch.Tensor:
    """(H, W) float image in [0, 1] -> (H, W, C) blended logits.
    ``overlap=None`` means window / 2."""
    overlap = _resolve_overlap(window, overlap)
    h, w = img_f32.shape
    img_f32, ph, pw = _pad_to_window(img_f32, window)
    stride = window - overlap
    with torch.inference_mode():
        tiles = extract_windows(img_f32, window, stride)[..., None]
        out = blend_windows(chunked_logits(model, tiles), h + ph, w + pw,
                            window, stride)
    return out[:h, :w] if (ph or pw) else out


def make_tiled_pipeline(model: Models, window: int = 512, overlap=None,
                        device_postprocess: bool = True, on_pass=None,
                        mesh: Optional[pmesh.Mesh] = None):
    """(H, W) uint8 on the model's device -> (H, W) uint8 mask, by sliding
    windows through ``model`` (the logits of ``UNet.forward``).  A padded
    image's logits are cropped before the argmax, so the cleanup sees the
    image's own size.  ``device_postprocess=False`` stops at the argmax,
    for the engine's host cleanup.  ``overlap=None`` means window / 2;
    ``on_pass`` is called once per model pass.  ``mesh``: the windows
    split over its dp devices, ``model`` one replica a dp device
    (:func:`dp_logits`), the blend on the image's device."""
    ov = _resolve_overlap(window, overlap)
    logits_of, cfg = dp_logits(model, mesh, pmesh.split_ragged, on_pass)

    @torch.inference_mode()
    def pipeline(u8: torch.Tensor) -> torch.Tensor:
        h, w = u8.shape
        u8, ph, pw = _pad_to_window(u8, window)
        stride = window - ov
        logits = blend_windows(_window_logits(logits_of, u8, window, stride),
                               h + ph, w + pw, window, stride)
        if ph or pw:
            logits = logits[:h, :w]
        mask = decode_mask(logits, cfg.num_classes)
        if device_postprocess:
            mask = postprocess.postprocess_masks(mask[None].contiguous())[0]
        return mask

    return pipeline


def make_tiled_batch_pipeline(model: Models, window: int = 512,
                              overlap=None, device_postprocess: bool = True,
                              mesh: Optional[pmesh.Mesh] = None):
    """(B, H, W) uint8 -> (B, H, W) masks: the windows of all B images go
    through the model together, in chunks; each image is blended on its
    own.  ``overlap=None`` means window / 2.  ``mesh``: the B * n windows
    split over its dp devices, ``model`` one replica a dp device
    (:func:`dp_logits`)."""
    ov = _resolve_overlap(window, overlap)
    logits_of, cfg = dp_logits(model, mesh, pmesh.split_ragged)

    @torch.inference_mode()
    def pipeline(u8b: torch.Tensor) -> torch.Tensor:
        b, h, w = u8b.shape
        u8b, ph, pw = _pad_to_window(u8b, window)
        stride = window - ov
        tiles = torch.stack([extract_windows(im, window, stride)
                             for im in u8b])
        n = tiles.shape[1]
        flat = tiles.reshape(b * n, window, window, 1)
        logit_flat = logits_of(flat.to(torch.float32) / 255.0)
        logit_tiles = logit_flat.reshape(b, n, window, window, -1)
        logits = torch.stack([blend_windows(lt, h + ph, w + pw, window,
                                            stride) for lt in logit_tiles])
        if ph or pw:
            logits = logits[:, :h, :w]
        mask = decode_mask(logits, cfg.num_classes)
        if device_postprocess:
            mask = postprocess.postprocess_masks(mask.contiguous())
        return mask

    return pipeline
