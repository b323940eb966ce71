"""Post-training w8a8 quantization of the UNet, the port of
``unetseg_tpu/quantize.py``.

* :func:`calibrate` runs representative slices through the float32 model
  (:func:`_forward_f32`) and records each conv site's input absolute
  maximum (the activation scales);
* :func:`quantize_params` turns a float tree and those scales into an int8
  tree: per-output-channel symmetric int8 weights ``w_q`` with f32
  ``w_scale``, f32 ``b`` and the site's 0-d f32 ``act_scale`` (numpy, the
  JAX package's arithmetic copied, so the trees are bit-equal);
* :class:`W8A8UNet` is the quantized forward (``apply_w8a8``): the 3x3
  convs run int8 x int8 -> int32 in K7 (``ops/conv_s8.py``,
  ``csrc/conv3x3_s8.cu``) on the card and in its exact plain version on the
  CPU, the 2x2 up-convs and the 1x1 head are int8 products
  (``torch._int_mm``).  Activations pass between the sites in int8: the
  input is quantized once, each K7 dequantizes (+ bias, ReLU) and quantizes
  again for the site(s) that read its output in its epilogue, max-pool and
  concat run on int8, and only the up-convs (dequantize, requantize) and
  the head (dequantize to the logits) leave int8.  It computes JAX's flow
  (a quantize at every site input) bit for bit: the quantize is
  elementwise and non-decreasing, so it commutes with concat and max-pool;
* :func:`quantize_checkpoint` writes a ``arch="unet_w8a8"`` checkpoint that
  every entry point serves through ``models/registry.build``
  (:func:`register_arch`).

The accuracy contract is the JAX module's: masks agree with the float
parent's at polygon IoU >= 0.999 (``chip_smoke.py`` phase 21 measures it on
the card on the trained slim4).  Whether int8 pays on the H100 is measured
there too; no TPU figure is a prior for it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.overrides import handle_torch_function, has_torch_function_unary

from unetseg_tpu_torch import checkpoint
from unetseg_tpu_torch.config import ModelConfig
from unetseg_tpu_torch.models.unet import (depth_to_space, max_pool_2x2,
                                           space_to_depth, stage_channels)
from unetseg_tpu_torch.ops.conv_s8 import (conv3x3_s8, conv3x3_s8_q,
                                           dequant, quant_act)
from unetseg_tpu_torch.ops.decode import decode_mask


# ---------------------------------------------------------------------------
# calibration: per-conv input absmax over representative data
# ---------------------------------------------------------------------------

def _conv_order(cfg: ModelConfig) -> List[str]:
    """Stable names of every conv site, in forward order."""
    names = []
    for i in range(cfg.depth):
        names += [f"enc{i}.conv1", f"enc{i}.conv2"]
    names += ["bottleneck.conv1", "bottleneck.conv2"]
    for i in range(cfg.depth):
        names += [f"dec{i}.up", f"dec{i}.conv1", f"dec{i}.conv2"]
    names += ["head"]
    return names


def _tensors(tree, device: torch.device):
    """The JAX-layout tree with every array as an f32 tensor on ``device``."""
    if isinstance(tree, dict):
        return {k: _tensors(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tensors(v, device) for v in tree]
    return torch.from_numpy(np.asarray(tree, np.float32).copy()).to(device)


def _forward_f32(params, x: torch.Tensor, cfg: ModelConfig, record=None
                 ) -> torch.Tensor:
    """The UNet in float32 with each conv site's input absmax appended to
    ``record`` as ``(name, 0-d tensor)``.  ``params`` is the tree of
    :func:`_tensors`; ``x`` NHWC f32 on the same device.  The same layers in
    the same order as JAX's ``_forward_f32``: library convs and products
    (the JAX package leaves these to XLA), which on the card need TF32 off
    (:func:`calibrate` turns it off)."""
    def obs(name, t):
        if record is not None:
            record.append((name, t.abs().amax()))
        return t

    def conv(name, t, p, relu=True):
        t = obs(name, t)
        w = p["w"]
        if w.shape[0] == 1:  # the 1x1 head
            y = t @ w.reshape(w.shape[2], w.shape[3]) + p["b"]
        else:
            y = F.conv2d(t.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                         p["b"], padding=1).permute(0, 2, 3, 1)
        return torch.relu(y) if relu else y

    def up(t, p):
        # lax.conv_transpose(x, w, (2, 2), "VALID"): out(2i+a, 2j+b) =
        # x(i, j) @ w(1-a, 1-b) (checkpoint.up_weight_from_hwio)
        w = p["w"]
        n, h, wd, c = t.shape
        o = w.shape[3]
        wm = w.flip(0, 1).permute(2, 0, 1, 3).reshape(c, 4 * o)
        y = (t @ wm).reshape(n, h, wd, 2, 2, o).permute(0, 1, 3, 2, 4, 5)
        return y.reshape(n, 2 * h, 2 * wd, o) + p["b"]

    x = x.float()
    if cfg.stem > 1:
        x = space_to_depth(x, cfg.stem)
    skips = []
    for i, stage in enumerate(params["encoder"]):
        x = conv(f"enc{i}.conv1", x, stage["conv1"])
        x = conv(f"enc{i}.conv2", x, stage["conv2"])
        skips.append(x)
        x = max_pool_2x2(x)
    x = conv("bottleneck.conv1", x, params["bottleneck"]["conv1"])
    x = conv("bottleneck.conv2", x, params["bottleneck"]["conv2"])
    for i, (stage, skip) in enumerate(zip(params["decoder"], reversed(skips))):
        x = up(obs(f"dec{i}.up", x), stage["up"])
        x = torch.cat([skip, x], dim=-1)
        x = conv(f"dec{i}.conv1", x, stage["conv1"])
        x = conv(f"dec{i}.conv2", x, stage["conv2"])
    logits = conv("head", x, params["head"], relu=False)
    if cfg.stem > 1:
        logits = depth_to_space(logits, cfg.stem)
    return logits


def calibrate(params, cfg: ModelConfig, calib_batches,
              device: str = "cuda") -> Dict[str, float]:
    """Per-conv activation scales from representative model inputs:
    {conv name: absmax} over ``calib_batches``, an iterable of (N, H, W, 1)
    float arrays in [0, 1] (the served distribution, e.g.
    ``data.training_batch``).  Runs on ``device`` with TF32 off.

    The drift guard: :func:`_forward_f32` hand-mirrors the UNet, so on the
    first batch its logits are held against the port's ``UNet`` in float32
    built on the calibration device (K8 on the card), as JAX holds it
    against ``unet.apply``, within 5% of max(1, max |logit|): a structural drift (a missing stem, a
    changed activation) moves the logits by their own size and raises.
    An empty iterable, or one that leaves a scale at 0, raises ValueError:
    every activation would saturate."""
    from unetseg_tpu_torch.models import registry  # it imports this module

    registry.refuse(cfg, "w8a8")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' "
                           "explicitly to calibrate on the CPU")
    names = _conv_order(cfg)
    tree = _tensors(params, device)
    mx = np.zeros((len(names),), np.float64)
    checked = False
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.inference_mode():
            for xb in calib_batches:
                x_host = torch.from_numpy(np.asarray(xb, np.float32).copy())
                record: list = []
                logits = _forward_f32(tree, x_host.to(device), cfg, record)
                got = [n for n, _ in record]
                if got != names:
                    raise AssertionError(
                        f"conv order mismatch: {got} vs {names}")
                scales = torch.stack([v for _, v in record]).cpu().numpy()
                if not checked:
                    ref_cfg = dataclasses.replace(cfg, arch="unet",
                                                  compute_dtype="float32")
                    ref = registry.build(params, ref_cfg, device)(
                        x_host.to(device))
                    drift = float((logits - ref).abs().max())
                    tol = 0.05 * max(1.0, float(ref.abs().max()))
                    if not drift < tol:
                        raise AssertionError(
                            f"calibration forward drifted from the UNet "
                            f"(max |delta| = {drift} > {tol}); update "
                            "quantize._forward_f32")
                    checked = True
                mx = np.maximum(mx, scales)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    if not checked or not np.all(mx > 0):
        raise ValueError(
            "calibration saw no data (or produced zero activation scales) "
            f"— got {int(np.sum(mx > 0))}/{len(mx)} nonzero scales; pass "
            "at least one representative batch")
    return {n: float(v) for n, v in zip(names, mx)}


# ---------------------------------------------------------------------------
# weight quantization (numpy, the JAX package's arithmetic)
# ---------------------------------------------------------------------------

def _quant_w(w: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-output-channel symmetric int8: w ~= w_q * scale, scale over the
    last axis."""
    w = np.asarray(w, np.float32)
    absmax = np.abs(w).reshape(-1, w.shape[-1]).max(axis=0)
    scale = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
    w_q = np.clip(np.rint(w / scale), -127, 127).astype(np.int8)
    return w_q, scale


def _quant_site(p, act_absmax: float) -> Dict[str, Any]:
    w_q, w_scale = _quant_w(p["w"])
    return {
        "w_q": w_q,
        "w_scale": w_scale,
        "b": np.asarray(p["b"], np.float32),
        "act_scale": np.float32(max(act_absmax, 1e-12) / 127.0),
    }


def quantize_params(params, cfg: ModelConfig,
                    act_scales: Dict[str, float]) -> Dict[str, Any]:
    """Float tree + calibration -> the int8 tree :class:`W8A8UNet` serves."""
    q: Dict[str, Any] = {"encoder": [], "decoder": []}
    for i, stage in enumerate(params["encoder"]):
        q["encoder"].append({
            "conv1": _quant_site(stage["conv1"], act_scales[f"enc{i}.conv1"]),
            "conv2": _quant_site(stage["conv2"], act_scales[f"enc{i}.conv2"]),
        })
    q["bottleneck"] = {
        "conv1": _quant_site(params["bottleneck"]["conv1"],
                             act_scales["bottleneck.conv1"]),
        "conv2": _quant_site(params["bottleneck"]["conv2"],
                             act_scales["bottleneck.conv2"]),
    }
    for i, stage in enumerate(params["decoder"]):
        q["decoder"].append({
            "up": _quant_site(stage["up"], act_scales[f"dec{i}.up"]),
            "conv1": _quant_site(stage["conv1"], act_scales[f"dec{i}.conv1"]),
            "conv2": _quant_site(stage["conv2"], act_scales[f"dec{i}.conv2"]),
        })
    q["head"] = _quant_site(params["head"], act_scales["head"])
    return q


# ---------------------------------------------------------------------------
# the quantized forward (int8 weights, int8 activations, int32 sums)
# ---------------------------------------------------------------------------

def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> exact (M, N) int32 (``torch._int_mm``,
    the JAX package's ``dot_general(..., preferred_element_type=int32)``).
    On CUDA, cuBLASLt needs M > 16 and K, N multiples of 8: the operands are
    zero-padded to that (exact) and the product is sliced back."""
    if a.device.type != "cuda":
        return torch._int_mm(a, b)
    m, k = a.shape
    n = b.shape[1]
    pad_m, pad_k, pad_n = max(0, 17 - m), -k % 8, -n % 8
    if pad_k:
        a, b = F.pad(a, (0, pad_k)), F.pad(b, (0, 0, 0, pad_k))
    if pad_n:
        b = F.pad(b, (0, pad_n))
    if pad_m:
        a = F.pad(a, (0, 0, 0, pad_m))
    out = torch._int_mm(a.contiguous(), b.contiguous())
    return out[:m, :n] if pad_m or pad_n else out


class _Site(nn.Module):
    """One quantized site's buffers, as ``checkpoint.params_from_jax``
    names them: ``weight`` (int8, in the layout the site's product reads),
    ``scale`` = act_scale * w_scale and ``bias`` (f32, per output channel),
    ``act_scale`` (0-d f32)."""

    def __init__(self, weight_shape, d: int):
        super().__init__()
        self.register_buffer("weight", torch.zeros(weight_shape,
                                                   dtype=torch.int8))
        self.register_buffer("scale", torch.zeros(d))
        self.register_buffer("bias", torch.zeros(d))
        self.register_buffer("act_scale", torch.zeros(()))


class W8A8Conv3x3(_Site):
    """3x3 SAME conv + dequantize + bias + ReLU; weight K-major (3, 3, D, C)
    for K7 (``ops/conv_s8.py``)."""

    def __init__(self, cin: int, cout: int):
        super().__init__((3, 3, cout, cin), cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv3x3_s8(quant_act(x, self.act_scale), self.weight,
                          self.scale, self.bias, relu=True)

    def forward_q(self, x_q: torch.Tensor, out_scales) -> list:
        """int8 in (already quantized with ``act_scale``), int8 out: one
        tensor per scale of ``out_scales``, the consumers' ``act_scale``,
        quantized in K7's epilogue."""
        return conv3x3_s8_q(x_q, self.weight, self.scale, self.bias,
                            out_scales, relu=True)


def up_conv_s8(x_q: torch.Tensor, weight: torch.Tensor, scale: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    """The w8a8 2x2 stride-2 transposed conv (``_up2_w8a8``): int8 ``x_q``
    (N, H, W, C) @ int8 ``weight`` (C, 4D) laid out (c, a, b, d) -> exact
    int32 sums, the subpixel rearrange, then :func:`dequant` with ``scale``
    and ``bias`` (D,), no ReLU -> f32 (N, 2H, 2W, D).  Row-local: row bands
    (``parallel.spatial.Bands``) take it band by band."""
    if has_torch_function_unary(x_q):
        return handle_torch_function(up_conv_s8, (x_q,), x_q, weight, scale,
                                     bias)
    n, h, w, c = x_q.shape
    d = bias.shape[0]
    acc = int8_matmul(x_q.reshape(-1, c), weight)
    acc = acc.reshape(n, h, w, 2, 2, d).permute(0, 1, 3, 2, 4, 5)
    return dequant(acc.reshape(n, 2 * h, 2 * w, d), scale, bias, relu=False)


def conv1x1_s8(x_q: torch.Tensor, weight: torch.Tensor, scale: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    """The w8a8 1x1 conv (the head): int8 ``x_q`` (..., C) @ int8 ``weight``
    (C, D) -> exact int32 sums, then :func:`dequant`, no ReLU -> f32
    (..., D).  Pixel-local: row bands (``parallel.spatial.Bands``) take it
    band by band."""
    if has_torch_function_unary(x_q):
        return handle_torch_function(conv1x1_s8, (x_q,), x_q, weight, scale,
                                     bias)
    c, d = weight.shape
    acc = int8_matmul(x_q.reshape(-1, c), weight)
    return dequant(acc.reshape(*x_q.shape[:-1], d), scale, bias, relu=False)


class W8A8UpConv(_Site):
    """2x2 stride-2 transposed conv as an int8 product over channels
    (:func:`up_conv_s8`)."""

    def __init__(self, cin: int, cout: int):
        super().__init__((cin, 4 * cout), cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return up_conv_s8(quant_act(x, self.act_scale), self.weight,
                          self.scale, self.bias)

    def forward_q(self, x_q: torch.Tensor, out_scale: torch.Tensor
                  ) -> torch.Tensor:
        """int8 in (quantized with ``act_scale``), int8 out, quantized
        with ``out_scale`` (the next conv's ``act_scale``)."""
        return quant_act(up_conv_s8(x_q, self.weight, self.scale, self.bias),
                         out_scale)


class W8A8Conv1x1(_Site):
    """1x1 conv (the head) as an int8 product, no ReLU
    (:func:`conv1x1_s8`)."""

    def __init__(self, cin: int, cout: int):
        super().__init__((cin, cout), cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.forward_q(quant_act(x, self.act_scale))

    def forward_q(self, x_q: torch.Tensor) -> torch.Tensor:
        """int8 in (quantized with ``act_scale``), f32 out."""
        return conv1x1_s8(x_q, self.weight, self.scale, self.bias)


class _Double(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1 = W8A8Conv3x3(cin, cout)
        self.conv2 = W8A8Conv3x3(cout, cout)


class _Decoder(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.up = W8A8UpConv(cin, cout)
        self.conv1 = W8A8Conv3x3(2 * cout, cout)
        self.conv2 = W8A8Conv3x3(cout, cout)


class W8A8UNet(nn.Module):
    """The quantized UNet (``apply_w8a8``): NHWC input in [0, 1] -> f32
    logits (N, H, W, num_classes); :meth:`masks` -> uint8 first-max class
    map, the engine's pair."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        chans = stage_channels(cfg)
        bottleneck = cfg.base_channels * (2 ** cfg.depth)
        cin = cfg.in_channels * cfg.stem * cfg.stem
        self.encoder = nn.ModuleList()
        for cout in chans:
            self.encoder.append(_Double(cin, cout))
            cin = cout
        self.bottleneck = _Double(chans[-1], bottleneck)
        self.decoder = nn.ModuleList()
        cin = bottleneck
        for cout in reversed(chans):
            self.decoder.append(_Decoder(cin, cout))
            cin = cout
        self.head = W8A8Conv1x1(chans[0],
                                cfg.num_classes * cfg.stem * cfg.stem)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Activations in int8 between the sites: each conv's output is
        quantized, in K7's epilogue, with the scale of the site that reads
        it; an encoder stage's last conv writes two tensors, one pooled for
        the next stage and the skip for its decoder's first conv.  Row
        bands (``parallel.spatial.Bands``) run it as it is: every site is a
        function that takes part in ``torch.overrides``."""
        x = x.float()
        if self.cfg.stem > 1:
            x = space_to_depth(x, self.cfg.stem)
        enc, mid, dec = self.encoder, self.bottleneck, self.decoder
        x_q = quant_act(x, enc[0].conv1.act_scale)
        skips = []
        for i, stage in enumerate(enc):
            h_q, = stage.conv1.forward_q(x_q, [stage.conv2.act_scale])
            down = enc[i + 1].conv1 if i + 1 < len(enc) else mid.conv1
            x_q, skip_q = stage.conv2.forward_q(h_q, [
                down.act_scale, dec[len(enc) - 1 - i].conv1.act_scale])
            skips.append(skip_q)
            x_q = max_pool_2x2(x_q)
        h_q, = mid.conv1.forward_q(x_q, [mid.conv2.act_scale])
        x_q, = mid.conv2.forward_q(h_q, [dec[0].up.act_scale])
        for i, (stage, skip_q) in enumerate(zip(dec, reversed(skips))):
            up_q = stage.up.forward_q(x_q, stage.conv1.act_scale)
            x_q = torch.cat([skip_q, up_q], dim=-1)
            h_q, = stage.conv1.forward_q(x_q, [stage.conv2.act_scale])
            nxt = dec[i + 1].up if i + 1 < len(dec) else self.head
            x_q, = stage.conv2.forward_q(h_q, [nxt.act_scale])
        logits = self.head.forward_q(x_q)
        if self.cfg.stem > 1:
            logits = depth_to_space(logits, self.cfg.stem)
        return logits

    def masks(self, x: torch.Tensor) -> torch.Tensor:
        return decode_mask(self(x), self.cfg.num_classes)


def _w8a8_init(cfg: ModelConfig, generator: torch.Generator):
    raise ValueError(
        "arch='unet_w8a8' checkpoints are produced by quantization "
        "(unetseg_tpu_torch.quantize.quantize_checkpoint), not random init")


def register_arch() -> None:
    """Make quantized checkpoints a family of the registry: built as they
    are stored (int8 weights, f32 scales and biases), never cast to the
    config's compute dtype."""
    from unetseg_tpu_torch.models import registry

    registry.register("unet_w8a8", lambda cfg, params: W8A8UNet(cfg),
                      _w8a8_init, cast=False)


# ---------------------------------------------------------------------------
# one call: float checkpoint -> calibrated w8a8 checkpoint
# ---------------------------------------------------------------------------

def quantize_checkpoint(src_path: str, dst_path: str, calib_batches,
                        device: str = "cuda"
                        ) -> Tuple[Dict[str, Any], ModelConfig]:
    """Calibrate (on ``device``) and quantize a saved float UNet checkpoint
    into a w8a8 one with ``arch="unet_w8a8"``, in the JAX package's format:
    ``engine.initialize_engine(dst_path)`` serves it with no other change.
    Returns (int8 tree, config)."""
    from unetseg_tpu_torch.models import registry  # it imports this module

    params, cfg = checkpoint.load(src_path)
    registry.refuse(cfg, "w8a8")
    if cfg.arch != "unet":
        raise ValueError("quantization covers the UNet family")
    scales = calibrate(params, cfg, calib_batches, device=device)
    q = quantize_params(params, cfg, scales)
    qcfg = dataclasses.replace(cfg, arch="unet_w8a8")
    checkpoint.save(dst_path, q, qcfg)
    return q, qcfg
