"""TransUNet (R50-ViT-B/16), a family of the port only (the JAX package
has none).

Chen et al., TransUNet (arXiv:2102.04306), as the authors' code builds the
hybrid (github.com/Beckschen/TransUNet, ``get_r50_b16_config``):

* a ResNet-50 v2 root and three stages of bottleneck units, every conv a
  StdConv (each output channel's weights standardised, eps 1e-5) followed
  by GroupNorm(32, eps 1e-6); a stage's first unit projects its residual
  through a StdConv 1x1 and GroupNorm(C, C) (eps 1e-5); skips at 1/2, 1/4
  (zero-padded on its last row and column: the max-pool has no padding,
  so stage 1 runs at S/4 - 1) and 1/8;
* a 1x1 patch embedding of the 1/16 map and a learned position
  embedding; pre-LN transformer layers (multi-head attention, an MLP with
  exact GELU) and a final LayerNorm (eps 1e-6);
* a cascaded upsampler: conv3x3 + ReLU on the tokens' (S/16)^2 map, then
  blocks of bilinear x2 (``align_corners=True``), the skip concatenated
  after the upsampled map, two conv3x3 + ReLU (their BatchNorm folded into
  weight and bias); a conv3x3 head.

NHWC in [0, 1] -> float32 logits ``(N, S, S, classes)`` from
:meth:`TransUNet.forward`, and :meth:`TransUNet.masks` the first-max class
map, as :class:`models.unet.UNet` has them; the engine, the study runner,
TTA (activation space: attention is not dihedral-equivariant) and windows
of ``S`` serve it.  Where each part runs:

* stride-1 3x3 convs (the units' mid convs, the decoder's, the head,
  whose 3 classes the wrapper pads to 16 outputs) in the conv kernel
  (K1/K2, ``ops.conv``);
* the 7x7 root and the stride-2 3x3 mid convs of stages 2 and 3, which K1
  does not compute, in ``F.conv2d`` (cuDNN on the card);
* 1x1 convs, the patch embedding and every linear as plain products
  (``torch.addmm``, the bias in the GEMM), as the UNet's up-convs and head
  are;
* attention in ``ops.attention`` (FlashAttention on the card, counted);
* GroupNorm in ``ops.groupnorm`` (on the card a kernel of the port's own,
  counted, each unit's residual add and ReLU in its last norm's pass);
* LayerNorm, GELU, max-pool and the bilinear upsampling as plain
  ``torch`` ops.

The model is built from the configuration and the parameter tree
(:class:`Widths` reads every width from the tree's shapes, the head count
from the attention's per-head products); :func:`init` draws a tree at the
published widths or any other.  StdConv standardises its weights once, when
they are loaded (:class:`StdConv`), the same arithmetic on fixed weights;
the grey input takes the root's standardised (7, 7, 3, D) weights summed
over their three input channels, as the published model's repeat of the
grey channel computes.  While a profiler records, the forward's stages are
the spans ``transunet.backbone``, ``transunet.embed``,
``transunet.encoder`` and ``transunet.decoder``.  The family cannot run in
row bands, quantized to w8a8 or in training (``models/registry.py`` refuses
each by name); K6 fuses the plain UNet's last level only, so
:meth:`TransUNet.masks` decodes the logits.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.overrides import has_torch_function_unary

from unetseg_tpu_torch.config import ModelConfig
from unetseg_tpu_torch.models.unet import Conv3x3, compute_dtype
from unetseg_tpu_torch.ops import attention as attention_ops
from unetseg_tpu_torch.ops import groupnorm as groupnorm_ops
from unetseg_tpu_torch.ops.conv import conv3x3_bias_act_train
from unetseg_tpu_torch.ops.decode import decode_mask
from unetseg_tpu_torch.utils.profiling import _recording

__all__ = ["TransUNet", "Widths", "init"]

#: GroupNorm's groups in the R50's units and root (published).
GN_GROUPS = 32
#: The R50's and the patch embedding's reduction: S / 16 tokens a side.
REDUCTION = 16
#: :func:`init`'s scale of each unit's last GroupNorm: BiT's code starts it
#: at zero; at 1 the random 16-unit ResNet is chaotic (a rounding of the
#: root's output moves the logits by a third of their scale).
BRANCH_SCALE = 0.2


@dataclasses.dataclass(frozen=True)
class Widths:
    """A TransUNet's widths; the defaults are the published R50-ViT-B/16's
    (``get_r50_b16_config``)."""

    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_dim: int = 3072
    resnet_units: Tuple[int, ...] = (3, 4, 9)
    resnet_width: int = 64
    decoder_head_channels: int = 512
    decoder_channels: Tuple[int, ...] = (256, 128, 64, 16)
    n_skip: int = 3

    @classmethod
    def of(cls, params: dict) -> "Widths":
        """The widths of a parameter tree, read from its shapes."""
        def shape(site):
            return tuple(np.shape(site["w"]))

        layers = params["encoder"]["layers"]
        blocks = params["decoder"]["blocks"]
        hidden, heads, _ = shape(layers[0]["q"])
        cin = shape(params["decoder"]["conv_more"])[-1]
        n_skip = 0
        for b in blocks:  # a block with a skip reads more than cin
            n_skip += shape(b["conv1"])[2] > cin
            cin = shape(b["conv2"])[-1]
        return cls(hidden_size=hidden, num_layers=len(layers),
                   num_heads=heads, mlp_dim=shape(layers[0]["fc1"])[-1],
                   resnet_units=tuple(len(s) for s in params["stages"]),
                   resnet_width=shape(params["root"]["conv"])[-1],
                   decoder_head_channels=shape(
                       params["decoder"]["conv_more"])[-1],
                   decoder_channels=tuple(shape(b["conv2"])[-1]
                                          for b in blocks),
                   n_skip=n_skip)

    def stages(self) -> List[Tuple[int, int, int]]:
        """(units, mid, out) of each R50 stage."""
        r = self.resnet_width
        return [(n, r * 2 ** i, 4 * r * 2 ** i)
                for i, n in enumerate(self.resnet_units)]

    def skips(self) -> List[int]:
        """Each decoder block's skip channels (stage 2's, stage 1's, the
        root's, then none; the first ``n_skip`` kept)."""
        r = self.resnet_width
        return [c if i < self.n_skip else 0
                for i, c in enumerate([8 * r, 4 * r, r, 0])]


def _span(name: str):
    """``name`` as a profiler span while a profiler records, else
    nothing."""
    if _recording():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def product(x: torch.Tensor, w: torch.Tensor,
            b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x (..., C) @ w (C, D) [+ b]`` as one GEMM, the bias added in it."""
    x2 = x.reshape(-1, x.shape[-1])
    y = torch.mm(x2, w) if b is None else torch.addmm(b, x2, w)
    return y.view(*x.shape[:-1], w.shape[-1])


class GroupNorm(nn.Module):
    """GroupNorm over NHWC in place of ``F.group_norm``, whose CUDA kernel
    reads NCHW only (a copy on each side of every norm); ``weight`` and
    ``bias`` are the tree's ``scale`` and ``bias``.  :meth:`forward`
    returns ``relu(residual + gn(x))``, the ReLU where asked and the add
    only with it, through :func:`ops.groupnorm.group_norm`: on the card one
    kernel call on bf16 (float32 statistics and output, rounded once), on
    the CPU the plain PyTorch ops."""

    def __init__(self, c: int, groups: int, eps: float):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.weight = nn.Parameter(torch.ones(c), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(c), requires_grad=False)

    def forward(self, x: torch.Tensor, relu: bool = False,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        return groupnorm_ops.group_norm(x, self.weight, self.bias,
                                        self.groups, self.eps, relu=relu,
                                        residual=residual)


class LayerNorm(nn.Module):
    def __init__(self, c: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(c), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, x.shape[-1:], self.weight, self.bias,
                            self.eps)


class StdConv(nn.Module):
    """A ResNet conv without bias whose weights each output channel
    standardises (the authors' ``StdConv2d``): ``weight`` is stored as the
    tree holds it (HWIO; a 1x1 as (C, D)); the standardised weights, in the
    layout the conv's route reads, are computed once each time weights are
    loaded (a ``load_state_dict`` hook) into the buffer ``standardised``.

    ``grey``: the root of a one-channel model, whose weights' input
    channels (the published three) are summed after standardising."""

    def __init__(self, k: int, cin: int, cout: int, stride: int = 1,
                 grey: bool = False):
        super().__init__()
        self.k, self.stride, self.grey = k, stride, grey
        shape = (cin, cout) if k == 1 else (k, k, cin, cout)
        self.weight = nn.Parameter(torch.zeros(shape), requires_grad=False)
        self.register_buffer("standardised", self._layout(
            torch.zeros(shape)), persistent=False)
        if self._in_kernel():
            self.register_buffer("zero", torch.zeros(cout), persistent=False)
        self.register_load_state_dict_post_hook(StdConv._standardise)

    def _in_kernel(self) -> bool:
        """A stride-1 3x3: the conv kernel takes it."""
        return self.k == 3 and self.stride == 1

    def _layout(self, w: torch.Tensor) -> torch.Tensor:
        """Standardised (k, k, C, D) or (C, D) weights as the route reads
        them: (C, D) for the product, HWIO for the conv kernel, OIHW
        channels-last for ``F.conv2d``."""
        if self.grey:
            w = w.sum(dim=2, keepdim=True)
        if self.k == 1 or self._in_kernel():
            return w.contiguous()
        return w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)

    @staticmethod
    def _standardise(module: "StdConv", _incompatible) -> None:
        w = module.weight.detach().float()
        var, mean = torch.var_mean(w, dim=tuple(range(w.dim() - 1)),
                                   keepdim=True, unbiased=False)
        old = module.standardised
        module.standardised = module._layout(
            (w - mean) / torch.sqrt(var + 1e-5)).to(old.device, old.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.standardised
        if self.k == 1:
            if self.stride > 1:
                x = x[:, ::self.stride, ::self.stride]
            return product(x, w)
        if self._in_kernel():
            return conv3x3_bias_act_train(x.contiguous(), w, self.zero,
                                          relu=False)
        return _nhwc(F.conv2d(_nchw(x), w, None, self.stride, self.k // 2))


class Bottleneck(nn.Module):
    """The authors' ``PreActBottleneck``: conv1x1 -> GN -> ReLU -> conv3x3
    (``stride``) -> GN -> ReLU -> conv1x1 -> GN, then ReLU(residual + y),
    the residual projected where ``project``; the last norm takes the add
    and the ReLU into its own pass."""

    def __init__(self, cin: int, mid: int, cout: int, stride: int,
                 project: bool):
        super().__init__()
        self.conv1 = StdConv(1, cin, mid)
        self.gn1 = GroupNorm(mid, GN_GROUPS, 1e-6)
        self.conv2 = StdConv(3, mid, mid, stride)
        self.gn2 = GroupNorm(mid, GN_GROUPS, 1e-6)
        self.conv3 = StdConv(1, mid, cout)
        self.gn3 = GroupNorm(cout, GN_GROUPS, 1e-6)
        self.downsample = StdConv(1, cin, cout, stride) if project else None
        self.gn_proj = GroupNorm(cout, cout, 1e-5) if project else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x
        if self.downsample is not None:
            residual = self.gn_proj(self.downsample(x))
        y = self.gn1(self.conv1(x), relu=True)
        y = self.gn2(self.conv2(y), relu=True)
        return self.gn3(self.conv3(y), relu=True, residual=residual)


class Dense(nn.Module):
    """A product over the last axis with bias.  ``weight`` keeps the
    tree's shape ((C, D); per head (hidden, heads, d) or (heads, d,
    hidden)) and is applied flattened to (its first ``n_in`` axes, the
    rest); ``bias`` likewise flattened."""

    def __init__(self, w_shape: Sequence[int], b_shape: Sequence[int],
                 n_in: int = 1):
        super().__init__()
        self.n_in = n_in
        self.weight = nn.Parameter(torch.zeros(tuple(w_shape)),
                                   requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(tuple(b_shape)),
                                 requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.reshape(math.prod(self.weight.shape[:self.n_in]), -1)
        return product(x, w, self.bias.reshape(-1))


class Embed(nn.Module):
    """The 1x1 patch embedding and the learned position embedding
    ``pos`` (tokens, hidden)."""

    def __init__(self, cin: int, hidden: int, tokens: int):
        super().__init__()
        self.patch = Dense((cin, hidden), (hidden,))
        self.pos = nn.Parameter(torch.zeros(tokens, hidden),
                                requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, g, _, _ = x.shape
        return self.patch(x).view(n, g * g, -1) + self.pos


class Layer(nn.Module):
    """A pre-LN transformer layer: ``x + attn(ln1(x))``, then ``x +
    fc2(gelu(fc1(ln2(x))))``."""

    def __init__(self, hidden: int, heads: int, mlp: int):
        super().__init__()
        d = hidden // heads
        self.heads, self.d = heads, d
        self.ln1 = LayerNorm(hidden)
        self.q = Dense((hidden, heads, d), (heads, d))
        self.k = Dense((hidden, heads, d), (heads, d))
        self.v = Dense((hidden, heads, d), (heads, d))
        self.out = Dense((heads, d, hidden), (hidden,), n_in=2)
        self.ln2 = LayerNorm(hidden)
        self.fc1 = Dense((hidden, mlp), (mlp,))
        self.fc2 = Dense((mlp, hidden), (hidden,))

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        n, L, _ = x.shape

        def heads(t):  # (n, L, heads * d) -> (n, heads, L, d), a view
            return t.view(n, L, self.heads, self.d).transpose(1, 2)
        o = attention_ops.attention(heads(self.q(x)), heads(self.k(x)),
                                    heads(self.v(x)))
        return self.out(o.transpose(1, 2).reshape(n, L, -1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attend(self.ln1(x))
        return x + self.fc2(F.gelu(self.fc1(self.ln2(x))))


class Encoder(nn.Module):
    def __init__(self, wd: Widths):
        super().__init__()
        self.layers = nn.ModuleList(
            Layer(wd.hidden_size, wd.num_heads, wd.mlp_dim)
            for _ in range(wd.num_layers))
        self.norm = LayerNorm(wd.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return self.norm(x)


class Block(nn.Module):
    """A decoder block: bilinear x2, ``[x, skip]`` where it has a skip,
    two conv3x3 + ReLU."""

    def __init__(self, cin: int, skip: int, cout: int):
        super().__init__()
        self.has_skip = skip > 0
        self.conv1 = Conv3x3(cin + skip, cout)
        self.conv2 = Conv3x3(cout, cout)

    def forward(self, x: torch.Tensor, skip: Optional[torch.Tensor]
                ) -> torch.Tensor:
        x = _nhwc(F.interpolate(_nchw(x), scale_factor=2, mode="bilinear",
                                align_corners=True))
        x = torch.cat([x, skip], dim=-1) if self.has_skip else x.contiguous()
        return self.conv2(self.conv1(x))


class Decoder(nn.Module):
    def __init__(self, wd: Widths):
        super().__init__()
        self.conv_more = Conv3x3(wd.hidden_size, wd.decoder_head_channels)
        cins = [wd.decoder_head_channels, *wd.decoder_channels[:-1]]
        self.blocks = nn.ModuleList(
            Block(cin, skip, cout) for cin, skip, cout in zip(
                cins, wd.skips(), wd.decoder_channels))

    def forward(self, t: torch.Tensor, skips: List[torch.Tensor]
                ) -> torch.Tensor:
        n, L, h = t.shape
        g = math.isqrt(L)
        x = self.conv_more(t.view(n, g, g, h))
        for i, block in enumerate(self.blocks):
            x = block(x, skips[i] if i < len(skips) else None)
        return x


class TransUNet(nn.Module):
    """NHWC input in [0, 1] -> float32 logits (N, S, S, num_classes); S
    is fixed by the position embedding (``16 * sqrt(tokens)``)."""

    def __init__(self, cfg: ModelConfig, params: dict):
        super().__init__()
        if cfg.in_channels != 1:
            raise ValueError(f"arch {cfg.arch!r} takes one grey channel, "
                             f"got in_channels={cfg.in_channels}")
        self.cfg = cfg
        wd = self.widths = Widths.of(params)
        r = wd.resnet_width
        tokens = int(np.shape(params["embed"]["pos"])[0])
        self.size = REDUCTION * math.isqrt(tokens)
        if self.size != cfg.image_size or math.isqrt(tokens) ** 2 != tokens:
            raise ValueError(
                f"arch {cfg.arch!r}: the position embedding holds {tokens} "
                f"tokens, image_size {cfg.image_size} needs "
                f"{(cfg.image_size // REDUCTION) ** 2}")
        self.root = nn.ModuleDict({
            "conv": StdConv(7, 3, r, 2, grey=True),
            "gn": GroupNorm(r, GN_GROUPS, 1e-6)})
        self.stages = nn.ModuleList()
        cin = r
        for i, ((n, mid, cout), units) in enumerate(zip(wd.stages(),
                                                        params["stages"])):
            stage = nn.ModuleList()
            for j in range(n):
                stage.append(Bottleneck(cin, mid, cout,
                                        2 if i > 0 and j == 0 else 1,
                                        "downsample" in units[j]))
                cin = cout
            self.stages.append(stage)
        self.embed = Embed(cin, wd.hidden_size, tokens)
        self.encoder = Encoder(wd)
        self.decoder = Decoder(wd)
        last = wd.decoder_channels[-1]
        self.head_weight = nn.Parameter(
            torch.zeros(3, 3, last, cfg.num_classes), requires_grad=False)
        self.head_bias = nn.Parameter(torch.zeros(cfg.num_classes),
                                      requires_grad=False)

    def backbone(self, x: torch.Tensor):
        """(N, S, S, 1) -> (stage 3's map, the skips at 1/8, 1/4, 1/2)."""
        x = self.root["gn"](self.root["conv"](x), relu=True)
        feats = [x]
        x = _nhwc(F.max_pool2d(_nchw(x), 3, 2))
        for i, stage in enumerate(self.stages):
            for unit in stage:
                x = unit(x)
            if i < len(self.stages) - 1:
                pad = (self.size // 4 >> i) - x.shape[1]
                feats.append(F.pad(x, (0, 0, 0, pad, 0, pad)))
        return x, feats[::-1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if has_torch_function_unary(x):
            raise NotImplementedError(
                f"arch {self.cfg.arch!r} cannot run in row bands: its "
                f"attention mixes every token of the slice")
        if tuple(x.shape[1:3]) != (self.size, self.size):
            raise ValueError(f"arch {self.cfg.arch!r} takes {self.size}x"
                             f"{self.size} inputs, got {tuple(x.shape)}")
        x = x.to(compute_dtype(self.cfg))
        with _span("transunet.backbone"):
            x, skips = self.backbone(x)
        with _span("transunet.embed"):
            t = self.embed(x)
        with _span("transunet.encoder"):
            t = self.encoder(t)
        with _span("transunet.decoder"):
            x = self.decoder(t, skips)
            logits = conv3x3_bias_act_train(
                x, self.head_weight.to(x.dtype), self.head_bias.to(x.dtype),
                relu=False)
        return logits.float()

    def masks(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC input in [0, 1] -> uint8 (N, S, S) first-max class map."""
        return decode_mask(self(x), self.cfg.num_classes)


def init(cfg: ModelConfig, generator: torch.Generator,
         widths: Widths = Widths()) -> dict:
    """A fresh tree at ``widths`` (the published by default) for an
    ``image_size``^2 input, float32 numpy: He-normal convs (no bias in the
    R50, zero biases elsewhere), LeCun-normal products with zero biases,
    norms at scale 1 and bias 0 but each unit's last at
    :data:`BRANCH_SCALE`, the position embedding N(0, 0.02^2)."""
    def normal(shape, std):
        return (torch.randn(shape, generator=generator) * std).numpy()

    def conv(k, cin, cout, bias=True):
        site = {"w": normal((k, k, cin, cout), math.sqrt(2.0 / (k * k * cin)))}
        if bias:
            site["b"] = np.zeros((cout,), np.float32)
        return site

    def dense(shape, b_shape, fan_in):
        return {"w": normal(shape, math.sqrt(1.0 / fan_in)),
                "b": np.zeros(b_shape, np.float32)}

    def norm(c, scale=1.0):
        return {"scale": np.full((c,), scale, np.float32),
                "bias": np.zeros((c,), np.float32)}

    r, h = widths.resnet_width, widths.hidden_size
    heads, mlp = widths.num_heads, widths.mlp_dim
    d = h // heads
    tree: dict = {"root": {"conv": conv(7, 3, r, bias=False),
                           "gn": norm(r)}, "stages": []}
    cin = r
    for i, (n, mid, cout) in enumerate(widths.stages()):
        units = []
        for j in range(n):
            u = {"conv1": conv(1, cin, mid, False), "gn1": norm(mid),
                 "conv2": conv(3, mid, mid, False), "gn2": norm(mid),
                 "conv3": conv(1, mid, cout, False),
                 "gn3": norm(cout, BRANCH_SCALE)}
            if j == 0:
                u.update(downsample=conv(1, cin, cout, False),
                         gn_proj=norm(cout))
            units.append(u)
            cin = cout
        tree["stages"].append(units)
    tokens = (cfg.image_size // REDUCTION) ** 2
    tree["embed"] = {"patch": {"w": normal((1, 1, cin, h),
                                           math.sqrt(1.0 / cin)),
                               "b": np.zeros((h,), np.float32)},
                     "pos": normal((tokens, h), 0.02)}
    layers = []
    for _ in range(widths.num_layers):
        layers.append({
            "ln1": norm(h),
            **{k: dense((h, heads, d), (heads, d), h) for k in "qkv"},
            "out": dense((heads, d, h), (h,), h),
            "ln2": norm(h),
            "fc1": dense((1, 1, h, mlp), (mlp,), h),
            "fc2": dense((1, 1, mlp, h), (h,), mlp)})
    tree["encoder"] = {"layers": layers, "norm": norm(h)}
    cin = widths.decoder_head_channels
    blocks = []
    for skip, cout in zip(widths.skips(), widths.decoder_channels):
        blocks.append({"conv1": conv(3, cin + skip, cout),
                       "conv2": conv(3, cout, cout)})
        cin = cout
    tree["decoder"] = {"conv_more": conv(3, h, widths.decoder_head_channels),
                       "blocks": blocks}
    tree["head"] = conv(3, cin, cfg.num_classes)
    return tree
