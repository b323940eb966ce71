"""TransUNet (R50-ViT-B/16), in float32 PyTorch, as the program's
``transunet`` family computes it.

Chen et al., TransUNet (arXiv:2102.04306), the hybrid of the authors' code
(github.com/Beckschen/TransUNet: ``vit_seg_configs.get_r50_b16_config``,
``vit_seg_modeling.py``, ``vit_seg_modeling_resnet_skip.py``):

* a ResNet-50 v2 root: StdConv 7x7 stride 2 (each output channel's
  weights standardised, eps 1e-5), GroupNorm(32, eps 1e-6), ReLU; a 3x3
  stride-2 max-pool without padding;
* three stages of bottleneck units, (3, 4, 9) at the published widths:
  conv1x1 -> GN -> ReLU -> conv3x3 (stride 2 in a stage's first unit,
  stages 2 and 3) -> GN -> ReLU -> conv1x1 -> GN, plus ``ReLU(residual +
  y)``; a stage's first unit projects its residual (StdConv 1x1 with the
  unit's stride, then GroupNorm(C, C) at its default eps 1e-5); skips at
  1/2 (the root), 1/4 (stage 1, zero-padded on its last row and column to
  S/4) and 1/8 (stage 2);
* a 1x1 patch embedding of stage 3's 1/16 map to ``hidden_size`` and a
  learned position embedding, one row a token;
* ``num_layers`` pre-LN transformer layers: LN (eps 1e-6), multi-head
  attention (q, k, v and the output projection each with a bias;
  softmax(q k^T / sqrt(head_dim)) v), residual; LN, MLP with exact GELU,
  residual; a final LN;
* the cascaded upsampler: the tokens as a (S/16)^2 map, conv3x3 to
  ``decoder_head_channels`` + ReLU, then per block a bilinear x2
  (``align_corners=True``), the skip concatenated after the upsampled map
  where the block has one (``n_skip``), two conv3x3 + ReLU; a conv3x3
  head.

Departures from the published model, each the configuration's:

* the decoder's BatchNorm folded into its convs' weights and biases, as
  inference does (the tree holds the folded values);
* 3 classes (the Synapse head has 9);
* a grey one-channel input, repeated to the published three channels
  here; the program sums the root's standardised weights over them;
* dropout off (inference);
* the max-pool without padding and the 1/4 skip zero-padded, as the
  authors' code does (the paper does not say).

Every conv and product is float32 with TF32 off; StdConv standardises per
forward, as published.  ``quant="fp8"`` is the control: each conv's and
each linear's input and weights, and each attention product's operands
(q and k; the probabilities and v), rounded to float8 e4m3 with one scale
per tensor, the products summed in float32.

The tree is the program's checkpoint layout: conv sites ``{"w": HWIO}``
(the R50's have no bias), 1x1 convs and the MLP's products ``(1, 1, C,
D)``, the attention's per-head products ``(hidden, heads, head_dim)`` and
``(heads, head_dim, hidden)`` (flax's DenseGeneral), norms ``{"scale",
"bias"}``, the position embedding ``embed.pos`` ``(tokens, hidden)``, the
head ``head``.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from perfbench import peaks
from perfbench.reference.unet import _fp8, _put, tf32_off

#: The published widths (``get_r50_b16_config`` at a 512^2 input); a
#: configuration file may name any of them.
PUBLISHED = {"hidden_size": 768, "num_layers": 12, "num_heads": 12,
             "mlp_dim": 3072, "resnet_units": [3, 4, 9], "resnet_width": 64,
             "decoder_head_channels": 512,
             "decoder_channels": [256, 128, 64, 16], "n_skip": 3}
BF16 = 2
GN_GROUPS = 32


def widths(cfg: dict) -> dict:
    return {k: cfg.get(k, v) for k, v in PUBLISHED.items()}


def tokens(cfg: dict) -> int:
    return (cfg["image_size"] // 16) ** 2


def _stages(cfg: dict):
    """(units, mid, out) of each R50 stage."""
    w = widths(cfg)
    r = w["resnet_width"]
    return [(n, r * 2 ** i, 4 * r * 2 ** i)
            for i, n in enumerate(w["resnet_units"])]


def _skips(cfg: dict) -> List[int]:
    """The skip channels of each decoder block: stage 2's, stage 1's, the
    root's, then none, the first ``n_skip`` kept."""
    w = widths(cfg)
    r = w["resnet_width"]
    chans = [8 * r, 4 * r, r, 0]
    return [c if i < w["n_skip"] else 0 for i, c in enumerate(chans)]


# ----------------------------------------------------------------- weights

def sites(cfg: dict) -> List[Tuple[str, tuple, str, int]]:
    """Every array of the tree as (dotted path, shape, how it is drawn, the
    inputs each output sums), in the order drawn."""
    w = widths(cfg)
    r = w["resnet_width"]
    h, heads = w["hidden_size"], w["num_heads"]
    hd = h // heads
    out: List[Tuple[str, tuple, str, int]] = []

    def norm(name, c, kind="scale"):
        out.extend([(name + ".scale", (c,), kind, 0),
                    (name + ".bias", (c,), "shift", 0)])

    def conv(name, shape, kind="he"):
        out.append((name, shape, kind, shape[0] * shape[1] * shape[2]))

    def bias(name, c):
        out.append((name, (c,), "shift", 0))

    conv("root.conv.w", (7, 7, 3, r))
    norm("root.gn", r)
    cin = r
    for i, (n, mid, cout) in enumerate(_stages(cfg)):
        for j in range(n):
            p = f"stages.{i}.{j}."
            conv(p + "conv1.w", (1, 1, cin, mid))
            norm(p + "gn1", mid)
            conv(p + "conv2.w", (3, 3, mid, mid))
            norm(p + "gn2", mid)
            conv(p + "conv3.w", (1, 1, mid, cout))
            norm(p + "gn3", cout, "branch")
            if j == 0:
                conv(p + "downsample.w", (1, 1, cin, cout))
                norm(p + "gn_proj", cout)
            cin = cout
    conv("embed.patch.w", (1, 1, cin, h), "lecun")
    bias("embed.patch.b", h)
    out.append(("embed.pos", (tokens(cfg), h), "pos", 0))
    for i in range(w["num_layers"]):
        p = f"encoder.layers.{i}."
        norm(p + "ln1", h)
        for name in ("q", "k", "v"):
            out += [(p + name + ".w", (h, heads, hd), "lecun", h),
                    (p + name + ".b", (heads, hd), "shift", 0)]
        out.append((p + "out.w", (heads, hd, h), "lecun", h))
        bias(p + "out.b", h)
        norm(p + "ln2", h)
        conv(p + "fc1.w", (1, 1, h, w["mlp_dim"]), "lecun")
        bias(p + "fc1.b", w["mlp_dim"])
        conv(p + "fc2.w", (1, 1, w["mlp_dim"], h), "lecun")
        bias(p + "fc2.b", h)
    norm("encoder.norm", h)
    hc = w["decoder_head_channels"]
    conv("decoder.conv_more.w", (3, 3, h, hc))
    bias("decoder.conv_more.b", hc)
    cin = hc
    for i, (c, skip) in enumerate(zip(w["decoder_channels"], _skips(cfg))):
        p = f"decoder.blocks.{i}."
        conv(p + "conv1.w", (3, 3, cin + skip, c))
        bias(p + "conv1.b", c)
        conv(p + "conv2.w", (3, 3, c, c))
        bias(p + "conv2.b", c)
        cin = c
    conv("head.w", (3, 3, cin, cfg["num_classes"]))
    out.append(("head.b", (cfg["num_classes"],), "zero", 0))
    return out


def init(cfg: dict, generator: torch.Generator, device) -> dict:
    """Seeded weights in one ``torch.randn`` on ``device``, rounded to
    bfloat16: He-normal convs, LeCun-normal products, norm scales 1 +
    N(0, 0.1^2) and shifts N(0, 0.1^2), biases N(0, 0.1^2), the position
    embedding N(0, 0.02^2) as ViT draws it, the head's bias zero (the
    harness centres it).

    The last GroupNorm of each unit's branch (``gn3``) scales by 0.2 (1 +
    N(0, 0.1^2)).  The BiT code this ResNet comes from (timm's ResNetV2,
    ``zero_init_last``) starts it at zero; at full scale the random
    16-unit ResNet is chaotic, and one bfloat16 rounding of the root's
    output moves the logits by a third of their scale, as far as the
    float8 control moves them.  A fifth keeps every branch in the judged
    function."""
    shapes = sites(cfg)
    total = sum(math.prod(s) for _, s, _, _ in shapes)
    flat = torch.randn(total, generator=generator, device=device)
    tree: dict = {}
    pos = 0
    for name, shape, kind, fan_in in shapes:
        n = math.prod(shape)
        z = flat[pos: pos + n].reshape(shape)
        pos += n
        if kind == "he":
            a = z * math.sqrt(2.0 / fan_in)
        elif kind == "lecun":
            a = z * math.sqrt(1.0 / fan_in)
        elif kind == "scale":
            a = 1.0 + 0.1 * z
        elif kind == "branch":
            a = 0.2 * (1.0 + 0.1 * z)
        elif kind == "shift":
            a = 0.1 * z
        elif kind == "pos":
            a = 0.02 * z
        else:
            a = torch.zeros_like(z)
        _put(tree, name, a.bfloat16().float().cpu().numpy())
    return tree


def centre(tree: dict, bias: np.ndarray) -> None:
    """The head's bias set to ``bias``, rounded to bfloat16."""
    tree["head"]["b"] = torch.tensor(np.asarray(bias, np.float32)) \
        .bfloat16().float().numpy()


# ---------------------------------------------------------------- counting

def _conv(px: int, k: int, cin: int, cout: int) -> float:
    return 2.0 * px * k * k * cin * cout


def flops_per_slice(cfg: dict) -> float:
    """Every multiply-add of one slice's forward, times two, at the
    resolutions the authors' code gives (stage 1 at (S/4 - 1)^2): the
    root's 7x7 conv on the grey channel, the R50's convs, the patch
    embedding, the transformer's products (q, k, v, output, MLP) and its
    attention (q k^T and the probabilities times v: 4 L^2 hidden a layer),
    the decoder's 3x3 convs and the head.  Norms, GELU, softmax, the
    upsampling and the adds are elementwise and not counted."""
    w = widths(cfg)
    s = cfg["image_size"]
    r = w["resnet_width"]
    res = s // 2
    total = _conv(res * res, 7, cfg.get("in_channels", 1), r)
    res = (res - 3) // 2 + 1
    cin = r
    for i, (n, mid, cout) in enumerate(_stages(cfg)):
        for j in range(n):
            stride = 2 if i > 0 and j == 0 else 1
            out = (res - 1) // stride + 1
            total += _conv(res * res, 1, cin, mid)
            total += _conv(out * out, 3, mid, mid)
            total += _conv(out * out, 1, mid, cout)
            if j == 0:
                total += _conv(out * out, 1, cin, cout)
            cin, res = cout, out
    h, L = w["hidden_size"], tokens(cfg)
    total += 2.0 * L * cin * h
    total += w["num_layers"] * (2.0 * L * (4 * h * h + 2 * h * w["mlp_dim"])
                                + 4.0 * L * L * h)
    g = s // 16
    hc = w["decoder_head_channels"]
    total += _conv(g * g, 3, h, hc)
    cin = hc
    for c, skip in zip(w["decoder_channels"], _skips(cfg)):
        g *= 2
        total += _conv(g * g, 3, cin + skip, c) + _conv(g * g, 3, c, c)
        cin = c
    return total + _conv(s * s, 3, cin, cfg["num_classes"])


def attention_launches(cfg: dict) -> int:
    """Attention kernel launches a forward: one a layer."""
    return widths(cfg)["num_layers"]


def attention_bound_s(cfg: dict, batch: int) -> float:
    """The least time of one forward's attention launches at ``batch``:
    each launch the larger of its operations (4 L^2 hidden a slice) at the
    bf16 peak and its bytes (q, k and v read once, the output written once:
    4 L hidden bf16 values a slice) at the memory peak."""
    h, L = widths(cfg)["hidden_size"], tokens(cfg)
    flops = 4.0 * L * L * h * batch
    nbytes = 4.0 * L * h * BF16 * batch
    return attention_launches(cfg) * max(flops / peaks.BF16_FLOPS,
                                         nbytes / peaks.HBM_BYTES_PER_S)


# ------------------------------------------------------------------- model

class Weights:
    """The tree's arrays as float32 tensors on ``device``, converted once
    (StdConv's standardisation is not: it runs per forward)."""

    def __init__(self, params: dict, device, quant):
        if quant not in (None, "fp8"):
            raise ValueError(f"unknown control precision {quant!r}")
        self.q = _fp8 if quant == "fp8" else (lambda t: t)
        self.device = device
        self.p = self._tensors(params)

    def _tensors(self, node):
        if isinstance(node, dict):
            return {k: self._tensors(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [self._tensors(v) for v in node]
        return torch.as_tensor(np.asarray(node, np.float32),
                               device=self.device)


def oihw(w: torch.Tensor) -> torch.Tensor:
    return w.permute(3, 2, 0, 1)


def std_conv(wt: Weights, x, w, stride=1, padding=0):
    """The authors' ``StdConv2d``: each output channel's weights less
    their mean over their own inputs and taps, over the square root of
    their variance (biased) plus 1e-5."""
    w = oihw(w)
    var, mean = torch.var_mean(w, dim=(1, 2, 3), keepdim=True,
                               unbiased=False)
    w = (w - mean) / torch.sqrt(var + 1e-5)
    return F.conv2d(wt.q(x), wt.q(w), None, stride, padding)


def group_norm(x, p, groups, eps=1e-6):
    return F.group_norm(x, groups, p["scale"], p["bias"], eps)


def unit(wt: Weights, p: dict, x, stride: int):
    """One pre-activation bottleneck (``PreActBottleneck``)."""
    residual = x
    if "downsample" in p:
        residual = std_conv(wt, x, p["downsample"]["w"], stride)
        residual = group_norm(residual, p["gn_proj"],
                              residual.shape[1], eps=1e-5)
    y = F.relu(group_norm(std_conv(wt, x, p["conv1"]["w"]), p["gn1"],
                          GN_GROUPS))
    y = F.relu(group_norm(std_conv(wt, y, p["conv2"]["w"], stride, 1),
                          p["gn2"], GN_GROUPS))
    y = group_norm(std_conv(wt, y, p["conv3"]["w"]), p["gn3"], GN_GROUPS)
    return F.relu(residual + y)


def backbone(wt: Weights, x):
    """(N, 3, S, S) -> (stage 3's map, the skips at 1/8, 1/4, 1/2)."""
    p = wt.p
    s = x.shape[-1]
    x = F.relu(group_norm(std_conv(wt, x, p["root"]["conv"]["w"], 2, 3),
                          p["root"]["gn"], GN_GROUPS))
    feats = [x]
    x = F.max_pool2d(x, 3, 2)
    for i, stage in enumerate(p["stages"]):
        for j, u in enumerate(stage):
            x = unit(wt, u, x, 2 if i > 0 and j == 0 else 1)
        if i < len(p["stages"]) - 1:
            right = s // 4 >> i
            pad = right - x.shape[-1]
            feats.append(F.pad(x, (0, pad, 0, pad)))
    return x, feats[::-1]


def linear(wt: Weights, x, p, n_in: int = 1):
    """``x @ w + b``, ``w`` flattened to (its first ``n_in`` axes, the
    rest); a (1, 1, C, D) conv site is the product (C, D)."""
    w = p["w"]
    if w.dim() == 4:
        w = w[0, 0]
    w = w.reshape(math.prod(w.shape[:n_in]), -1)
    return wt.q(x) @ wt.q(w) + p["b"].reshape(-1)


def layer_norm(x, p):
    return F.layer_norm(x, x.shape[-1:], p["scale"], p["bias"], 1e-6)


def attention(wt: Weights, p: dict, x):
    n, L, h = x.shape
    heads, hd = p["q"]["w"].shape[1:]

    def split(t):
        return t.reshape(n, L, heads, hd).transpose(1, 2)
    q, k, v = (split(linear(wt, x, p[name])) for name in ("q", "k", "v"))
    scores = wt.q(q) @ wt.q(k).transpose(-1, -2) / math.sqrt(hd)
    probs = torch.softmax(scores, dim=-1)
    o = (wt.q(probs) @ wt.q(v)).transpose(1, 2).reshape(n, L, h)
    return linear(wt, o, p["out"], n_in=2)


def encoder(wt: Weights, x):
    for p in wt.p["encoder"]["layers"]:
        x = x + attention(wt, p, layer_norm(x, p["ln1"]))
        y = F.gelu(linear(wt, layer_norm(x, p["ln2"]), p["fc1"]))
        x = x + linear(wt, y, p["fc2"])
    return layer_norm(x, wt.p["encoder"]["norm"])


def conv3x3(wt: Weights, x, p, relu=True):
    y = F.conv2d(wt.q(x), wt.q(oihw(p["w"])), p["b"], padding=1)
    return F.relu(y) if relu else y


def forward(wt: Weights, u8: torch.Tensor) -> torch.Tensor:
    """(N, S, S) uint8 -> (N, S, S, K) float32 logits."""
    p = wt.p
    x = (u8.float() / 255.0)[:, None].repeat(1, 3, 1, 1)
    x, skips = backbone(wt, x)
    emb = F.conv2d(wt.q(x), wt.q(oihw(p["embed"]["patch"]["w"])),
                   p["embed"]["patch"]["b"])
    n, h, g, _ = emb.shape
    t = emb.flatten(2).transpose(1, 2) + p["embed"]["pos"]
    t = encoder(wt, t)
    x = t.transpose(1, 2).reshape(n, h, g, g)
    x = conv3x3(wt, x, p["decoder"]["conv_more"])
    for i, blk in enumerate(p["decoder"]["blocks"]):
        x = F.interpolate(x, scale_factor=2, mode="bilinear",
                          align_corners=True)
        if i < len(skips) and blk["conv1"]["w"].shape[2] > x.shape[1]:
            x = torch.cat([x, skips[i]], dim=1)
        x = conv3x3(wt, conv3x3(wt, x, blk["conv1"]), blk["conv2"])
    return conv3x3(wt, x, p["head"], relu=False).permute(0, 2, 3, 1) \
        .contiguous()


class Reference:
    """The reference model of one configuration: ``logits(u8)`` in blocks
    of ``block`` images."""

    def __init__(self, params: dict, cfg: dict, device, quant=None,
                 block: int = 4):
        tf32_off()
        self.device = torch.device(device)
        self.block = block
        self.w = Weights(params, self.device, quant)

    @torch.no_grad()
    def logits(self, u8: np.ndarray) -> np.ndarray:
        out = []
        for i in range(0, len(u8), self.block):
            x = torch.as_tensor(np.ascontiguousarray(u8[i: i + self.block]),
                                device=self.device)
            out.append(forward(self.w, x).cpu().numpy())
        return np.concatenate(out)
