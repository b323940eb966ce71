"""SAMed (SAM ViT-B, automatic multi-organ head), in float32 PyTorch, as the
program's ``samed`` family computes it.

Zhang & Liu, SAMed (arXiv:2304.13785, github.com/hitachinsk/SAMed), on
Segment Anything's ViT-B (Kirillov et al., arXiv:2304.02643,
``build_sam_vit_b``) at ``img_size`` 512, with no prompt; the layer
equations follow ``segment_anything/modeling``:

* ``ImageEncoderViT``: a 16x16 stride-16 patch embedding to 768 and an
  absolute position embedding at (S/16)^2; 12 pre-LN blocks (LayerNorm eps
  1e-6; attention with one qkv product and a bias, 12 heads of 64; an MLP
  3072 wide with exact GELU).  Blocks 2, 5, 8 and 11 attend over the whole
  grid; the others pad the grid with zeros after ``norm1`` to a multiple of
  the window (14) and attend inside each window (``window_partition``: the
  padded tokens are not masked, so as keys they carry the qkv bias), then
  join and crop (``window_unpartition``) before the residual.  Every block
  adds the decomposed relative-position bias (``add_decomposed_rel_pos``):
  ``rel_h = einsum(q, R_h)`` and ``rel_w = einsum(q, R_w)`` with the
  unscaled q and the tables indexed by ``q_i - k_j + (side - 1)``
  (``get_rel_pos``; 2 side - 1 rows: 27 in a window, 63 over the grid),
  added to ``q k^T / sqrt(64)`` before the softmax.  The neck: 1x1 conv
  768 -> 256 without bias, LayerNorm2d (eps 1e-6), 3x3 conv 256 -> 256
  without bias, LayerNorm2d.
* ``PromptEncoder`` with no prompt: ``no_mask_embed`` added to every image
  token, and the random-Fourier encoding of the (S/16)^2 grid
  (``PositionEmbeddingRandom``: sin and cos of 2 pi (2 c - 1) G, G a
  (2, 128) Gaussian matrix, c the cell centres in [0, 1]) as the image's
  position encoding.
* ``MaskDecoder``: the tokens ``[iou_token, mask_tokens]``, a
  ``TwoWayTransformer`` of depth 2 (width 256, 8 heads, MLP 2048 with
  ReLU, LayerNorm eps 1e-5): token self-attention (without its residual
  and position encoding in the first block), token-to-image attention, the
  MLP, image-to-token attention, the cross-attentions at an inner width of
  128 (``attention_downsample_rate`` 2); a final token-to-image attention
  and LayerNorm.  The upscaling: ConvTranspose2d 2x2 stride 2 256 -> 64,
  LayerNorm2d, GELU, ConvTranspose2d 64 -> 32, GELU (to (S/4)^2); a
  3-layer MLP (256 -> 256 -> 256 -> 32, ReLU between) of each mask token,
  and ``hyper_in @ upscaled``: (S/4)^2 logits a class.  SAMed keeps every
  mask token as a class, the first as the background.
* ``postprocess_masks``: the logits bilinear (``align_corners=False``) to
  S^2.

Departures from the published model, each the configuration's:

* 3 classes (SAMed's Synapse head has 9; the study path packs 2 bits a
  pixel);
* a grey one-channel input in [0, 1] (SAMed's pixel mean 0 and std 1),
  repeated to the published three channels here; the program sums the
  patch embedding's weights over them;
* the LoRA (rank 4 on q and v) merged into the qkv weights, as inference
  does: the tree holds the merged product;
* the IoU head left out: no mask reads it (the IoU token stays among the
  tokens, which the masks do read);
* a per-class offset (``decoder.offset``) added to the (S/4)^2 logits,
  which :func:`centre` sets: at 0 the seeded classes would be unbalanced;
* relative-position tables drawn at ``REL_POS_STD`` (SAM starts them at
  zero; a trained SAM's are not), so the bias moves the softmax.

Every product is float32 with TF32 off.  ``quant="fp8"`` is the control:
each product's operands (the linears' and convs' inputs and weights, q and
k, the probabilities and v, q and the relative-position tables) rounded
to float8 e4m3 with one scale per tensor, the products summed in float32.

The tree is the program's checkpoint layout: the patch embedding
``embed.patch`` ``{"w": (p, p, 3, hidden), "b"}``, ``embed.pos`` (g, g,
hidden); an encoder block's ``qkv`` ``(1, 1, hidden, 3 hidden)``, its
columns (q, k, v) x heads x head_dim as SAM's ``qkv`` Linear lays them,
``proj``, ``fc1``, ``fc2`` likewise, ``rel_pos_h`` and ``rel_pos_w`` (2
side - 1, head_dim); the neck's bias-less convs ``{"w": HWIO}``; norms
``{"scale", "bias"}``; the prompt encoder's ``no_mask_embed`` (256,) and
``pe_gaussian`` (2, 128); the decoder's ``tokens`` (1 + classes, 256),
its attentions' per-head products ``(dim, heads, d)`` and ``(heads, d,
dim)``, its upscaling's ``up`` ``{"w": (2, 2, C, D), "b"}`` (the JAX
transposed-conv layout: output pixel (2i + a, 2j + b) takes tap (1 - a, 1
- b)), the hypernetworks' products and ``offset`` (classes,).
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from perfbench import peaks
from perfbench.reference.unet import _fp8, _put, tf32_off

#: The published widths (``build_sam_vit_b`` at a 512^2 input, SAM's
#: prompt encoder and mask decoder); a configuration file may name any.
PUBLISHED = {"hidden_size": 768, "num_layers": 12, "num_heads": 12,
             "mlp_dim": 3072, "patch_size": 16, "window_size": 14,
             "global_attn_indexes": [2, 5, 8, 11], "prompt_embed_dim": 256,
             "decoder_depth": 2, "decoder_heads": 8, "decoder_mlp_dim": 2048,
             "attention_downsample_rate": 2}
#: The seeded relative-position tables' scale: the decomposed terms then
#: have about the spread of the scores q k^T / sqrt(d) (|q| ~ sqrt(d)).
REL_POS_STD = 0.1
#: The hypernetworks' layers (SAM's ``MLP(..., 3)``).
HYPER_LAYERS = 3
BF16 = 2


def widths(cfg: dict) -> dict:
    return {k: cfg.get(k, v) for k, v in PUBLISHED.items()}


def grid(cfg: dict) -> int:
    return cfg["image_size"] // widths(cfg)["patch_size"]


def block_side(cfg: dict, i: int) -> int:
    """The side of block ``i``'s attention: the grid for a global block,
    the window for a windowed one."""
    w = widths(cfg)
    return grid(cfg) if i in w["global_attn_indexes"] else w["window_size"]


def _padded(g: int, window: int) -> int:
    return -(-g // window) * window


# ----------------------------------------------------------------- weights

def sites(cfg: dict) -> List[Tuple[str, tuple, str, int]]:
    """Every array of the tree as (dotted path, shape, how it is drawn, the
    inputs each output sums), in the order drawn."""
    w = widths(cfg)
    h, heads, p = w["hidden_size"], w["num_heads"], w["patch_size"]
    hd = h // heads
    d, dh = w["prompt_embed_dim"], w["decoder_heads"]
    inner = d // w["attention_downsample_rate"]
    k = cfg["num_classes"]
    g = grid(cfg)
    out: List[Tuple[str, tuple, str, int]] = []

    def norm(name, c):
        out.extend([(name + ".scale", (c,), "scale", 0),
                    (name + ".bias", (c,), "shift", 0)])

    def dense(name, cin, cout, bias=True):
        out.append((name + ".w", (1, 1, cin, cout), "lecun", cin))
        if bias:
            out.append((name + ".b", (cout,), "shift", 0))

    def attn(name, dim, width):
        for part in ("q", "k", "v"):
            out.extend([(f"{name}.{part}.w", (dim, dh, width // dh), "lecun",
                         dim),
                        (f"{name}.{part}.b", (dh, width // dh), "shift", 0)])
        out.extend([(name + ".out.w", (dh, width // dh, dim), "lecun", width),
                    (name + ".out.b", (dim,), "shift", 0)])

    out.append(("embed.patch.w", (p, p, 3, h), "lecun", p * p * 3))
    out.append(("embed.patch.b", (h,), "shift", 0))
    out.append(("embed.pos", (g, g, h), "pos", 0))
    for i in range(w["num_layers"]):
        b = f"encoder.blocks.{i}."
        side = block_side(cfg, i)
        norm(b + "ln1", h)
        dense(b + "qkv", h, 3 * h)
        out.append((b + "rel_pos_h", (2 * side - 1, hd), "rel_pos", 0))
        out.append((b + "rel_pos_w", (2 * side - 1, hd), "rel_pos", 0))
        dense(b + "proj", h, h)
        norm(b + "ln2", h)
        dense(b + "fc1", h, w["mlp_dim"])
        dense(b + "fc2", w["mlp_dim"], h)
    dense("neck.conv1", h, d, bias=False)
    norm("neck.ln1", d)
    out.append(("neck.conv2.w", (3, 3, d, d), "lecun", 9 * d))
    norm("neck.ln2", d)
    out.append(("prompt.no_mask_embed", (d,), "normal", 0))
    out.append(("prompt.pe_gaussian", (2, d // 2), "normal", 0))
    out.append(("decoder.tokens", (1 + k, d), "normal", 0))
    for i in range(w["decoder_depth"]):
        b = f"decoder.layers.{i}."
        attn(b + "self_attn", d, d)
        norm(b + "norm1", d)
        attn(b + "cross_t2i", d, inner)
        norm(b + "norm2", d)
        dense(b + "mlp.fc1", d, w["decoder_mlp_dim"])
        dense(b + "mlp.fc2", w["decoder_mlp_dim"], d)
        norm(b + "norm3", d)
        norm(b + "norm4", d)
        attn(b + "cross_i2t", d, inner)
    attn("decoder.final_attn", d, inner)
    norm("decoder.norm_final", d)
    out.append(("decoder.upscale.0.up.w", (2, 2, d, d // 4), "lecun", d))
    out.append(("decoder.upscale.0.up.b", (d // 4,), "shift", 0))
    norm("decoder.upscale.0.norm", d // 4)
    out.append(("decoder.upscale.1.up.w", (2, 2, d // 4, d // 8), "lecun",
                d // 4))
    out.append(("decoder.upscale.1.up.b", (d // 8,), "shift", 0))
    for c in range(k):
        widths_ = [d] * HYPER_LAYERS + [d // 8]
        for j in range(HYPER_LAYERS):
            dense(f"decoder.hyper.{c}.fc{j + 1}", widths_[j], widths_[j + 1])
    out.append(("decoder.offset", (k,), "zero", 0))
    return out


def init(cfg: dict, generator: torch.Generator, device) -> dict:
    """Seeded weights in one ``torch.randn`` on ``device``, rounded to
    bfloat16: LeCun-normal products and convs (the tree's fan-in), norm
    scales 1 + N(0, 0.1^2) and shifts, biases N(0, 0.1^2), the position
    embedding N(0, 0.02^2), the relative-position tables N(0,
    ``REL_POS_STD``^2), the tokens, ``no_mask_embed`` and the Fourier
    matrix N(0, 1) (``nn.Embedding``'s and SAM's scale-1 Gaussian), the
    class offset zero (the harness centres it)."""
    shapes = sites(cfg)
    total = sum(math.prod(s) for _, s, _, _ in shapes)
    flat = torch.randn(total, generator=generator, device=device)
    tree: dict = {}
    pos = 0
    for name, shape, kind, fan_in in shapes:
        n = math.prod(shape)
        z = flat[pos: pos + n].reshape(shape)
        pos += n
        if kind == "lecun":
            a = z * math.sqrt(1.0 / fan_in)
        elif kind == "scale":
            a = 1.0 + 0.1 * z
        elif kind == "shift":
            a = 0.1 * z
        elif kind == "pos":
            a = 0.02 * z
        elif kind == "rel_pos":
            a = REL_POS_STD * z
        elif kind == "normal":
            a = z
        else:
            a = torch.zeros_like(z)
        _put(tree, name, a.bfloat16().float().cpu().numpy())
    return tree


def centre(tree: dict, bias: np.ndarray) -> None:
    """The decoder's class offset set to ``bias``, rounded to bfloat16."""
    tree["decoder"]["offset"] = torch.tensor(
        np.asarray(bias, np.float32)).bfloat16().float().numpy()


# ---------------------------------------------------------------- counting

def flops_per_slice(cfg: dict) -> float:
    """Every multiply-add of one slice's forward, times two: the patch
    embedding on the grey channel; each block's qkv and output products on
    the tokens it attends over (a windowed block's padded grid), its
    attention (q k^T and the probabilities times v: 4 L^2 hidden a window
    or grid) and decomposed terms (2 L side hidden each), its MLP on the
    grid; the neck's two convs; the decoder's products and attention (the
    image-side projections on the grid's tokens), its two transposed convs,
    the hypernetworks and the masks' product.  Norms, GELU, softmax, the
    bias's expansion, the Fourier encoding and the bilinear upsampling are
    elementwise and not counted."""
    w = widths(cfg)
    h, g, p = w["hidden_size"], grid(cfg), w["patch_size"]
    L = g * g
    total = 2.0 * L * p * p * cfg.get("in_channels", 1) * h
    for i in range(w["num_layers"]):
        side = block_side(cfg, i)
        tokens = L if side == g else _padded(g, side) ** 2
        total += 2.0 * tokens * 4 * h * h
        total += (tokens // (side * side)) * (4.0 * side ** 4 * h
                                              + 2 * 2.0 * side ** 3 * h)
        total += 2.0 * L * 2 * h * w["mlp_dim"]
    d = w["prompt_embed_dim"]
    total += 2.0 * L * h * d + 2.0 * L * 9 * d * d
    t = 1 + cfg["num_classes"]
    inner = d // w["attention_downsample_rate"]

    def attention(lq, lk, width):  # projections and products
        return (2.0 * lq * d * width + 2.0 * 2 * lk * d * width
                + 2.0 * lq * width * d + 4.0 * lq * lk * width)
    for _ in range(w["decoder_depth"]):
        total += attention(t, t, d) + attention(t, L, inner) \
            + attention(L, t, inner) + 2.0 * t * 2 * d * w["decoder_mlp_dim"]
    total += attention(t, L, inner)
    total += 2.0 * L * d * 4 * (d // 4) + 2.0 * 4 * L * (d // 4) * 4 * (d // 8)
    total += cfg["num_classes"] * 2.0 * (2 * d * d + d * (d // 8))
    return total + 2.0 * 16 * L * (d // 8) * cfg["num_classes"]


def _decoder_attentions(cfg: dict) -> List[Tuple[int, int, int]]:
    """(queries, keys, inner width) of the decoder's attentions, in order:
    per two-way block the tokens' self-attention (at the full width), the
    token-to-image and image-to-token cross-attentions (at the
    downsampled width); then the final token-to-image attention."""
    w = widths(cfg)
    d, L, t = w["prompt_embed_dim"], grid(cfg) ** 2, 1 + cfg["num_classes"]
    inner = d // w["attention_downsample_rate"]
    return [(t, t, d), (t, L, inner), (L, t, inner)] * w["decoder_depth"] \
        + [(t, L, inner)]


def attention_launches(cfg: dict) -> int:
    """FlashAttention launches a forward (``ops/attention.attention``):
    the decoder's attentions, one launch each."""
    return len(_decoder_attentions(cfg))


def attention_bound_s(cfg: dict, batch: int) -> float:
    """The least time of one forward's FlashAttention launches at
    ``batch``: each launch the larger of its operations (4 queries keys
    width a slice) at the bf16 peak and its bytes (q, k and v read once,
    the output written once, bf16) at the memory peak."""
    total = 0.0
    for lq, lk, width in _decoder_attentions(cfg):
        flops = 4.0 * lq * lk * width * batch
        nbytes = 2.0 * (lq + lk) * width * BF16 * batch
        total += max(flops / peaks.BF16_FLOPS, nbytes / peaks.HBM_BYTES_PER_S)
    return total


def relpos_attention_launches(cfg: dict) -> int:
    """Rel-pos attention launches a forward: one a block."""
    return widths(cfg)["num_layers"]


def relpos_attention_bound_s(cfg: dict, batch: int) -> float:
    """The least time of one forward's rel-pos attention launches at
    ``batch``: each launch the larger of its operations (4 L^2 hidden a
    window, or over the grid) at the bf16 peak and its bytes (q, k, v, the
    output and the two decomposed terms, each read or written once, bf16:
    4 L hidden + 2 heads L side values a window) at the memory peak.  The
    expanded bias is not counted: a kernel that never writes it does the
    same work."""
    w = widths(cfg)
    h, heads, g = w["hidden_size"], w["num_heads"], grid(cfg)
    total = 0.0
    for i in range(w["num_layers"]):
        side = block_side(cfg, i)
        windows = 1 if side == g else (_padded(g, side) // side) ** 2
        L = side * side
        flops = 4.0 * L * L * h * windows * batch
        nbytes = (4.0 * L * h + 2.0 * heads * L * side) * BF16 * windows \
            * batch
        total += max(flops / peaks.BF16_FLOPS, nbytes / peaks.HBM_BYTES_PER_S)
    return total


# ------------------------------------------------------------------- model

class Weights:
    """The tree's arrays as float32 tensors on ``device``."""

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


def linear(wt: Weights, x, p, n_in: int = 1):
    """``x @ w (+ b)``, ``w`` flattened to (its first ``n_in`` axes, the
    rest); a (1, 1, C, D) site is the product (C, D)."""
    w = p["w"]
    if w.dim() == 4:
        w = w[0, 0]
    w = w.reshape(math.prod(w.shape[:n_in]), -1)
    y = wt.q(x) @ wt.q(w)
    return y + p["b"].reshape(-1) if "b" in p else y


def layer_norm(x, p, eps):
    return F.layer_norm(x, x.shape[-1:], p["scale"], p["bias"], eps)


def window_partition(x, window: int):
    """SAM's ``window_partition``: (B, H, W, C) zero-padded to multiples of
    ``window`` -> (B * windows, window, window, C), and the padded size."""
    b, h, w, c = x.shape
    pad_h, pad_w = (-h) % window, (-w) % window
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    hp, wp = h + pad_h, w + pad_w
    x = x.view(b, hp // window, window, wp // window, window, c)
    return (x.permute(0, 1, 3, 2, 4, 5).contiguous()
            .view(-1, window, window, c), (hp, wp))


def window_unpartition(windows, window: int, pad_hw, hw):
    """SAM's ``window_unpartition``: the windows joined and cropped."""
    hp, wp = pad_hw
    h, w = hw
    b = windows.shape[0] // (hp * wp // window // window)
    x = windows.view(b, hp // window, wp // window, window, window, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).contiguous().view(b, hp, wp, -1)
    return x[:, :h, :w, :].contiguous()


def get_rel_pos(q_size: int, k_size: int, rel_pos):
    """SAM's ``get_rel_pos`` where the table has 2 max(q, k) - 1 rows (no
    interpolation): (q_size, k_size, C)."""
    q_coords = torch.arange(q_size)[:, None] * max(k_size / q_size, 1.0)
    k_coords = torch.arange(k_size)[None, :] * max(q_size / k_size, 1.0)
    rel = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos[rel.long().to(rel_pos.device)]


def add_decomposed_rel_pos(wt: Weights, attn, q, rel_pos_h, rel_pos_w,
                           q_size, k_size):
    """SAM's ``add_decomposed_rel_pos``: ``attn`` (B, qh qw, kh kw) plus
    ``rel_h[b, i, k_row] + rel_w[b, i, k_col]``, the terms of the unscaled
    ``q`` (B, qh qw, C)."""
    q_h, q_w = q_size
    k_h, k_w = k_size
    rh = get_rel_pos(q_h, k_h, rel_pos_h)
    rw = get_rel_pos(q_w, k_w, rel_pos_w)
    b, _, dim = q.shape
    r_q = wt.q(q).reshape(b, q_h, q_w, dim)
    rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, wt.q(rh))
    rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, wt.q(rw))
    attn = (attn.view(b, q_h, q_w, k_h, k_w) + rel_h[:, :, :, :, None]
            + rel_w[:, :, :, None, :]).view(b, q_h * q_w, k_h * k_w)
    return attn


def encoder_attention(wt: Weights, p: dict, x):
    """SAM's ``Attention`` with ``use_rel_pos``: (B, H, W, C) -> (B, H, W,
    C), an explicit softmax."""
    b, h, w, c = x.shape
    heads = c // p["rel_pos_h"].shape[1]
    qkv = linear(wt, x.reshape(b, h * w, c), p["qkv"])
    qkv = qkv.reshape(b, h * w, 3, heads, -1).permute(2, 0, 3, 1, 4)
    q, k, v = qkv.reshape(3, b * heads, h * w, -1).unbind(0)
    scale = (c // heads) ** -0.5
    attn = wt.q(q * scale) @ wt.q(k).transpose(-2, -1)
    attn = add_decomposed_rel_pos(wt, attn, q, p["rel_pos_h"],
                                  p["rel_pos_w"], (h, w), (h, w))
    attn = attn.softmax(dim=-1)
    o = (wt.q(attn) @ wt.q(v)).view(b, heads, h, w, -1)
    o = o.permute(0, 2, 3, 1, 4).reshape(b, h, w, -1)
    return linear(wt, o, p["proj"])


def encoder_block(wt: Weights, p: dict, x):
    """SAM's ``Block``: the window or global attention by the table's
    rows, the residual, the MLP."""
    side = (p["rel_pos_h"].shape[0] + 1) // 2
    shortcut = x
    x = layer_norm(x, p["ln1"], 1e-6)
    h, w = x.shape[1], x.shape[2]
    windowed = side != h
    if windowed:
        x, pad_hw = window_partition(x, side)
    x = encoder_attention(wt, p, x)
    if windowed:
        x = window_unpartition(x, side, pad_hw, (h, w))
    x = shortcut + x
    y = F.gelu(linear(wt, layer_norm(x, p["ln2"], 1e-6), p["fc1"]))
    return x + linear(wt, y, p["fc2"])


def layer_norm_2d(x, p):
    """SAM's ``LayerNorm2d`` on NCHW: over channels, eps 1e-6."""
    u = x.mean(1, keepdim=True)
    s = (x - u).pow(2).mean(1, keepdim=True)
    x = (x - u) / torch.sqrt(s + 1e-6)
    return p["scale"][:, None, None] * x + p["bias"][:, None, None]


def image_encoder(wt: Weights, x):
    """(N, 3, S, S) -> the neck's (N, 256, g, g)."""
    p = wt.p
    w = p["embed"]["patch"]["w"]
    ps = w.shape[0]
    x = F.conv2d(wt.q(x), wt.q(w.permute(3, 2, 0, 1)),
                 p["embed"]["patch"]["b"], stride=ps)
    x = x.permute(0, 2, 3, 1) + p["embed"]["pos"]
    for blk in p["encoder"]["blocks"]:
        x = encoder_block(wt, blk, x)
    n = p["neck"]
    x = x.permute(0, 3, 1, 2)
    x = F.conv2d(wt.q(x), wt.q(n["conv1"]["w"].permute(3, 2, 0, 1)))
    x = layer_norm_2d(x, n["ln1"])
    x = F.conv2d(wt.q(x), wt.q(n["conv2"]["w"].permute(3, 2, 0, 1)),
                 padding=1)
    return layer_norm_2d(x, n["ln2"])


def dense_pe(p: dict, g: int):
    """``PositionEmbeddingRandom`` of a g x g grid: (C, g, g)."""
    grid_ = torch.ones((g, g), device=p["pe_gaussian"].device)
    y = (grid_.cumsum(dim=0) - 0.5) / g
    x = (grid_.cumsum(dim=1) - 0.5) / g
    coords = 2 * torch.stack([x, y], dim=-1) - 1
    coords = 2 * np.pi * (coords @ p["pe_gaussian"])
    return torch.cat([torch.sin(coords), torch.cos(coords)],
                     dim=-1).permute(2, 0, 1)


def decoder_attention(wt: Weights, p: dict, q, k, v):
    """SAM's two-way ``Attention``: per-head products, an explicit
    softmax of ``q k^T / sqrt(d)``."""
    heads = p["q"]["w"].shape[1]

    def separate(t):
        b, n, c = t.shape
        return t.reshape(b, n, heads, c // heads).transpose(1, 2)
    q = separate(linear(wt, q, p["q"]))
    k = separate(linear(wt, k, p["k"]))
    v = separate(linear(wt, v, p["v"]))
    attn = wt.q(q) @ wt.q(k).permute(0, 1, 3, 2) / math.sqrt(q.shape[-1])
    attn = torch.softmax(attn, dim=-1)
    out = wt.q(attn) @ wt.q(v)
    b, h, n, c = out.shape
    return linear(wt, out.transpose(1, 2).reshape(b, n, h * c), p["out"],
                  n_in=2)


def two_way_block(wt: Weights, p: dict, queries, keys, query_pe, key_pe,
                  skip_first_layer_pe: bool):
    """SAM's ``TwoWayAttentionBlock`` (LayerNorm eps 1e-5, ReLU MLP)."""
    def ln(x, name):
        return layer_norm(x, p[name], 1e-5)
    if skip_first_layer_pe:
        queries = decoder_attention(wt, p["self_attn"], queries, queries,
                                    queries)
    else:
        q = queries + query_pe
        queries = queries + decoder_attention(wt, p["self_attn"], q, q,
                                              queries)
    queries = ln(queries, "norm1")
    q, k = queries + query_pe, keys + key_pe
    queries = ln(queries + decoder_attention(wt, p["cross_t2i"], q, k, keys),
                 "norm2")
    mlp = linear(wt, F.relu(linear(wt, queries, p["mlp"]["fc1"])),
                 p["mlp"]["fc2"])
    queries = ln(queries + mlp, "norm3")
    q, k = queries + query_pe, keys + key_pe
    keys = ln(keys + decoder_attention(wt, p["cross_i2t"], k, q, queries),
              "norm4")
    return queries, keys


def conv_transpose(wt: Weights, x, p):
    """A 2x2 stride-2 transposed conv from the tree's JAX layout (output
    pixel (2i + a, 2j + b) takes tap (1 - a, 1 - b)) as
    ``F.conv_transpose2d``'s (C, D, a, b) weight."""
    w = p["w"].flip(0, 1).permute(2, 3, 0, 1)
    return F.conv_transpose2d(wt.q(x), wt.q(w), p["b"], stride=2)


def mask_decoder(wt: Weights, emb):
    """(N, 256, g, g) image embedding -> (N, classes, 4g, 4g) logits."""
    p = wt.p
    d = p["decoder"]
    n, c, g, _ = emb.shape
    src = emb + p["prompt"]["no_mask_embed"].reshape(1, -1, 1, 1)
    pos = dense_pe(p["prompt"], g)[None]
    tokens = d["tokens"][None].expand(n, -1, -1)
    keys = src.flatten(2).permute(0, 2, 1)
    key_pe = pos.flatten(2).permute(0, 2, 1)
    queries = tokens
    for i, layer in enumerate(d["layers"]):
        queries, keys = two_way_block(wt, layer, queries, keys, tokens,
                                      key_pe, i == 0)
    q, k = queries + tokens, keys + key_pe
    queries = layer_norm(queries + decoder_attention(wt, d["final_attn"], q,
                                                     k, keys),
                         d["norm_final"], 1e-5)
    x = keys.transpose(1, 2).reshape(n, c, g, g)
    up0, up1 = d["upscale"]
    x = F.gelu(layer_norm_2d(conv_transpose(wt, x, up0["up"]), up0["norm"]))
    x = F.gelu(conv_transpose(wt, x, up1["up"]))
    hyper = []
    for i, mlp in enumerate(d["hyper"]):
        t = queries[:, 1 + i, :]
        for j in range(HYPER_LAYERS):
            t = linear(wt, t, mlp[f"fc{j + 1}"])
            if j < HYPER_LAYERS - 1:
                t = F.relu(t)
        hyper.append(t)
    hyper_in = torch.stack(hyper, dim=1)
    b, c, h, w = x.shape
    masks = (wt.q(hyper_in) @ wt.q(x.view(b, c, h * w))).view(b, -1, h, w)
    return masks + d["offset"].reshape(1, -1, 1, 1)


def forward(wt: Weights, u8: torch.Tensor) -> torch.Tensor:
    """(N, S, S) uint8 -> (N, S, S, K) float32 logits."""
    s = u8.shape[-1]
    x = (u8.float() / 255.0)[:, None].repeat(1, 3, 1, 1)
    low = mask_decoder(wt, image_encoder(wt, x))
    up = F.interpolate(low, (s, s), mode="bilinear", align_corners=False)
    return up.permute(0, 2, 3, 1).contiguous()


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
