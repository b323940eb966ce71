"""SAMed (SAM ViT-B with an automatic multi-organ head), a family of the port
only (the JAX package has none).

Zhang & Liu, SAMed (arXiv:2304.13785, github.com/hitachinsk/SAMed): Segment
Anything's ViT-B (Kirillov et al., arXiv:2304.02643, ``build_sam_vit_b``)
at ``img_size`` 512 with no prompt, every mask token a class:

* a 16x16 stride-16 patch embedding and an absolute position embedding;
  12 pre-LN blocks (LayerNorm eps 1e-6, one qkv product with a bias, 12
  heads of 64, an MLP with exact GELU).  Blocks whose relative-position
  tables have 2 g - 1 rows (g the grid's side; blocks 2, 5, 8 and 11 of
  ViT-B) attend over the whole grid; the others pad the grid with zeros
  after ``ln1`` to a multiple of their window (the tables' (rows + 1) / 2,
  14) and attend inside each window, the padded tokens unmasked, as SAM
  does; the windows are joined and cropped before the residual.  Every
  block adds SAM's decomposed relative-position bias: ``rel_h =
  einsum(q, R_h)`` and ``rel_w = einsum(q, R_w)`` with the unscaled q and
  the tables gathered at ``q_i - k_j + side - 1``;
* the neck: 1x1 conv to 256 and 3x3 conv 256 -> 256, both without bias,
  each followed by a LayerNorm over the channels (eps 1e-6);
* the prompt encoder without a prompt: ``no_mask_embed`` added to every
  image token, the random-Fourier encoding of the grid (a constant, made
  when the weights are loaded) as the image's position encoding;
* SAM's mask decoder: the tokens (the IoU token, then one a class) through
  a two-way transformer (self-attention, token-to-image and
  image-to-token cross-attention at half the width, a ReLU MLP, LayerNorm
  eps 1e-5; a final token-to-image attention), two 2x2 stride-2
  transposed convs (LayerNorm and GELU, then GELU) to (S/4)^2, a 3-layer
  hypernetwork MLP a class and their product with the upscaled
  embedding: (S/4)^2 logits a class, plus a per-class offset, bilinear
  (``align_corners=False``) to S^2.

NHWC in [0, 1] -> float32 logits ``(N, S, S, classes)`` from
:meth:`SAMed.forward`, and :meth:`SAMed.masks` the first-max class map, as
:class:`models.unet.UNet` has them; the engine, the study runner, its
graph capture, TTA (activation space: the windows start at the top-left, so
a flip moves the padding) and windows of ``S`` serve it.  Where each part
runs:

* the encoder's attention in ``ops.attention.attention_relpos`` (on the
  card the port's ``relpos_bias`` kernel writes the bias, the
  memory-efficient backend attends; counted as ``relpos``), windows
  batched into the batch axis, so a block is one call;
* the decoder's seven attentions in ``ops.attention.attention``
  (FlashAttention on the card, counted as ``attention``);
* the neck's 3x3 conv in the conv kernel (K1/K2, ``ops.conv``);
* the patch embedding (the three input channels' weights summed once, when
  the weights are loaded), every linear and 1x1 conv as plain products;
  the decomposed terms as one batched product of q and both tables and
  two gathers (:meth:`Block.rel_terms`); the transposed convs as one
  product each (``ops.dec1.up_conv``);
* LayerNorm, GELU, ReLU, the window copies and the bilinear upsampling as
  plain ``torch`` ops.

The model is built from the configuration and the parameter tree
(:class:`Widths` reads every width from the tree's shapes);
:func:`init` draws a tree at the published widths or any other.  The IoU
head is left out: no mask reads it.  While a profiler records, the forward's
stages are the spans ``samed.encoder``, ``samed.neck``, ``samed.decoder``
and ``samed.upsample``.  The family cannot run in row bands, quantized to
w8a8 or in training (``models/registry.py`` refuses each by name).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.overrides import has_torch_function_unary

from unetseg_tpu_torch.config import ModelConfig
from unetseg_tpu_torch.models.transunet import (Dense, LayerNorm, _nchw,
                                                _nhwc, _span, product)
from unetseg_tpu_torch.models.unet import compute_dtype
from unetseg_tpu_torch.ops import attention as attention_ops
from unetseg_tpu_torch.ops.conv import conv3x3_bias_act_train
from unetseg_tpu_torch.ops.decode import decode_mask
from unetseg_tpu_torch.ops.dec1 import up_conv

__all__ = ["SAMed", "Widths", "init"]

#: :func:`init`'s scale of the relative-position tables.  SAM starts them at
#: zero; a trained SAM's are not, and at this scale the decomposed terms
#: have about the spread of the scores q k^T / sqrt(d).
REL_POS_STD = 0.1
#: The hypernetworks' layers (SAM's ``MLP(dim, dim, dim / 8, 3)``).
HYPER_LAYERS = 3


@dataclasses.dataclass(frozen=True)
class Widths:
    """A SAMed's widths; the defaults are the published SAM ViT-B's
    (``build_sam_vit_b``) and its prompt encoder's and mask decoder's."""

    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_dim: int = 3072
    patch_size: int = 16
    window_size: int = 14
    global_attn_indexes: Tuple[int, ...] = (2, 5, 8, 11)
    prompt_embed_dim: int = 256
    decoder_depth: int = 2
    decoder_heads: int = 8
    decoder_mlp_dim: int = 2048
    attention_downsample_rate: int = 2

    @classmethod
    def of(cls, params: dict) -> "Widths":
        """The widths of a parameter tree, read from its shapes: a block
        whose table has 2 g - 1 rows attends globally, the others in
        windows of (rows + 1) / 2."""
        def shape(a):
            return tuple(np.shape(a))

        patch = shape(params["embed"]["patch"]["w"])
        g = shape(params["embed"]["pos"])[0]
        blocks = params["encoder"]["blocks"]
        sides = [(shape(b["rel_pos_h"])[0] + 1) // 2 for b in blocks]
        windows = {s for s in sides if s != g}
        if len(windows) > 1:
            raise ValueError(f"samed: windowed blocks of sides "
                             f"{sorted(windows)}; SAM has one window")
        hd = shape(blocks[0]["rel_pos_h"])[1]
        layers = params["decoder"]["layers"]
        dim, heads, d = shape(layers[0]["self_attn"]["q"]["w"])
        inner = math.prod(shape(layers[0]["cross_t2i"]["q"]["w"])[1:])
        return cls(hidden_size=patch[-1], num_layers=len(blocks),
                   num_heads=patch[-1] // hd,
                   mlp_dim=shape(blocks[0]["fc1"]["w"])[-1],
                   patch_size=patch[0],
                   window_size=windows.pop() if windows else g,
                   global_attn_indexes=tuple(i for i, s in enumerate(sides)
                                             if s == g),
                   prompt_embed_dim=dim, decoder_depth=len(layers),
                   decoder_heads=heads,
                   decoder_mlp_dim=shape(layers[0]["mlp"]["fc1"]["w"])[-1],
                   attention_downsample_rate=dim // inner)


def window_partition(x: torch.Tensor, window: int
                     ) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """(N, H, W, C) zero-padded to multiples of ``window`` -> (N *
    windows, window, window, C), contiguous, and the padded (H, W)."""
    n, h, w, c = x.shape
    ph, pw = (-h) % window, (-w) % window
    if ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
    hp, wp = h + ph, w + pw
    x = x.view(n, hp // window, window, wp // window, window, c)
    return (x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window, window, c),
            (hp, wp))


def window_unpartition(x: torch.Tensor, window: int, padded: Tuple[int, int],
                       size: Tuple[int, int]) -> torch.Tensor:
    """The inverse of :func:`window_partition`, cropped to ``size``: a view
    of one joined copy."""
    hp, wp = padded
    n = x.shape[0] // (hp * wp // window // window)
    x = x.view(n, hp // window, wp // window, window, window, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(n, hp, wp, -1)
    return x[:, :size[0], :size[1]]


def rel_index(side: int) -> torch.Tensor:
    """(side, side) rows of a table of 2 side - 1: ``q - k + side - 1``
    (SAM's ``get_rel_pos`` where queries and keys have one size)."""
    r = torch.arange(side)
    return r[:, None] - r[None, :] + side - 1


class Block(nn.Module):
    """An encoder block: ``x + proj(attn(ln1(x)))`` (in windows of
    ``side`` where ``side`` is not the grid's), then ``x +
    fc2(gelu(fc1(ln2(x))))``."""

    def __init__(self, hidden: int, heads: int, mlp: int, side: int,
                 grid: int):
        super().__init__()
        d = hidden // heads
        self.heads, self.d, self.side = heads, d, side
        self.window = side if side != grid else 0
        self.ln1 = LayerNorm(hidden)
        self.qkv = Dense((hidden, 3 * hidden), (3 * hidden,))
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * side - 1, d),
                                      requires_grad=False)
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * side - 1, d),
                                      requires_grad=False)
        self.register_buffer("index", rel_index(side), persistent=False)
        self.proj = Dense((hidden, hidden), (hidden,))
        self.ln2 = LayerNorm(hidden)
        self.fc1 = Dense((hidden, mlp), (mlp,))
        self.fc2 = Dense((mlp, hidden), (hidden,))

    def rel_terms(self, q: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """SAM's decomposed terms of (B, heads, L, d) ``q``, a view of the
        qkv product: ``rel_h[.., i, k] = q_i . R_h[x_i - k + side - 1]``
        and ``rel_w[.., i, k] = q_i . R_w[y_i - k + side - 1]`` (query i at
        row x_i, column y_i), each (B, heads, L, side), contiguous.

        One batched product a head takes q as it lies in the qkv product
        (no copy) against both tables, every row of each; two gathers then
        pick each query's rows, in SAM's ``get_rel_pos`` order."""
        b, heads, L, d = q.shape
        s = self.side
        table = torch.cat([self.rel_pos_h, self.rel_pos_w]).to(q.dtype)
        scores = torch.bmm(q.transpose(0, 1).reshape(heads, b * L, d),
                           table.t().expand(heads, d, table.shape[0]))
        scores = scores.view(heads, b, s, s, 2, 2 * s - 1).transpose(0, 1)
        shape = (b, heads, s, s, s)
        rows = self.index[:, None, :].expand(shape)  # by the query's row
        cols = self.index[None, :, :].expand(shape)  # by its column
        rel_h = torch.gather(scores[..., 0, :], -1, rows)
        rel_w = torch.gather(scores[..., 1, :], -1, cols)
        return rel_h.view(b, heads, L, s), rel_w.view(b, heads, L, s)

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        """(B, s, s, hidden) -> (B, s, s, hidden), s = ``side``."""
        b, s, _, c = x.shape
        L = s * s
        qkv = self.qkv(x.reshape(b, L, c)).view(b, L, 3, self.heads, self.d)
        # (b, heads, L, d) views of the one product
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        rel_h, rel_w = self.rel_terms(q)
        o = attention_ops.attention_relpos(q, k, v, rel_h, rel_w)
        return self.proj(o.transpose(1, 2).reshape(b, s, s, c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.ln1(x)
        if self.window:
            g = tuple(y.shape[1:3])
            y, padded = window_partition(y, self.window)
            y = window_unpartition(self.attend(y), self.window, padded, g)
        else:
            y = self.attend(y)
        x = x + y
        return x + self.fc2(F.gelu(self.fc1(self.ln2(x))))


class PatchEmbed(nn.Module):
    """The 16x16 stride-16 patch embedding of the grey channel as one
    product: ``weight`` is stored as the tree holds it (p, p, 3, hidden);
    its sum over the three input channels, (p p, hidden), is computed each
    time weights are loaded (a ``load_state_dict`` hook) into ``grey``."""

    def __init__(self, patch: int, hidden: int):
        super().__init__()
        self.patch = patch
        self.weight = nn.Parameter(torch.zeros(patch, patch, 3, hidden),
                                   requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(hidden), requires_grad=False)
        self.register_buffer("grey", torch.zeros(patch * patch, hidden),
                             persistent=False)
        self.register_load_state_dict_post_hook(PatchEmbed._grey)

    @staticmethod
    def _grey(module: "PatchEmbed", _incompatible) -> None:
        w = module.weight.detach().float().sum(dim=2)
        old = module.grey
        module.grey = w.reshape(old.shape).to(old.device, old.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, S, S, 1) -> (N, S/p, S/p, hidden)."""
        n, p = x.shape[0], self.patch
        g = x.shape[1] // p
        patches = x.reshape(n, g, p, g, p).permute(0, 1, 3, 2, 4)
        return product(patches.reshape(n, g, g, p * p), self.grey, self.bias)


class Weight(nn.Module):
    """A site without bias: ``weight`` of ``shape`` as the state dict holds
    it."""

    def __init__(self, *shape: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(shape), requires_grad=False)


class Neck(nn.Module):
    """1x1 conv (a product), LayerNorm2d, 3x3 conv (the conv kernel),
    LayerNorm2d; the convs without bias.  SAM's ``LayerNorm2d`` (over the
    channels, eps 1e-6) on NHWC is a last-axis LayerNorm."""

    def __init__(self, hidden: int, dim: int):
        super().__init__()
        self.conv1 = Weight(hidden, dim)
        self.ln1 = LayerNorm(dim)
        self.conv2 = Weight(3, 3, dim, dim)
        self.register_buffer("zero", torch.zeros(dim), persistent=False)
        self.ln2 = LayerNorm(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.ln1(product(x, self.conv1.weight))
        x = conv3x3_bias_act_train(x.contiguous(), self.conv2.weight,
                                   self.zero, relu=False)
        return self.ln2(x)


class Attention(nn.Module):
    """The two-way transformer's attention: per-head products ``q``, ``k``,
    ``v`` (dim, heads, d) and ``out`` (heads, d, dim), at an inner width
    heads x d."""

    def __init__(self, dim: int, heads: int, inner: int):
        super().__init__()
        d = inner // heads
        self.heads, self.d = heads, d
        self.q = Dense((dim, heads, d), (heads, d))
        self.k = Dense((dim, heads, d), (heads, d))
        self.v = Dense((dim, heads, d), (heads, d))
        self.out = Dense((heads, d, dim), (dim,), n_in=2)

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                ) -> torch.Tensor:
        n, lq, _ = q.shape

        def heads(t):  # (n, L, heads * d) -> (n, heads, L, d), a view
            return t.view(n, -1, self.heads, self.d).transpose(1, 2)
        o = attention_ops.attention(heads(self.q(q)), heads(self.k(k)),
                                    heads(self.v(v)))
        return self.out(o.transpose(1, 2).reshape(n, lq, -1))


class MLP(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Dense((dim, hidden), (hidden,))
        self.fc2 = Dense((hidden, dim), (dim,))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.relu(self.fc1(x)))


class TwoWayBlock(nn.Module):
    """SAM's ``TwoWayAttentionBlock``; the first block's self-attention
    takes no position encoding and no residual."""

    def __init__(self, dim: int, heads: int, inner: int, mlp: int,
                 first: bool):
        super().__init__()
        self.first = first
        self.self_attn = Attention(dim, heads, dim)
        self.norm1 = LayerNorm(dim, 1e-5)
        self.cross_t2i = Attention(dim, heads, inner)
        self.norm2 = LayerNorm(dim, 1e-5)
        self.mlp = MLP(dim, mlp)
        self.norm3 = LayerNorm(dim, 1e-5)
        self.norm4 = LayerNorm(dim, 1e-5)
        self.cross_i2t = Attention(dim, heads, inner)

    def forward(self, queries, keys, query_pe, key_pe):
        if self.first:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)
        k = keys + key_pe
        queries = self.norm2(queries + self.cross_t2i(queries + query_pe, k,
                                                      keys))
        queries = self.norm3(queries + self.mlp(queries))
        keys = self.norm4(keys + self.cross_i2t(k, queries + query_pe,
                                                queries))
        return queries, keys


class Hyper(nn.Module):
    """A class's hypernetwork: ``HYPER_LAYERS`` products, ReLU between."""

    def __init__(self, dim: int, out: int):
        super().__init__()
        sizes = [dim] * HYPER_LAYERS + [out]
        for j in range(HYPER_LAYERS):
            setattr(self, f"fc{j + 1}", Dense((sizes[j], sizes[j + 1]),
                                              (sizes[j + 1],)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for j in range(HYPER_LAYERS):
            x = getattr(self, f"fc{j + 1}")(x)
            if j < HYPER_LAYERS - 1:
                x = F.relu(x)
        return x


class UpStep(nn.Module):
    """A 2x2 stride-2 transposed conv (``weight`` (C, 4 D) laid out (c, a,
    b, d) by ``checkpoint.params_from_jax``), with a LayerNorm2d where it
    has one."""

    def __init__(self, cin: int, cout: int, norm: bool):
        super().__init__()
        self.up = Weight(cin, 4 * cout)
        self.up.bias = nn.Parameter(torch.zeros(cout), requires_grad=False)
        self.norm = LayerNorm(cout) if norm else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = up_conv(x, self.up.weight, self.up.bias)
        if self.norm is not None:
            x = self.norm(x)
        return F.gelu(x)


class Prompt(nn.Module):
    """The prompt encoder without a prompt: ``no_mask_embed`` and the
    Fourier matrix ``pe_gaussian`` (2, dim / 2); ``image_pe``, the grid's
    encoding (g g, dim), is computed in float32 each time weights are
    loaded."""

    def __init__(self, dim: int, grid: int):
        super().__init__()
        self.grid = grid
        self.no_mask_embed = nn.Parameter(torch.zeros(dim),
                                          requires_grad=False)
        self.pe_gaussian = nn.Parameter(torch.zeros(2, dim // 2),
                                        requires_grad=False)
        self.register_buffer("image_pe", torch.zeros(grid * grid, dim),
                             persistent=False)
        self.register_load_state_dict_post_hook(Prompt._encode)

    @staticmethod
    def _encode(module: "Prompt", _incompatible) -> None:
        g = module.grid
        centres = (torch.arange(g, dtype=torch.float32) + 0.5) / g
        yy, xx = torch.meshgrid(centres, centres, indexing="ij")
        coords = 2 * torch.stack([xx, yy], dim=-1) - 1
        coords = 2 * np.pi * (coords @ module.pe_gaussian.detach().float()
                              .cpu())
        pe = torch.cat([torch.sin(coords), torch.cos(coords)], dim=-1)
        old = module.image_pe
        module.image_pe = pe.reshape(old.shape).to(old.device, old.dtype)


class Decoder(nn.Module):
    """SAM's mask decoder without the IoU head: (N, g g, dim) image
    embedding -> (N, 4 g, 4 g, classes) logits in the compute dtype."""

    def __init__(self, wd: Widths, classes: int):
        super().__init__()
        dim, heads = wd.prompt_embed_dim, wd.decoder_heads
        inner = dim // wd.attention_downsample_rate
        self.tokens = nn.Parameter(torch.zeros(1 + classes, dim),
                                   requires_grad=False)
        self.layers = nn.ModuleList(
            TwoWayBlock(dim, heads, inner, wd.decoder_mlp_dim, i == 0)
            for i in range(wd.decoder_depth))
        self.final_attn = Attention(dim, heads, inner)
        self.norm_final = LayerNorm(dim, 1e-5)
        self.upscale = nn.ModuleList([UpStep(dim, dim // 4, True),
                                      UpStep(dim // 4, dim // 8, False)])
        self.hyper = nn.ModuleList(Hyper(dim, dim // 8)
                                   for _ in range(classes))
        self.offset = nn.Parameter(torch.zeros(classes), requires_grad=False)

    def forward(self, keys: torch.Tensor, key_pe: torch.Tensor
                ) -> torch.Tensor:
        n, L, dim = keys.shape
        g = math.isqrt(L)
        tokens = self.tokens.expand(n, -1, -1)
        queries = tokens
        for layer in self.layers:
            queries, keys = layer(queries, keys, tokens, key_pe)
        queries = self.norm_final(queries + self.final_attn(
            queries + tokens, keys + key_pe, keys))
        x = keys.view(n, g, g, dim)
        for step in self.upscale:
            x = step(x)
        hyper = torch.stack([mlp(queries[:, 1 + i])
                             for i, mlp in enumerate(self.hyper)], dim=1)
        side = x.shape[1]
        logits = torch.bmm(x.reshape(n, side * side, -1),
                           hyper.transpose(1, 2))
        return logits.view(n, side, side, -1)


class SAMed(nn.Module):
    """NHWC input in [0, 1] -> float32 logits (N, S, S, num_classes); S is
    fixed by the position embedding (``patch * g``)."""

    def __init__(self, cfg: ModelConfig, params: dict):
        super().__init__()
        if cfg.in_channels != 1:
            raise ValueError(f"arch {cfg.arch!r} takes one grey channel, "
                             f"got in_channels={cfg.in_channels}")
        self.cfg = cfg
        wd = self.widths = Widths.of(params)
        g = int(np.shape(params["embed"]["pos"])[0])
        self.size = wd.patch_size * g
        if self.size != cfg.image_size:
            raise ValueError(
                f"arch {cfg.arch!r}: the position embedding holds a {g}x{g} "
                f"grid of {wd.patch_size}-pixel patches, image_size "
                f"{cfg.image_size} needs "
                f"{cfg.image_size // wd.patch_size}")
        classes = int(np.shape(params["decoder"]["tokens"])[0]) - 1
        if classes != cfg.num_classes:
            raise ValueError(f"arch {cfg.arch!r}: the decoder holds "
                             f"{classes} mask tokens, num_classes is "
                             f"{cfg.num_classes}")
        h = wd.hidden_size
        self.embed = nn.Module()
        self.embed.patch = PatchEmbed(wd.patch_size, h)
        self.embed.pos = nn.Parameter(torch.zeros(g, g, h),
                                      requires_grad=False)
        sides = [g if i in wd.global_attn_indexes else wd.window_size
                 for i in range(wd.num_layers)]
        self.encoder = nn.Module()
        self.encoder.blocks = nn.ModuleList(
            Block(h, wd.num_heads, wd.mlp_dim, s, g) for s in sides)
        self.neck = Neck(h, wd.prompt_embed_dim)
        self.prompt = Prompt(wd.prompt_embed_dim, g)
        self.decoder = Decoder(wd, cfg.num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if has_torch_function_unary(x):
            raise NotImplementedError(
                f"arch {self.cfg.arch!r} cannot run in row bands: its "
                f"global attention mixes every token of the slice")
        if tuple(x.shape[1:3]) != (self.size, self.size):
            raise ValueError(f"arch {self.cfg.arch!r} takes {self.size}x"
                             f"{self.size} inputs, got {tuple(x.shape)}")
        x = x.to(compute_dtype(self.cfg))
        with _span("samed.encoder"):
            t = self.embed.patch(x) + self.embed.pos
            for block in self.encoder.blocks:
                t = block(t)
        with _span("samed.neck"):
            emb = self.neck(t)
        with _span("samed.decoder"):
            n, g, _, dim = emb.shape
            keys = emb.reshape(n, g * g, dim) + self.prompt.no_mask_embed
            low = self.decoder(keys, self.prompt.image_pe)
        with _span("samed.upsample"):
            low = low.float() + self.decoder.offset.float()
            logits = _nhwc(F.interpolate(_nchw(low), size=(self.size,
                                                          self.size),
                                         mode="bilinear",
                                         align_corners=False))
        return logits

    def masks(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC input in [0, 1] -> uint8 (N, S, S) first-max class map."""
        return decode_mask(self(x), self.cfg.num_classes)


def init(cfg: ModelConfig, generator: torch.Generator,
         widths: Widths = Widths()) -> dict:
    """A fresh tree at ``widths`` (the published by default) for an
    ``image_size``^2 input and ``num_classes`` mask tokens, float32 numpy:
    LeCun-normal products and convs with zero biases, norms at scale 1 and
    bias 0, the position embedding N(0, 0.02^2), the relative-position
    tables N(0, :data:`REL_POS_STD`^2), the tokens, ``no_mask_embed`` and
    the Fourier matrix N(0, 1), the class offset 0."""
    def normal(shape, std):
        return (torch.randn(shape, generator=generator) * std).numpy()

    def dense(shape: Sequence[int], b_shape, fan_in, bias=True):
        site = {"w": normal(tuple(shape), math.sqrt(1.0 / fan_in))}
        if bias:
            site["b"] = np.zeros(b_shape, np.float32)
        return site

    def norm(c):
        return {"scale": np.ones((c,), np.float32),
                "bias": np.zeros((c,), np.float32)}

    def attn(dim, width):
        heads = widths.decoder_heads
        d = width // heads
        site = {k: dense((dim, heads, d), (heads, d), dim) for k in "qkv"}
        site["out"] = dense((heads, d, dim), (dim,), width)
        return site

    h, p = widths.hidden_size, widths.patch_size
    hd = h // widths.num_heads
    g = cfg.image_size // p
    mlp = widths.mlp_dim
    tree: dict = {"embed": {"patch": dense((p, p, 3, h), (h,), p * p * 3),
                            "pos": normal((g, g, h), 0.02)}}
    blocks = []
    for i in range(widths.num_layers):
        side = g if i in widths.global_attn_indexes else widths.window_size
        blocks.append({
            "ln1": norm(h), "qkv": dense((1, 1, h, 3 * h), (3 * h,), h),
            "rel_pos_h": normal((2 * side - 1, hd), REL_POS_STD),
            "rel_pos_w": normal((2 * side - 1, hd), REL_POS_STD),
            "proj": dense((1, 1, h, h), (h,), h), "ln2": norm(h),
            "fc1": dense((1, 1, h, mlp), (mlp,), h),
            "fc2": dense((1, 1, mlp, h), (h,), mlp)})
    tree["encoder"] = {"blocks": blocks}
    d = widths.prompt_embed_dim
    inner = d // widths.attention_downsample_rate
    tree["neck"] = {"conv1": dense((1, 1, h, d), None, h, bias=False),
                    "ln1": norm(d),
                    "conv2": dense((3, 3, d, d), None, 9 * d, bias=False),
                    "ln2": norm(d)}
    tree["prompt"] = {"no_mask_embed": normal((d,), 1.0),
                      "pe_gaussian": normal((2, d // 2), 1.0)}
    k = cfg.num_classes
    layers = []
    for _ in range(widths.decoder_depth):
        layers.append({
            "self_attn": attn(d, d), "norm1": norm(d),
            "cross_t2i": attn(d, inner), "norm2": norm(d),
            "mlp": {"fc1": dense((1, 1, d, widths.decoder_mlp_dim),
                                 (widths.decoder_mlp_dim,), d),
                    "fc2": dense((1, 1, widths.decoder_mlp_dim, d), (d,),
                                 widths.decoder_mlp_dim)},
            "norm3": norm(d), "norm4": norm(d),
            "cross_i2t": attn(d, inner)})
    sizes = [d] * HYPER_LAYERS + [d // 8]
    tree["decoder"] = {
        "tokens": normal((1 + k, d), 1.0), "layers": layers,
        "final_attn": attn(d, inner), "norm_final": norm(d),
        "upscale": [{"up": dense((2, 2, d, d // 4), (d // 4,), d),
                     "norm": norm(d // 4)},
                    {"up": dense((2, 2, d // 4, d // 8), (d // 8,),
                                 d // 4)}],
        "hyper": [{f"fc{j + 1}": dense((1, 1, sizes[j], sizes[j + 1]),
                                       (sizes[j + 1],), sizes[j])
                   for j in range(HYPER_LAYERS)} for _ in range(k)],
        "offset": np.zeros((k,), np.float32)}
    return tree
