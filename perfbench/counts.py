"""Operations and bytes of the UNet and of its kernels' launches, from the
configuration alone, and the least time the chip could take for them.

A conv's operations are 2 x 9 x C x D per output pixel; its bytes count
each input read once (activations, weights, bias) and each output written
once, in the compute dtype, at the widths the algorithm needs (the
flagship's one-channel stem counts C = 1, though the kernel reads it padded
to 16).  The model's FLOPs per slice add every 3x3 conv, the 2x2 up-convs
(2 x C x 4 D per input pixel) and the 1x1 head.
"""

from __future__ import annotations

from typing import List, NamedTuple

from perfbench import peaks

BF16 = 2


class Conv(NamedTuple):
    cin: int
    cout: int
    res: int  # the square side of its input and output


def _levels(cfg: dict):
    stem = cfg["stem"]
    side = cfg["image_size"] // stem
    chans = [cfg["base_channels"] * 2 ** i for i in range(cfg["depth"])]
    bottleneck = cfg["base_channels"] * 2 ** cfg["depth"]
    return stem, side, chans, bottleneck


def convs(cfg: dict) -> List[Conv]:
    """Every 3x3 conv of one forward, encoder first, in the order run."""
    stem, side, chans, bottleneck = _levels(cfg)
    out, cin = [], cfg.get("in_channels", 1) * stem * stem
    for i, c in enumerate(chans):
        out += [Conv(cin, c, side >> i), Conv(c, c, side >> i)]
        cin = c
    d = cfg["depth"]
    out += [Conv(chans[-1], bottleneck, side >> d),
            Conv(bottleneck, bottleneck, side >> d)]
    for i in reversed(range(d)):
        out += [Conv(2 * chans[i], chans[i], side >> i),
                Conv(chans[i], chans[i], side >> i)]
    return out


def fused_last_level(cfg: dict) -> bool:
    """Whether the program runs the last decoder level, head and argmax in
    one launch (its K6): a plain bf16 stem-1 UNet of 16 to 96 channels at
    the first level and at most 8 classes."""
    return (cfg["arch"] == "unet" and cfg["stem"] == 1
            and cfg["compute_dtype"] == "bfloat16"
            and 16 <= cfg["base_channels"] <= 96
            and cfg["base_channels"] % 16 == 0 and cfg["num_classes"] <= 8)


def conv_launches(cfg: dict) -> List[Conv]:
    """The 3x3 convs one forward launches in the conv kernel (K1/K2): all
    of them but the last level's two where that level is fused."""
    cs = convs(cfg)
    return cs[:-2] if fused_last_level(cfg) else cs


def conv_flops(c: Conv, batch: int = 1) -> float:
    return 2.0 * 9 * c.cin * c.cout * c.res * c.res * batch


def conv_bytes(c: Conv, batch: int = 1, elem: int = BF16) -> float:
    px = c.res * c.res * batch
    return float(elem * (px * c.cin + 9 * c.cin * c.cout + c.cout
                         + px * c.cout))


def bound_s(flops: float, nbytes: float) -> float:
    """The least time: the larger of operations at the bf16 peak and bytes
    at the memory peak."""
    return max(flops / peaks.BF16_FLOPS, nbytes / peaks.HBM_BYTES_PER_S)


def conv_bound_s(cfg: dict, batch: int) -> float:
    """The summed bound of one forward's conv-kernel launches at ``batch``."""
    return sum(bound_s(conv_flops(c, batch), conv_bytes(c, batch))
               for c in conv_launches(cfg))


def last_level(cfg: dict, batch: int):
    """(operations, bytes) of one fused last-level launch: the up-conv of
    the second level's output, the two 3x3 convs over [skip, up], the head,
    and one uint8 class per pixel written."""
    stem, side, chans, _ = _levels(cfg)
    c = chans[0]
    cup = chans[1] if len(chans) > 1 else 2 * c
    k = cfg["num_classes"]
    px = side * side * batch
    flops = (2.0 * cup * 4 * c * (px // 4) + 2.0 * 9 * 2 * c * c * px
             + 2.0 * 9 * c * c * px + 2.0 * c * k * px)
    nbytes = (BF16 * ((px // 4) * cup + px * c
                      + cup * 4 * c + c + 9 * 2 * c * c + c + 9 * c * c + c
                      + c * k + k) + px)
    return flops, float(nbytes)


def dec1_bound_s(cfg: dict, batch: int) -> float:
    return bound_s(*last_level(cfg, batch))


def model_flops_per_slice(cfg: dict) -> float:
    """Every multiply-add of one slice's forward, times two."""
    stem, side, chans, bottleneck = _levels(cfg)
    total = sum(conv_flops(c) for c in convs(cfg))
    cin = bottleneck
    for i in reversed(range(cfg["depth"])):
        r_in = side >> (i + 1)
        total += 2.0 * cin * 4 * chans[i] * r_in * r_in
        cin = chans[i]
    total += 2.0 * chans[0] * cfg["num_classes"] * stem * stem * side * side
    return total
