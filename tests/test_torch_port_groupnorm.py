"""NHWC GroupNorm (``ops/groupnorm.py``; on the card the K9 kernel of
``csrc/groupnorm_nhwc.cu``) for TransUNet's R50.

On the CPU: the module against the former composition of PyTorch ops on
the SMALL variants of ``test_torch_port_transunet.py`` (bit for bit), a
call a norm and none counted as a kernel launch, the norms' shapes, the
kernel's chunk plan on the 52 norms of the published widths, the plain
path against the float64 oracle, and a numpy emulation of the kernel's
statistics (Welford within a thread, Chan's merges across rows, channels,
chunks and the shuffle tree, in its order) against float64.

Marked ``card`` (skipped without one; on the card: ``python3 -m pytest
tests/test_torch_port_groupnorm.py -q -m card --noconftest -p
no:cacheprovider``, since this directory's conftest imports JAX): the
kernel against a float64 GroupNorm on every published norm shape at
batches 32 and 1, without ReLU, with it, and with it and a residual;
eager against graph replay, bit for bit; the counter under replays; the
refusals, float32 among them.
"""

import numpy as np
import pytest
import torch

from test_torch_port_transunet import VARIANTS, _cfg, _mcfg, _setup, _x
from unetseg_tpu_torch import graphs
from unetseg_tpu_torch.config import ModelConfig
from unetseg_tpu_torch.models import registry, transunet
from unetseg_tpu_torch.ops import groupnorm

#: Both paths within GN_TOL of the terms' magnitude, the kernel within one
#: rounding and KERNEL_STATS_TOL of its operands' (``ops/groupnorm.py``
#: gives the readings they were set from; ``chip_smoke.py`` holds a
#: forward's own norms to the same).
GN_TOL = groupnorm.ORACLE_TOL
KERNEL_STATS_TOL = groupnorm.ORACLE_STATS_TOL


def norm_shapes(wd: transunet.Widths, size: int) -> list:
    """(side, C, groups, eps, relu, residual) of each GroupNorm of a
    TransUNet forward at ``size``^2, in the order the forward runs them."""
    r = wd.resnet_width
    out = [(size // 2, r, transunet.GN_GROUPS, 1e-6, True, False)]
    side = (size // 2 - 3) // 2 + 1  # the max-pool, no padding
    for i, (units, mid, cout) in enumerate(wd.stages()):
        for j in range(units):
            stride = 2 if i > 0 and j == 0 else 1
            out_side = (side - 1) // stride + 1
            if j == 0:
                out.append((out_side, cout, cout, 1e-5, False, False))
            out += [(side, mid, transunet.GN_GROUPS, 1e-6, True, False),
                    (out_side, mid, transunet.GN_GROUPS, 1e-6, True, False),
                    (out_side, cout, transunet.GN_GROUPS, 1e-6, True, True)]
            side = out_side
    return out


PUBLISHED = norm_shapes(transunet.Widths(), 512)
#: The published norms' distinct (side, C, groups, eps).
DISTINCT = sorted({s[:4] for s in PUBLISHED})


def _former_group_norm(module, x, relu=False):
    """``transunet.GroupNorm.forward`` as it was before the kernel."""
    n, h, w, c = x.shape
    g = module.groups
    xv = x.reshape(n, h * w, g, c // g)
    count = h * w * (c // g)
    mean = xv.sum(dim=(1, 3), keepdim=True, dtype=torch.float32) / count
    norm = torch.linalg.vector_norm(xv, dim=(1, 3), keepdim=True,
                                    dtype=torch.float32)
    var = (norm * norm / count - mean * mean).clamp_min_(0)
    scale = torch.rsqrt(var + module.eps) * \
        module.weight.float().view(1, 1, g, c // g)
    shift = module.bias.float().view(1, 1, g, c // g) - mean * scale
    y = torch.addcmul(shift.to(x.dtype), xv, scale.to(x.dtype))
    if relu:
        y.relu_()
    return y.view(n, h, w, c)


def _former_bottleneck(unit, x):
    """``transunet.Bottleneck.forward`` as it was before the kernel."""
    residual = x
    if unit.downsample is not None:
        residual = _former_group_norm(unit.gn_proj, unit.downsample(x))
    y = _former_group_norm(unit.gn1, unit.conv1(x), relu=True)
    y = _former_group_norm(unit.gn2, unit.conv2(y), relu=True)
    y = _former_group_norm(unit.gn3, unit.conv3(y))
    return torch.relu_(residual + y)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_module_equals_the_former_composition(variant, dtype, monkeypatch):
    cfg = _cfg(compute_dtype=dtype, **VARIANTS[variant])
    tree, u8 = _setup(cfg, 12)
    model = registry.build(tree, _mcfg(cfg), "cpu")
    with torch.no_grad():
        now = model(_x(u8))
        monkeypatch.setattr(transunet.GroupNorm, "forward",
                            _former_group_norm)
        monkeypatch.setattr(transunet.Bottleneck, "forward",
                            _former_bottleneck)
        before = model(_x(u8))
    assert torch.equal(now, before)


def _recorded(monkeypatch):
    calls = []
    inner = groupnorm.group_norm

    def record(x, weight, bias, groups, eps, relu=False, residual=None):
        calls.append((x.shape[1], x.shape[-1], groups, eps, relu,
                      residual is not None))
        assert x.shape[1] == x.shape[2]
        return inner(x, weight, bias, groups, eps, relu, residual)
    monkeypatch.setattr(transunet.groupnorm_ops, "group_norm", record)
    return calls


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_counter_counts_a_call_a_norm(variant, monkeypatch):
    """A forward makes one call a norm; on the CPU none reaches the kernel,
    so the kernel's counter stays at 0."""
    cfg = _cfg(compute_dtype="bfloat16", **VARIANTS[variant])
    tree, u8 = _setup(cfg, 13)
    model = registry.build(tree, _mcfg(cfg), "cpu")
    units = cfg["resnet_units"]
    calls = _recorded(monkeypatch)
    graphs.reset_launches()
    with torch.no_grad():
        model(_x(u8))
    assert len(calls) == 1 + 3 * sum(units) + len(units)
    assert groupnorm.LAUNCHES["groupnorm_nhwc"] == 0


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_norm_shapes_are_the_forwards(variant, monkeypatch):
    cfg = _cfg(**VARIANTS[variant])
    tree, u8 = _setup(cfg, 14, 1)
    model = registry.build(tree, _mcfg(cfg), "cpu")
    calls = _recorded(monkeypatch)
    with torch.no_grad():
        model(_x(u8))
    assert calls == norm_shapes(model.widths, cfg["image_size"])


def test_the_published_forward_runs_52_norms():
    assert len(PUBLISHED) == 52
    # the elements a slice the norms cover, and those of the residual adds
    assert sum(s * s * c for s, c, *_ in PUBLISHED) == 59_115_008
    assert sum(s * s * c for s, c, *_, res in PUBLISHED if res) == 30_212_864


@pytest.mark.parametrize("n", [32, 1])
def test_plan_covers_every_published_norm(n):
    for side, c, groups, _eps, _relu, _res in PUBLISHED:
        hw = side * side
        p = groupnorm.plan(n, hw, c, groups)
        cols = c // 8
        assert p.rows == groupnorm.THREADS // cols and p.rows * cols <= \
            groupnorm.THREADS
        assert p.pixels % p.rows == 0
        iters = p.pixels // p.rows
        assert groupnorm.UNROLL <= iters <= groupnorm.MAX_ITERS
        # the chunks cover the image, none empty
        assert (p.chunks - 1) * p.pixels < hw <= p.chunks * p.pixels
        # the grid fills the card, or the chunk is at its floor
        assert n * p.chunks >= groupnorm.MIN_BLOCKS or \
            iters == groupnorm.UNROLL
        if iters < groupnorm.MAX_ITERS:  # halved only while short of blocks
            assert n * -(-hw // (2 * p.pixels)) < groupnorm.MIN_BLOCKS
        assert p.scratch == 2 * n * c + 2 * n * p.chunks * groups


@pytest.mark.parametrize("c, groups", [(64, 6), (12, 4), (2056, 8),
                                       (64, 0)])
def test_plan_and_wrapper_refuse(c, groups):
    with pytest.raises(ValueError):
        groupnorm.plan(2, 100, c, groups)
    if groups and c % groups:  # the wrapper refuses it on any device
        x = torch.zeros((1, 2, 2, c), dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="groups"):
            groupnorm.group_norm(x, torch.ones(c), torch.zeros(c), groups,
                                 1e-6)


def test_residual_only_with_relu():
    x = torch.ones((1, 2, 2, 64), dtype=torch.bfloat16)
    w, b = torch.ones(64), torch.zeros(64)
    with pytest.raises(ValueError, match="only with relu"):
        groupnorm.group_norm(x, w, b, 32, 1e-6, residual=x)
    assert torch.equal(
        groupnorm.group_norm(x, w, b, 32, 1e-6, True, x),
        groupnorm.group_norm_plain(x, w, b, 32, 1e-6, True, x))


def test_cpu_norm_matches_the_oracle():
    """The plain path on the CPU against :func:`groupnorm.oracle_float64`
    within ``GN_TOL``, with ReLU and residual, at one channel a group too."""
    g = torch.Generator().manual_seed(6)
    for c, groups in ((64, 32), (32, 32)):
        x = (torch.randn((2, 7, 7, c), generator=g) * 1.5 + 2).bfloat16()
        w = (torch.randn((c,), generator=g) * 0.5 + 1).bfloat16()
        b = (torch.randn((c,), generator=g) * 0.5).bfloat16()
        r = torch.randn((2, 7, 7, c), generator=g).bfloat16()
        for relu, res in ((False, None), (True, None), (True, r)):
            got = groupnorm.group_norm(x, w, b, groups, 1e-6, relu, res)
            y64, terms, _ = groupnorm.oracle_float64(x, w, b, groups, 1e-6,
                                                     relu, res)
            assert bool(((got.double() - y64).abs()
                         <= GN_TOL * terms).all()), (c, relu)


# -- the kernel's arithmetic, emulated in numpy float32 ----------------------

def _merge(n, mean, m2, nb, mean_b, m2_b):
    """``merge`` of groupnorm_nhwc.cu, elementwise in float32."""
    f32 = np.float32
    total = n + nb
    d = mean_b - mean
    with np.errstate(divide="ignore", invalid="ignore"):
        f = np.where(total > 0, nb / total, f32(0)).astype(f32)
    m_mean = (mean + d * f).astype(f32)
    m_m2 = (m2 + m2_b + d * d * n * f).astype(f32)
    take_b = (n == 0) & (nb > 0)
    keep = nb == 0
    mean = np.where(keep, mean, np.where(take_b, mean_b, m_mean))
    m2 = np.where(keep, m2, np.where(take_b, m2_b, m_m2))
    return (np.where(keep, n, total).astype(f32), mean.astype(f32),
            m2.astype(f32))


def emulate_statistics(x: np.ndarray, groups: int, p: groupnorm.Plan):
    """(mean, var) float32 (N, G) as the kernels compute them from x (N,
    HW, C) float32: statistics blocks, then the finalize warps."""
    f32 = np.float32
    n, hw, c = x.shape
    rows, pixels, chunks = p.rows, p.pixels, p.chunks
    iters = pixels // rows
    xp = np.zeros((n, chunks * pixels, c), f32)
    xp[:, :hw] = x
    valid = (np.arange(chunks * pixels) < hw).reshape(chunks, iters, rows)
    xr = xp.reshape(n, chunks, iters, rows, c)
    mean = np.zeros((n, chunks, rows, c), f32)
    m2 = np.zeros_like(mean)
    cnt = np.zeros((chunks, rows), f32)
    for i in range(iters):  # pixel p = chunk start + row + i rows
        v = valid[:, i, :]
        cnt = (cnt + v).astype(f32)
        with np.errstate(divide="ignore"):
            inv = np.where(v, f32(1) / cnt, f32(0)).astype(f32)
        xi = xr[:, :, i]
        d = (xi - mean).astype(f32)
        new = (mean + d * inv[None, :, :, None]).astype(f32)
        m2 = np.where(v[None, :, :, None], m2 + d * (xi - new), m2).astype(f32)
        mean = np.where(v[None, :, :, None], new, mean)
    # rows -> channels, in row order
    cn = np.zeros((n, chunks, c), f32)
    cm, cq = np.zeros_like(cn), np.zeros_like(cn)
    for r in range(rows):
        nr = np.broadcast_to(cnt[None, :, r, None], cn.shape)
        cn, cm, cq = _merge(cn, cm, cq, nr, mean[:, :, r], m2[:, :, r])
    # channels -> groups, in channel order
    cpg = c // groups
    cm = cm.reshape(n, chunks, groups, cpg)
    cq = cq.reshape(n, chunks, groups, cpg)
    n_chunk = np.broadcast_to(cn[:, :, :1], (n, chunks, groups))
    gn = np.zeros((n, chunks, groups), f32)
    gm, gq = np.zeros_like(gn), np.zeros_like(gn)
    for j in range(cpg):
        gn, gm, gq = _merge(gn, gm, gq, n_chunk, cm[..., j], cq[..., j])
    # finalize: lane l takes chunks l, l + 32, ..., then the shuffle tree
    pix = (np.minimum((np.arange(chunks) + 1) * pixels, hw)
           - np.arange(chunks) * pixels).astype(f32) * f32(cpg)
    ln = np.zeros((n, 32, groups), f32)
    lm, lq = np.zeros_like(ln), np.zeros_like(ln)
    for k in range(chunks):
        lane = k % 32
        ln[:, lane], lm[:, lane], lq[:, lane] = _merge(
            ln[:, lane], lm[:, lane], lq[:, lane],
            np.full((n, groups), pix[k], f32), gm[:, k], gq[:, k])
    off = 16
    while off:
        a = slice(0, off)
        b = slice(off, 2 * off)
        ln[:, a], lm[:, a], lq[:, a] = _merge(ln[:, a], lm[:, a], lq[:, a],
                                              ln[:, b], lm[:, b], lq[:, b])
        off //= 2
    return lm[:, 0], (lq[:, 0] / ln[:, 0]).astype(f32)


def _float64_statistics(x: np.ndarray, groups: int):
    n, hw, c = x.shape
    xg = x.astype(np.float64).reshape(n, hw, groups, c // groups)
    return xg.mean(axis=(1, 3)), xg.var(axis=(1, 3))


@pytest.mark.parametrize("n, side, c, groups, offset", [
    (2, 15, 64, 32, 0.0),     # ragged chunks (225 pixels)
    (1, 127, 64, 32, 0.0),    # stage 1's side at batch 1: many chunks, lanes
    (3, 8, 256, 256, 0.0),    # one channel a group (the projection's)
    (2, 9, 96, 32, 0.0),      # 12 columns: 21 rows, 4 threads idle
    (2, 16, 1024, 32, 0.0),   # 32 channels a group, 2 rows
    (2, 33, 128, 32, 40.0),   # a mean 40x the spread
])
def test_emulated_statistics_match_float64(n, side, c, groups, offset):
    rng = np.random.default_rng(side * c + groups)
    x = torch.from_numpy(rng.standard_normal((n, side * side, c)) + offset)
    x = x.to(torch.bfloat16).float().numpy()
    p = groupnorm.plan(n, side * side, c, groups)
    mean, var = emulate_statistics(x, groups, p)
    mean64, var64 = _float64_statistics(x, groups)
    assert np.abs(mean - mean64).max() <= 1e-6 * (np.abs(mean64).max() + 1)
    assert np.abs(var - var64).max() <= 1e-5 * var64.max()


# -- on the card --------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _case(dev, n, side, c, groups, seed):
    """bf16 (x, weight, bias, residual) for one norm: x off-centre per
    channel, so the variance is not the mean square."""
    g = torch.Generator(device=dev).manual_seed(seed)
    shape = (n, side, side, c)
    centre = torch.randn((c,), generator=g, device=dev) * 2
    x = torch.randn(shape, generator=g, device=dev) * 1.5 + centre
    w = torch.randn((c,), generator=g, device=dev) * 0.5 + 1
    b = torch.randn((c,), generator=g, device=dev) * 0.5
    r = torch.randn(shape, generator=g, device=dev)
    return [t.to(torch.bfloat16) for t in (x, w, b, r)]


@pytest.mark.card
@pytest.mark.parametrize("shape", DISTINCT, ids=lambda s: "x".join(
    map(str, s[:3])))
def test_kernel_against_float64(card, shape):
    side, c, groups, eps = shape
    worst = {}
    for n in (32, 1):
        x, w, b, r = _case(card, n, side, c, groups, side * c + n)
        for relu, res in ((False, None), (True, None), (True, r)):
            got = groupnorm.group_norm(x, w, b, groups, eps, relu, res)
            plain = groupnorm.group_norm_plain(x, w, b, groups, eps,
                                               relu, res)
            y64, mag, operands = groupnorm.oracle_float64(
                x, w, b, groups, eps, relu, res)
            err_k = (got.double() - y64).abs()
            err_p = (plain.double() - y64).abs()
            key = (n, relu, res is not None)
            beyond = (err_k - 2.0 ** -8 * y64.abs()) / operands
            worst[key] = ((err_k / mag).max().item(),
                          (err_p / mag).max().item(),
                          beyond.max().item())
            assert got.dtype == torch.bfloat16 and got.shape == x.shape
            assert bool((err_k <= GN_TOL * mag).all()), key
            assert bool((err_p <= GN_TOL * mag).all()), key
            assert beyond.max().item() <= KERNEL_STATS_TOL, key
    print(f"groupnorm {shape}: worst error / magnitude (kernel, plain), "
          f"the kernel's beyond one rounding / operands: {worst}")


def _published(card):
    cfg = ModelConfig(arch="transunet")
    tree = transunet.init(cfg, torch.Generator().manual_seed(3))
    return tree, cfg


@pytest.mark.card
def test_graph_replay_is_bit_equal_and_counts_52_a_forward(card):
    from unetseg_tpu_torch.engine import InferenceEngine
    from unetseg_tpu_torch.graphs import ForwardGraph

    tree, cfg = _published(card)
    eng = InferenceEngine(tree, cfg, str(card))
    eng.compile(2)
    g = torch.Generator(device=card).manual_seed(4)
    u8 = torch.randint(0, 256, (2, 512, 512), generator=g, device=card,
                       dtype=torch.uint8)
    x = u8.float()[..., None] / 255.0
    with torch.inference_mode():
        graphs.reset_launches()
        f0, r0 = eng.forwards, eng.graph_replays
        for _ in range(3):
            got = eng._pipeline(u8)
        torch.cuda.synchronize()
        assert eng.forwards - f0 == eng.graph_replays - r0 == 3
        assert groupnorm.LAUNCHES["groupnorm_nhwc"] == 3 * 52
        assert torch.equal(got, eng.model.masks(x))
        # the logits themselves, captured and replayed
        eager = eng.model(x)
        graph = ForwardGraph(eng.model, x.clone())
        assert torch.equal(graph.replay(x), eager)


@pytest.mark.card
def test_kernel_refusals_and_the_float32_path(card):
    x, w, b, r = _case(card, 2, 8, 64, 32, 5)
    with pytest.raises(ValueError, match="contiguous"):
        groupnorm.group_norm(x.transpose(1, 2), w, b, 32, 1e-6)
    with pytest.raises(ValueError, match="contiguous"):
        groupnorm.group_norm(x, w, b, 32, 1e-6, True, r.transpose(1, 2))
    with pytest.raises(ValueError, match="groups"):
        groupnorm.group_norm(x, w, b, 24, 1e-6)
    with pytest.raises(ValueError, match="only with relu"):
        groupnorm.group_norm(x, w, b, 32, 1e-6, residual=r)
    with pytest.raises(TypeError):
        groupnorm.group_norm(x.half(), w.half(), b.half(), 32, 1e-6)
    with pytest.raises(TypeError):  # weights of another dtype than x
        groupnorm.group_norm(x, w.float(), b.float(), 32, 1e-6)
    # float32 on the card: the kernel refuses it, and counts nothing
    graphs.reset_launches()
    xf, wf, bf, rf = (t.float() for t in (x, w, b, r))
    with pytest.raises(TypeError, match="bf16 only"):
        groupnorm.group_norm(xf, wf, bf, 32, 1e-6, True, rf)
    assert groupnorm.LAUNCHES["groupnorm_nhwc"] == 0
    # nor could a float32 TransUNet run on the card before: its attention
    # (FlashAttention, pinned) takes no float32
    q = torch.zeros((1, 2, 16, 64), device=card)
    with pytest.raises(RuntimeError):
        transunet.attention_ops.attention(q, q, q)
