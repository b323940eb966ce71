"""The SAMed cell (``samed.study_masks``) at a small size on the CPU: the
whole run ``correct`` on the sound path and not under each fault of
``test_perfbench_faults.py``; its reference against the port in float32;
the float8 control failing the cell's ``gap_max``; the cell's manifest
entries; the rel-pos attention roofline's reader; the FLOPs a slice against
a count worked by hand.  On the card: the float8 control at the cell's size
is ``test_perfbench_control.py``'s."""

import numpy as np
import pytest
import torch

from perfbench import harness, inputs
from perfbench.calibrate import control_gap
from perfbench.reference import host, samed, transunet
from perfbench.reference.logit_gap import first_max, widest_gap
import test_perfbench_faults as faults

CELL = "samed.study_masks"
#: every kind of part at widths the CPU runs in milliseconds: 64² slices,
#: a 4 x 4 grid, windows of 3 (the grid padded to 6), one global block
SMALL = {"hidden_size": 64, "num_layers": 3, "num_heads": 2, "mlp_dim": 128,
         "window_size": 3, "global_attn_indexes": [1],
         "prompt_embed_dim": 32, "decoder_heads": 2, "decoder_mlp_dim": 64,
         "image_size": 64}
STUDY = {"distinct_slices": 4, "study_slices": 10, "batch": 4,
         "warm_studies": 1, "raw_size": 96}


def _run(monkeypatch, fault=None):
    """A whole run of the cell at the small size, in its own process, as
    ``test_perfbench_faults.py`` runs its cells."""
    monkeypatch.setitem(faults.CELLS, "samed",
                        (CELL, {"config": SMALL, "traffic": STUDY}))
    return faults._run("samed", fault)


def test_sound_run_is_correct(monkeypatch):
    r = _run(monkeypatch)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert r["checks"]["u8_unjudged"]["value"] == 0
    assert set(harness.cell(CELL)["limits"]) <= set(r["checks"])


@pytest.mark.parametrize("fault", sorted(faults.CAUGHT_BY))
def test_broken_run_is_not_correct(monkeypatch, fault):
    r = _run(monkeypatch, fault)
    assert not r["correct"]
    check = r["checks"][faults.CAUGHT_BY[fault]]
    assert check["value"] > check["limit"]


def _cfg(**kw):
    return {**harness.cell(CELL)["config"], **SMALL, **kw}


def test_reference_matches_the_port_in_float32():
    from unetseg_tpu_torch.models import registry

    cfg = _cfg(compute_dtype="float32")
    raws = inputs.slices(21, 2, 64)
    params = inputs.seeded_params(cfg, 9, raws, "cpu", samed)
    u8 = np.stack([host.preprocess_u8(r, 64) for r in raws])
    ref = samed.Reference(params, cfg, "cpu").logits(u8)
    model = registry.build(params, harness.model_config(cfg), "cpu")
    with torch.no_grad():
        port = model(torch.from_numpy(u8).float()[..., None] / 255.0).numpy()
    assert np.abs(ref - port).max() <= 1e-4 * np.abs(ref).max()
    assert widest_gap(ref[0], first_max(port[0])) < 1e-3


def test_control_fails_gap_max_small():
    # the cut widths above on 128² slices (an 8 x 8 grid)
    spec = harness.cell(CELL)
    traffic = dict(spec["traffic"], distinct_slices=4, raw_size=192)
    gap = control_gap(_cfg(image_size=128), traffic, 2 ** 31 + 17, "cpu")
    assert gap > spec["limits"]["gap_max"]


def test_manifest_entries():
    man = harness.manifest()
    spec = harness.cell(CELL, man)
    assert spec["workload"]["chips"] == 1
    assert spec["config"]["arch"] == "samed"
    assert spec["traffic"] == harness.cell("transunet.study_masks",
                                           man)["traffic"]
    reported = {m["name"] for m in spec["per_layer"]}
    assert reported == {m["name"] for m in harness.cell(
        "transunet.study_masks", man)["per_layer"]} \
        - {"attention_roofline_pct.study"} \
        | {"relpos_attention_roofline_pct.study"}
    assert [m["name"] for m in spec["end_to_end"]] == ["setup_s",
                                                       "study_slices_per_s"]
    entry = next(c for c in man["configs"] if c["name"] == "samed")
    assert entry["reduced"] == [] and \
        entry["source"] == spec["config"]["source"]


class _Trace:
    """A trace's kernel lookup over (name, seconds) launches."""

    def __init__(self, launches):
        self.launches = launches

    def kernels(self, pred):
        hit = [s for n, s in self.launches if pred(n)]
        return len(hit), sum(hit)


BIAS = "void (anonymous namespace)::relpos_bias_kernel(__nv_bfloat16 const*)"
FMHA = "fmha_cutlassF_bf16_aligned_64x64_rf_sm80(PyTorchMemEffAttention::" \
    "AttentionKernel<cutlass::bfloat16_t>::Params)"
FUSED = "relpos_attention_fused_kernel(Params)"


def test_relpos_attention_roofline_reader():
    read = harness.reader("relpos_attention_roofline_pct.study")
    cfg = harness.cell(CELL)["config"]
    bound = samed.relpos_attention_bound_s(cfg, 32)
    each = bound / 12 / 0.25 / 2  # half a launch's time each kernel: 25%
    ctx = {"cfg": cfg, "family": samed, "batch": 32, "traced_forwards": 2,
           "trace": _Trace([(BIAS, each)] * 24 + [(FMHA, each)] * 24
                           + [("conv3x3_wgmma", 1.0),
                              ("pytorch_flash::flash_fwd_kernel", 1.0)])}
    assert read(ctx) == pytest.approx(25.0)
    # a fused kernel named with relpos: no backend kernel, read alike
    fused = dict(ctx, trace=_Trace([(FUSED, 2 * each)] * 24))
    assert read(fused) == pytest.approx(25.0)
    # the bias kernel without the backend's (renamed, say): nothing
    assert read(dict(ctx, trace=_Trace([(BIAS, 2 * each)] * 24))) is None
    # another count of either: nothing to read
    assert read(dict(ctx, traced_forwards=3)) is None
    assert read(dict(ctx, trace=_Trace([(BIAS, each)] * 24
                                       + [(FMHA, each)] * 12))) is None
    assert read(dict(ctx, trace=_Trace([(FMHA, each)] * 24))) is None
    assert read(dict(ctx, family=transunet)) is None  # no rel-pos attention
    assert read(dict(ctx, trace=None)) is None


def test_flops_per_slice_by_hand():
    """227.2 GFLOP a 512² slice (two a multiply-add): per block the qkv
    and output products on the tokens it attends over (4 x 768² each: the
    eight windowed blocks on the 42² padded grid, 1,764 tokens), the MLP
    on 1,024 (2 x 768 x 3,072), attention 4 L² 768 a window (9 of 196
    tokens) or over the grid (1,024) and its two decomposed terms (2 L side
    768 each); the patch embedding (256 taps), the neck (1x1 768→256 and
    3x3 256→256); the decoder: per two-way block its self-attention on 4
    tokens at 256, its two cross-attentions at 128 (the image side's
    projections on 1,024 tokens), the MLP on 4 tokens; the final
    attention; the transposed convs (256→4x64 on 32², 64→4x32 on 64²);
    three hypernetworks and the masks' product on 128²."""
    cfg = {"image_size": 512, "num_classes": 3, "in_channels": 1}
    h, L, m = 768, 1024, 3072
    encoder = 2 * L * 256 * h
    for i in range(12):
        side = 32 if i in (2, 5, 8, 11) else 14
        tokens = L if side == 32 else 42 * 42
        windows = tokens // side ** 2
        encoder += 2 * tokens * 4 * h * h + 2 * L * 2 * h * m
        encoder += windows * (4 * side ** 4 * h + 2 * 2 * side ** 3 * h)
    neck = 2 * L * h * 256 + 2 * L * 9 * 256 * 256
    d, t, inner = 256, 4, 128

    def attention(lq, lk, width):
        return 2 * (lq * d * width + 2 * lk * d * width + lq * width * d) \
            + 4 * lq * lk * width
    decoder = 2 * (attention(t, t, d) + attention(t, L, inner)
                   + attention(L, t, inner) + 2 * t * 2 * d * 2048)
    decoder += attention(t, L, inner)
    decoder += 2 * L * d * 4 * 64 + 2 * 4 * L * 64 * 4 * 32
    decoder += 3 * 2 * (2 * d * d + d * 32) + 2 * 128 * 128 * 32 * 3
    assert samed.flops_per_slice(cfg) == encoder + neck + decoder
    assert abs((encoder + neck + decoder) / 1e9 - 227.2) < 0.05
