"""The TransUNet cell (``transunet.study_masks``) at a small size on the
CPU: the whole run ``correct`` on the sound path and not under each fault
of ``test_perfbench_faults.py``; its reference against the port in float32;
the float8 control failing the cell's ``gap_max``; the attention roofline's
reader.  On the card: the attention launches a captured forward's replays
count."""

import numpy as np
import pytest
import torch

from perfbench import harness, inputs, readers
from perfbench.calibrate import control_gap
from perfbench.reference import host, transunet, unet
from perfbench.reference.logit_gap import first_max, widest_gap
import test_perfbench_faults as faults

CELL = "transunet.study_masks"
#: every kind of part at widths the CPU runs in milliseconds
SMALL = {"hidden_size": 64, "num_layers": 2, "num_heads": 2, "mlp_dim": 128,
         "resnet_units": [1, 1, 1], "resnet_width": 32,
         "decoder_head_channels": 64, "decoder_channels": [32, 32, 16, 16],
         "image_size": 64}
STUDY = {"distinct_slices": 4, "study_slices": 10, "batch": 4,
         "warm_studies": 1, "raw_size": 96}


def _run(monkeypatch, fault=None):
    """A whole run of the cell at the small size, in its own process, as
    ``test_perfbench_faults.py`` runs its cells."""
    monkeypatch.setitem(faults.CELLS, "transunet",
                        (CELL, {"config": SMALL, "traffic": STUDY}))
    return faults._run("transunet", fault)


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
    params = inputs.seeded_params(cfg, 9, raws, "cpu", transunet)
    u8 = np.stack([host.preprocess_u8(r, 64) for r in raws])
    ref = transunet.Reference(params, cfg, "cpu").logits(u8)
    model = registry.build(params, harness.model_config(cfg), "cpu")
    with torch.no_grad():
        port = model(torch.from_numpy(u8).float()[..., None] / 255.0).numpy()
    assert np.abs(ref - port).max() <= 1e-4 * np.abs(ref).max()
    assert widest_gap(ref[0], first_max(port[0])) < 1e-3


def test_control_fails_gap_max_small():
    # the cell's widths on 128² slices: the control's widest gap grows with
    # the pixels judged (1.9-4.0 here on six seeds, 5.1-10.5 at the cell's
    # size), and at 64² with the cut widths above it falls to 0.6-2.2,
    # around the limit
    spec = harness.cell(CELL)
    traffic = dict(spec["traffic"], distinct_slices=4, raw_size=192)
    cfg = dict(spec["config"], image_size=128)
    gap = control_gap(cfg, traffic, 2 ** 31 + 17, "cpu")
    assert gap > spec["limits"]["gap_max"]


class _Trace:
    """A trace's kernel lookup over (name, seconds) launches."""

    def __init__(self, launches):
        self.launches = launches

    def kernels(self, pred):
        hit = [s for n, s in self.launches if pred(n)]
        return len(hit), sum(hit)


def test_attention_roofline_reader():
    read = harness.reader("attention_roofline_pct.study")
    cfg = harness.cell(CELL)["config"]
    bound = transunet.attention_bound_s(cfg, 32)
    flash = "void pytorch_flash::flash_fwd_kernel<Flash_fwd_kernel_traits>"
    ctx = {"cfg": cfg, "family": transunet, "batch": 32,
           "traced_forwards": 2,
           "trace": _Trace([(flash, bound / 12 / 0.3)] * 24
                           + [("conv3x3_wgmma", 1.0)])}
    assert read(ctx) == pytest.approx(30.0)
    assert read(dict(ctx, traced_forwards=3)) is None  # 24 != 3 x 12
    assert read(dict(ctx, family=unet)) is None  # a family with no attention
    assert readers.roofline_pct(ctx, "flash_fwd", 12, bound) == read(ctx)


@pytest.mark.card
def test_graph_replays_count_attention(card):
    from unetseg_tpu_torch.engine import InferenceEngine
    from unetseg_tpu_torch.ops import attention

    cfg = _cfg(compute_dtype="bfloat16")
    raws = inputs.slices(22, 4, 64)
    params = inputs.seeded_params(cfg, 10, raws, card, transunet)
    eng = InferenceEngine(params, harness.model_config(cfg), str(card))
    eng.compile(4)
    u8 = torch.as_tensor(np.stack([host.preprocess_u8(r, 64) for r in raws]),
                         device=card)
    attention.reset_launches()
    f0, r0 = eng.forwards, eng.graph_replays
    with torch.inference_mode():
        for _ in range(3):
            got = eng._pipeline(u8)
        torch.cuda.synchronize()
        assert eng.forwards - f0 == eng.graph_replays - r0 == 3
        assert attention.LAUNCHES["attention"] == 3 * SMALL["num_layers"]
        eager = eng.model.masks(u8.float()[..., None] / 255.0)
    assert torch.equal(got, eager)
