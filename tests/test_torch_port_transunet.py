"""TransUNet (``models/transunet.py``, the port's own family) on the CPU at
small sizes, against the benchmark's plain reference
(``perfbench/reference/transunet.py``, float32 PyTorch that imports nothing
of the program): the float32 logits, the bf16 model within a tolerance the
float8 control fails, the masks, the spans, the attention counter, a study
through the runner and the engine, the checkpoint layout, the refusals, and
the FLOP count at the published widths.  The count of attention launches
under a captured graph's replays needs the card
(``perfbench/tests/test_perfbench_transunet.py``)."""

import dataclasses

import numpy as np
import pytest
import torch

from perfbench import inputs
from perfbench.reference import host, transunet as ref_t
from perfbench.reference.logit_gap import first_max, widest_gap
from unetseg_tpu_torch import checkpoint, engine as engine_mod, graphs
from unetseg_tpu_torch.config import ModelConfig
from unetseg_tpu_torch.models import registry, transunet
from unetseg_tpu_torch.ops import attention
from unetseg_tpu_torch.ops.decode import decode_mask

#: A small TransUNet: every kind of part, at widths the CPU runs in
#: milliseconds (GroupNorm's 32 groups need widths of 32 and more).
SMALL = dict(arch="transunet", in_channels=1, num_classes=3, image_size=64,
             compute_dtype="float32", hidden_size=64, num_layers=2,
             num_heads=2, mlp_dim=128, resnet_units=[1, 1, 1],
             resnet_width=32, decoder_head_channels=64,
             decoder_channels=[32, 32, 16, 16], n_skip=3)
VARIANTS = {
    "small": {},
    "one_skip": dict(n_skip=1),
    "deeper": dict(resnet_units=[2, 1, 2], num_heads=4, num_layers=3),
    "size_32": dict(image_size=32, decoder_channels=[32, 16, 16, 16]),
}
#: bf16 against the float32 reference, widest logit gap over the slice's
#: logit scale: bf16's 8-bit mantissa moves the worst pixel by 0.017-0.094
#: of the scale at this size, float8 e4m3's 4-bit one (the control) by
#: 0.55-2.23 (seeds 6-11, three slices each); 0.25 lies 2.7x above the
#: one and 2.2x below the other.
BF16_GAP = 0.25


def _cfg(**kw) -> dict:
    return {**SMALL, **kw}


def _mcfg(cfg: dict) -> ModelConfig:
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: v for k, v in cfg.items() if k in names})


def _setup(cfg: dict, seed: int, n: int = 2):
    """(seeded tree centred as the benchmark centres it, u8 slices)."""
    size = cfg["image_size"]
    raws = inputs.slices(seed, n, size)
    tree = inputs.seeded_params(cfg, seed, raws, "cpu", ref_t)
    u8 = np.stack([host.preprocess_u8(r, size) for r in raws])
    return tree, u8


def _x(u8: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(u8).float()[..., None] / 255.0


def _port(tree, cfg, u8, **kw):
    model = registry.build(tree, _mcfg({**cfg, **kw}), "cpu")
    with torch.no_grad():
        return model(_x(u8)).numpy()


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_float32_logits_match_the_reference(variant):
    cfg = _cfg(**VARIANTS[variant])
    tree, u8 = _setup(cfg, 5)
    ref = ref_t.Reference(tree, cfg, "cpu").logits(u8)
    port = _port(tree, cfg, u8)
    assert port.shape == ref.shape == (*u8.shape, 3)
    # float32 both sides, other summation orders (the port's GroupNorm
    # statistics, StdConv standardised once, the grey root summed): 1e-4
    # of the logits' scale is a hundred times the differences seen
    assert np.abs(ref - port).max() <= 1e-4 * np.abs(ref).max()
    assert np.array_equal(first_max(ref), first_max(port))


@pytest.mark.parametrize("seed", [6, 7, 10])  # the narrowest control, the
def test_bf16_within_a_tolerance_the_control_fails(seed):  # widest bf16
    cfg = _cfg(compute_dtype="bfloat16")
    tree, u8 = _setup(cfg, seed, 3)
    ref = ref_t.Reference(tree, cfg, "cpu").logits(u8)
    ctl = ref_t.Reference(tree, cfg, "cpu", quant="fp8").logits(u8)
    port = _port(tree, cfg, u8)
    g_port = max(widest_gap(r, first_max(p)) for r, p in zip(ref, port))
    g_ctl = max(widest_gap(r, first_max(c)) for r, c in zip(ref, ctl))
    assert g_port < BF16_GAP < g_ctl


def test_masks_are_the_decoded_logits():
    cfg = _cfg(compute_dtype="bfloat16")
    tree, u8 = _setup(cfg, 8)
    model = registry.build(tree, _mcfg(cfg), "cpu")
    with torch.no_grad():
        masks = model.masks(_x(u8))
        assert masks.dtype == torch.uint8
        assert torch.equal(masks, decode_mask(model(_x(u8)), 3))


def test_spans_under_a_profiler(monkeypatch):
    cfg = _cfg()
    tree, u8 = _setup(cfg, 9, 1)
    model = registry.build(tree, _mcfg(cfg), "cpu")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.no_grad():
            model(_x(u8))
    events = prof.events()
    stages = ["transunet.backbone", "transunet.embed", "transunet.encoder",
              "transunet.decoder"]
    assert [e.name for e in events if e.name.startswith("transunet.")] \
        == stages

    def stage_of(e):
        while e is not None and not e.name.startswith("transunet."):
            e = e.cpu_parent
        return e.name if e is not None else None
    # the attention inside the encoder's span, the convs' kernels where
    # they run
    sdpa = [e for e in events
            if e.name == "aten::scaled_dot_product_attention"]
    assert len(sdpa) == 2
    assert {stage_of(e) for e in sdpa} == {"transunet.encoder"}
    assert {stage_of(e) for e in events if e.name == "aten::max_pool2d"} \
        == {"transunet.backbone"}
    assert {stage_of(e) for e in events
            if e.name == "aten::upsample_bilinear2d"} == {"transunet.decoder"}

    # profiler off: no span is entered
    def no_span(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", no_span)
    with torch.no_grad():
        model(_x(u8))


@pytest.mark.parametrize("layers", [1, 3])
def test_attention_counter_counts_a_launch_a_layer(layers):
    cfg = _cfg(num_layers=layers)
    tree, u8 = _setup(cfg, 10, 1)
    model = registry.build(tree, _mcfg(cfg), "cpu")
    graphs.reset_launches()
    with torch.no_grad():
        model(_x(u8))
        model.masks(_x(u8))
    assert attention.LAUNCHES["attention"] == 2 * layers == \
        2 * ref_t.attention_launches(cfg)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_widths_read_from_the_tree(variant):
    cfg = _cfg(**VARIANTS[variant])
    wd = transunet.Widths(
        **{f.name: tuple(cfg[f.name]) if isinstance(cfg[f.name], list)
           else cfg[f.name] for f in dataclasses.fields(transunet.Widths)})
    # the program's own init and the reference's, at the same widths
    for tree in (transunet.init(_mcfg(cfg), torch.Generator().manual_seed(1),
                                wd),
                 ref_t.init(cfg, torch.Generator().manual_seed(1), "cpu")):
        assert transunet.Widths.of(tree) == wd
    assert transunet.Widths.of(transunet.init(
        ModelConfig(arch="transunet"), torch.Generator().manual_seed(0))) \
        == transunet.Widths()


@pytest.mark.parametrize("maker", ["program", "reference"])
def test_checkpoint_round_trip(tmp_path, maker):
    cfg = _cfg()
    mcfg = _mcfg(cfg)
    if maker == "program":
        tree = transunet.init(mcfg, torch.Generator().manual_seed(2),
                              transunet.Widths.of(_setup(cfg, 2, 1)[0]))
    else:
        tree = _setup(cfg, 2, 1)[0]
    state = checkpoint.params_from_jax(tree)
    back = checkpoint.params_to_jax(state)
    _same_tree(tree, back)
    # every array of the tree is one entry of the module's state dict
    model = registry.build(tree, mcfg, "cpu")
    assert set(state) == set(model.state_dict())
    assert sorted(k for k in state if "pos" in k) == ["embed.pos"]
    path = str(tmp_path / "t.ckpt")
    checkpoint.save(path, tree, mcfg)
    loaded, lcfg = checkpoint.load(path)
    assert lcfg == mcfg
    _same_tree(tree, loaded)
    u8 = _setup(cfg, 3, 1)[1]
    assert np.array_equal(_port(tree, cfg, u8), _port(loaded, cfg, u8))


def _same_tree(a, b, path="tree"):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            _same_tree(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, list) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same_tree(x, y, f"{path}.{i}")
    else:
        assert np.shape(a) == np.shape(b), path
        assert np.array_equal(np.asarray(a, np.float32),
                              np.asarray(b, np.float32)), path


def test_a_study_through_the_runner_and_the_engine(tmp_path):
    from unetseg_tpu_torch.parallel import pipeline

    cfg = _cfg(compute_dtype="bfloat16")
    tree, u8 = _setup(cfg, 11, 4)
    raws = inputs.slices(11, 4, 96)
    paths = inputs.write_files(raws, str(tmp_path / "in"), 7)
    mcfg = _mcfg(cfg)
    got = {}
    res = pipeline.run_study(tree, mcfg, paths, 96, 96, batch_size=4,
                             emit=lambda k, p, m: got.__setitem__(k, m),
                             loader_threads=2, host_preprocess=True,
                             device="cpu")
    assert res.n_slices == 7 and sorted(got) == list(range(7))
    eng = pipeline.study_engine(tree, mcfg, "cpu")
    assert eng.forwards >= 2 and eng.graph_replays == 0  # no graph: a CPU
    # the runner's masks are the engine's on the same u8, cleaned
    from unetseg_tpu_torch.io import native

    u8s = np.stack([native.preprocess_u8(r, 64) for r in raws])
    with torch.no_grad():
        masks = eng._masks(torch.from_numpy(u8s)).numpy()
    for k in range(7):
        assert np.array_equal(got[k], native.postprocess_batch(
            masks[k % 4][None])[0])


def test_tta_runs_in_activation_space():
    cfg = _cfg()
    tree, u8 = _setup(cfg, 12, 1)
    eng = engine_mod.InferenceEngine(tree, _mcfg(cfg), "cpu")
    mask = eng.infer_tta(u8[0])
    assert eng._tta[0] == "act" and eng.forwards == 1
    # the mean of the model's logits over the 8 dihedral views, mapped back
    from unetseg_tpu_torch.parallel import tta

    x = torch.from_numpy(u8[0]).float() / 255.0
    with torch.no_grad():
        logits = eng.model(torch.stack([tta.dihedral(x, k)
                                        for k in range(8)])[..., None])
        mean = torch.stack([tta.dihedral_inverse(logits[k], k)
                            for k in range(8)]).mean(dim=0)
    assert torch.equal(mask, decode_mask(mean, 3))


@pytest.mark.parametrize("path", ["row bands", "w8a8", "training"])
def test_refusals_name_the_arch(path, tmp_path):
    from unetseg_tpu_torch import quantize
    from unetseg_tpu_torch.parallel import spatial

    cfg = _cfg()
    tree = _setup(cfg, 13, 1)[0]
    mcfg = _mcfg(cfg)
    with pytest.raises(NotImplementedError) as e:
        if path == "row bands":
            spatial.row_unit(mcfg)
        elif path == "w8a8":
            ckpt = str(tmp_path / "t.ckpt")
            checkpoint.save(ckpt, tree, mcfg)
            quantize.quantize_checkpoint(ckpt, str(tmp_path / "q.ckpt"),
                                         [], device="cpu")
        else:
            registry.trainable(mcfg, checkpoint.params_from_jax(tree))
    assert "'transunet'" in str(e.value) and path in str(e.value)


def test_refuses_bands_and_other_sizes():
    from unetseg_tpu_torch.parallel import spatial

    cfg = _cfg()
    tree, u8 = _setup(cfg, 14, 1)
    model = registry.build(tree, _mcfg(cfg), "cpu")
    with pytest.raises(NotImplementedError, match="'transunet'.*row bands"):
        model(spatial.Bands([_x(u8)[:, :32], _x(u8)[:, 32:]]))
    with pytest.raises(ValueError, match="takes 64x64"):
        model(torch.zeros(1, 32, 32, 1))
    with pytest.raises(ValueError, match="position embedding"):
        registry.build(tree, _mcfg(_cfg(image_size=128)), "cpu")


def test_flops_at_the_published_widths():
    """335.5 GFLOP a 512² slice, every product counted twice at the
    resolutions the authors' code gives (stage 1 at 127²):

    * transformer linears 174.0 (12 layers x 1,024 tokens x 2 x (4 x 768²
      + 2 x 768 x 3072));
    * attention q kᵀ and the probabilities times v 38.7 (12 x 4 x 1,024²
      x 768);
    * decoder 81.2 (the 768→512 conv at 32², four blocks, the 16→3 head);
    * R50 39.7 (stages 1-3 at 127², 64² and 32², the projections);
    * patch embedding 1.6; root 0.4 (7x7 over the grey channel).
    """
    cfg = {"image_size": 512, "num_classes": 3, "in_channels": 1}
    assert abs(ref_t.flops_per_slice(cfg) / 1e9 - 335.5) <= 0.5
    # the transformer alone, from its widths
    h, L = 768, 1024
    tf = 12 * (2 * L * (4 * h * h + 2 * h * 3072) + 4 * L * L * h)
    assert abs(tf / 1e9 - 212.6) < 0.05
    # the roofline's bound: 12 launches, each compute-bound at batch 32
    assert ref_t.attention_launches(cfg) == 12
    assert ref_t.attention_bound_s(cfg, 32) == pytest.approx(
        12 * 4 * L * L * h * 32 / 989e12)
