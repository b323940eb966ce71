"""The engine's forward graphs (``graphs.py``, ``InferenceEngine.compile``)
on the CPU: when the replay rule serves a forward from a graph and when it
leaves it eager, and what a replay adds to the counters and returns.

A CPU engine never captures (CUDA graphs exist on the card only), so the
capture itself is replaced by a stand-in: a graph object whose replay runs
the captured function on the static input into the static output, and
whose capture bumps the launch counters as the kernel wrappers would on
the card.  The card check is ``chip_smoke.py``'s phase 27.  The replayed
masks are held against the port's eager forward and, from a JAX-written
checkpoint, against the JAX engine's masks.
"""

import jax
import numpy as np
import pytest
import torch

from unetseg_tpu import checkpoint as jax_ckpt, engine as jax_engine
from unetseg_tpu.config import ModelConfig as JaxModelConfig
from unetseg_tpu_torch import checkpoint, engine, graphs
from unetseg_tpu_torch.config import ModelConfig
from unetseg_tpu_torch.data import synth_slice
from unetseg_tpu_torch.io import native
from unetseg_tpu_torch.models import registry
from unetseg_tpu_torch.ops import conv, dec1
from unetseg_tpu_torch.parallel.spatial import Bands

SIZE = 64
BATCH = 2
FAMILIES = {
    "unet_stem1": dict(),
    "unet_stem4": dict(stem=4),
    "attention_unet": dict(arch="attention_unet"),
    "unetpp": dict(arch="unetpp"),
}
#: What the stand-in capture adds to the counters (K1 and K6 launches).
CAPTURED = {"conv3x3_bias_act": 3, "dec1_fused": 1}
#: Caller forms of ``_masks_on``: the u8 batch alone, or with the model
#: input the study's device preprocess gives.
FORMS = {"u8": lambda u8: (u8, None), "x": lambda u8: (u8, _x(u8))}


def _engine(devices=None, **kw):
    cfg = ModelConfig(base_channels=8, depth=2, image_size=SIZE,
                      compute_dtype="float32", **kw)
    params = registry.init(cfg, torch.Generator().manual_seed(0))
    return engine.InferenceEngine(params, cfg, device="cpu", devices=devices)


def _u8(seed, n=BATCH):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (n, SIZE, SIZE), dtype=torch.uint8,
                         generator=g)


def _x(u8):
    return (u8.to(torch.float32) / 255.0)[..., None]


class StandInGraph:
    """A CUDA graph's stand-in: ``replay`` runs the captured function on
    the static input into the static output, as the graph's kernels
    would."""

    def __init__(self, fn, static_in, pool):
        self.fn, self.static_in, self.given_pool = fn, static_in, pool
        self.static_out = None
        self.replays = 0

    def replay(self):
        self.replays += 1
        self.static_out.copy_(self.fn(self.static_in))

    def pool(self):
        return self.given_pool or ("pool", id(self))


@pytest.fixture()
def stand_in(monkeypatch):
    """Capture through :class:`StandInGraph` on a CPU engine; yields the
    stand-ins made."""
    made = []

    def capture(fn, static_in, pool):
        g = StandInGraph(fn, static_in, pool)
        g.static_out = fn(static_in)
        conv.LAUNCHES["conv3x3_bias_act"] += CAPTURED["conv3x3_bias_act"]
        dec1.LAUNCHES["dec1_fused"] += CAPTURED["dec1_fused"]
        made.append(g)
        return g, g.static_out

    monkeypatch.setattr(graphs, "_capture", capture)
    monkeypatch.setattr(engine.InferenceEngine, "_capturable",
                        lambda self: self.mesh is None)
    graphs.reset_launches()
    yield made
    graphs.reset_launches()


def _launches():
    return (conv.LAUNCHES["conv3x3_bias_act"], dec1.LAUNCHES["dec1_fused"])


def test_cpu_engine_stays_eager():
    eng = _engine()
    assert not eng._capturable()
    eng.compile(BATCH)
    assert eng._graphs == {}
    u8 = _u8(1)
    assert eng._graph_for(_x(u8)) is None
    eng._pipeline(u8)
    eng._pipeline(u8, _x(u8))
    # the warm-up and the two calls, none replayed
    assert (eng.forwards, eng.graph_replays) == (3, 0)


def test_mesh_engine_stays_eager(stand_in):
    eng = _engine(devices=["cpu", "cpu"])
    assert not eng._capturable()
    eng.compile(BATCH)
    assert eng._graphs == {} and stand_in == []
    u8 = _u8(2)
    # a graph put there by hand is not replayed either: one device only
    eng._graphs[graphs.key(_x(u8))] = object()
    assert eng._graph_for(_x(u8)) is None
    eng._pipeline(u8)
    # the warm-up and the call, each one forward a device
    assert eng.graph_replays == 0 and eng.forwards == 4


def test_only_a_one_card_engine_captures(monkeypatch):
    eng = _engine()
    assert not eng._capturable()
    monkeypatch.setattr(eng, "device", torch.device("cuda", 0))
    assert eng._capturable()
    mesh = _engine(devices=["cpu", "cpu"])
    monkeypatch.setattr(mesh, "device", torch.device("cuda", 0))
    assert not mesh._capturable()


def test_replay_rule(stand_in):
    eng = _engine()
    eng.compile(BATCH)
    assert len(stand_in) == 1 and len(eng._graphs) == 1
    x = _x(_u8(3))
    assert eng._graph_for(x) is eng._graphs[graphs.key(x)]
    # an unwarmed batch size, another dtype, and row bands run eagerly
    assert eng._graph_for(_x(_u8(3, n=BATCH + 1))) is None
    assert eng._graph_for(x.double()) is None
    assert eng._graph_for(Bands([x[:, :SIZE // 2], x[:, SIZE // 2:]])) \
        is None
    # the graphs of two batch sizes share one pool
    assert stand_in[0].given_pool is None
    eng.compile(BATCH * 2)
    assert len(eng._graphs) == 2
    assert stand_in[1].given_pool == stand_in[0].pool()


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("form", sorted(FORMS))
def test_replay_counts_and_returns_fresh_masks(stand_in, family, form):
    eng = _engine(**FAMILIES[family])
    a, b = _u8(4), 255 - _u8(4)
    arg = FORMS[form]
    want_a = eng._masks_on(0, *arg(a))
    want_b = eng._masks_on(0, *arg(b))
    assert not torch.equal(want_a, want_b)   # the check below can fail
    eng.compile(BATCH)
    # the capture launched nothing: its counts are taken back
    assert _launches() == (0, 0)
    forwards = eng.forwards
    got_a = eng._masks_on(0, *arg(a))
    assert _launches() == (3, 1)
    got_b = eng._masks_on(0, *arg(b))
    assert _launches() == (6, 2)
    assert (eng.forwards - forwards, eng.graph_replays) == (2, 2)
    g = eng._graphs[graphs.key(_x(a))]
    assert g.graph.replays == 3   # the upload at compile, then two
    # fresh tensors, each keeping its own input's masks across replays
    for got in (got_a, got_b):
        assert got.data_ptr() != g.static_out.data_ptr()
    assert got_a.data_ptr() != got_b.data_ptr()
    assert torch.equal(got_a, want_a) and torch.equal(got_b, want_b)
    # the pipeline entry replays the same graph
    before = eng.graph_replays
    eng._pipeline(*arg(a))
    assert eng.graph_replays == before + 1 and g.graph.replays == 4


def test_compile_counts_one_forward(stand_in):
    eng = _engine()
    eng.compile(BATCH)
    eng.compile(BATCH)   # warmed: nothing more
    assert (eng.forwards, eng.graph_replays, len(stand_in)) == (1, 0, 1)
    assert _launches() == (0, 0)


@pytest.mark.parametrize("form", sorted(FORMS))
def test_replayed_masks_match_jax(stand_in, tmp_path, form):
    """A JAX-written float32 checkpoint served by both engines on the same
    u8 batch of synthetic slices: the replayed masks equal the JAX
    engine's, as the eager port's artifacts do."""
    path = str(tmp_path / "model.ckpt")
    jax_ckpt.create(path, JaxModelConfig(base_channels=8, depth=2,
                                         image_size=SIZE,
                                         compute_dtype="float32"), seed=0)
    rng = np.random.default_rng(7)
    u8 = np.stack([native.preprocess_u8(synth_slice(rng, 112)[0], SIZE)
                   for _ in range(BATCH)])
    want = np.asarray(jax_engine.InferenceEngine(
        *jax_ckpt.load(path), devices=jax.devices()[:1]).infer(u8))
    eng = engine.InferenceEngine(*checkpoint.load(path), device="cpu")
    eng.compile(BATCH)
    got = eng._masks_on(0, *FORMS[form](torch.from_numpy(u8)))
    assert eng.graph_replays == 1 and len(np.unique(want)) > 1
    np.testing.assert_array_equal(got.numpy(), want)
