"""The port's importers (``models/import_torch.py``, ``models/import_onnx.py``,
``checkpoint.params_from_torch_state_dict``) against the JAX package's.

The same bytes go into both packages' importers and the parameter trees
must come out bit-equal (the JAX tree as numpy): a ``build_torch_unet``
state dict through a real ``.pt``, with and without BatchNorm layers
(folded by each package's ``fold_batchnorm``); hand-encoded TensorProtos
(raw_data and float_data); a ``write_onnx_graph`` file with live
BatchNormalization nodes, and the same file with every name scrambled; a
real ``torch.onnx`` export, as ``tests/test_onnx_real.py`` makes one; the
graphs outside the family are refused with the same message.  Then the
user's journey on the CPU: ``.pt`` -> ``params_from_torch_state_dict`` ->
``checkpoint.save`` -> ``initialize_engine(device="cpu")``.
"""

import os

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from test_onnx_import import _unet_d1_nodes, _unet_d1_tensors
from test_onnx_real import _export_onnx
from unetseg_tpu import checkpoint as jax_ckpt
from unetseg_tpu.config import ModelConfig as JaxModelConfig
from unetseg_tpu.models import import_onnx as jax_onnx
from unetseg_tpu.models import import_torch as jax_torch
from unetseg_tpu_torch import checkpoint, engine
from unetseg_tpu_torch.config import ModelConfig
from unetseg_tpu_torch.data import synth_slice
from unetseg_tpu_torch.io import raw as raw_io
from unetseg_tpu_torch.models import import_onnx, import_torch, registry

CFG = ModelConfig(base_channels=8, depth=2, image_size=64,
                  compute_dtype="float32")
JCFG = JaxModelConfig(base_channels=8, depth=2, image_size=64,
                      compute_dtype="float32")


def _assert_trees_bit_equal(got, want):
    want = jax.device_get(want)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert isinstance(a, np.ndarray) and a.dtype == np.float32
        assert a.shape == np.shape(b)
        np.testing.assert_array_equal(a.view(np.uint32),
                                      np.asarray(b).view(np.uint32))


def _state_dict(seed):
    torch.manual_seed(seed)
    sd = import_torch.build_torch_unet(CFG).state_dict()
    torch.manual_seed(seed)
    jsd = jax_torch.build_torch_unet(JCFG).state_dict()
    assert sd.keys() == jsd.keys()
    assert all(torch.equal(sd[k], jsd[k]) for k in sd)
    return sd


@pytest.mark.parametrize("with_bn", [False, True], ids=["plain", "bn"])
def test_pt_state_dict_trees_bit_equal(tmp_path, with_bn):
    sd = _state_dict(5)
    if with_bn:
        sd.update({k: torch.from_numpy(v) for k, v in chip_smoke.bn_state(
            np, sd, seed=6).items()})
    pt = str(tmp_path / "w.pt")
    torch.save(sd, pt)
    loaded = torch.load(pt, map_location="cpu")
    got = checkpoint.params_from_torch_state_dict(loaded, CFG)
    _assert_trees_bit_equal(got, jax_torch.convert_state_dict(loaded, JCFG))
    if with_bn:  # each package folds every BN group into its conv
        want = jax.device_get(jax_torch.convert_state_dict(loaded, JCFG))
        chip_smoke.fold_bn_tree(jax_torch, want, loaded)
        chip_smoke.fold_bn_tree(import_torch, got, loaded)
        _assert_trees_bit_equal(got, want)
        assert not np.array_equal(got["encoder"][0]["conv1"]["w"],
                                  _state_dict(5)["encoder.0.conv1.weight"]
                                  .numpy().transpose(2, 3, 1, 0))


def test_fold_batchnorm_bit_equal():
    rng = np.random.default_rng(0)
    conv = {"w": rng.standard_normal((3, 3, 4, 6)).astype(np.float32),
            "b": rng.standard_normal(6).astype(np.float32)}
    stats = [rng.uniform(0.5, 1.5, 6).astype(np.float32) for _ in range(4)]
    for eps in (1e-5, 1e-3):
        got = import_torch.fold_batchnorm(conv, *stats, eps)
        want = jax_torch.fold_batchnorm(conv, *stats, eps)
        for k in ("w", "b"):
            np.testing.assert_array_equal(got[k], np.asarray(want[k]))


@pytest.mark.parametrize("kind", ["raw_data", "float_data"])
def test_hand_encoded_tensorprotos(tmp_path, kind):
    data = np.arange(6, dtype="<f4")
    if kind == "raw_data":
        tensor = (b"\x08\x02\x08\x03\x10\x01\x42\x01w"
                  + b"\x4a\x18" + data.tobytes())
    else:
        floats = data.tobytes()
        tensor = (b"\x08\x02\x08\x03\x10\x01\x22" + bytes([len(floats)])
                  + floats + b"\x42\x01w")
    graph = b"\x2a" + bytes([len(tensor)]) + tensor
    path = tmp_path / "hand.onnx"
    path.write_bytes(b"\x3a" + bytes([len(graph)]) + graph)
    got = import_onnx.read_initializers(str(path))
    want = jax_onnx.read_initializers(str(path))
    assert set(got) == set(want) == {"w"}
    np.testing.assert_array_equal(got["w"], data.reshape(2, 3))
    np.testing.assert_array_equal(got["w"], want["w"])


def _scramble(path, out):
    blob = open(path, "rb").read()
    names = sorted(import_onnx.read_initializers(path), key=len, reverse=True)
    for i, name in enumerate(names):  # opaque hex of the same length
        repl = format(i, "x").rjust(len(name), "0").encode()
        assert len(repl) == len(name)
        blob = blob.replace(name.encode(), repl)
    with open(out, "wb") as f:
        f.write(blob)
    return out


def test_written_graph_with_bn_and_scrambled_names(tmp_path):
    rng = np.random.default_rng(3)
    tensors = _unet_d1_tensors(rng)
    tensors.update({k: v.astype(np.float32) for k, v in {
        "bn1_g": rng.uniform(0.5, 1.5, 4), "bn1_b": rng.standard_normal(4),
        "bn1_m": rng.standard_normal(4), "bn1_v": rng.random(4) + 0.1,
        "bn2_g": rng.uniform(0.5, 1.5, 4), "bn2_b": rng.standard_normal(4),
        "bn2_m": rng.standard_normal(4), "bn2_v": rng.random(4) + 0.1,
    }.items()})
    nodes = _unet_d1_nodes(True)
    path = str(tmp_path / "bn.onnx")
    import_onnx.write_onnx_graph(path, nodes, tensors)
    jpath = str(tmp_path / "bn_jax.onnx")
    jax_onnx.write_onnx_graph(jpath, nodes, tensors)
    assert open(path, "rb").read() == open(jpath, "rb").read()
    for p in (path, _scramble(path, str(tmp_path / "scrambled.onnx"))):
        got, cfg = import_onnx.load_onnx(p)
        want, jcfg = jax_onnx.load_onnx(p)
        assert (cfg.depth, cfg.base_channels, cfg.in_channels,
                cfg.num_classes) == (jcfg.depth, jcfg.base_channels,
                                     jcfg.in_channels, jcfg.num_classes) \
            == (1, 4, 1, 3)
        _assert_trees_bit_equal(got, want)
    # both packages' initializer-only writers write the same bytes
    init_path = str(tmp_path / "init.onnx")
    import_onnx.write_onnx_initializers(init_path, tensors)
    jinit = str(tmp_path / "init_jax.onnx")
    jax_onnx.write_onnx_initializers(jinit, tensors)
    assert open(init_path, "rb").read() == open(jinit, "rb").read()


def test_canonical_graph_and_pt_routes_agree(tmp_path):
    """``chip_smoke.unet_onnx_graph`` (live BN nodes) read by both
    packages' ``load_onnx`` and by the name-based ``params_from_onnx``;
    the ``.pt`` route with its BN folded gives the same tree, bit for bit
    (phase 19 holds the two on the card at full width)."""
    sd = {k: v.numpy() for k, v in _state_dict(8).items()}
    sd.update(chip_smoke.bn_state(np, sd, seed=9))
    path = str(tmp_path / "canonical.onnx")
    import_onnx.write_onnx_graph(path, *chip_smoke.unet_onnx_graph(np, sd,
                                                                   CFG))
    got, cfg = import_onnx.load_onnx(path)
    want, jcfg = jax_onnx.load_onnx(path)
    assert (cfg.depth, cfg.base_channels) == (jcfg.depth,
                                              jcfg.base_channels) == (2, 8)
    _assert_trees_bit_equal(got, want)
    pt_tree = chip_smoke.fold_bn_tree(
        import_torch, checkpoint.params_from_torch_state_dict(sd, CFG), sd)
    _assert_trees_bit_equal(pt_tree, got)
    plain = str(tmp_path / "plain.onnx")
    import_onnx.write_onnx_initializers(plain, sd)
    _assert_trees_bit_equal(import_onnx.params_from_onnx(plain, CFG),
                            jax_onnx.params_from_onnx(plain, JCFG))


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    td = tmp_path_factory.mktemp("onnx")
    torch.manual_seed(7)
    m = import_torch.build_torch_unet(CFG).eval()
    x = torch.randn(1, 1, 64, 64)
    path = str(td / "unet.onnx")
    _export_onnx(m, x, path)
    with torch.no_grad():
        y = m(x).numpy()
    return x.numpy(), y, path


def test_real_torch_export(exported, tmp_path):
    x, y, path = exported
    for p in (path, _scramble(path, str(tmp_path / "scrambled.onnx"))):
        got, cfg = import_onnx.load_onnx(p)
        want, _ = jax_onnx.load_onnx(p)
        _assert_trees_bit_equal(got, want)
        assert cfg == ModelConfig(base_channels=8, depth=2)
        model = registry.build(got, CFG, device="cpu")
        with torch.no_grad():
            out = model(torch.from_numpy(x.transpose(0, 2, 3, 1)))
        np.testing.assert_allclose(out.numpy().transpose(0, 3, 1, 2), y,
                                   atol=2e-5)


def _mutated(tmp_path, name, mutate, drop=None):
    nodes = [mutate(op, i, o, dict(a) if a else None)
             for op, i, o, a in _unet_d1_nodes(False)
             if op != drop]
    path = str(tmp_path / f"{name}.onnx")
    import_onnx.write_onnx_graph(path, nodes,
                                 _unet_d1_tensors(np.random.default_rng(4)))
    return path


def _set(op_type, key, value, weight=None):
    def mutate(op, i, o, a):
        if op == op_type and (weight is None or i[1] == weight):
            a = {**(a or {}), key: value}
        return (op, i, o, a)
    return mutate


REFUSED = {
    "strided": (_set("Conv", "strides", [2, 2], "e0c1_w"), None),
    "grouped": (_set("Conv", "group", 2, "b1_w"), None),
    "dilated": (_set("Conv", "dilations", [2, 2], "b2_w"), None),
    "kernel5": (_set("Conv", "kernel_shape", [5, 5], "d1_w"), None),
    "valid_pads": (_set("Conv", "pads", [0, 0, 0, 0], "d2_w"), None),
    "big_pool": (_set("MaxPool", "kernel_shape", [3, 3]), None),
    "up_stride1": (_set("ConvTranspose", "strides", [1, 1]), None),
    "sigmoid": (lambda op, i, o, a: ("Sigmoid", i, o, None)
                if op == "Relu" and i == ["t3"] else (op, i, o, a), None),
    "no_up": (lambda op, i, o, a: (op, i, o, a), "ConvTranspose"),
}


@pytest.mark.parametrize("name", list(REFUSED))
def test_off_family_graphs_are_refused_as_jax_refuses(tmp_path, name):
    mutate, drop = REFUSED[name]
    path = _mutated(tmp_path, name, mutate, drop)
    with pytest.raises(ValueError) as jerr:
        jax_onnx.load_onnx(path)
    with pytest.raises(ValueError) as perr:
        import_onnx.load_onnx(path)
    assert str(perr.value) == str(jerr.value)


def test_pt_into_the_cpu_engine(tmp_path):
    """torch.save -> torch.load -> ``params_from_torch_state_dict`` ->
    ``checkpoint.save`` -> ``initialize_engine(device="cpu")`` -> serve;
    the checkpoint also loads in the JAX package, and the served model's
    logits are the torch model's."""
    torch.manual_seed(11)
    cfg = ModelConfig(base_channels=4, depth=2, image_size=64,
                      compute_dtype="float32")
    m = import_torch.build_torch_unet(cfg).eval()
    pt = str(tmp_path / "weights.pt")
    torch.save(m.state_dict(), pt)
    params = checkpoint.params_from_torch_state_dict(
        torch.load(pt, map_location="cpu"), cfg)
    ckpt = str(tmp_path / "models" / "imported.ckpt")
    os.makedirs(os.path.dirname(ckpt))
    checkpoint.save(ckpt, params, cfg)
    jparams, jcfg = jax_ckpt.load(ckpt)
    _assert_trees_bit_equal(params, jparams)
    assert jcfg.base_channels == 4

    raw = str(tmp_path / "s.raw")
    raw_io.write_raw(raw, synth_slice(np.random.default_rng(0), 96)[0])
    try:
        assert engine.initialize_engine(ckpt, log_dir=str(tmp_path / "log"),
                                        device="cpu")
        out = str(tmp_path / "out")
        assert engine.process_single_image(raw, 96, 96, out)
        assert os.path.exists(os.path.join(out, "s_mask.png"))
        x = np.random.default_rng(1).random((1, 64, 64, 1)).astype(np.float32)
        with torch.no_grad():
            got = engine.get_engine().model(torch.from_numpy(x)).numpy()
            want = m(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy()
        np.testing.assert_allclose(got.transpose(0, 3, 1, 2), want,
                                   atol=2e-5)
    finally:
        engine.cleanup_resources()
