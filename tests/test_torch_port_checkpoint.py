"""The port's own msgpack checkpoint reader against the JAX package's
flax-based ``checkpoint.load``: arrays equal bit for bit, dtype included."""

import dataclasses
import os

import msgpack
import numpy as np
import pytest

from unetseg_tpu import checkpoint as jax_ckpt
from unetseg_tpu.config import ModelConfig as JaxModelConfig
from unetseg_tpu_torch import checkpoint

MODELS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "models")


def _assert_same_tree(a, b, path="params"):
    if isinstance(b, dict):
        assert isinstance(a, dict) and set(a) == set(b), path
        for k in b:
            _assert_same_tree(a[k], b[k], f"{path}/{k}")
    elif isinstance(b, (list, tuple)):
        assert isinstance(a, list) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same_tree(x, y, f"{path}[{i}]")
    else:
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path


@pytest.mark.parametrize("name", ["flagship_slim4.ckpt",
                                  "flagship_slim4_robust.ckpt"])
def test_reader_matches_flax_on_tracked_checkpoints(name):
    path = os.path.join(MODELS, name)
    got_params, got_cfg = checkpoint.load(path)
    want_params, want_cfg = jax_ckpt.load(path)
    _assert_same_tree(got_params, want_params)
    assert dataclasses.asdict(got_cfg) == dataclasses.asdict(want_cfg)
    assert got_params["encoder"][0]["conv1"]["w"].dtype == np.float16


def test_reader_matches_flax_on_a_fresh_f32_checkpoint(tmp_path):
    cfg = JaxModelConfig(base_channels=4, depth=1, image_size=32,
                         compute_dtype="float32", stem=2)
    path = str(tmp_path / "m.ckpt")
    jax_ckpt.create(path, cfg, seed=3)
    got_params, got_cfg = checkpoint.load(path)
    want_params, want_cfg = jax_ckpt.load(path)
    _assert_same_tree(got_params, want_params)
    assert dataclasses.asdict(got_cfg) == dataclasses.asdict(want_cfg)


def test_load_serving_picks_slim4():
    params, cfg, name = checkpoint.load_serving(MODELS)
    assert name == "slim4"
    assert (cfg.arch, cfg.stem, cfg.base_channels, cfg.depth,
            cfg.compute_dtype) == ("unet", 4, 64, 2, "bfloat16")


@pytest.mark.parametrize("value", [
    None, True, False, 0, 127, 128, 255, 65535, 2 ** 32, 2 ** 63, -1, -32,
    -33, -200, -40000, -2 ** 40, 1.5, -2.25e300, "", "x" * 40, "y" * 300,
    "z" * 70000, b"\x00\x01", b"b" * 300, list(range(20)), [1, [2, [3]]],
    {"a": 1, "b": {"c": [None, "d"]}}, {str(i): i for i in range(20)},
])
def test_unpackb_scalars_and_containers(value):
    assert checkpoint.unpackb(msgpack.packb(value, use_bin_type=True)) == value


def test_unpackb_float32_and_ndarray_ext():
    assert checkpoint.unpackb(msgpack.packb(np.float32(0.5).item(),
                                            use_single_float=True)) == 0.5
    arr = np.arange(12, dtype=np.float16).reshape(3, 4)
    inner = msgpack.packb((arr.shape, arr.dtype.name, arr.tobytes()),
                          use_bin_type=True)
    got = checkpoint.unpackb(msgpack.packb(msgpack.ExtType(1, inner)))
    assert got.dtype == np.float16 and np.array_equal(got, arr)
    with pytest.raises(ValueError, match="ext type"):
        checkpoint.unpackb(msgpack.packb(msgpack.ExtType(5, b"abc")))


def test_load_rejects_foreign_files(tmp_path):
    bad = tmp_path / "bad.ckpt"
    bad.write_bytes(b"UTPUCKPT2\n" + msgpack.packb({}))
    with pytest.raises(ValueError, match="version mismatch"):
        checkpoint.load(str(bad))
    bad.write_bytes(b"not a checkpoint")
    with pytest.raises(ValueError, match="Not a unetseg_tpu checkpoint"):
        checkpoint.load(str(bad))
