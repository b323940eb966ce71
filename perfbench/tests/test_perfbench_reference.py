"""The plain reference against the port's CPU path at small sizes (this
test imports both; the reference imports nothing of the program)."""

import dataclasses

import numpy as np
import pytest
import torch

from perfbench import inputs
from perfbench.reference import host
from perfbench.reference.unet import Reference, first_max, widest_gap


def _port_logits(params, cfg_dict, u8):
    from unetseg_tpu_torch.config import ModelConfig
    from unetseg_tpu_torch.models import registry

    names = {f.name for f in dataclasses.fields(ModelConfig)}
    cfg = ModelConfig(**{k: v for k, v in cfg_dict.items() if k in names})
    model = registry.build(params, cfg, "cpu")
    x = torch.from_numpy(u8).float()[..., None] / 255.0
    with torch.no_grad():
        return model(x).numpy()


@pytest.mark.parametrize("stem,depth", [(1, 2), (4, 2), (1, 3)])
def test_unet_matches_the_port_in_float32(stem, depth):
    cfg = dict(arch="unet", in_channels=1, num_classes=3, base_channels=16,
               depth=depth, image_size=64, compute_dtype="float32", stem=stem)
    raws = inputs.slices(11, 2, 64)
    params = inputs.seeded_params(cfg, 5, raws, "cpu")
    u8 = np.stack([host.preprocess_u8(r, 64) for r in raws])
    ref = Reference(params, stem, "cpu").logits(u8)
    port = _port_logits(params, cfg, u8)
    scale = np.abs(ref).max()
    assert np.abs(ref - port).max() <= 1e-4 * scale
    assert widest_gap(ref[0], first_max(port[0])) < 1e-3


def test_control_is_coarser_than_bf16():
    cfg = dict(arch="unet", in_channels=1, num_classes=3, base_channels=16,
               depth=2, image_size=64, compute_dtype="bfloat16", stem=1)
    raws = inputs.slices(12, 2, 64)
    params = inputs.seeded_params(cfg, 6, raws, "cpu")
    u8 = np.stack([host.preprocess_u8(r, 64) for r in raws])
    ref = Reference(params, 1, "cpu").logits(u8)
    ctl = Reference(params, 1, "cpu", quant="fp8").logits(u8)
    port = _port_logits(params, cfg, u8)   # bf16 on the CPU
    g_port = max(widest_gap(r, first_max(p)) for r, p in zip(ref, port))
    g_ctl = max(widest_gap(r, first_max(c)) for r, c in zip(ref, ctl))
    assert g_ctl > 3 * g_port


@pytest.mark.parametrize("size", [768, 512, 700])
def test_preprocess_is_the_host_library_bit_for_bit(size):
    from unetseg_tpu_torch.io import native

    raw = inputs.slices(size, 1, size)[0]
    assert np.array_equal(host.preprocess_u8(raw, 512),
                          native.preprocess_u8(raw, 512))


def _blobs(seed, size=128):
    from scipy import ndimage

    rng = np.random.default_rng(seed)
    field = ndimage.gaussian_filter(rng.random((size, size)), 4)
    q = np.quantile(field, [0.55, 0.8])
    return np.digitize(field, q).astype(np.uint8)


@pytest.mark.parametrize("seed", range(6))
def test_cleanup_and_polygons_match_the_host_library(seed):
    from unetseg_tpu_torch.io import native

    m = _blobs(seed)
    clean = host.cleanup(m)
    assert np.array_equal(clean, native.postprocess_batch(m))
    vis = np.where(clean == 2, 255, 0).astype(np.uint8)
    assert host.polygons(clean, 200, 150) == native.scaled_polygons(
        vis, 200, 150)


def test_files_read_back(tmp_path):
    from unetseg_tpu_torch import checkpoint
    from unetseg_tpu_torch.io import native

    ref, cfg = host.read_checkpoint("models/flagship_slim4.ckpt")
    port, pcfg = checkpoint.load("models/flagship_slim4.ckpt")
    assert cfg["stem"] == pcfg.stem == 4
    assert np.array_equal(ref["decoder"][1]["up"]["w"],
                          port["decoder"][1]["up"]["w"])
    m = host.cleanup(_blobs(1, 64))
    u8 = inputs.slices(1, 1, 64)[0].astype(np.uint8)
    native.emit_batch(u8[None], m[None], [str(tmp_path)], ["s"], ["s.raw"],
                      64, 64, native.TIER_JSON)
    assert host.json_polygons(str(tmp_path / "s.json")) == \
        host.polygons(m, 64, 64)
