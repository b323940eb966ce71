"""What the flagship cell reads stays what it was before a configuration
named its own model: for the same seed, the same weight bits, head bias,
reference logits (float32 bytes) and FLOPs a slice.  The digests were
taken with the same recipe from the harness as it stood when the plain
UNet was wired into it (seeded weights drawn in ``inputs``, the reference
built from ``stem`` alone), on the CPU, at the fault tests' small flagship
(base 16, depth 2, 64²) at stem 1 and 4; they read the same on one thread
and on eight."""

import hashlib

import numpy as np
import pytest

from perfbench import harness, inputs
from perfbench.reference import host

SEED = 2 ** 31 + 5
FROZEN = {
    1: {"params": "e4c44d41bb5a1383d7d06396",
        "bias": "55c1930efc28ab150bdca182",
        "logits": "894549ad28c1869c91613841"},
    4: {"params": "eb8189e7a4b0257ff8243f90",
        "bias": "7cea6305fb39383c6e5c73be",
        "logits": "94bdf5d6ff0070380bd5db5d"},
}
FLAGSHIP_FLOPS = 384802226176.0


def _digest(a) -> str:
    a = np.ascontiguousarray(a)
    h = hashlib.sha256()
    h.update(repr((a.dtype.str, a.shape)).encode())
    h.update(a.tobytes())
    return h.hexdigest()[:24]


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, np.asarray(tree)


def _tree_digest(tree) -> str:
    h = hashlib.sha256()
    for p, a in _leaves(tree):
        h.update(p.encode())
        h.update(_digest(a).encode())
    return h.hexdigest()[:24]


@pytest.mark.parametrize("stem", sorted(FROZEN))
def test_flagship_weights_bias_and_logits(stem):
    cfg = dict(harness.cell("flagship.study_masks")["config"],
               base_channels=16, depth=2, image_size=64, stem=stem)
    fam = harness.family(cfg)
    raws = inputs.slices(SEED, 4, 96)
    params = inputs.seeded_params(cfg, SEED, raws, "cpu", fam)
    u8 = np.stack([host.preprocess_u8(r, 64) for r in raws])
    logits = fam.Reference(params, cfg, "cpu").logits(u8)
    got = {"params": _tree_digest(params),
           "bias": _digest(params["head"]["b"]),
           "logits": _digest(logits.astype(np.float32))}
    assert got == FROZEN[stem]


def test_flagship_flops():
    cfg = harness.cell("flagship.study_masks")["config"]
    assert harness.family(cfg).flops_per_slice(cfg) == FLAGSHIP_FLOPS
