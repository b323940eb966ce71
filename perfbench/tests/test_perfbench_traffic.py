"""The inputs are the seed's: the same for the same seed, others for
another, and the copy of the program's generator draws its numbers."""

import numpy as np

from perfbench import inputs, harness

BIG = 2 ** 31 + 977


def test_same_seed_same_inputs():
    a = inputs.slices(BIG, 3, 96)
    assert np.array_equal(a, inputs.slices(BIG, 3, 96))
    assert not np.array_equal(a, inputs.slices(BIG + 1, 3, 96))


def test_copy_of_the_program_generator():
    from unetseg_tpu_torch.data import synth_slice

    rng_a, rng_b = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(2):
        assert np.array_equal(inputs.synth_slice(rng_a, 80),
                              synth_slice(rng_b, 80)[0])


def test_files_hold_their_slice(tmp_path):
    raws = inputs.slices(5, 3, 32)
    paths = inputs.write_files(raws, str(tmp_path), 7)
    for k, p in enumerate(paths):
        back = np.fromfile(p, "<u2").reshape(32, 32)
        assert np.array_equal(back, raws[k % 3])


def test_seeded_weights():
    cfg = dict(harness.cell("flagship.study_masks")["config"],
               base_channels=16, depth=2, image_size=64)
    raws = inputs.slices(3, 2, 64)
    a = inputs.seeded_params(cfg, BIG, raws, "cpu")
    b = inputs.seeded_params(cfg, BIG, raws, "cpu")
    c = inputs.seeded_params(cfg, BIG + 1, raws, "cpu")
    w = lambda t: t["encoder"][1]["conv2"]["w"]  # noqa: E731
    assert np.array_equal(w(a), w(b)) and not np.array_equal(w(a), w(c))
    assert np.array_equal(a["head"]["b"], b["head"]["b"])
    assert w(a).shape == (3, 3, 32, 32)
