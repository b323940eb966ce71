"""How the study runner stages its batches (``parallel/pipeline.py``): one
loader task a slice, in batch order, into a reused ring of slots (pinned on
the card), the oldest batch first.

On the CPU, a small float32 UNet (base 8, depth 2, 64²) over 20 RAWs of
96 x 80 at batch 3, so that a study has 7 batches, the last one ragged (2
slices), and reuses every slot of its ring within itself: the batches the
device stage gets are the stack of the mapped RAWs (or of their host u8)
padded with the last slice, and stay so while a slow consumer holds them;
masks and callbacks are the former path's for 1, 2 and 4 loader threads;
with one thread every slice of batch k starts before any of batch k+1,
with several each batch is filled by more than one; after a warm-up study
every batch reuses a slot; 16 loader threads, switching every
microsecond, land every batch whole; in artifact mode the emitter's host
arrays are private; a slice that cannot be read fails the study.

Marked ``card`` (skipped without one; on the card: ``python3 -m pytest
tests/test_torch_port_staging.py -q -m card --noconftest -p
no:cacheprovider``, since this directory's conftest imports JAX): the
ring's slots are pinned, a study gives the masks of the former path and
reuses a slot for every batch.
"""

import shutil
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from unetseg_tpu_torch import checkpoint
from unetseg_tpu_torch.config import ModelConfig
from unetseg_tpu_torch.data import synth_slice
from unetseg_tpu_torch.io import native, raw as raw_io
from unetseg_tpu_torch.parallel import pipeline

SMALL = ModelConfig(base_channels=8, depth=2, image_size=64,
                    compute_dtype="float32")
W, H, N, BATCH = 96, 80, 20, 3


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """Torch's CPU ops on these tiny batches in one thread: beside other
    test processes a pool of threads a process spins far longer than the
    work takes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("staging") / "model.ckpt")
    checkpoint.create(path, SMALL, seed=0)
    return checkpoint.load(path)


@pytest.fixture(scope="module")
def study(tmp_path_factory):
    """N RAW files: 7 distinct slices, each copied to files of its own."""
    d = tmp_path_factory.mktemp("raws")
    rng = np.random.default_rng(7)
    paths = []
    for i in range(N):
        p = str(d / f"slice_{i:03d}.raw")
        if i < 7:
            raw_io.write_raw(p, synth_slice(rng, 112)[0][:H, :W])
        else:
            shutil.copy(paths[i % 7], p)
        paths.append(p)
    return paths


def _batches(paths):
    return [paths[i:i + BATCH] for i in range(0, len(paths), BATCH)]


def _stacked(paths, host_preprocess):
    """A batch as the former path staged it: ``np.stack`` of the mapped
    RAWs (or of their host u8), the ragged tail the last slice repeated."""
    imgs = [np.asarray(raw_io.read_raw(p, W, H)) for p in paths]
    if host_preprocess:
        imgs = [native.preprocess_u8(r, SMALL.image_size) for r in imgs]
    out = np.stack(imgs)
    return np.concatenate([out, np.repeat(out[-1:], BATCH - len(out), 0)])


def _former_masks(params, cfg, paths, host_preprocess, device):
    """The study's cleaned masks, each batch staged by ``_load_batch``'s
    former path (a private array, pinned and copied on its own)."""
    eng = pipeline.study_engine(params, cfg, device)
    stage = pipeline._device_stage(params, cfg, u8_input=host_preprocess,
                                   pack_masks=True, device=device)
    out = []
    for b in _batches(paths):
        dev = pipeline._load_batch(
            b, W, H, cfg.image_size if host_preprocess else None, BATCH,
            True, device=device)
        packed = eng.to_host(stage(dev))()[: len(b)]
        out.append(native.postprocess_packed_batch(packed, cfg.image_size))
    return np.concatenate(out)


def _recording_stage(monkeypatch, seen, delay):
    """Wrap the study's device stage to keep every batch it gets (and wait
    ``delay`` s before each, a slow consumer)."""
    device_stage = pipeline._device_stage

    def wrapped(*args, **kwargs):
        inner = device_stage(*args, **kwargs)

        def stage(raws):
            seen.append(raws)
            time.sleep(delay)
            return inner(raws)
        return stage
    monkeypatch.setattr(pipeline, "_device_stage", wrapped)


@pytest.mark.parametrize("loader_threads,host_preprocess",
                         [(1, False), (2, False), (4, False), (4, True)])
def test_staged_study(model, study, monkeypatch, loader_threads,
                      host_preprocess):
    params, cfg = model
    batches = _batches(study)
    want = _former_masks(params, cfg, study, host_preprocess, "cpu")
    want_in = [_stacked(b, host_preprocess) for b in batches]
    kw = dict(batch_size=BATCH, loader_threads=loader_threads,
              host_preprocess=host_preprocess, keep_masks=True, device="cpu")
    pipeline.run_study(params, cfg, study, W, H, **kw)  # warm-up: the ring

    seen = []
    _recording_stage(monkeypatch, seen, 0.02)
    reads = []

    def recording(read):
        def wrapped(path, *args):
            reads.append((study.index(path), threading.get_ident()))
            time.sleep(0.02)  # a read long enough for every thread to start
            return read(path, *args)
        return wrapped
    for name in ("read_raw", "read_raw_into"):
        monkeypatch.setattr(raw_io, name, recording(getattr(raw_io, name)))
    calls, lock = {}, threading.Lock()

    def emit(k, path, mask):
        assert path == study[k]
        np.testing.assert_array_equal(mask, want[k])
        with lock:
            calls[k] = calls.get(k, 0) + 1

    pipeline.STAGING.reset()
    got = pipeline.run_study(params, cfg, study, W, H, emit=emit, **kw)
    counts = pipeline.STAGING.summary()

    np.testing.assert_array_equal(got.masks, want)
    assert calls == {k: 1 for k in range(N)}
    # every batch as the former path staged it, after the loaders refilled
    # its slot (7 batches, at most 6 slots) while this consumer held it
    assert len(seen) == len(batches)
    for raws, x in zip(seen, want_in):
        np.testing.assert_array_equal(raws.numpy(), x)
    assert counts["batches"] == counts["reused"] == len(batches)
    assert counts["reuse_pct"] == 100.0
    fillers = [{t for k, t in reads if k // BATCH == j}
               for j in range(len(batches))]
    if loader_threads == 1:
        assert [k for k, _ in reads] == list(range(N))
        assert counts["split"] == 0
    else:
        # a share of each batch a loader: a batch with more slices than a
        # share is filled by more than one
        share = -(-BATCH // loader_threads)
        split = [len(b) > share for b in batches]
        assert [len(f) > 1 for f in fillers] == split
        assert counts["split"] == sum(split) > 0


def test_read_raw_into_reads_the_mapped_bytes(study, tmp_path):
    want = np.asarray(raw_io.read_raw(study[0], W, H))
    out = np.full((H, W), 7, np.uint16)
    raw_io.read_raw_into(study[0], W, H, out)
    np.testing.assert_array_equal(out, want)
    small = tmp_path / "small.raw"
    small.write_bytes(b"\0" * (W * H * 2 - 1))
    for read in (raw_io.read_raw, lambda *a: raw_io.read_raw_into(*a, out)):
        with pytest.raises(ValueError, match="too small"):
            read(str(small), W, H)
    with pytest.raises(ValueError, match="C-contiguous"):
        raw_io.read_raw_into(study[0], W, H, np.empty((W, H), np.uint16))
    with pytest.raises(ValueError, match="C-contiguous"):
        raw_io.read_raw_into(study[0], W // 2, H,
                             np.empty((H, W), np.uint16)[:, ::2])


def test_staging_under_many_threads(study):
    """More loader threads than cores, the interpreter switching threads
    every microsecond: every batch lands whole, in order, once."""
    batches = _batches(study) * 3
    depth = 17
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pipeline.STAGING.reset()
        with pipeline._staging_ring(depth + 1, (BATCH, H, W), np.uint16,
                                    torch.device("cpu")) as ring, \
                ThreadPoolExecutor(max_workers=16) as pool:
            got = list(pipeline._staged(pool, batches, W, H, None, BATCH,
                                        torch.device("cpu"), depth, 1, ring))
    finally:
        sys.setswitchinterval(interval)
    assert len(got) == len(batches)
    for x, b in zip(got, batches):
        np.testing.assert_array_equal(x.numpy(), _stacked(b, False))
    assert pipeline.STAGING.summary()["batches"] == len(batches)


def test_emitter_arrays_are_not_ring_slots(model, study, tmp_path,
                                           monkeypatch):
    """In artifact mode the emitter keeps each batch's host u8 after the
    copy: it gets a private array, never a slot of the cached u8 ring."""
    params, cfg = model
    kw = dict(batch_size=BATCH, host_preprocess=True, device="cpu")
    pipeline.run_study(params, cfg, study, W, H, **kw)  # the u8 ring
    ring = pipeline._RINGS[("cpu", (BATCH, 64, 64), np.dtype(np.uint8))]
    emitted, emit = [], pipeline._emit

    def recording_emit(u8_host, *args):
        emitted.append(u8_host)
        return emit(u8_host, *args)
    monkeypatch.setattr(pipeline, "_emit", recording_emit)
    pipeline.STAGING.reset()
    pipeline.run_study(params, cfg, study, W, H, artifacts="json",
                       out_dir=str(tmp_path), **kw)
    batches = _batches(study)
    assert len(emitted) == len(batches)
    for u8, b in zip(emitted, batches):
        np.testing.assert_array_equal(u8, _stacked(b, True))
        assert not any(np.shares_memory(u8, s.host) for s in ring)
    counts = pipeline.STAGING.summary()
    assert counts["batches"] == len(batches) and counts["reused"] == 0


def test_failed_read_fails_the_study(model, study, monkeypatch):
    """A slice that cannot be read fails its batch's wait, not a loader
    future nobody reads: the study raises."""
    params, cfg = model

    def failing(read):
        def wrapped(path, *args):
            if path == study[4]:
                raise OSError("unreadable slice")
            return read(path, *args)
        return wrapped
    for name in ("read_raw", "read_raw_into"):
        monkeypatch.setattr(raw_io, name, failing(getattr(raw_io, name)))
    with pytest.raises(OSError, match="unreadable slice"):
        pipeline.run_study(params, cfg, study, W, H, batch_size=BATCH,
                           device="cpu")


# -- on the card --------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.card
def test_staged_study_on_the_card(model, study, card, monkeypatch):
    params, cfg = model
    dev = str(card)
    kw = dict(batch_size=BATCH, keep_masks=True, device=dev)
    pipeline.run_study(params, cfg, study, W, H, **kw)  # warm-up: the ring
    ring = pipeline._RINGS[(dev, (BATCH, H, W), np.dtype(np.uint16))]
    assert len(ring) >= 6
    assert all(s.tensor.is_pinned() for s in ring)
    want = _former_masks(params, cfg, study, False, dev)

    seen = []
    _recording_stage(monkeypatch, seen, 0.0)
    pipeline.STAGING.reset()
    got = pipeline.run_study(params, cfg, study, W, H, **kw)
    counts = pipeline.STAGING.summary()
    np.testing.assert_array_equal(got.masks, want)
    for raws, b in zip(seen, _batches(study)):
        assert raws.device == card
        np.testing.assert_array_equal(raws.cpu().numpy(), _stacked(b, False))
    assert counts["batches"] == counts["reused"] == len(seen) == 7
