"""What the study thread's ``dispatch`` stage costs on the host, and why.

    python3 -m unetseg_tpu_torch.benchmarks.dispatch_probe [--batches N]
        [--threads T] [--root DIR] [--out FILE]

One flagship study batch (``ModelConfig()``, seeded weights, 32 RAWs of
768² u16, device resample, 2-bit packed masks) is dispatched as
``parallel.pipeline.run_study`` dispatches it: ``_device_stage`` then
``InferenceEngine.to_host``, after ``compile(32)``.  The card is idle
before each dispatch.  Prints one JSON line per measurement:

- ``parts``: the host ms of each part of one dispatch, median of N: the
  device preprocess (``preprocess.preprocess_batch``), the engine's
  ``_pipeline`` (the forward), the 2-bit pack and ``to_host``; and the
  launches each part enqueues (``cudaLaunchKernel``, ``cuLaunchKernelEx``,
  ``cudaGraphLaunch``, memsets and copies in a torch.profiler pass).
- ``beside``: the whole dispatch's host ms, median and 90th percentile of
  N, alone and beside T threads: the study's loaders staging batch after
  batch of the RAWs to the card as ``run_study`` stages them, a share of
  each batch a thread into a reused pinned ring (``loader``; in a tree
  that stages whole batches, each thread repeats ``_load_batch`` of the
  batch); and T threads that each repeat one task: a stack of the
  memory-mapped RAWs (``mmap_stack``); a copy of a fresh 38 MB array with
  numpy, the GIL released (``numpy_copy``); a pure-Python loop, the GIL
  held (``python_spin``, 3 dispatches, each takes seconds).  Then alone
  again.

``--root DIR`` imports ``unetseg_tpu_torch`` from another checkout (for
example the parent commit unpacked with ``git archive``), so two versions
can be probed in one call on one card.  Needs a card; exits 1 without one.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BATCH = 32
RAW_SIDE = 768
SPIN_BATCHES = 3
#: The runtime calls that enqueue work on the card.
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernelEx", "cuLaunchKernel",
                "cudaGraphLaunch", "cudaMemsetAsync", "cudaMemcpyAsync")


def _median_p90(ms):
    ms = sorted(ms)
    return statistics.median(ms), ms[min(len(ms) - 1, int(0.9 * len(ms)))]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", type=int, default=10)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    for name in [m for m in sys.modules if m == "unetseg_tpu_torch"
                 or m.startswith("unetseg_tpu_torch.")]:
        del sys.modules[name]  # the package of --root, not this one

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("dispatch_probe: CUDA is not available", file=sys.stderr)
        return 1
    from unetseg_tpu_torch.config import ModelConfig
    from unetseg_tpu_torch.io import raw as raw_io
    from unetseg_tpu_torch.models import registry
    from unetseg_tpu_torch.ops import preprocess
    from unetseg_tpu_torch.parallel import pipeline

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    out = open(args.out, "a") if args.out else None

    def log(rec):
        line = json.dumps({**rec, "nvidia_smi": smi, "root": root})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    cfg = ModelConfig()
    params = registry.init(cfg, torch.Generator().manual_seed(0))
    eng = pipeline.study_engine(params, cfg, "cuda")
    stage = pipeline._device_stage(params, cfg, pack_masks=True)
    eng.compile(BATCH)
    tmp = tempfile.TemporaryDirectory()
    rng = np.random.default_rng(0)
    paths = []
    for i in range(BATCH):
        p = os.path.join(tmp.name, f"slice_{i:03d}.raw")
        raw_io.write_raw(p, rng.integers(0, 4096, (RAW_SIDE, RAW_SIDE),
                                         dtype=np.uint16))
        paths.append(p)

    def load():
        return pipeline._load_batch(paths, RAW_SIDE, RAW_SIDE, None, BATCH,
                                    True, device=eng.device)

    raws = load()
    eng.to_host(stage(raws))()   # warm: every shape of the dispatch
    torch.cuda.synchronize()

    # -- the parts of one dispatch, alone ---------------------------------
    size = cfg.image_size
    parts = {"preprocess": [], "forward": [], "pack": [], "to_host": []}
    for _ in range(args.batches):
        torch.cuda.synchronize()
        with torch.inference_mode():
            t0 = time.perf_counter()
            u8, x = preprocess.preprocess_batch(raws, size)
            t1 = time.perf_counter()
            masks = eng._pipeline(u8, x)
            t2 = time.perf_counter()
            packed = pipeline._pack_mask2(masks)
            t3 = time.perf_counter()
            wait = eng.to_host(packed)
            t4 = time.perf_counter()
        wait()
        for k, a, b in (("preprocess", t0, t1), ("forward", t1, t2),
                        ("pack", t2, t3), ("to_host", t3, t4)):
            parts[k].append((b - a) * 1e3)

    def launches(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with torch.inference_mode():
                got = fn()
            torch.cuda.synchronize()
        return got, sum(e.count for e in prof.key_averages()
                        if e.key in LAUNCH_CALLS)

    (u8, x), n_pre = launches(
        lambda: preprocess.preprocess_batch(raws, size))
    masks, n_fwd = launches(lambda: eng._pipeline(u8, x))
    packed, n_pack = launches(lambda: pipeline._pack_mask2(masks))
    wait, n_host = launches(lambda: eng.to_host(packed))
    wait()
    log({"probe": "parts", "batch": BATCH,
         "host_ms_median": {k: statistics.median(v)
                            for k, v in parts.items()},
         "launches": {"preprocess": n_pre, "forward": n_fwd,
                      "pack": n_pack, "to_host": n_host},
         "forwards": eng.forwards,
         "graph_replays": getattr(eng, "graph_replays", None)})

    # -- the whole dispatch beside other threads --------------------------
    fresh = np.ones((BATCH, RAW_SIDE, RAW_SIDE), np.uint16)

    def python_spin():
        s = 0
        for i in range(10000):
            s += i
        return s

    def staging_loaders(stop):
        """``args.threads`` loaders staging batch after batch as the study
        runner does, until ``stop``."""
        shape = (BATCH, RAW_SIDE, RAW_SIDE)
        depth = args.threads + 1
        with pipeline._staging_ring(depth + 1, shape, np.uint16,
                                    eng.device) as ring, \
                ThreadPoolExecutor(max_workers=args.threads) as pool:
            while not stop.is_set():
                for _ in pipeline._staged(pool, [paths] * 4, RAW_SIDE,
                                          RAW_SIDE, None, BATCH, eng.device,
                                          depth, -(-BATCH // args.threads),
                                          ring):
                    pass

    tasks = {
        "loader": load,
        "mmap_stack": lambda: np.stack([np.asarray(raw_io.read_raw(
            p, RAW_SIDE, RAW_SIDE)) for p in paths]),
        "numpy_copy": lambda: np.array(fresh, copy=True),
        "python_spin": python_spin,
    }
    for beside in ("alone", *tasks, "alone_again"):
        stop = threading.Event()

        def neighbour(task=tasks.get(beside)):
            while not stop.is_set():
                task()

        n_threads = args.threads if beside in tasks else 0
        if beside == "loader" and hasattr(pipeline, "_staged"):
            neighbour, n_threads = (lambda: staging_loaders(stop)), 1
        threads = [threading.Thread(target=neighbour, daemon=True)
                   for _ in range(n_threads)]
        for t in threads:
            t.start()
        ms = []
        n = SPIN_BATCHES if beside == "python_spin" else args.batches
        try:
            for _ in range(n):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                wait = eng.to_host(stage(raws))
                ms.append((time.perf_counter() - t0) * 1e3)
                wait()
        finally:
            stop.set()
            for t in threads:
                t.join()
        med, p90 = _median_p90(ms)
        log({"probe": "beside", "beside": beside,
             "threads": args.threads if beside in tasks else 0,
             "dispatches": n,
             "dispatch_ms_median": med, "dispatch_ms_p90": p90,
             "graph_replays": getattr(eng, "graph_replays", None)})
    torch.cuda.synchronize()
    tmp.cleanup()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
