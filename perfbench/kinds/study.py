"""Whole studies back to back in a closed loop, through the program's study
runner (``parallel.pipeline.run_study``).

A study is ``study_slices`` RAW files of ``raw_size``², file k holding
distinct slice ``k % distinct_slices``.  The traffic file sets the batch,
where the preprocess runs (``host_preprocess``), the artifact tier
(``artifacts``, written under the run's temporary directory, one
directory that every study overwrites) and whether an ``emit`` callback
takes each cleaned mask.  Set-up runs ``warm_studies`` whole studies; the
window counts whole studies; a traced run profiles ``trace_studies`` whole
studies after the first ``trace_after``.

Judged: one file of each distinct slice, drawn from the seed, in every
study: the u8 the device got (from the host's resample or its own), its
decoded mask against the reference's float32 logits, its cleanup, its
contour JSON where one is written, and the mask the callback received;
the logits are the reference module's that the configuration names.
"""

from __future__ import annotations

import gc
import os
import threading
import time

import numpy as np
import torch

from perfbench import harness, inputs, taps as taps_mod
from perfbench.reference import host
from perfbench.reference.logit_gap import widest_gap
from perfbench.trace import Profiler, spans


def _options(run, cb):
    tr = run.traffic
    out = os.path.join(run.tmp, "out") if tr["artifacts"] else None
    return dict(batch_size=tr["batch"], host_preprocess=tr["host_preprocess"],
                artifacts=tr["artifacts"], out_dir=out,
                loader_threads=tr["loader_threads"], emit=cb,
                device=run.device)


def prepare(run) -> None:
    from unetseg_tpu_torch.io import native
    from unetseg_tpu_torch.parallel import pipeline

    tr, st = run.traffic, run.state
    d, n, size = tr["distinct_slices"], tr["study_slices"], tr["raw_size"]
    t = time.perf_counter()
    raws = inputs.slices(run.seed, d, size)
    t = run.part("inputs", t)
    paths = inputs.write_files(raws, os.path.join(run.tmp, "in"), n)
    t = run.part("files", t)
    ref_params, params, mcfg, _ = harness.weights(run, raws)
    t = run.part("weights", t)

    # one file of each distinct slice, drawn from the seed, is judged
    rng = np.random.default_rng([run.seed, 1])
    sample = {}
    for i in range(d):
        ks = np.arange(i, n, d)
        sample[int(ks[rng.integers(len(ks))])] = i
    lock = threading.Lock()
    st.update(raws=raws, paths=paths, ref_params=ref_params, params=params,
              mcfg=mcfg, sample=sample, lock=lock, received=[0],
              emitted={}, native=native, pipeline=pipeline)

    cb = None
    if tr["emit_callback"]:
        def cb(k, path, mask):
            fp = taps_mod.fingerprint(mask) if k in sample else None
            with lock:
                st["received"][0] += 1
                if fp is not None:
                    st["emitted"].setdefault(sample[k], set()).add(fp)
    st["cb"] = cb
    for _ in range(tr["warm_studies"]):
        pipeline.run_study(params, mcfg, paths, size, size,
                           **_options(run, cb))
    st["emitted"].clear()
    eng = st["engine"] = pipeline.study_engine(params, mcfg, run.device)
    b = tr["batch"]
    tap = st["taps"] = taps_mod.Taps(native, eng)
    tap.row_ids = lambda j, rows: [sample.get(j * b + r) for r in range(rows)]
    tap.install()
    gc.collect()
    run.part("warm", t)


def window(run, seconds: float, traced: bool) -> None:
    tr, st = run.traffic, run.state
    pipeline, native = st["pipeline"], st["native"]
    n, size = tr["study_slices"], tr["raw_size"]
    first, n_trace = tr["trace_after"], tr["trace_studies"]
    opts = _options(run, st["cb"])
    eng = st["engine"]
    studies, trace, prof, fw0 = [], None, None, 0
    span_ctx = spans([(pipeline, "_load_batch", "pipeline.load_batch"),
                      (native, "postprocess_packed_batch",
                       "native.postprocess_packed_batch"),
                      (native, "emit_batch", "native.emit_batch")])
    t0 = time.perf_counter()
    s = 0
    while True:
        in_trace = traced and first <= s < first + n_trace
        if traced and s == first:
            span_ctx.__enter__()
            prof = Profiler(run.tmp)
            fw0 = eng.forwards
            prof.start()
        pipeline.STAGES.reset()
        st["taps"].new_study()
        st["received"][0] = 0
        ts = time.perf_counter()
        ok = True
        try:
            pipeline.run_study(st["params"], st["mcfg"], st["paths"], size,
                               size, **opts)
        except Exception as e:  # a failed study completes no slice
            ok = False
            run.notes.append(f"study {s} failed: {type(e).__name__}: {e}")
        te = time.perf_counter()
        stages = {k: v["total_s"]
                  for k, v in pipeline.STAGES.summary().items()}
        if traced and s == first + n_trace - 1:
            trace = prof.stop()
            span_ctx.__exit__(None, None, None)
            run.ctx["traced_forwards"] = eng.forwards - fw0
        missing = (n - st["received"][0]) if st["cb"] is not None else 0
        studies.append(dict(ok=ok, wall=te - ts, traced=in_trace,
                            stages=stages, missing=missing))
        s += 1
        if te - t0 >= seconds and (not traced or s >= first + n_trace):
            break
    elapsed = te - t0

    done = [x for x in studies if x["ok"]]
    run.attempted = n * len(studies)
    run.failed = (n * (len(studies) - len(done))
                  + sum(x["missing"] for x in done))
    run.e2e["study_slices_per_s"] = n * len(done) / elapsed
    plain = [x for x in done if not x["traced"]]
    stage_s = {}
    for x in plain:
        for k, v in x["stages"].items():
            stage_s[k] = stage_s.get(k, 0.0) + v
    run.ctx.update(cfg=run.cfg, family=run.family, batch=tr["batch"],
                   stages=stage_s, slices_untraced=n * len(plain), trace=trace,
                   traced_slices=n * n_trace if trace is not None else 0)
    run.notes.append(
        f"window studies {len(studies)} slices {n * len(done)} "
        f"elapsed_s {elapsed} study_s "
        f"{[round(x['wall'], 4) for x in studies]}")
    run.notes.append(f"stages_untraced {stage_s}")
    if trace is not None:
        traced_wall = sum(x["wall"] for x in studies if x["traced"])
        plain_wall = sum(x["wall"] for x in plain)
        run.notes.append(
            f"tracing overhead: traced {n * n_trace / traced_wall} slices/s, "
            f"untraced {n * len(plain) / plain_wall if plain else None}")


def release(run) -> None:
    st = run.state
    if "taps" in st:
        st["taps"].uninstall()
    st.pop("engine", None)
    st.pop("params", None)
    # the study runner keeps its engines (and their weights on the card)
    # by params object; the reference runs after them, beside nothing
    st["pipeline"]._ENGINES.clear()
    gc.collect()


def judge(run) -> dict:
    tr, st, cfg = run.traffic, run.state, run.cfg
    size, d = cfg["image_size"], tr["distinct_slices"]
    raws, tap = st["raws"], st["taps"]
    t_judge = time.perf_counter()
    ids = sorted(tap.masks)
    u8_ref = {i: host.preprocess_u8(raws[i], size) for i in range(d)}
    ref = run.family.Reference(st["ref_params"], cfg, run.device)
    logits = ref.logits(np.stack([u8_ref[i] for i in ids])) if ids else []
    t_ref = time.perf_counter()
    t_poly = 0.0
    gap = cleanup_px = contour_files = emit_bad = u8_px = 0
    out = os.path.join(run.tmp, "out")
    inv = {i: k for k, i in st["sample"].items()}
    for lg, i in zip(logits, ids):
        rec = tap.masks[i]
        for j, (dec, clean) in enumerate(rec.instances):
            if dec.shape[-1] * 4 == size:
                dec = taps_mod.unpack2(dec)
            gap = max(gap, widest_gap(lg, dec))
            ref_clean = host.cleanup(dec)
            cleanup_px = max(cleanup_px, int((ref_clean != clean).sum()))
            if j == 0 and tr["artifacts"]:
                t = time.perf_counter()
                polys = host.polygons(ref_clean, tr["raw_size"],
                                      tr["raw_size"])
                base = os.path.splitext(os.path.basename(
                    st["paths"][inv[i]]))[0]
                path = os.path.join(out, base + ".json")
                if os.path.exists(path) != bool(polys) or (
                        polys and host.json_polygons(path) != polys):
                    contour_files += 1
                t_poly += time.perf_counter() - t
        if st["cb"] is not None:
            clean_fps = {fp[1] for fp in rec.fps}
            if not st["emitted"].get(i) or st["emitted"][i] - clean_fps:
                emit_bad += 1
    # the first u8 of a slice against the reference, plus the most pixels
    # by which a later one differed from that first (exact where the first
    # is; above the true count otherwise)
    for i, rec in tap.u8.items():
        first = rec.first.cpu().numpy()
        u8_px = max(u8_px, int((first != u8_ref[i]).sum())
                    + int(rec.most_differing))
    checks = {"gap_max": gap, "cleanup_px": cleanup_px,
              "unjudged": d - len(ids), "u8_px": u8_px,
              "u8_unjudged": d - len(tap.u8)}
    if tr["artifacts"]:
        checks["contour_files"] = contour_files
    if st["cb"] is not None:
        checks["emit_mismatch"] = emit_bad
    run.notes.append(
        f"judged slices {len(ids)} instances "
        f"{sum(tap.masks[i].seen for i in ids)} differing from their first "
        f"{sum(tap.masks[i].differing for i in ids)}; u8 instances "
        f"{sum(r.seen for r in tap.u8.values())}")
    run.notes.append(f"judge: reference_s {t_ref - t_judge} "
                     f"contours_s {t_poly} rest_s "
                     f"{time.perf_counter() - t_ref - t_poly}")
    del ref
    if torch.device(run.device).type == "cuda":
        torch.cuda.empty_cache()
    return checks
