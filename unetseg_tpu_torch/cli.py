"""Interactive CLI REPL over the port engine (``unetseg_tpu.cli``).

The reference's grammar (``src/main.cpp:51-196``):

    init <engine_cache_path> [--cascade <ckpt> [threshold]]
         [--cascade-disagree <co> <fb> [max_px]]
         [--cascade-both <co> <fb> [max_px] [margin_thr]]
    process [-r] [--batched] [--fast-emit] [--tier T] [--tta] [--window N]
            [--overlap N] [--per-class] <input> <width> <height> [output_dir]
    exit
    help

Directory inputs are walked (recursively with -r), mirroring relative paths
into the output directory; per-file failures do not abort the batch.
``--batched`` sends a directory through ``engine.process_batch``.  A file
input takes ``--tta`` (the 8-fold dihedral ensemble) and ``--window N``
(sliding windows at native resolution, ``--overlap N`` between them); a
directory input with any of the three is an error.  ``--per-class`` adds
``{base}_classes.json`` to either.  The ``--cascade*`` init options attach
the confidence cascade with the JAX REPL's defaults (margin 1.5; 106
disagreeing pixels).

``python -m unetseg_tpu_torch --serve [HOST:]PORT [--device-post]
[--timeout S]`` starts the TCP service instead.  ``--device DEV`` (default
``cuda``) picks the device of either; ``--device cpu`` rehearses on a host
without a card.  ``--partitions N`` serves concurrent clients from a pool of
partition engines (``service.py``; one engine per visible card at most).
"""

from __future__ import annotations

import os
import sys
from typing import List, Optional

from unetseg_tpu_torch import engine
from unetseg_tpu_torch.io import raw as raw_io

#: Disagreeing pixels above which ``--cascade-disagree`` / ``--cascade-both``
#: route a slice by default (the JAX REPL's: the 10%-budget point of its
#: disagreement experiment).
DISAGREE_PX = 106.0


def print_usage() -> None:
    print("\nMedical Image Segmentation Tool (PyTorch/CUDA)")
    print("Commands:")
    print("  init <engine_cache_path> [--cascade <ckpt> [threshold]] - Initialize segmentation engine")
    print("  process [-r] [--batched] [--tta] [--window N] [--per-class] <input> <width> <height> [output_dir] - Process file/directory")
    print("  exit                          - Cleanup and exit")
    print("\nOptions:")
    print("  -r                            - Recursively process directory")
    print("  --batched                     - Use batched inference for directories")
    print("  --fast-emit                   - Batched C++ artifact emission (with --batched)")
    print("  --tier full|mask_json|json    - Artifact set for --batched (default full)")
    print("  --tta                         - 8-fold dihedral TTA ensemble (file input)")
    print("  --window N                    - Sliding windows of N px at native resolution (file input)")
    print("  --overlap N                   - Window overlap (default N/2 of the window)")
    print("  --per-class                   - Also emit {base}_classes.json (per-class shapes)")
    print("  --cascade <ckpt> [threshold]  - Route low-margin slices to a stronger model (init)")
    print("  --cascade-disagree <co> <fb> [max_px] - Route on co-model pixel disagreement (init)")
    print("  --cascade-both <co> <fb> [max_px] [margin_thr] - Union router: disagreement OR low margin (init)")
    print("  <input>                       - Path to image file or directory")


def _process_directory(input_path: str, width: int, height: int,
                       output_dir: str, recursive: bool, batched: bool,
                       fast_emit: bool, tier: str, per_class: bool) -> None:
    print(f"Processing directory: {input_path}")
    print(f"Recursive: {'Yes' if recursive else 'No'}")
    files = raw_io.find_16bit_images(input_path, recursive)
    if not files:
        print("No 16-bit images found in directory")
        return
    print(f"Found {len(files)} images to process")

    out_dirs = []
    for f in files:
        file_output_dir = output_dir
        if recursive:
            rel = os.path.dirname(os.path.relpath(f, input_path))
            file_output_dir = os.path.join(output_dir, rel)
            os.makedirs(file_output_dir, exist_ok=True)
        out_dirs.append(file_output_dir)

    if batched:
        ok, fail = engine.process_batch(
            files, width, height, out_dirs,
            emitter="native" if fast_emit else "cv2", tier=tier,
            per_class=per_class)
    else:
        ok = fail = 0
        for f, d in zip(files, out_dirs):
            print(f"\nProcessing: {f}")
            if engine.process_single_image(f, width, height, d,
                                           per_class=per_class):
                ok += 1
            else:
                fail += 1
    print("\nDirectory processing completed:")
    print(f"  Success: {ok} files")
    print(f"  Failed: {fail} files")


def _cascade_options(rest: List[str]) -> Optional[dict]:
    """The cascade keywords of ``initialize_engine`` from the options after
    the checkpoint path, with the JAX REPL's defaults and messages; None
    (after printing the error) when they are malformed."""
    kw = {}
    if not rest:
        return kw
    flag = rest[0]
    if flag == "--cascade":
        if len(rest) < 2:
            print("Error: --cascade requires a checkpoint path",
                  file=sys.stderr)
            return None
        kw["cascade_ckpt"] = rest[1]
        if len(rest) > 2:
            try:
                kw["cascade_threshold"] = float(rest[2])
            except ValueError:
                print("Error: invalid cascade threshold", file=sys.stderr)
                return None
        return kw
    if flag in ("--cascade-disagree", "--cascade-both"):
        if len(rest) < 3:
            print(f"Error: {flag} requires <co_ckpt> <fallback_ckpt>",
                  file=sys.stderr)
            return None
        router = "disagree" if flag == "--cascade-disagree" else "both"
        kw.update(cascade_router=router, cascade_co_ckpt=rest[1],
                  cascade_ckpt=rest[2], cascade_threshold=DISAGREE_PX)
        if len(rest) > 3:
            try:
                kw["cascade_threshold"] = float(rest[3])
            except ValueError:
                print("Error: invalid disagreement threshold",
                      file=sys.stderr)
                return None
        if router == "both" and len(rest) > 4:
            try:
                kw["cascade_margin_threshold"] = float(rest[4])
            except ValueError:
                print("Error: invalid margin threshold", file=sys.stderr)
                return None
        return kw
    # a misspelled cascade flag must not initialize an engine without the
    # cascade the operator asked for
    print(f"Error: unknown init option {flag!r} (expected --cascade / "
          "--cascade-disagree / --cascade-both)", file=sys.stderr)
    return None


def _init(parts: List[str], device: str, device_postprocess: bool) -> bool:
    if len(parts) < 2:
        print("Error: Missing engine cache path", file=sys.stderr)
        return False
    kw = _cascade_options(parts[2:])
    if kw is None:
        return False
    if engine.initialize_engine(parts[1], device=device,
                                device_postprocess=device_postprocess, **kw):
        print("Engine initialized successfully")
        return True
    print("Engine initialization failed", file=sys.stderr)
    return False


def _process(args: List[str]) -> None:
    recursive = batched = fast_emit = tier_explicit = tta = False
    per_class = False
    window = overlap = None
    tier = "full"
    while args and args[0].startswith("-"):
        flag = args.pop(0)
        if flag == "-r":
            recursive = True
        elif flag == "--per-class":
            per_class = True
        elif flag == "--batched":
            batched = True
        elif flag == "--fast-emit":
            fast_emit = True
        elif flag == "--tta":
            tta = True
        elif flag == "--tier" and args:
            tier, tier_explicit = args.pop(0), True
        elif flag in ("--window", "--overlap") and args:
            try:
                value = int(args.pop(0))
            except ValueError:
                print(f"Error: {flag} requires an integer", file=sys.stderr)
                return
            if flag == "--window":
                window = value
            else:  # ignored without --window, as in the JAX engine
                overlap = value
        elif flag in ("--tier", "--window", "--overlap"):
            print(f"Error: {flag} requires a value", file=sys.stderr)
            return
        else:
            print(f"Error: unknown process option {flag!r}", file=sys.stderr)
            return
    if tier not in engine.ARTIFACT_TIERS:
        print(f"Error: --tier must be one of "
              f"{'|'.join(engine.ARTIFACT_TIERS)}", file=sys.stderr)
        return
    if len(args) < 3:
        print("Error: Invalid process command", file=sys.stderr)
        return
    input_path = args[0]
    try:
        width, height = int(args[1]), int(args[2])
    except ValueError:
        print("Error: Invalid process command", file=sys.stderr)
        return
    output_dir = args[3] if len(args) > 3 else os.path.dirname(input_path)
    os.makedirs(output_dir or ".", exist_ok=True)

    if os.path.isdir(input_path):
        dropped = [n for n, v in (("--tta", tta), ("--window", window),
                                  ("--overlap", overlap))
                   if v not in (False, None)]
        if dropped:
            print(f"Error: {dropped} not supported for directory inputs "
                  "(batched path)", file=sys.stderr)
            return
        _process_directory(input_path, width, height, output_dir, recursive,
                           batched, fast_emit, tier, per_class)
    elif os.path.isfile(input_path):
        dropped = [n for n, v in (("--batched", batched),
                                  ("--fast-emit", fast_emit),
                                  ("--tier", tier_explicit),
                                  ("-r", recursive)) if v]
        if dropped:
            print(f"Error: {dropped} apply to directory inputs only",
                  file=sys.stderr)
            return
        print(f"Processing file: {input_path}")
        if engine.process_single_image(input_path, width, height, output_dir,
                                       tta=tta, window=window,
                                       overlap=overlap, per_class=per_class):
            print("Processing completed")
        else:
            print("Processing failed", file=sys.stderr)
    else:
        print("Error: Input path is not a valid file or directory",
              file=sys.stderr)


def repl(stdin=None, device: str = "cuda",
         device_postprocess: bool = False) -> int:
    stdin = stdin or sys.stdin
    initialized = False
    print("Welcome to Medical Image Segmentation Tool")
    print_usage()

    while True:
        print("\n> ", end="", flush=True)
        line = stdin.readline()
        if not line:
            break
        parts = line.split()
        if not parts:
            continue
        cmd = parts[0]
        if cmd == "init":
            initialized = _init(parts, device, device_postprocess) or initialized
        elif cmd == "process":
            if not initialized:
                print("Error: Engine not initialized", file=sys.stderr)
                continue
            try:
                _process(parts[1:])
            except Exception as e:
                print(f"Processing error: {e}", file=sys.stderr)
        elif cmd == "exit":
            if initialized:
                engine.cleanup_resources()
            print("Exiting...")
            break
        elif cmd == "help":
            print_usage()
        else:
            print(f"Unknown command: {cmd}", file=sys.stderr)
    return 0


def _option(argv: List[str], flag: str, kind, default):
    """The value after ``flag`` in ``argv`` (``default`` if absent); raises
    ValueError when it is missing or not a ``kind``."""
    if flag not in argv:
        return default
    i = argv.index(flag)
    if i + 1 >= len(argv):
        raise ValueError(f"{flag} requires a value")
    return kind(argv[i + 1])


def _serve_address(argv: List[str]):
    """(host, port) of ``--serve [HOST:]PORT``; raises ValueError."""
    host, port = "127.0.0.1", 8473
    if len(argv) > 1 and not argv[1].startswith("--"):
        spec = argv[1]
        host, sep, p = spec.rpartition(":")
        if not sep:  # bare "PORT"
            host, p = "127.0.0.1", spec
        host = host or "127.0.0.1"
        # IPv6 literal: the [addr]:port form (a bare ::1:8473 is ambiguous)
        if host.startswith("[") and host.endswith("]"):
            host = host[1:-1]
        elif ":" in host:
            raise ValueError(f"IPv6 --serve addresses need brackets: "
                             f"[{host}]:{p}")
        try:
            port = int(p)
        except ValueError:
            raise ValueError(f"invalid --serve address '{spec}' "
                             "(expected [HOST:]PORT)") from None
    return host, port


def main(argv: Optional[List[str]] = None) -> int:
    """REPL by default; ``--serve [HOST:]PORT`` starts the TCP service
    (``service.py``), ``--device-post`` runs the mask cleanup on the device,
    ``--timeout S`` bounds each process request, ``--partitions N`` serves
    from a pool of partition engines, ``--device DEV`` picks the device
    (default cuda)."""
    argv = sys.argv[1:] if argv is None else argv
    try:
        device = _option(argv, "--device", str, "cuda")
        if argv and argv[0] == "--serve":
            host, port = _serve_address(argv)
            timeout_s = _option(argv, "--timeout", float, None)
            partitions = _option(argv, "--partitions", int, 1)
    except ValueError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 2
    device_postprocess = "--device-post" in argv
    if not (argv and argv[0] == "--serve"):
        return repl(device=device, device_postprocess=device_postprocess)
    from unetseg_tpu_torch import service

    service.serve(host, port, device_postprocess=device_postprocess,
                  request_timeout_s=timeout_s, partitions=partitions,
                  device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
