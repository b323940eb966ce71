"""Serving-daemon demo: start the TCP service, drive it like a client.  The
port of ``examples/service_client.py``.

    python -m unetseg_tpu_torch.examples.service_client [--out DIR]
        [--device cuda]

Starts ``SegmentationService`` in this process (in production: ``python
-m unetseg_tpu_torch --serve 8473`` in its own process), initializes it
with a fresh small checkpoint, submits one slice and a directory, and
prints the JSON responses; a response that is not ``ok`` fails the demo.
Artifacts land under ``DIR/single`` and ``DIR/batch``.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "unetseg_service_demo"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from unetseg_tpu_torch import checkpoint, service
    from unetseg_tpu_torch.config import ModelConfig
    from unetseg_tpu_torch.io import raw as raw_io

    out = args.out
    os.makedirs(os.path.join(out, "engine"), exist_ok=True)
    os.makedirs(os.path.join(out, "data"), exist_ok=True)
    ckpt = os.path.join(out, "engine", "model.ckpt")
    # a small model for the demo; a 512² checkpoint serves the same way
    checkpoint.create(ckpt, ModelConfig(base_channels=8, depth=2,
                                        image_size=64,
                                        compute_dtype="float32"))
    rng = np.random.default_rng(0)
    for i in range(4):
        raw_io.write_raw(os.path.join(out, "data", f"slice{i}.raw"),
                         rng.integers(0, 65536, (70, 90), np.uint16))

    svc = service.SegmentationService(port=0, device=args.device)
    addr = svc.start()
    print(f"service on {addr[0]}:{addr[1]}")
    try:
        for req in (
            {"cmd": "status"},
            {"cmd": "init", "cache": ckpt},
            {"cmd": "process", "path": os.path.join(out, "data", "slice0.raw"),
             "width": 90, "height": 70,
             "output_dir": os.path.join(out, "single")},
            {"cmd": "process", "path": os.path.join(out, "data"),
             "width": 90, "height": 70,
             "output_dir": os.path.join(out, "batch")},
            {"cmd": "status"},
        ):
            print(f">>> {req}")
            resp = service.request(addr, req)
            print(f"<<< {resp}")
            if not resp.get("ok"):
                raise RuntimeError(f"service {req['cmd']}: {resp}")
    finally:
        svc.stop()
    print(f"artifacts under {out}/single and {out}/batch")
    return 0


if __name__ == "__main__":
    sys.exit(main())
