"""Device-memory bandwidth through the halo-copy kernels (K4 and K5).

The port of ``benchmarks/exp_bw.py``: copies (32, 514, 257, 128) bf16 to
(32, 512, 256, 128) with the kernel of each TPU copy mode, row offset 1
(``copy_elem``) and row offset 0 (``copy_blocked``), and prints each one's
time and rate beside the one-call yardstick
``x[:, o:o+512, :256].contiguous()`` and the bound (each needed byte read
once and written once at 3.35 TB/s).  ``chip_smoke.py`` holds the kernels
against the slice; this script only times them.  Needs a CUDA card::

    python -m unetseg_tpu_torch.benchmarks.exp_bw
"""

from __future__ import annotations

import json
import sys

import torch

from unetseg_tpu_torch.ops import halo_copy

SHAPE = (32, 514, 257, 128)   # (B, H + 2, W2 + 1, K), as exp_bw.py:36
H, W2 = 512, 256
PEAK_HBM_BYTES = 3.35e12      # H100 SXM (NVIDIA data sheet)


def moved_bytes() -> int:
    """Bytes the copy must move: the output read once and written once."""
    b, _, _, k = SHAPE
    return 2 * b * H * W2 * k * 2


def bound_ms() -> float:
    return moved_bytes() / PEAK_HBM_BYTES * 1e3


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("exp_bw: CUDA is not available", file=sys.stderr)
        return 1
    x = torch.randn(SHAPE, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(0)).to(torch.bfloat16)
    gb = moved_bytes() / 1e9
    rows = []
    for offset, name in sorted(halo_copy.NAMES.items(), reverse=True):
        k_ms = time_ms(lambda: halo_copy.halo_copy(x, H, W2, offset))
        lib_ms = time_ms(lambda: x[:, offset:offset + H, :W2].contiguous())
        rows.append({"kernel": name, "row_offset": offset, "ms": k_ms,
                     "gb_per_s": gb / k_ms * 1e3, "contiguous_ms": lib_ms,
                     "contiguous_gb_per_s": gb / lib_ms * 1e3,
                     "bound_ms": bound_ms(), "card": torch.cuda.get_device_name(0)})
        print(json.dumps({"phase": "exp_bw", **rows[-1]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
