"""Where one tile of the K6 kernel spends its cycles, on the card.

    python3 -m unetseg_tpu_torch.benchmarks.dec1_phases [B H W C]

Builds ``csrc/dec1_fused.cu`` with ``-DDEC1_PHASES`` (a separate library:
the served kernel carries no stamps), runs it once on seeded random
operands of the flagship's last level (default B=32, 512², C=64, three
classes), and prints one JSON line: the mean ``clock64`` cycles of each
phase of a tile per consumer warpgroup, the mean tile in cycles, and the
median time between two tiles' starts on one SM (``%globaltimer``, µs).
The phases, as the kernel stamps them: params (biases and head to f32),
x_wait, up_mma, up_epilogue (with its barrier), skip_wait, conv1,
c1_epilogue (with its barrier), conv2 (with c2's epilogue), head (with its
barrier).  Needs a card; exits 1 without one.
"""

from __future__ import annotations

import ctypes
import json
import sys

import torch

from unetseg_tpu_torch._build import Library, check, cuda
from unetseg_tpu_torch.ops import dec1

PHASES = ("params", "x_wait", "up_mma", "up_epilogue", "skip_wait", "conv1",
          "c1_epilogue", "conv2", "head")


#: The stamped build of the kernel library.
LIBRARY = Library("libdec1_phases", cuda("-DDEC1_PHASES"), [dec1.SOURCE],
                  deps=[dec1.HEADER], functions={
                      **dec1.FUNCTIONS,
                      "utdec1_set_phase_buffer": (ctypes.c_int,
                                                  [ctypes.c_void_p])})


def run(B: int = 32, H: int = 512, W: int = 512, C: int = 64,
        K: int = 3) -> dict:
    lib = LIBRARY.load()
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(
            torch.bfloat16)

    ops = [torch.relu(rand(B, H // 2, W // 2, 2 * C)),
           torch.relu(rand(B, H, W, C)), rand(2 * C, 4 * C, scale=0.1),
           rand(C, scale=0.1), rand(3, 3, 2 * C, C, scale=0.05),
           rand(C, scale=0.1), rand(3, 3, C, C, scale=0.05),
           rand(C, scale=0.1), rand(C, K, scale=0.1), rand(K, scale=0.1)]
    plan = dec1.tile_plan(B, H, W, C)
    stamps = torch.zeros((plan.grid, 2, 16), dtype=torch.int64, device=dev)
    out = torch.empty((B, H, W), dtype=torch.uint8, device=dev)
    if lib.utdec1_set_phase_buffer(stamps.data_ptr()):
        raise RuntimeError("dec1_phases: cannot set the stamp buffer")
    for _ in range(2):  # the second run is the one kept
        check(lib.utdec1_fused_bf16(
            *(t.data_ptr() for t in ops), out.data_ptr(), B, H, W, C, K,
            plan.th, plan.tw, plan.stages,
            torch.cuda.current_stream().cuda_stream), "dec1_phases")
        torch.cuda.synchronize()
    t = stamps.cpu().double()
    cycles = (t[..., 1:10] - t[..., :9]).mean(0)  # (group, phase)
    starts, sms = t[:, 0, 14], t[:, 0, 15].long()
    periods = []
    for sm in sms.unique():
        s = starts[sms == sm].sort().values
        if len(s) > 2:
            periods.append((s[1:] - s[:-1]).median().item())
    periods.sort()
    return {"shape": [B, H, W, C], "classes": K, "tile": [plan.th, plan.tw],
            "tiles": plan.grid,
            "cycles": [{p: round(cycles[wg, i].item())
                        for i, p in enumerate(PHASES)} for wg in range(2)],
            "tile_cycles": round((t[..., 9] - t[..., 0]).mean().item()),
            "tile_period_us": periods[len(periods) // 2] / 1e3,
            "device": torch.cuda.get_device_name(0)}


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("dec1_phases: CUDA is not available", file=sys.stderr)
        return 1
    args = [int(a) for a in (sys.argv[1:] if argv is None else argv)]
    print(json.dumps({"phase": "dec1_phases", **run(*args)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
