"""The device: the study thread's ``d2h`` stage (waiting for a batch's masks on
the host: the device's remaining work and the copy back) per slice, over
the run's untraced studies."""

from perfbench.readers import stage_ms_per_slice


def read(ctx):
    return stage_ms_per_slice(ctx, "d2h")
