"""The device, its host side: the study thread's ``dispatch`` stage (enqueueing
the device preprocess, the forward, the mask packing and the copy back)
per slice, over the run's untraced studies."""

from perfbench.readers import stage_ms_per_slice


def read(ctx):
    return stage_ms_per_slice(ctx, "dispatch")
