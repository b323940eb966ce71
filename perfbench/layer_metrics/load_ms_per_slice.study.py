"""Host in: the study runner's ``load`` stage (RAW read, host preprocess,
tail padding; summed over the loader threads) per slice, over the run's
untraced studies."""

from perfbench.readers import stage_ms_per_slice


def read(ctx):
    return stage_ms_per_slice(ctx, "load")
