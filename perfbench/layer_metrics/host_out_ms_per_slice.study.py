"""Host out: the study runner's ``cleanup`` and ``emit`` stages (the C++
mask cleanup; the artifact emitter, summed over its threads) per slice,
over the run's untraced studies."""

from perfbench.readers import stage_ms_per_slice


def read(ctx):
    return stage_ms_per_slice(ctx, "cleanup", "emit")
