"""The study runner: its own thread's ``wait_load`` stage (waiting for the next
loaded batch; the next load's submission with it) per slice, over the
run's untraced studies."""

from perfbench.readers import stage_ms_per_slice


def read(ctx):
    return stage_ms_per_slice(ctx, "wait_load")
