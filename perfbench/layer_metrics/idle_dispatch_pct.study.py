"""The device's launch-bound stretches: the share of the traced window in
which the device was idle while the study thread enqueued a batch's work
(its ``study.dispatch`` span)."""

from perfbench.layer_metrics.idle_spans import idle_while_pct


def read(ctx):
    return idle_while_pct(ctx, "study.dispatch")
