"""Host out, as the card feels it: the share of the traced window in which
the device was idle while the study thread ran the mask cleanup (its
``study.cleanup`` span)."""

from perfbench.layer_metrics.idle_spans import idle_while_pct


def read(ctx):
    return idle_while_pct(ctx, "study.cleanup")
