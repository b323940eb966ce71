"""Host in, as the card feels it: the share of the traced window in which the
device was idle while the study thread waited for a loaded batch (its
``study.wait_load`` span)."""

from perfbench.layer_metrics.idle_spans import idle_while_pct


def read(ctx):
    return idle_while_pct(ctx, "study.wait_load")
