"""The whole model step: the model's FLOPs per slice (the
``flops_per_slice`` of the configuration's reference module; the UNet's is
``counts.model_flops_per_slice``) times the slices the traced whole
studies completed, over the traced seconds, over the bf16 peak."""

from perfbench.readers import mfu_pct


def read(ctx):
    return mfu_pct(ctx)
