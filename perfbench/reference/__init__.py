"""Plain references the benchmark judges the program by; they import
nothing of the program.

A configuration names its model by the module its ``"reference"`` key
gives (``unet.py``, ``attention_unet.py``), which the harness loads by
path.  Such a module exports:

* ``init(cfg, generator, device)``: the seeded weights in the program's
  checkpoint (JAX) layout, rounded to the compute dtype;
* ``centre(tree, bias)``: the per-class bias put where the family's head
  adds it;
* ``Reference(params, cfg, device, quant=None, block=4)`` with
  ``.logits(u8)``, the float32 model (``quant="fp8"``: the control);
* ``flops_per_slice(cfg)``: every multiply-add of one slice's forward,
  times two.
"""
