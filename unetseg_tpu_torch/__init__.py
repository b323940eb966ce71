"""PyTorch/CUDA port of ``unetseg_tpu`` for one NVIDIA H100.

The same service (16-bit RAW slices -> UNet masks -> polygon-contour JSON and
PNG artifacts) with the same entry points, checkpoints and artifacts as the
JAX package, which stays beside it as the reference.  Every 3x3 conv of the
UNet runs in a hand-written Hopper kernel (``csrc/conv3x3.cu``).  The package
imports torch, numpy and the standard library only: never jax, flax or
``unetseg_tpu``.

    from unetseg_tpu_torch import engine
    engine.initialize_engine("models/flagship_slim4.ckpt")   # device="cuda"
    engine.process_single_image(image_path, width, height, output_dir)
    engine.cleanup_resources()
"""

__version__ = "0.1.0"
