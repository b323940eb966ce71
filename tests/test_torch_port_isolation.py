"""``unetseg_tpu_torch``, every submodule and ``chip_smoke.py`` import
without JAX, flax, optax, OpenCV or the JAX package."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
import unetseg_tpu_torch
names = [m.name for m in pkgutil.walk_packages(unetseg_tpu_torch.__path__,
                                               "unetseg_tpu_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                    "unetseg_tpu", "cv2"))
print(len(names), bad, *names)
"""
#: Modules of the later slices, named so the walk cannot miss them.
NEW_MODULES = ("unetseg_tpu_torch.ops.dec1", "unetseg_tpu_torch.ops.halo_copy",
               "unetseg_tpu_torch.benchmarks.exp_bw",
               "unetseg_tpu_torch.parallel", "unetseg_tpu_torch.parallel.tiles",
               "unetseg_tpu_torch.parallel.tta",
               "unetseg_tpu_torch.parallel.pipeline", "unetseg_tpu_torch.metrics",
               "unetseg_tpu_torch.reference_twin",
               "unetseg_tpu_torch.io.contours_py",
               "unetseg_tpu_torch.utils.profiling",
               "unetseg_tpu_torch.utils.watchdog", "unetseg_tpu_torch.bench",
               "unetseg_tpu_torch.io.png", "unetseg_tpu_torch.io.jsonfmt",
               "unetseg_tpu_torch.compat", "unetseg_tpu_torch.ops.confidence",
               "unetseg_tpu_torch.models.attention_unet",
               "unetseg_tpu_torch.models.unetpp",
               "unetseg_tpu_torch.models.import_torch",
               "unetseg_tpu_torch.models.import_onnx",
               "unetseg_tpu_torch.parallel.mesh",
               "unetseg_tpu_torch.parallel.batch",
               "unetseg_tpu_torch.parallel.distributed",
               "unetseg_tpu_torch.quantize", "unetseg_tpu_torch.ops.conv_s8",
               "unetseg_tpu_torch.train",
               "unetseg_tpu_torch.benchmarks.train_flagship",
               "unetseg_tpu_torch.benchmarks.k7_bench",
               "unetseg_tpu_torch.parallel.spatial",
               "unetseg_tpu_torch.benchmarks.run_all",
               "unetseg_tpu_torch.benchmarks.eval_shift",
               "unetseg_tpu_torch.benchmarks.eval_real",
               "unetseg_tpu_torch.examples",
               "unetseg_tpu_torch.examples.end_to_end",
               "unetseg_tpu_torch.examples.service_client",
               "unetseg_tpu_torch.examples.cascade_tiers")


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    n, bad, *names = proc.stdout.strip().split(" ")
    assert int(n) >= 45 and bad == "[]", proc.stdout
    assert set(NEW_MODULES) <= set(names), proc.stdout


def test_port_sources_name_no_jax():
    """No module of the port, nor ``chip_smoke.py``, even mentions
    importing the JAX side."""
    import unetseg_tpu_torch

    root = os.path.dirname(unetseg_tpu_torch.__file__)
    sources = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, _, files in os.walk(root):
        sources += [os.path.join(dirpath, f) for f in files
                    if f.endswith(".py")]
    assert len(sources) >= 46
    assert {os.path.join(root, "ops", "dec1.py"),
            os.path.join(root, "ops", "halo_copy.py"),
            os.path.join(root, "benchmarks", "exp_bw.py"),
            os.path.join(root, "parallel", "tiles.py"),
            os.path.join(root, "parallel", "tta.py"),
            os.path.join(root, "parallel", "pipeline.py"),
            os.path.join(root, "metrics.py"),
            os.path.join(root, "reference_twin.py"),
            os.path.join(root, "io", "contours_py.py"),
            os.path.join(root, "utils", "profiling.py"),
            os.path.join(root, "utils", "watchdog.py"),
            os.path.join(root, "bench.py"),
            os.path.join(root, "io", "png.py"),
            os.path.join(root, "io", "jsonfmt.py"),
            os.path.join(root, "compat.py"),
            os.path.join(root, "ops", "confidence.py"),
            os.path.join(root, "models", "attention_unet.py"),
            os.path.join(root, "models", "unetpp.py"),
            os.path.join(root, "models", "import_torch.py"),
            os.path.join(root, "models", "import_onnx.py"),
            os.path.join(root, "parallel", "mesh.py"),
            os.path.join(root, "parallel", "batch.py"),
            os.path.join(root, "parallel", "distributed.py"),
            os.path.join(root, "parallel", "spatial.py"),
            os.path.join(root, "quantize.py"),
            os.path.join(root, "ops", "conv_s8.py"),
            os.path.join(root, "train.py"),
            os.path.join(root, "benchmarks", "train_flagship.py")} \
        <= set(sources)
    # the float32 kernel's wrapper (K8) is the conv module
    from unetseg_tpu_torch.ops import conv

    assert conv.SOURCE_F32 == os.path.join(root, "csrc", "conv3x3_f32.cu")
    assert os.path.exists(conv.SOURCE_F32)
    for path in sources:
        src = open(path).read()
        for word in ("import jax", "from jax", "import flax",
                     "from flax", "import optax", "from optax",
                     "import cv2", "from cv2 import",
                     "from unetseg_tpu ",
                     "from unetseg_tpu.", "import unetseg_tpu\n",
                     "import unetseg_tpu."):
            assert word not in src, (path, word)
