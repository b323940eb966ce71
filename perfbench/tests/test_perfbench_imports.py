"""Neither the harness nor its reference loads JAX or the JAX package
(top-level module names compared whole: the port's name starts with the
JAX package's), the reference loads nothing of the program, and the
command fails without the program beside it."""

import json
import os
import shutil
import subprocess
import sys

from perfbench import harness

PROBE = """
import sys, json
sys.path.insert(0, {root!r})
{imports}
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def _loaded(imports):
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(root=harness.ROOT,
                                            imports=imports)],
        capture_output=True, text=True, check=True, cwd=harness.ROOT)
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_harness_loads_no_jax():
    mods = _loaded("import perfbench.harness, perfbench.kinds.study, "
                   "perfbench.trace, perfbench.readers, "
                   "perfbench.calibrate\n"
                   "import unetseg_tpu_torch.parallel.pipeline\n"
                   "[perfbench.harness.reader(m['name']) for m in "
                   "perfbench.harness.manifest()['per_layer']]")
    assert "unetseg_tpu_torch" in mods
    assert not mods & set(harness.FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    mods = _loaded("import perfbench.reference.unet, "
                   "perfbench.reference.host, perfbench.reference.contours")
    assert not mods & {"unetseg_tpu_torch", *harness.FORBIDDEN}


def test_forbidden_names_are_whole():
    sys.modules.setdefault("unetseg_tpu_torch_probe_only", sys)
    try:
        assert "unetseg_tpu_torch_probe_only" not in \
            harness.forbidden_modules()
    finally:
        del sys.modules["unetseg_tpu_torch_probe_only"]


def test_command_fails_alone(tmp_path):
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(harness.ROOT, "perfbench"),
                    tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "flagship.study_masks",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=tmp_path)
    assert out.returncode != 0 and not out.stdout.strip()
