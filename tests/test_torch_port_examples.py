"""The port's demos (``unetseg_tpu_torch.examples``) run on the CPU and
write what the JAX package's ``examples/`` write: ``end_to_end`` (3 training
steps) its checkpoint and the served slice's artifacts, ``service_client``
the single slice's and the directory's artifacts, ``cascade_tiers`` the
``json`` tier's size JSONs only."""

import os

import pytest

from unetseg_tpu_torch.examples import cascade_tiers, end_to_end, \
    service_client

from test_torch_port_native_ready import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _names(d):
    return sorted(os.listdir(d))


@pytest.mark.parametrize("demo", ["end_to_end", "service_client",
                                  "cascade_tiers"])
def test_demo_writes_its_artifacts(demo, tmp_path, capsys):
    out = str(tmp_path / demo)
    argv = ["--out", out, "--device", "cpu"]
    if demo == "end_to_end":
        assert end_to_end.main(argv + ["--steps", "3"]) == 0
        assert os.path.getsize(os.path.join(out, "engine", "model.ckpt"))
        arts = _names(os.path.join(out, "results"))
        # a slice without contours has no overlay and no contour JSON
        assert {"case_001_normalized.png", "case_001_original_sizes.json",
                "case_001_mask.png"} <= set(arts)
        assert "process_single_image: True" in capsys.readouterr().out
    elif demo == "service_client":
        assert service_client.main(argv) == 0
        assert {"slice0_normalized.png", "slice0_original_sizes.json",
                "slice0_mask.png"} <= set(_names(os.path.join(out, "single")))
        batch = _names(os.path.join(out, "batch"))
        assert {f"slice{i}_mask.png" for i in range(4)} <= set(batch)
    else:
        assert cascade_tiers.main(argv) == 0
        arts = _names(os.path.join(out, "artifacts"))
        assert {f"s{i}_64_64_original_sizes.json" for i in range(4)} \
            <= set(arts)
        assert all(a.endswith(".json") for a in arts)
        assert "size record:" in capsys.readouterr().out
