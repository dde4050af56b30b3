"""A cell run on the card, end to end, through the benchmark's command:
the result line's form and the run's correctness. Skips without a card
(decided inside the test). Run on the card with
``python -m pytest -m cuda evabench/tests``."""
import json
import subprocess
import sys

import pytest

import evabench_smoke  # noqa: F401  (puts evabench/ on the path)
from bench.manifest import ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_small_cell_on_the_card(trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    res = subprocess.run([sys.executable, "evabench/run.py", "--workload",
                          "qwen3_0_6b.chat_decode", "--seed", str(2 ** 31 + 7),
                          "--seconds", "5", "--trace", str(trace)], cwd=ROOT,
                         capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] is True
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 1
    assert list(out)[-1] == "compared"
    want = ({"engine.decode_step_ms", "step_mfu", "device.idle_share"}
            if trace else {"setup_s", "output_tok_s", "itl_p95_ms",
                           "peak_mem_gib"})
    assert want <= set(out["metrics"])
    if trace:
        assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
