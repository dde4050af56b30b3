"""The port's serving entry point (``repro_torch/launch/serve.py``) against
the reference's (``repro/launch/serve.py``) on the CPU: for the same
arch, seed and flags both drive the same synthetic trace, so the
engine's counters (admitted, rejected, finished and why, decode steps,
slot occupancy) and the request and token counts they print are equal,
though the tokens are not (the weights come from another generator)."""
import re
import sys
from unittest import mock

import pytest
import torch

from repro.launch import serve as jserve
from repro_torch.launch import serve as tserve

torch.set_num_threads(1)
ENGINE_LINE = re.compile(
    r"engine: admitted=(\d+) rejected=(\d+) finished=(\d+) \(stop=(\d+) "
    r"length=(\d+)\) decode_steps=(\d+) occupancy=(\d+\.\d\d)")
SERVED_LINE = re.compile(r"served (\d+) requests, (\d+) tokens, [\d.]+ tok/s")
CASES = [
    ("llama2-7b", []),
    ("llama3-8b", ["--requests", "5", "--slots", "2", "--max-new", "6"]),
    ("qwen3-0.6b", ["--sample"]),
    ("minitron-4b", ["--vq-mode", "dequant", "--max-new", "5"]),
    ("qwen2-72b", ["--no-quantize", "--requests", "3", "--smoke"]),
    ("mixtral-8x22b", ["--requests", "5", "--slots", "2", "--max-new", "6"]),
    ("deepseek-v2-lite-16b", ["--requests", "5", "--slots", "2",
                              "--max-new", "6"]),
    ("recurrentgemma-2b", ["--requests", "5", "--slots", "2",
                           "--max-new", "6"]),
]


def _lines(capsys, run):
    run()
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 2, out
    served, engine = SERVED_LINE.fullmatch(out[0]), ENGINE_LINE.fullmatch(out[1])
    assert served and engine, out
    return served.groups(), engine.groups()


def _reference_main(argv):
    with mock.patch.object(sys, "argv", ["serve", *argv]):
        jserve.main()


@pytest.mark.parametrize("arch,flags", CASES, ids=[c[0] for c in CASES])
def test_cli_prints_the_reference_counters(arch, flags, capsys):
    argv = ["--arch", arch, *flags]
    want = _lines(capsys, lambda: _reference_main(argv))
    got = _lines(capsys, lambda: tserve.main([*argv, "--device", "cpu"]))
    assert got == want


def test_cli_serves_xlstm(capsys):
    """xlstm-125m (SMOKE, bf16) through the port's CLI: the reference's
    two lines, every request admitted and finished at its length. The
    reference's own CLI cannot serve it on the CPU (XLA's CPU dot takes
    no bf16 x bf16 -> fp32, which its sLSTM gates ask for), so the
    counters are checked against the trace, not against it."""
    served, engine = _lines(capsys, lambda: tserve.main(
        ["--arch", "xlstm-125m", "--requests", "5", "--slots", "2",
         "--max-new", "6", "--device", "cpu"]))
    assert served == ("5", "30")
    admitted, rejected, finished, stop, length, steps, occ = engine
    assert (admitted, rejected, finished, stop, length) == \
        ("5", "0", "5", "0", "5")
    assert int(steps) >= 3 * 5 and 0 < float(occ) <= 1


def test_serve_returns_the_engine_and_every_request():
    out = tserve.serve("qwen3-0.6b", requests=3, max_new=4, num_slots=2,
                       device="cpu")
    eng = out["engine"]
    assert out["tokens"] == 12 and len(out["results"]) == 3
    assert all(len(t) == 4 for t in out["results"].values())
    assert eng.model.cfg.name == "qwen3-0.6b-smoke"
    assert eng.ecfg.max_len == 12 + 4 + 8
    assert eng.metrics()["finished_length"] == 3


def test_serve_runs_on_the_card_by_default():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tserve.serve("llama3-8b")
    # the vision family serves its smoke config from 8 image rows
    out = tserve.serve("llama-3.2-vision-11b", requests=2, max_new=3,
                       num_slots=2, device="cpu")
    assert out["engine"].model.cfg.name == "llama-3.2-vision-smoke"
    assert out["tokens"] == 6 and len(out["results"]) == 2
