"""The correctness check sees a broken timed path: a whole run at a size
the CPU holds (the look for a card skipped), with the engine broken
underneath, comes out not correct; unbroken, it comes out correct. The
control (the plain reference in fp8 put in the program's place) reads a
wider gap than the program on the same tokens, and comes out not correct
against each cell's own limits (``evabench/workloads``). The cell runs on one chip, so there
is no exchange between chips to leave out."""
import json

import pytest

import evabench_smoke as smoke
from bench.cell import run_cell
from bench.manifest import HERE

CELL = "qwen2_72b.chat_decode"
CELLS = [w["name"] for w in json.load(open(HERE.parent / "BENCHMARK.json"))[
    "workloads"]]
LIMITS = json.load(open(HERE / "workloads" / f"{CELL}.json"))["judge"][
    "limits"]
SEED = 2 ** 31 + 99


def run(seconds=4.0):
    """Four slots, four layers, answers of 8-24 tokens: long enough that
    a cache left unwritten is attended over; every finished request is
    judged, so a fault in some lanes cannot miss the sample."""
    c = smoke.cell("qwen2", CELL, LIMITS)
    c.config["run"]["num_hidden_layers"] = 4
    c.workload["judge"]["sample"] = 1000
    c.workload["engine"].update(num_slots=4, max_len=64)
    c.traffic.update(clients=4, output_len=[8, 24], first_output_len=[1, 24])
    return run_cell(c, SEED, seconds, False, "cpu", 0.0)


def test_unbroken_run_is_correct():
    out = run()
    assert out["correct"], out["compared"]
    # enough finished requests that every lane's are among them
    assert out["attempted"] >= 8 and out["failed"] == 0


def _altered(monkeypatch):
    """Every lane's token altered where it is sampled, every third step."""
    from repro_torch.serve import api

    real, calls = api.sample_and_stop, [0]

    def sample_and_stop(logits, **kw):
        tok, done, bad = real(logits, **kw)
        calls[0] += 1
        if calls[0] % 3 == 0:
            tok = (tok + 1) % logits.shape[-1]
        return tok, done, bad

    monkeypatch.setattr(api, "sample_and_stop", sample_and_stop)


def _state_unchanged(monkeypatch):
    """Each decode step attends over its cache but leaves it as it was:
    no new row and no new length."""
    from repro_torch.models import common as cm

    def decode(p, q, rows, cache, rc, window=0):
        return cm.decode_attention(q, cache["k"], cache["v"],
                                   cache["len"].clamp(min=1))

    monkeypatch.setattr(cm, "_decode_contiguous", decode)


def _half_batch(monkeypatch):
    """The second half of the lanes is left out: it gets the first
    half's logits."""
    from repro_torch.serve import api

    real = api.sample_and_stop

    def sample_and_stop(logits, **kw):
        half = logits.shape[0] // 2
        logits = logits.clone()
        logits[half:2 * half] = logits[:half]
        return real(logits, **kw)

    monkeypatch.setattr(api, "sample_and_stop", sample_and_stop)


@pytest.mark.parametrize("fault", [_altered, _state_unchanged, _half_batch],
                         ids=["token_altered", "state_unchanged",
                              "half_batch_left_out"])
def test_a_broken_path_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    out = run()
    assert not out["correct"], out["compared"]


def _cell_limits(name):
    w = json.load(open(HERE / "workloads" / f"{name}.json"))
    conf = json.load(open(HERE / "configs" / f"{w['config']}.json"))
    return ("qwen3" if conf["run"]["qk_norm"] else "qwen2"), w["judge"][
        "limits"]


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    """The fp8 control, judged against the cell's own limits as the
    program is, comes out not correct on every seed; the program, on the
    same tokens, correct. Twelve layers: fp8's error grows with depth,
    and at four it reads under the limits set at the cells' own depth."""
    kind, limits = _cell_limits(name)
    c = smoke.cell(kind, name, limits)
    c.config["run"].update(num_hidden_layers=12)
    c.workload["judge"]["sample"] = 8
    for seed in (1, 2, 3):
        out = run_cell(c, seed, 1.0, False, "cpu", 0.0, ("fp8",))
        control = out["controls"]["fp8"]
        assert out["correct"], (seed, out["compared"])
        assert not control["correct"], (seed, control["compared"])
