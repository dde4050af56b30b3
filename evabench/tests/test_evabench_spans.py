"""The readers of the engine's own tracer and counters
(``bench/spans.py``; ``metrics/device.starved_share``,
``model.decode_graph_ms``, ``engine.host_ms_per_tick``,
``engine.prefill_pad_share``) against hand counts on synthetic runs, and
the program-traced stretch end to end on the CPU."""
import pytest

import evabench_smoke as smoke
from bench import spans
from bench.cell import Run
from bench.loop import Clients, Tick
from bench.manifest import reader
from bench.port import Served
from bench.traffic import ClosedLoop, prompt_lengths
from repro_torch.serve.tracing import OFF

MS = 1_000_000      # ns


def _rec(name, i, parent, a, b, wait=False, device=False):
    return {"name": name, "id": None if device else i, "parent": parent,
            "start_ns": a, "end_ns": b, "uid": None, "wait": wait,
            "device": device, "attrs": {}}


def _two_ticks():
    """Two 10 ms ticks 5 ms apart (the harness between them). The first
    prefills (a 2 ms replay, a 1 ms sync) and decodes; the second
    decodes. Graphs of 4 and 5 ms, epilogues of 1 ms, readbacks of 2 ms."""
    recs = [_rec("engine.step", 0, None, 0, 10 * MS),
            _rec("engine.prefill", 1, 0, 0, 4 * MS),
            _rec("prefill.replay", 2, 1, 0, 2 * MS),
            _rec("prefill.sync", 3, 1, 2 * MS, 3 * MS, wait=True),
            _rec("engine.decode", 4, 0, 4 * MS, 10 * MS),
            _rec("decode.graph", 5, 4, 4 * MS, 5 * MS),
            _rec("decode.epilogue", 6, 4, 5 * MS, 6 * MS),
            _rec("decode.readback", 7, 4, 6 * MS, 8 * MS, wait=True),
            _rec("engine.step", 8, None, 15 * MS, 25 * MS),
            _rec("engine.decode", 9, 8, 15 * MS, 25 * MS),
            _rec("decode.graph", 10, 9, 15 * MS, 16 * MS),
            _rec("decode.epilogue", 11, 9, 16 * MS, 17 * MS),
            _rec("decode.readback", 12, 9, 17 * MS, 23 * MS, wait=True)]
    segs = [("prefill.replay", 2, 0, 2 * MS),
            ("decode.graph", 5, 4 * MS, 8 * MS),
            ("decode.epilogue", 6, 8 * MS, 9 * MS),
            ("decode.graph", 10, 15 * MS, 20 * MS),
            ("decode.epilogue", 11, 20 * MS, 21 * MS)]
    recs += [_rec(n, None, p, a, b, device=True) for n, p, a, b in segs]
    ticks = [Tick(0.0, 0.01, prefills=[5], attended=[9, 12]),
             Tick(0.015, 0.025, attended=[10, 13])]
    return spans.Spans(recs, ticks)


def _run(counters_open=None, counters_close=None, with_spans=None):
    r = Run(cell=None, setup_s=0.0, peak_bytes=0, t_open=0.0, t_close=1.0,
            streams=[], ticks=[], counters_open=counters_open or {},
            counters_close=counters_close or {})
    if with_spans is not None:
        r.spans = with_spans
    return r


def test_starved_share_of_known_segments():
    # busy 2 + 5 (graph and epilogue abut) + 6 = 13 of 25 ms
    s = _two_ticks()
    assert spans.starved_share(s) == pytest.approx((1 - 13 / 25) * 100)
    assert reader("device.starved_share")(_run(with_spans=s)) == \
        pytest.approx(48.0)
    # overlapping and out-of-window segments count once, inside it
    s.records.append(_rec("decode.graph", None, 5, 3 * MS, 5 * MS,
                          device=True))
    s.records.append(_rec("decode.graph", None, 5, 24 * MS, 40 * MS,
                          device=True))
    assert spans.starved_share(s) == pytest.approx((1 - 15 / 25) * 100)


def test_gaps_named_by_the_innermost_span():
    got = dict(spans.gaps_by_span(_two_ticks()))
    # a span holds the instants from its start to its end: 2-4 ms, the
    # sync (its middle, 3 ms, is the sync's end); 9-15 between steps
    # (its middle, 12 ms); 21-25 the readback (23 ms)
    assert got == pytest.approx({"prefill.sync": 0.002,
                                 "between steps": 0.006,
                                 "decode.readback": 0.004})


def test_decode_graph_ms():
    s = _two_ticks()
    assert reader("model.decode_graph_ms")(_run(with_spans=s)) == \
        pytest.approx(4.5)
    assert spans.segment_ms(s, "prefill.replay") == pytest.approx(2.0)


def test_host_ms_with_nested_waits():
    s = _two_ticks()
    # 10 - 1 - 2 and 10 - 6
    assert spans.host_ms_per_tick(s) == pytest.approx((7 + 4) / 2)
    # a wait inside a wait is counted once
    s.records.append(_rec("inner", 99, 7, 6 * MS, 7 * MS, wait=True))
    assert reader("engine.host_ms_per_tick")(_run(with_spans=s)) == \
        pytest.approx(5.5)


def test_pad_share_from_counters():
    open_ = {"prefill_bucket_tokens": 100, "prefill_prompt_tokens": 60}
    close = {"prefill_bucket_tokens": 3956, "prefill_prompt_tokens": 2636}
    got = reader("engine.prefill_pad_share")(_run(open_, close))
    assert got == pytest.approx(1280 / 3856 * 100)       # 33.2%
    assert reader("engine.prefill_pad_share")(_run(open_, open_)) is None


@pytest.mark.parametrize("name", ["device.starved_share",
                                  "model.decode_graph_ms",
                                  "engine.host_ms_per_tick",
                                  "engine.prefill_pad_share"])
def test_silent_on_a_program_without_them(name):
    counters = {"prefill_prompt_tokens": 10}     # no prefill_bucket_tokens
    assert reader(name)(_run(counters, counters)) is None


def test_program_traced_stretch_on_the_cpu():
    c = smoke.cell("qwen3", "qwen3_0_6b.chat_decode")
    from bench import weights

    w = weights.draw(c.cfg, 2 ** 31 + 7, "cpu")
    served = Served(c.cfg, w, c.workload["engine"], "cpu")
    clients = Clients(served, ClosedLoop(c.traffic, c.cfg["vocab_size"],
                                         2 ** 31 + 7))
    served.warm(prompt_lengths(c.traffic))
    clients.start()
    clients.run_until(lambda t: clients.filled())
    before = served.counters()
    s = spans.program_trace(served.eng, clients.tick, 1.0)
    assert served.eng.tracer is OFF                 # off again
    roots = s.roots()
    assert len(roots) == len(s.ticks) >= 2
    assert s.ticks[-1].t1 - s.ticks[0].t0 >= 1.0
    names = {r["name"] for r in s.records}
    assert {"engine.step", "engine.decode", "decode.graph",
            "decode.readback"} <= names
    assert spans.host_ms_per_tick(s) > 0
    # no CUDA events on the CPU: no segment, so no starved share
    assert not s.segments() and spans.starved_share(s) is None
    after = served.counters()
    assert after["decode_steps"] - before["decode_steps"] == sum(
        1 for t in s.ticks if t.attended)
    served.close()
