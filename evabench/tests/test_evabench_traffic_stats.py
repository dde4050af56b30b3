"""The traffic generator and the end-to-end statistics, on the CPU."""
import numpy as np
import pytest

import evabench_smoke  # noqa: F401  (puts evabench/ on the path)
from bench import stats
from bench.traffic import ClosedLoop, max_len, prompt_lengths, strata

CHAT = {"loop": "closed", "clients": 8, "think_s": 0,
        "prompt_len": [64, 512], "output_len": [256, 1024], "strata": 16,
        "first_output_len": [1, 1024]}
SEED = 2 ** 31 + 12345          # larger than 32 signed bits


def requests(seed, n=40):
    loop = ClosedLoop(CHAT, 152064, seed)
    first = loop.first()
    return first + [loop.next(i % 8) for i in range(n - len(first))]


def test_same_seed_same_traffic():
    a, b = requests(SEED), requests(SEED)
    assert [r.max_new for r in a] == [r.max_new for r in b]
    assert all(np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b))


def test_other_seed_other_order_same_sizes():
    a, b = requests(SEED), requests(SEED + 1)
    assert [len(r.prompt) for r in a] != [len(r.prompt) for r in b]
    assert not np.array_equal(a[0].prompt[:16], b[0].prompt[:16])
    # every block of 16 requests holds the same sizes (the first eight
    # outputs are the staggered ones)
    assert sorted(len(r.prompt) for r in a[:16]) == \
        sorted(len(r.prompt) for r in b[:16])
    assert sorted(r.max_new for r in a[16:32]) == \
        sorted(r.max_new for r in b[16:32])
    assert sorted(r.max_new for r in a[:8]) == sorted(r.max_new for r in b[:8])


def test_sizes_cover_the_ranges():
    rs = requests(SEED, 200)
    p = [len(r.prompt) for r in rs]
    o = [r.max_new for r in rs[8:]]
    assert 64 <= min(p) and max(p) <= 512 and max(p) - min(p) > 400
    assert 256 <= min(o) and max(o) <= 1024 and max(o) - min(o) > 700
    assert all(r.prompt.dtype == np.int32 and r.prompt.max() < 152064
               for r in rs)
    assert max_len(CHAT) == 1535
    assert prompt_lengths(CHAT) == sorted(set(strata(64, 512, 16).tolist()))


def test_first_requests_spread_their_completions():
    first = sorted(r.max_new for r in requests(SEED)[:8])
    assert first == strata(1, 1024, 8).tolist()


def test_stats_on_a_steady_stream():
    # two requests, a token every 10 ms, window (0, 1]
    a = [0.01 * i for i in range(1, 101)]
    b = [0.005 + 0.01 * i for i in range(1, 100)]
    assert stats.window_tokens([a, b], 0.0, 1.0) == 199
    assert stats.output_tok_s([a, b], 0.0, 1.0) == pytest.approx(199.0)
    assert stats.itl_ms([a, b], 0.0, 1.0, 95) == pytest.approx(10.0)


def test_stats_with_a_stall():
    # 100 gaps of 10 ms and one stall of 500 ms (a prefill), then more
    s = [0.01 * i for i in range(1, 101)] + [1.5 + 0.01 * i for i in range(20)]
    g = stats.gaps([s], 0.0, 2.0)
    assert len(g) == 119 and max(g) == pytest.approx(0.5)
    # p95 of 118 gaps of 10 ms and one of 500 ms is still a step
    assert stats.itl_ms([s], 0.0, 2.0, 95) == pytest.approx(10.0)
    # a window that holds only the stall and the step after it: the
    # tokens at 1.0, 1.5 and 1.51, gaps of 500 and 10 ms
    assert stats.gaps([s], 0.995, 1.515) == pytest.approx([0.5, 0.01])
    assert stats.itl_ms([s], 0.995, 1.515, 95) == pytest.approx(
        10.0 + 0.95 * 490.0)
    assert stats.output_tok_s([s], 0.995, 1.515) == pytest.approx(3 / 0.52)


def test_idle_share_compares_ticks_of_one_kind():
    """The traced ticks' busy time over the window's time for ticks of
    the same kinds: one decode tick of 10 ms and one tick of 100 ms that
    also prefills, in a window of nine decode ticks to each prefill."""
    from types import SimpleNamespace

    from bench.loop import Tick
    from bench.manifest import reader
    from bench.trace import DeviceOp, TracedTick

    L = 2
    window, t = [], 0.0
    for i in range(20):
        prefill = i % 10 == 9
        window.append(Tick(t, t + 0.001, [64] if prefill else [], [100]))
        t += 0.1 if prefill else 0.01

    def traced(info, busy_ms):
        ops = [DeviceOp("fused_vq_kernel", "fused_vq_matmul", 0, 1)
               for _ in range(4 * L)]
        ops.append(DeviceOp("other", "other", 0, int(busy_ms * 1e6)))
        return TracedTick(0, int(1e9), info, ops)

    run = SimpleNamespace(
        cfg={"num_hidden_layers": L}, ticks=window, t_close=t,
        trace=SimpleNamespace(ticks=[
            traced(Tick(0, 0, [], [100]), 9.0),
            traced(Tick(0, 0, [64], [100]), 95.0)]))
    want = (1 - (9.0 + 95.0) / (10.0 + 100.0)) * 100
    assert reader("device.idle_share")(run) == pytest.approx(want)
    # a traced tick that lost a B1 launch is not read, nor is a kind the
    # window never ran
    run.trace.ticks[1].ops.pop(0)
    run.trace.ticks.append(traced(Tick(0, 0, [64, 64], [100]), 300.0))
    assert reader("device.idle_share")(run) == pytest.approx(10.0)
