"""The port's data pipeline (``repro_torch/data/pipeline.py``) against the
reference's (``repro/data/pipeline.py``): the same counter-based Philox
stream, so every batch is bit-identical (tokens, labels, dtypes) for
both tasks, at several (dp_rank, dp_size, step); shards partition the
global batch for every dp size (elastic re-sharding invariance);
``fail_at`` raises at its step; ``peek_step`` and the prefetch thread's
``close``."""
import numpy as np
import pytest

from repro.data import DataConfig as JDataConfig
from repro.data import DataPipeline as JDataPipeline
from repro.data import global_batch_at as jglobal_batch_at
from repro_torch.data import DataConfig, DataPipeline, global_batch_at

CFGS = [dict(vocab_size=64, seq_len=8, global_batch=8, seed=3),
        dict(vocab_size=151936, seq_len=33, global_batch=4, seed=0),
        dict(vocab_size=500, seq_len=16, global_batch=8, seed=1,
             task="uniform"),
        dict(vocab_size=97, seq_len=12, global_batch=16, seed=7, noise=0.3)]


def _equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype == np.int32, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("kw", CFGS)
def test_global_batches_bit_identical(kw):
    for step in (0, 1, 5, 123, 2 ** 31):
        _equal(global_batch_at(DataConfig(**kw), step),
               jglobal_batch_at(JDataConfig(**kw), step))


@pytest.mark.parametrize("dp_size", [1, 2, 4, 8])
def test_shards_bit_identical(dp_size):
    kw = CFGS[0]
    for dp_rank in range(dp_size):
        p = DataPipeline(DataConfig(**kw), dp_rank=dp_rank, dp_size=dp_size,
                         start_step=4, prefetch=2)
        j = JDataPipeline(JDataConfig(**kw), dp_rank=dp_rank,
                          dp_size=dp_size, start_step=4, prefetch=2)
        try:
            for _ in range(3):
                _equal(next(p), next(j))
            assert p.step == j.step == 7
            _equal(p.peek_step(11), j.peek_step(11))
        finally:
            p.close(), j.close()


@pytest.mark.parametrize("step", [0, 3, 17])
def test_elastic_resharding_invariance(step):
    cfg = DataConfig(**CFGS[0])
    g = global_batch_at(cfg, step)["tokens"]
    for dp in (1, 2, 4, 8):
        per = cfg.global_batch // dp
        got = []
        for r in range(dp):
            p = DataPipeline(cfg, dp_rank=r, dp_size=dp, start_step=step)
            got.append(next(p)["tokens"])
            p.close()
        np.testing.assert_array_equal(np.concatenate(got), g)
        assert all(x.shape[0] == per for x in got)


def test_failure_injection():
    p = DataPipeline(DataConfig(**CFGS[0]), fail_at=2)
    next(p), next(p)
    with pytest.raises(RuntimeError, match="injected data failure at step 2"):
        next(p)
    p.close()
    with pytest.raises(RuntimeError, match="injected"):
        DataPipeline(DataConfig(**CFGS[0]), fail_at=5).peek_step(5)


def test_close_stops_the_producer():
    p = DataPipeline(DataConfig(**CFGS[0]), prefetch=1)
    next(p)
    p.close()
    p._thread.join(timeout=10)
    assert not p._thread.is_alive()


def test_labels_shift_and_task_learnable():
    cfg = DataConfig(**CFGS[0])
    b = global_batch_at(cfg, 0)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    pred = (b["tokens"] * 31 + 17) % cfg.vocab_size
    assert (pred == b["labels"]).mean() > 0.85
