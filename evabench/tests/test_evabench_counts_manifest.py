"""The yardstick's arithmetic against hand counts, the manifest's form,
and the run's guard against JAX and the JAX package, on the CPU."""
import json
import os
import re
import subprocess
import sys

import pytest

import evabench_smoke  # noqa: F401  (puts evabench/ on the path)
from bench import counts
from bench.manifest import HERE, ROOT, load

QWEN2 = json.load(open(HERE / "configs" / "qwen2_72b.json"))["run"]
BENCH = json.load(open(ROOT / "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_qwen2_linears():
    assert counts.linears(QWEN2) == [("wqkv", 8192, 10240),
                                     ("wo", 8192, 8192),
                                     ("gu", 8192, 59136),
                                     ("down", 29568, 8192)]


def test_b1_bound_by_hand():
    # gu at M = 8: x fp32, indices C V N, codebooks, scales, y fp32
    nbytes = 8 * 8192 * 4 + 2 * 1024 * 59136 + 2 * 8 * 256 * 4 \
        + 59136 * 4 + 8 * 59136 * 4
    assert nbytes == 123_517_952
    flops = 2 * 8 * 1024 * 256 * 8 * 2 + 2 * 8 * 1024 * 59136 + 8 * 59136
    ms, which = counts.b1_bound_ms(8, 8192, 59136)
    assert which == "bytes"
    assert ms == pytest.approx(nbytes / 3.35e12 * 1e3)
    assert flops / 67e12 * 1e3 < ms
    # a whole decode layer at M = 4: PERF.md's B1 row for qwen2-72b
    assert counts.layer_bound_ms(QWEN2, 4) == \
        pytest.approx(0.0663, abs=5e-5)


def test_step_counts_by_hand():
    L = 80
    block = L * (8192 * 10240 + 8192 * 8192 + 8192 * 59136 + 29568 * 8192)
    assert counts.block_params(QWEN2) == block
    # one lane over 1000 positions: memory-bound at the weights' bytes
    wb = counts.weight_bytes(QWEN2)
    vq = sum(2 * (K // 8) * N + 2 * 8 * 256 * 4 + 4 * N
             for K, N in ((8192, 10240), (8192, 8192), (8192, 59136),
                          (29568, 8192)))
    # the VQ linears and the bf16 head; biases and norms are a few MB
    assert wb == pytest.approx(80 * vq + 2 * 8192 * 152064, rel=1e-3)
    s = counts.decode_least_s(QWEN2, [1000])
    assert s == pytest.approx((wb + 80 * 2 * 8 * 128 * 2 * 1001 + 8192 * 2)
                              / 3.35e12)
    # a 512-token prefill is compute-bound
    att = 80 * 4 * 64 * 128 * (512 * 513 // 2)
    flops = 2 * block * 512 + 2 * 8192 * 152064 + att
    assert counts.prefill_least_s(QWEN2, 512) == pytest.approx(flops / 989e12)
    assert counts.decode_least_s(QWEN2, []) == 0.0


def test_names_units_and_limits():
    assert BENCH["command"] == ["python3", "evabench/run.py"]
    assert BENCH["paths"] == ["evabench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(set(names)) == len(names)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert (HERE / "metrics" / f"{m['name']}.py").exists(), m["name"]
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert next(m for m in BENCH["end_to_end"]
                if m["name"] == "setup_s")["bound"] <= 0.25
    cells = [w["name"] for w in BENCH["workloads"]]
    assert len(set(cells)) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) \
        == len(cells)
    for w in BENCH["workloads"]:
        for key in ("name", "config", "traffic"):
            assert NAME.match(w[key]), w[key]
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        assert (HERE / "traffic" / f"{w['traffic']}.json").exists()
    for c in BENCH["configs"]:
        assert NAME.match(c["name"]) and c["file"].startswith("evabench/")
        assert json.load(open(ROOT / c["file"]))["reduced"] == c["reduced"]
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_every_cell_reports_what_its_metrics_move():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for w in BENCH["workloads"]:
        cell = load(w["name"])
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer, w["name"]
        for m in cell.per_layer:
            assert m["moves"] in e2e and m["moves"] in reported, (w, m)
    for m in BENCH["per_layer"]:
        assert m["workloads"] and m["layer"] and "\n" not in m["layer"]


def test_forbidden_modules_compares_whole_top_level_names():
    sys.path.insert(0, str(HERE))
    import run

    sys.modules["repro_torch_probe"] = sys
    assert "repro_torch_probe" not in run.forbidden_modules()
    for name in ("repro.core", "jax", "jaxlib.xla", "flax"):
        sys.modules[name] = sys
        try:
            assert name in run.forbidden_modules()
        finally:
            del sys.modules[name]
    del sys.modules["repro_torch_probe"]


def test_run_refuses_without_a_card(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "evabench/run.py", "--workload",
                          "qwen3_0_6b.chat_decode", "--seed", str(2 ** 33),
                          "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 2, res.stderr
    assert res.stdout.strip() == ""


def test_run_fails_without_the_program(tmp_path):
    # a directory with only BENCHMARK.json and the benchmark's files
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(HERE, tmp_path / "evabench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = subprocess.run([sys.executable, "evabench/run.py", "--workload",
                          "qwen3_0_6b.chat_decode", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert "{" not in res.stdout


def test_the_harness_imports_no_jax():
    code = ("import sys; sys.path[:0] = ['evabench', 'src']\n"
            "import run\n"
            "from bench import cell, judge, loop, port, trace, traffic\n"
            "import reference.dense_gqa\n"
            "assert not run.forbidden_modules(), run.forbidden_modules()\n"
            "print('ok')")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
