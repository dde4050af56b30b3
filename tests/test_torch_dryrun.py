"""The port's multi-pod dry run (``launch/dryrun.py``, the ``lower_*``
builders of ``launch/steps.py``, ``roofline/counting.py``), the
counterpart of ``tests/test_dryrun.py``: one subprocess (120 s at most)
takes a fake process group of 256, then 512 ranks, and counts
``qwen3_0_6b`` ``decode_32k`` on both production meshes, ``train_4k`` on
the single one, and one sharded product. It checks the reference's
assertions (status ``ok``, 256 and 512 chips, decode memory-bound, the
multi-pod mesh's memory term below the single one's, the files written),
``train_4k`` ``ok``, and that a (B x K)·(K x N) product with B over
``data`` and N over ``model`` counts 2BKN/256 FLOPs a device: the local
shards' work, not the global product's.
"""
import json
import os
import subprocess
import sys
import textwrap

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

_SCRIPT = textwrap.dedent("""
    import json, sys
    import torch
    from torch.distributed.tensor import Shard, distribute_tensor
    from repro_torch.launch.dryrun import fake_mesh, run_cell
    from repro_torch.roofline.counting import StepCounter
    from repro_torch.runtime import tensor_parallel as tp

    torch.set_num_threads(1)
    out_dir = sys.argv[1]
    results = {}
    for mesh in ("single", "multi"):
        r = run_cell("qwen3_0_6b", "decode_32k", mesh, out_dir)
        results[mesh] = {
            "status": r["status"], "error": r.get("error"),
            "chips": r.get("chips"),
            "bottleneck": r.get("roofline", {}).get("bottleneck"),
            "t_memory": r.get("roofline", {}).get("t_memory"),
        }
    r = run_cell("qwen3_0_6b", "train_4k", "single", out_dir)
    results["train"] = {"status": r["status"], "error": r.get("error"),
                        "flops": r.get("roofline", {}).get(
                            "flops_per_device")}

    mesh = fake_mesh({"data": 16, "model": 16})
    B, K, N = 256, 512, 1024
    x = torch.empty(B // 16, K, device="meta")        # this data rank's rows
    w = distribute_tensor(torch.empty(K, N, device="meta"), mesh["model"],
                          [Shard(1)], src_data_rank=None)
    counter = StepCounter()
    with tp.tp_region(), counter:
        y = x @ w
    results["product"] = {"flops": counter.costs.flops,
                          "want": 2 * B * K * N / 256,
                          "local": list(y.to_local().shape)}
    print("RESULT" + json.dumps(results))
""")


def test_dryrun_cells_on_both_meshes(tmp_path):
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", _SCRIPT, str(tmp_path)],
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [l for l in proc.stdout.splitlines() if l.startswith("RESULT")][-1]
    res = json.loads(line[len("RESULT"):])
    assert res["single"]["status"] == "ok", res
    assert res["multi"]["status"] == "ok", res
    assert res["single"]["chips"] == 256 and res["multi"]["chips"] == 512
    # decode must be memory-bound (EVA's expected physics) on this arch
    assert res["single"]["bottleneck"] == "memory", res
    assert res["multi"]["bottleneck"] == "memory", res
    # multi-pod shards the decode batch further -> lower memory term
    assert res["multi"]["t_memory"] < res["single"]["t_memory"]
    assert res["train"]["status"] == "ok", res
    assert res["train"]["flops"] > 0
    # a product's count is its local shard's: B/16 rows x N/16 columns
    assert res["product"]["flops"] == res["product"]["want"]
    assert res["product"]["local"] == [16, 1024 // 16]
    # artifacts written, one a cell
    files = os.listdir(tmp_path)
    assert "qwen3_0_6b__decode_32k__pod1.json" in files
    assert "qwen3_0_6b__decode_32k__pod2.json" in files
    assert "qwen3_0_6b__train_4k__pod1.json" in files
