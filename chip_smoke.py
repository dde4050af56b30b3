#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Phases (any failure exits non-zero):
  1. the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel of the serving path from kernels/*/csrc;
  3. check each kernel against its plain PyTorch version at the main
     path's full-width llama2-7b shapes (tolerance, bitwise determinism)
     and time it (CUDA events, median, L2 flushed between runs) beside its
     plain version, one PyTorch library call computing the same function,
     and its bound on this card;
  4. serve 8 greedy requests on full-width llama2-7b (32 layers, 2-bit VQ
     weights drawn on the card from a seed, bf16 activations, 4 slots,
     max_len 512) through the Engine, counting kernel launches; then one
     decode step through the plain versions, for the logits drift;
  5. a {"kernels": [...]} summary line, the card line, and the result
     line {"ok": true, "device": {...}} last.

Without a CUDA device, or outside a checkout of the repository, it fails
before printing any result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP32_FLOPS = 67e12             # H100 SXM, fp32 outside the tensor cores
SLOTS, MAX_LEN, N_REQUESTS, MAX_NEW = 4, 512, 8, 32
SEED = 0
LINEARS = (("wqkv", 4096, 12288), ("wo", 4096, 4096), ("gu", 4096, 22016),
           ("down", 11008, 4096))
REPLACES = {
    "fused_vq_matmul": "src/repro/kernels/fused_vq_matmul/kernel.py:49",
    "flash_decode": "src/repro/kernels/flash_decode/kernel.py:33",
    "dequant_gemv": "src/repro/kernels/dequant_gemv/kernel.py:20",
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound_ms(nbytes: float, flops: float) -> tuple:
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


class Timer:
    """Median CUDA-event time of a call over ``reps`` runs after warm-up.
    Before each run the L2 is flushed (the serving path finds every
    layer's weights cold) and the stream is held busy with a GPU sleep,
    so the host enqueues the whole call before the first event fires:
    the events then bracket the call's device time, not its host
    overhead."""

    SLEEP_CYCLES = 4_000_000       # ~2 ms at the H100's boost clock

    def __init__(self, torch, reps: int = 20, warmup: int = 3):
        self.torch, self.reps, self.warmup = torch, reps, warmup
        self.flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn) -> float:
        torch = self.torch
        for _ in range(self.warmup):
            fn()
        times = []
        for _ in range(self.reps):
            self.flush.bitwise_not_()
            torch.cuda._sleep(self.SLEEP_CYCLES)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)


def check_kernels(torch, timer):
    """Phase 3: every kernel against its plain version at full width."""
    import torch.nn.functional as F
    from repro_torch.core.vq import dequantize, synthetic_vq
    from repro_torch.kernels.dequant_gemv import dequant_gemv
    from repro_torch.kernels.flash_decode import flash_decode, flash_decode_ref
    from repro_torch.kernels.fused_vq_matmul import fused_vq_matmul

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = {n: [] for n in REPLACES}

    def record(kernel, case, got, want, tol, fn, plain, library, nbytes, flops):
        err = (got.float() - want.float()).abs().max().item()
        again = fn()
        det = bool(torch.equal(got, again))
        b_ms, b_by = bound_ms(nbytes, flops)
        row = {"kernel": kernel, "case": case, "max_abs_err": err, "tol": tol,
               "bitwise_equal": det, "kernel_ms": timer(fn),
               "plain_ms": timer(plain), "library_ms": timer(library),
               "bound_ms": b_ms, "bound_by": b_by}
        emit(row)
        if not (err <= tol and det):
            raise AssertionError(f"{kernel} {case}: err {err} > tol {tol} "
                                 f"or not deterministic ({det})")
        rows[kernel].append(row)

    C = 2
    for M, kernel, fn_k in ((1, "fused_vq_matmul", fused_vq_matmul),
                            (SLOTS, "fused_vq_matmul", fused_vq_matmul),
                            (MAX_LEN, "dequant_gemv", dequant_gemv)):
        for name, K, N in LINEARS:
            vq = synthetic_vq(gen, K, N, C=C, device="cuda")
            x = torch.randn((M, K), generator=gen, device="cuda")
            xb = x.to(torch.bfloat16)
            w = dequantize(vq).to(torch.bfloat16)
            run = lambda: fn_k(x, vq, out_dtype=torch.float32)
            plain = lambda: fn_k(x, vq, out_dtype=torch.float32,
                                 use_kernel=False)
            got, want = run(), plain()
            tol = 1e-4 * max(1.0, want.abs().max().item())
            V = K // 8
            nbytes = M * K * 4 + C * V * N + C * 8 * 256 * 4 + N * 4 + M * N * 4
            if kernel == "fused_vq_matmul":
                flops = C * M * V * 256 * 8 * 2 + C * M * V * N + M * N
            else:
                flops = 2 * M * K * N + C * V * N * 8 + M * N
            record(kernel, {"M": M, "linear": name, "K": K, "N": N}, got,
                   want, tol, run, plain, lambda: torch.matmul(xb, w),
                   nbytes, flops)
            del vq, w

    B, H, hd = SLOTS, 32, 128
    lengths = torch.tensor([1, MAX_LEN, 200, 64], dtype=torch.int32,
                           device="cuda")
    q = torch.randn((B, H, hd), generator=gen, device="cuda").bfloat16()
    k = torch.randn((B, MAX_LEN, H, hd), generator=gen, device="cuda").bfloat16()
    v = torch.randn((B, MAX_LEN, H, hd), generator=gen, device="cuda").bfloat16()
    mask = (torch.arange(MAX_LEN, device="cuda")[None, :]
            < lengths[:, None])[:, None, None, :]
    kt, vt, q4 = k.transpose(1, 2), v.transpose(1, 2), q[:, :, None, :]
    run = lambda: flash_decode(q, k, v, lengths)
    got, want = run(), flash_decode_ref(q, k, v, lengths)
    tot = int(lengths.clamp(max=MAX_LEN).sum())
    record("flash_decode", {"B": B, "H": H, "Hk": H, "hd": hd, "S": MAX_LEN,
                            "lengths": lengths.tolist(), "dtype": "bfloat16"},
           got, want, 2.0 ** -7 * max(1.0, want.float().abs().max().item()),
           run, lambda: flash_decode_ref(q, k, v, lengths),
           lambda: F.scaled_dot_product_attention(q4, kt, vt, attn_mask=mask),
           2 * q.numel() * 2 + tot * 2 * H * hd * 2 + B * 4,
           tot * H * hd * 4)
    return rows


def serve(torch):
    """Phase 4: full-width llama2-7b through the Engine."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.plan import PlanPolicy
    from repro_torch.models import RunConfig, build_model
    from repro_torch.serve import Engine, EngineConfig, GenerationRequest
    from repro_torch.serve.kvcache import pad_prefill_cache

    cfg = get_config("llama2_7b")
    model = build_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    t0 = time.perf_counter()
    params = model.quantize(model.init(gen, device="cuda", block_device="meta"),
                            generator=gen, device="cuda")
    torch.cuda.synchronize()
    emit({"phase": "weights", "layers": cfg.num_layers, "d_model": cfg.d_model,
          "d_ff": cfg.d_ff, "vocab": cfg.vocab_size, "bits_per_weight": 2,
          "seconds": time.perf_counter() - t0,
          "device_bytes": torch.cuda.memory_allocated()})
    rc = RunConfig(plan_policy=PlanPolicy(vq_mode="none", impl="cuda"))
    ecfg = EngineConfig(num_slots=SLOTS, max_len=MAX_LEN)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(32, 201, N_REQUESTS)]

    Engine(model, params, rc, ecfg, device="cuda").generate([prompts[0][:16]], 2)
    eng = Engine(model, params, rc, ecfg, device="cuda")
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    uids = [eng.submit(GenerationRequest(prompt=p, max_new_tokens=MAX_NEW))
            for p in prompts]
    while not eng.idle:
        eng.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    m = eng.metrics()
    for uid, p in zip(uids, prompts):
        out = eng.output(uid)
        emit({"request": uid, "prompt_len": len(p), "tokens": out.num_tokens,
              "finish": out.finish_reason, "prefill_ms": out.prefill_s * 1e3,
              "decode_ms_per_step": out.decode_s * 1e3 / max(1, out.num_tokens - 1),
              "decode_tok_per_s": out.decode_tokens_per_s})
        assert out.finish_reason == "length" and out.num_tokens == MAX_NEW
        assert all(0 <= t < cfg.vocab_size for t in out.tokens)
    emit({"phase": "serve", "requests": N_REQUESTS, "slots": SLOTS,
          "max_len": MAX_LEN, "wall_s": wall,
          "tokens_generated": m["tokens_generated"],
          "tok_per_s": m["tokens_generated"] / wall,
          "decode_steps": m["decode_steps"],
          "decode_ms_per_step": m["decode_s"] * 1e3 / m["decode_steps"],
          "prefill_s": m["prefill_s"], "slot_occupancy": m["slot_occupancy"],
          "launches": launches,
          "peak_device_bytes": torch.cuda.max_memory_allocated()})
    missing = [k for k, n in launches.items() if n == 0]
    assert not missing, f"kernels never launched on the main path: {missing}"

    # one decode step through the kernels and through the plain versions
    toks = torch.tensor(np.stack([p[:64] for p in prompts[:SLOTS]]),
                        dtype=torch.int32, device="cuda")
    with torch.no_grad():
        _, cache = model.prefill(params, {"tokens": toks}, rc)
        cache = pad_prefill_cache(cache, 128)
        step = (toks[:, -1:], torch.full((SLOTS, 1), 64, dtype=torch.int32,
                                         device="cuda"))
        plain_cache = {"body": {n: t.clone() for n, t in cache["body"].items()}}
        got, _ = model.decode(params, *step, cache, rc)
        want, _ = model.decode(params, *step, plain_cache,
                               rc.replace_policy(impl="torch"))
    got, want = got[:, 0, :cfg.vocab_size], want[:, 0, :cfg.vocab_size]
    drift = (got - want).abs().max().item()
    rel = drift / want.abs().max().item()
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    emit({"phase": "plain_decode_step", "max_abs_logit_drift": drift,
          "rel_drift": rel, "argmax_agreement": agree,
          "finite": bool(torch.isfinite(got).all())})
    assert bool(torch.isfinite(got).all()) and rel <= 0.05 and agree >= 0.75
    profile_decode(torch, model, params, cache, step, rc)
    return launches


def profile_decode(torch, model, params, cache, step, rc, steps: int = 5):
    """Where one batched decode step's time goes: host wall per step
    (synchronized, no profiler) against the device time of its kernels
    (torch.profiler), grouped by kernel."""
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad():
        model.decode(params, *step, cache, rc)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            model.decode(params, *step, cache, rc)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                model.decode(params, *step, cache, rc)
            torch.cuda.synchronize()
    groups = {}
    n_kernels = 0
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        n_kernels += 1
        name = ev.name
        key = next((k for k in ("fused_vq", "split_reduce", "flash_decode")
                    if k in name), "other")
        groups[key] = groups.get(key, 0.0) + ev.time_range.elapsed_us()
    busy_ms = sum(groups.values()) / 1e3 / steps
    emit({"phase": "decode_profile", "batch": SLOTS, "wall_ms_per_step": wall_ms,
          "device_busy_ms_per_step": busy_ms if n_kernels else None,
          "idle_share": (1 - busy_ms / wall_ms) if n_kernels else None,
          "device_kernels_per_step": n_kernels / steps,
          "device_ms_by_kernel": {k: v / 1e3 / steps
                                  for k, v in sorted(groups.items())}})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.kernels import build  # fails outside a checkout

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    emit({"phase": "build", "seconds": build.build_all(),
          "ptxas": {n: [ln.strip() for ln in log.splitlines()
                        if "registers" in ln or "spill" in ln][:4]
                    for n, log in build.BUILD_LOG.items()}})
    timer = Timer(torch)
    rows = check_kernels(torch, timer)
    launches = serve(torch)

    summary = []
    for name, replaces in REPLACES.items():
        rs = rows[name]
        if name == "fused_vq_matmul":  # one decode layer at M = slots
            rs = [r for r in rs if r["case"]["M"] == SLOTS]
        tot = lambda key: sum(r[key] for r in rs)
        summary.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/{name}/csrc/{name}.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows[name]),
            "ms": tot("kernel_ms"), "plain_ms": tot("plain_ms"),
            "bound_ms": tot("bound_ms"),
            "bound_by": max(rs, key=lambda r: r["bound_ms"])["bound_by"],
            "library_ms": tot("library_ms")})
    emit({"kernels": summary})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
