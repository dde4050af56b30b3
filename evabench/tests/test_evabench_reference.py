"""The plain reference at a size the CPU holds: against a forward written
out position by position, and against the port's own prefill (a second
witness: the port in bf16 lies within rounding of the fp32 reference)."""
import math

import numpy as np
import pytest
import torch

import evabench_smoke as smoke
from bench import weights
from reference import dense_gqa


def hand_forward(cfg, w, tokens):
    """fp32 logits (T, vocab) of one sequence, one position at a time."""
    L, eps = cfg["num_hidden_layers"], cfg["rms_norm_eps"]
    H, Hk, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                 cfg["head_dim"])

    def W(name, layer):
        lin = w[name]
        C, V, N = lin["idx"][layer].shape
        out = torch.zeros((V * 8, N))
        for v in range(V):
            for c in range(C):
                cols = lin["codebooks"][layer][c][:, lin["idx"][layer][c, v]
                                                  .long()]
                out[v * 8:(v + 1) * 8] += cols
        return out * lin["scale"][layer]

    def norm(x, g):
        return x / torch.sqrt((x * x).mean(-1, keepdim=True) + eps) * g.float()

    def rope(x, pos):
        half = hd // 2
        out = torch.empty_like(x)
        for i in range(half):
            a = pos / cfg["rope_theta"] ** (2 * i / hd)
            c, s = math.cos(a), math.sin(a)
            out[..., i] = x[..., i] * c - x[..., i + half] * s
            out[..., i + half] = x[..., i + half] * c + x[..., i] * s
        return out

    T = len(tokens)
    x = w["embed"][torch.as_tensor(tokens)].float()
    for layer in range(L):
        h = norm(x, w["attn_norm"][layer])
        qkv = h @ W("wqkv", layer)
        if cfg["qkv_bias"]:
            qkv = qkv + w["qkv_bias"][layer]
        q = qkv[:, :H * hd].reshape(T, H, hd)
        k = qkv[:, H * hd:(H + Hk) * hd].reshape(T, Hk, hd)
        v = qkv[:, (H + Hk) * hd:].reshape(T, Hk, hd)
        if cfg["qk_norm"]:
            q, k = norm(q, w["q_norm"][layer]), norm(k, w["k_norm"][layer])
        q = torch.stack([rope(q[t], t) for t in range(T)])
        k = torch.stack([rope(k[t], t) for t in range(T)])
        o = torch.zeros((T, H, hd))
        for t in range(T):
            for head in range(H):
                kv = head // (H // Hk)
                s = (k[:t + 1, kv] @ q[t, head]) / math.sqrt(hd)
                o[t, head] = torch.softmax(s, 0) @ v[:t + 1, kv]
        x = x + o.reshape(T, H * hd) @ W("wo", layer)
        h = norm(x, w["mlp_norm"][layer])
        gu = h @ W("gu", layer)
        ff = cfg["intermediate_size"]
        x = x + (torch.nn.functional.silu(gu[:, :ff]) * gu[:, ff:]) @ \
            W("down", layer)
    head = w["embed"].t() if w["head"] is None else w["head"]
    return norm(x, w["final_norm"]) @ head.float()


@pytest.mark.parametrize("kind", ["qwen2", "qwen3"])
def test_reference_matches_a_hand_rolled_forward(kind):
    cfg = smoke.config(kind)["run"]
    w = weights.draw(cfg, 2 ** 32 + 5, "cpu")
    rng = np.random.default_rng(0)
    seqs = [rng.integers(0, cfg["vocab_size"], n) for n in (9, 14)]
    starts = [3, 10]
    got = dense_gqa.logits(cfg, w, [torch.as_tensor(s) for s in seqs], starts)
    for s, st, z in zip(seqs, starts, got["fp32"]):
        want = hand_forward(cfg, w, s)[st:]
        assert z.shape == want.shape
        torch.testing.assert_close(z, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kind", ["qwen2", "qwen3"])
def test_port_prefill_lies_within_rounding_of_the_reference(kind):
    from bench import port
    from repro_torch.models import RunConfig, build_model

    cfg = smoke.config(kind)["run"]
    w = weights.draw(cfg, 77, "cpu")
    mcfg = port.model_config(cfg)
    model = build_model(mcfg)
    tokens = np.random.default_rng(1).integers(0, cfg["vocab_size"], 24)
    got, _ = model.prefill(port.params(cfg, w, mcfg),
                           {"tokens": torch.as_tensor(tokens[None],
                                                      dtype=torch.int32)},
                           RunConfig(mode="prefill"))
    want = dense_gqa.logits(cfg, w, [torch.as_tensor(tokens)], [0])["fp32"][0]
    err = (got[0, :, :cfg["vocab_size"]] - want).abs().max()
    assert err <= 0.05 * want.abs().max(), float(err)


def test_fp8_control_departs_from_fp32():
    cfg = smoke.config("qwen2")["run"]
    w = weights.draw(cfg, 3, "cpu")
    s = torch.as_tensor(np.random.default_rng(2).integers(0, 512, 16))
    out = dense_gqa.logits(cfg, w, [s], [0], ("fp32", "fp8"))
    diff = (out["fp8"][0] - out["fp32"][0]).abs().max()
    assert 1e-3 * out["fp32"][0].abs().max() < diff < 0.5 * \
        out["fp32"][0].abs().max()
