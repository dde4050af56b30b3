"""The system under test: the port's engine (``repro_torch``), built over
the benchmark's drawn weights and driven through its public entry,
``Engine.submit`` / ``Engine.step``. The only module of the harness that
imports the port; it takes from it the engine, its counters
(``EngineMetrics``) and nothing else."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Event:
    uid: int
    index: int
    token: Optional[int]
    finish: Optional[str]
    logprob: Optional[float] = None


def model_config(cfg: Dict):
    """The port's ``ModelConfig`` for a configuration file's ``run`` block."""
    from repro_torch.models.common import ModelConfig

    return ModelConfig(
        name=cfg["name"], family="dense",
        num_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        num_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg["num_key_value_heads"], head_dim=cfg["head_dim"],
        d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
        qk_norm=cfg["qk_norm"], qkv_bias=cfg["qkv_bias"],
        rope_theta=float(cfg["rope_theta"]), norm_eps=cfg["rms_norm_eps"],
        tie_embeddings=cfg["tie_word_embeddings"], dtype="bfloat16",
        vq_C=2, vq_d=8, vq_n=8)


def params(cfg: Dict, w: Dict, mcfg) -> Dict[str, Any]:
    """The port's param tree over the drawn tensors (views, no copies):
    grouped ``wqkv`` and ``gu`` VQ linears, as the port's quantization
    pass groups them."""
    from repro_torch.core.vq import VQWeight

    if mcfg.padded_vocab != cfg["vocab_size"]:
        raise ValueError("a vocabulary that is not a multiple of 128 needs "
                         "the port's padded layout")
    q, kv = mcfg.q_dim, mcfg.kv_dim
    splits = {"wqkv": (q, kv, kv), "gu": (mcfg.d_ff, mcfg.d_ff)}

    def vq(name: str, layer: int) -> VQWeight:
        lin = w[name]
        _, C, V, N = lin["idx"].shape
        return VQWeight(idx=lin["idx"][layer],
                        codebooks=lin["codebooks"][layer],
                        scale=lin["scale"][layer], K=V * 8, N=N, d=8, n=8,
                        splits=splits.get(name, ()))

    layers = []
    for i in range(mcfg.num_layers):
        attn = {"wqkv": {"vq": vq("wqkv", i)}, "wo": {"vq": vq("wo", i)}}
        if mcfg.qkv_bias:
            attn["wqkv"]["b"] = w["qkv_bias"][i]
        if mcfg.qk_norm:
            attn["qnorm"] = {"g": w["q_norm"][i]}
            attn["knorm"] = {"g": w["k_norm"][i]}
        layers.append({"attn_norm": {"g": w["attn_norm"][i]},
                       "mlp_norm": {"g": w["mlp_norm"][i]}, "attn": attn,
                       "mlp": {"gu": {"vq": vq("gu", i)},
                               "down": {"vq": vq("down", i)}}})
    p = {"embedding": {"emb": w["embed"]}, "layers": layers,
         "final_norm": {"g": w["final_norm"]}}
    if w["head"] is not None:
        p["lm_head"] = {"w": w["head"]}
    return p


def build_kernels(names: Sequence[str]) -> float:
    """Build (or find built) and load the port's kernels ``names``, the
    ones the cell launches, before the engine uses them; returns the wall
    seconds. Only a checkout's first run compiles: the libraries stay in
    the checkout's ``build/``."""
    import time

    from repro_torch.kernels import build

    t0 = time.perf_counter()
    for name in names:
        build.load(name)
    return time.perf_counter() - t0


class Served:
    """The engine over the drawn weights: ``submit`` a greedy request
    with no stop ids (asking for each token's log-probability, which the
    engine computes and reads back for every lane in any case), ``step``
    it, read its counters."""

    def __init__(self, cfg: Dict, w: Dict, engine: Dict, device):
        from repro_torch.models import build_model
        from repro_torch.models.common import RunConfig
        from repro_torch.serve import Engine, EngineConfig

        mcfg = model_config(cfg)
        self.eng = Engine(build_model(mcfg), params(cfg, w, mcfg),
                          RunConfig(mode="decode"),
                          EngineConfig(num_slots=engine["num_slots"],
                                       max_len=engine["max_len"],
                                       max_queue=engine["num_slots"] * 4,
                                       kv_bits=engine.get("kv_bits", 16)),
                          device=device)

    def submit(self, prompt: np.ndarray, max_new: int) -> int:
        from repro_torch.serve import GenerationRequest, SamplingParams

        return self.eng.submit(GenerationRequest(
            prompt=prompt, max_new_tokens=max_new,
            sampling=SamplingParams(logprobs=True)))

    def step(self) -> List[Event]:
        return [Event(e.uid, e.index, e.token, e.finish_reason, e.logprob)
                for e in self.eng.step()]

    def counters(self) -> Dict[str, float]:
        return dict(self.eng.metrics_counters.state())

    def warm(self, prompt_lens: Sequence[int]) -> Tuple[int, ...]:
        """Build and replay once the prefill step of every length bucket
        that these prompt lengths fall in, and no other; returns them."""
        from repro_torch.serve import api

        buckets = sorted({api.bucket_for(n, self.eng._buckets)
                          for n in prompt_lens})
        for b in buckets:
            step = self.eng.prefill_graph(b)
            step(tokens=np.zeros((1, b), np.int32))
        return tuple(buckets)

    def close(self) -> None:
        """Free every graph and cache the engine holds."""
        eng = self.eng
        for g in (eng.decode_graph, *eng.prefill_graphs.values(),
                  *eng.chunk_graphs.values()):
            if g is not None:
                g.release()
        self.eng = None
        del eng
