"""Model facade of the port (``repro/models/api.py``): the dense and MoE
families (``models/transformer.py``; MLA and dense prefix layers
included), Whisper (``models/whisper.py``), xLSTM (``models/xlstm.py``),
RecurrentGemma (``models/rglru.py``) and Llama-3.2-Vision
(``models/vision.py``), dispatched on ``cfg.family``:

    model = build_model(cfg)
    params = model.init(generator, device="cuda")
    qparams = model.quantize(params, generator=generator, device="cuda")
    logits, caches = model.prefill(params, {"tokens": tokens}, rc)
    logits, caches = model.prefill(params, {"tokens": tokens,
                                            "frames": frames}, rc)  # whisper
    logits, caches = model.prefill(params, {"tokens": tokens,
                                            "image_embeds": img}, rc)  # vision
    logits, caches = model.decode(params, tokens, positions, caches, rc)
    logits, view = model.forward(params, batch, rc, caches=view)  # a chunk
    loss = model.loss(params, {"tokens": t, "labels": l}, rc)  # train mode

    model.input_specs(shape)      # meta-device inputs of a named shape
    model.param_specs(quantized)  # meta-device params (no allocation)
    model.cache_specs(batch, seq) # meta-device caches

``quantize`` fits the weights by k-means (``method="fit"``, the
reference's default); ``method="synthetic"`` draws random VQ weights.
``init``/``quantize``/``init_cache`` default to ``device="cuda"`` and
raise without a GPU unless the caller passes ``device="cpu"``. The
``*_specs`` methods put every tensor on the ``meta`` device, where the
reference returns ``ShapeDtypeStruct`` trees.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, Optional, Tuple

import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.core.logits_vq import VQLogitsHead
from repro_torch.core.quantize import quantize_params
from repro_torch.core.vq import KVQuantConfig, VQWeight
from repro_torch.models import rglru, transformer, vision, whisper, xlstm
from repro_torch.runtime import tensor_parallel as tp
from repro_torch.models.common import (ModelConfig, RunConfig,
                                       cross_entropy_loss)

_FAMILY = {"dense": transformer, "moe": transformer, "xlstm": xlstm,
           "rglru": rglru, "whisper": whisper, "vision": vision}
# the inputs beside the tokens a family's prefill needs, each one
# (B, rows, d_model) array (whisper's frames, vision's image embeddings)
PREFILL_EXTRAS = {"whisper": ("frames",), "vision": ("image_embeds",)}
# the extras' rows a prefill reads, by family
_EXTRA_ROWS = {"whisper": whisper.S_SRC, "vision": vision.N_IMG_TOKENS}

# assigned input shapes: name -> (seq_len, global_batch, kind)
SHAPES = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}


@dataclasses.dataclass
class Model:
    cfg: ModelConfig

    @property
    def module(self):
        return _FAMILY[self.cfg.family]

    def init(self, generator: torch.Generator, *, device: DeviceLike = None,
             block_device: DeviceLike = None) -> Any:
        """Dense params drawn from ``generator`` (on ``device``).
        ``block_device="meta"`` gives the block linears shapes only, for
        ``quantize(method="synthetic")`` to build at full width without
        materializing the dense block weights."""
        dev = resolve_device(device)
        block = dev if block_device is None else torch.device(block_device)
        return self.module.init_params(generator, self.cfg, device=dev,
                                       block_device=block)

    def quantize(self, params: Any, *, method: str = "fit",
                 generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None) -> Any:
        """``core.quantize.quantize_params``: "fit" (k-means, the
        default), "synthetic" or "specs"."""
        return quantize_params(params, self.cfg, method=method,
                               generator=generator, device=device)

    def forward(self, params: Any, batch: Dict[str, Any], rc: RunConfig,
                caches=None) -> Tuple[torch.Tensor, Any]:
        """``batch``: "tokens", optionally "positions", and the prefill's
        extras: whisper's "frames" (B, S_src, d_model), vision's
        "image_embeds" (B, n_img, d_model)."""
        kw = {k: batch[k] for k in PREFILL_EXTRAS.get(self.cfg.family, ())
              if k in batch}
        return self.module.forward(params, batch["tokens"], rc, self.cfg,
                                   positions=batch.get("positions"),
                                   caches=caches, **kw)

    def loss(self, params: Any, batch: Dict[str, Any],
             rc: RunConfig) -> torch.Tensor:
        """Mean next-token cross entropy of the train-mode forward over
        ``batch["labels"]`` (weighted by ``batch["loss_mask"]`` when
        given), the padded vocabulary's columns masked out."""
        logits, _ = self.forward(params, batch, rc)
        if tp.is_dtensor(logits):  # a model sharded over ``model``
            return tp.vocab_parallel_cross_entropy(
                logits, batch["labels"], batch.get("loss_mask"),
                self.cfg.vocab_size)
        return cross_entropy_loss(self._mask_pad_vocab(logits),
                                  batch["labels"], batch.get("loss_mask"))

    def _mask_pad_vocab(self, logits: torch.Tensor) -> torch.Tensor:
        pad = self.cfg.padded_vocab - self.cfg.vocab_size
        if not pad:
            return logits
        neg = torch.full((*logits.shape[:-1], pad), -1e30,
                         dtype=logits.dtype, device=logits.device)
        return torch.cat([logits[..., :self.cfg.vocab_size], neg], dim=-1)

    def init_cache(self, batch: int, max_len: int, dtype=None, *,
                   device: DeviceLike = None, kv_int8: bool = False,
                   kv_int4: bool = False,
                   kvq: Optional[KVQuantConfig] = None,
                   paging: Any = None) -> Any:
        """Decode caches: fp, or with ``kv_int8`` / ``kv_int4`` / ``kvq``
        (a ``core.vq.KVQuantConfig``) the int8, packed int4 or KV-VQ
        layout; contiguous, or with ``paging`` (a
        ``serve.paging.PagingConfig``) block arenas and a block table
        (``serve.paging.init_paged_cache``). The recurrent families
        (xLSTM, RecurrentGemma), Whisper and Vision ignore the layout
        knobs, as the reference's: recurrent state is not a KV cache, and
        RecurrentGemma's rings and the caches of the cross-attention
        families stay fp."""
        if paging is not None:
            from repro_torch.serve import paging as paging_mod

            return paging_mod.init_paged_cache(
                self, batch, max_len, paging, device=resolve_device(device),
                kv_int8=kv_int8, kv_int4=kv_int4, kvq=kvq)
        dtype, dev = dtype or self.cfg.act_dtype, resolve_device(device)
        if self.module is not transformer:
            return self.module.init_cache(self.cfg, batch, max_len, dtype,
                                          dev)
        return transformer.init_cache(self.cfg, batch, max_len, dtype, dev,
                                      kv_int8=kv_int8, kv_int4=kv_int4,
                                      kvq=kvq)

    def prefill(self, params, batch: Dict[str, Any], rc: RunConfig):
        return self.forward(params, batch, rc.replace(mode="prefill"))

    def decode(self, params, tokens, positions, caches, rc: RunConfig):
        """tokens (B, 1), positions (B, 1); ``caches`` is updated in place
        and returned."""
        batch = {"tokens": tokens, "positions": positions}
        return self.forward(params, batch, rc.replace(mode="decode"),
                            caches=caches)

    def input_specs(self, shape: str, *, global_batch: Optional[int] = None,
                    kv_int8: bool = False, kv_int4: bool = False
                    ) -> Tuple[str, Dict[str, Any]]:
        """(step kind, inputs on the meta device) of a named ``SHAPES``
        entry: tokens (and labels to train), a decode step's one token
        and positions against caches of the shape's length, and the
        prefill extras of whisper and vision."""
        seq, gb, kind = SHAPES[shape]
        gb = global_batch or gb
        meta = lambda shape_, dt: torch.empty(shape_, dtype=dt,
                                              device="meta")
        specs: Dict[str, Any] = {}
        if kind == "decode":
            specs["tokens"] = meta((gb, 1), torch.int32)
            specs["positions"] = meta((gb, 1), torch.int32)
            specs["caches"] = self.cache_specs(gb, seq, kv_int8=kv_int8,
                                               kv_int4=kv_int4)
        else:
            specs["tokens"] = meta((gb, seq), torch.int32)
            if kind == "train":
                specs["labels"] = meta((gb, seq), torch.int32)
            for name in PREFILL_EXTRAS.get(self.cfg.family, ()):
                specs[name] = meta((gb, _EXTRA_ROWS[self.cfg.family],
                                    self.cfg.d_model), self.cfg.act_dtype)
        return kind, specs

    def param_specs(self, *, quantized: bool = False) -> Any:
        """The params' tree with every tensor on the meta device: dense,
        or with ``quantized`` as ``quantize(method="specs")`` lays it
        out."""
        dense = self.init(torch.Generator().manual_seed(0), device="meta")
        if not quantized:
            return dense
        return quantize_params(dense, self.cfg, method="specs")

    def cache_specs(self, batch: int, max_len: int, kv_int8: bool = False,
                    kv_int4: bool = False,
                    kvq: Optional[KVQuantConfig] = None) -> Any:
        """The decode cache's tree for the given layout on the meta
        device (no allocation)."""
        return self.init_cache(batch, max_len, device="meta",
                               kv_int8=kv_int8, kv_int4=kv_int4, kvq=kvq)

    def supports_shape(self, shape: str) -> bool:
        """``long_500k`` only for the sub-quadratic families (recurrent
        state, or a sliding window that bounds the cache)."""
        if shape != "long_500k":
            return True
        if self.cfg.family in ("xlstm", "rglru"):
            return True
        return self.cfg.sliding_window > 0


def param_tensors(params: Any) -> Iterator[torch.Tensor]:
    """Every tensor of a param tree, a VQWeight's indices, codebooks and
    scales and a VQLogitsHead's codebook, assignment and scales included
    (a tensor shared by several layers once a layer)."""
    if isinstance(params, torch.Tensor):
        yield params
    elif isinstance(params, dict):
        for v in params.values():
            yield from param_tensors(v)
    elif isinstance(params, (list, tuple)):
        for v in params:
            yield from param_tensors(v)
    elif isinstance(params, VQWeight):
        yield from (params.idx, params.codebooks, params.scale)
    elif isinstance(params, VQLogitsHead):
        yield from (params.codebook, params.assign, params.scale)


def param_count(params: Any) -> int:
    """Elements of every tensor in a param tree (as the reference's
    stacked leaves count them)."""
    return sum(t.numel() for t in param_tensors(params))


def build_model(cfg: ModelConfig) -> Model:
    """The model of ``cfg``: the dense or MoE family, with full,
    sliding-window or multi-head latent attention (MLA) and optional
    dense prefix layers (``first_dense_layers``), Whisper (an
    encoder-decoder with cross-attention), xLSTM, RecurrentGemma (RG-LRU
    layers and local-attention rings), or Llama-3.2-Vision (gated
    cross-attention over image embeddings).

    Raises:
      ValueError: an unknown family.
      NotImplementedError: a local window outside RecurrentGemma (the
        reference has no such model)."""
    if cfg.family not in _FAMILY:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")
    if cfg.local_window and cfg.family != "rglru":
        raise NotImplementedError(
            f"{cfg.name}: local windows are ported in RecurrentGemma only")
    return Model(cfg)
