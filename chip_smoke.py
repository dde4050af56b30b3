#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Phases (any failure exits non-zero):
  1. the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel of the serving paths from kernels/*/csrc (and
     the lookup kernels' timing variants), one nvcc per library, all
     started together;
  3. check each kernel against its plain PyTorch version at the serving
     paths' full-width llama2-7b shapes (tolerance, bitwise determinism;
     the lookup kernels and vq_gemm at the four decode linears x M in
     {1, 2, 4, 8} and at a ragged shape, vq_gemm with fp32 and with the
     served bf16 x)
     and time it (CUDA events, median, L2 flushed between runs) beside its
     plain version, one PyTorch library call computing the same function
     (where one exists), and its bound on this card; dequant_gemv with
     fp32 and bf16 x at the prefill layer and bf16 x at the prefill
     buckets of 256, 128, 64 and 32 tokens; the VQ matmuls' library call
     is fp32 torch.matmul on the dequantized weights, with bf16
     torch.matmul timed beside it (a lower-precision function);
     flash_decode at mixed lengths and with every row at max_len;
     int8_gemm at every prefill bucket of the lm_head (32-256 tokens);
     the two-kernel EVA split (vq_gemm, then oc_lookup) is also held
     against the fused kernel; the paged entries flash_decode_paged and
     flash_decode_kvq_paged (kv_bits=4) over block arenas (16-position
     blocks, a parity pool of 128) through a shuffled table with each
     row's free entries on the sentinel, at the mixed lengths, held
     against their plain versions and bitwise against the contiguous
     kernels over the gathered view, and timed beside the contiguous
     kernel and the reference's route (a gather of the view, then the
     contiguous kernel); last, fused_vq_matmul at the four decode
     linears with the rows of a speculative verify window, M = 12 and 16
     (K = 2, 3 at 4 slots), with the tile model's launch shape;
  3b. `breakdown`: fused_vq_matmul and oc_lookup against their
     timing-only variants (no lookup, no index loads, no output codebook,
     no split reduce; compile-time builds of the same sources), and
     vq_gemm (bf16 x) against its own (no O writes, no loads, an empty
     grid), at the four decode linears x M in {1, 4} and at the ragged
     case, each call also timed twice back to back, and for the lookup
     kernels one run of the trace variant (its own entry point; per-CTA
     %globaltimer stamps: entry, first slab landed, slab loop done,
     cluster barrier, exit);
  4. serve 8 greedy requests on full-width llama2-7b (32 layers, 2-bit VQ
     weights drawn on the card from a seed, bf16 activations, 4 slots,
     max_len 512) through the Engine, whose decode step is a CUDA graph
     captured at construction (the caches must come out of the capture
     as init_cache made them, and the construction's peak device memory
     beyond the cache must stay below the cache's size) and whose prefill buckets are graphs
     captured at first use, counting kernel launches per phase (replays
     included): `serve`, the fp KV cache (kv_bits=16: fused_vq_matmul,
     flash_decode, dequant_gemv); `serve_kvq`, the 4-bit KV-VQ cache and
     INT8 prefill (kv_bits=4, int8_prefill: fused_vq_matmul,
     flash_decode_kvq, dequant_gemv, int8_gemm); after each, one decode
     step through the plain versions, for the logits drift; `graph_step`:
     from a prefilled 4-slot cache, 8 replayed decode steps against 8
     eager ones on a clone (logits at every step and every cache leaf
     after the last, bitwise) with launches equal to the capture's times
     8, and each prefill bucket of 32-256 tokens (and 512, built there)
     replayed against the eager prefill (logits and cache, bitwise),
     each graph's build time printed beside the bytes of the decode
     graph's pool and of the prefill buckets' shared pool; then a profile of the eager and the replayed
     decode step and of a replayed prefill bucket (each kernel the phase
     requires must show among the device events of the replay that runs
     it). Both rank the planner's backends analytically. Then the same
     on the paged cache (serve/paging.py, 16-position blocks):
     `serve_paged` (fp, a parity pool of 128 blocks: flash_decode_paged;
     greedy tokens identical to `serve`'s), `serve_kvq_paged` (kv_bits=4
     and INT8 prefill, parity pool: flash_decode_kvq_paged; tokens
     identical to `serve_kvq`'s) and `serve_paged_tight` (fp,
     prefill_chunk 64, a pool of 40 blocks: every request finishes, with
     at least one preemption and one chunk; its peak KV bytes and its
     token agreement with `serve` printed); on each, the contiguous
     attention kernels launch 0 times, and one eager paged decode step
     runs no index_select (no view gathered); graph_step and the
     profiles run on the paged cache and the chunk graphs too;
  5. `calibration`: time `plan.execute` of the two decode EVA backends
     (eva_fused, eva_split) at the four decode linears x M in {1, 2, 4,
     8}, fit the port's cost model to those rows, print what the fitted
     model picks at each decode site and save the fit to
     build/calibration_torch.json (never the default calibration path);
  6. `serve_split`, last: the default planner ranks with a pinned
     calibration that prices eva_fused above eva_split, and the fp-cache
     phase is served again through vq_gemm + oc_lookup (fused_vq_matmul
     must launch 0 times), with its plain decode step, graph_step and
     profiles; the planner is restored afterwards; then `serve_spec`
     (`serve` with speculate_k = 3: the decode graph built once at 4
     tokens a slot, flash_decode 0 launches, each replay running every
     VQ linear through the EVA kernel the planner ranks at M = 16,
     drafted = accepted + rejected; graph_step replays the verify window
     against the eager one with the eager part applied to both; row 0 of
     a window within PLAIN_REL of `serve`'s step on the same cache; the
     plain window attention's device time; decode ms a step, tokens a
     step, acceptance rate and tok/s beside `serve`'s) and `serve_vql`
     (`serve`'s traffic with a synthetic VQ-Logits head of 2048
     codewords, against the same model with the head's expansion:
     greedy token agreement, prefill logits within VQL_REL, the head's
     device time beside the dense bf16 head's; the dense head's fp32
     accumulator timed with CUDA events beside its product rounded to
     bf16 before the cast, the form it took before); then
     `serve_resilience`
     (`serve`'s weights and traffic through the resilience layer, every
     count set to 0 at its start): serve_with_restarts with a prefill, a
     decode and a sample fault (3 restarts, all scripted, each fresh
     engine's decode graph built once, peak device memory within
     `serve`'s plus a snapshot, tokens `serve`'s exactly), the snapshot's
     bytes and device-to-host ms, an engine's rebuild s and the
     restore's host-to-device ms; a nan poison on one request (it
     errors, the others' tokens are `serve`'s) and three poisoned ticks
     that trip the breaker; two backend faults quarantining eva_fused,
     then eva_split (the decode graph rebuilt over the live caches; the
     split's kernels, then dequant_gemv at M = 4, among the replay's
     device events; the step across each switch within PLAIN_REL; decode
     ms a step per backend; the quarantine reset after); the tight paged
     engine and the speculative engine snapshotted mid-run and restored
     into fresh engines, tokens equal to the uninterrupted runs; the
     check phase holds dequant_gemv at M = 4 first;
  7. the other dense configs at full width and depth, GQA in the engine's
     stream (the check phase also holds flash_decode, flash_decode_kvq
     and both paged entries at their grouped heads, g = 4/2/3/8, and
     fused_vq_matmul and dequant_gemv at their linears, with the lookup
     kernel's picked launch shape): `serve_llama3_8b` and
     `serve_llama3_8b_kvq` (as `serve` and `serve_kvq`; the int8 head
     quantization of its 128256 rows timed); `serve_qwen3_0_6b`, then
     `serve_qwen3_0_6b_ckpt` (the params saved with the port's
     CheckpointManager, restored bit for bit, served again: the same
     greedy tokens) and `serve_cli` (python -m repro_torch.launch.serve
     --arch qwen3-0.6b --full in a subprocess: exit 0, the reference
     CLI's two lines); `serve_qwen2_72b` (80 layers through
     launch.serve.serve on the card: weight bytes against bf16 dense,
     peak device memory; its plain decode step held at fp32
     activations); `serve_minitron_4b` (g = 3); each with graph_step
     and replayed profiles; each phase prints its wall seconds;
  8. `serve_mixtral_8x22b`: mixtral-8x22b (top-2 MoE over 8 experts,
     sliding-window rings of 4096) at full width, cut to 28 of its 56
     layers (MIXTRAL_LAYERS, printed as "reduced"),
     synthetic 2-bit VQ weights drawn on the card from their shapes,
     max_len 4608, 8 requests (prompts of 4160 and 4080 tokens, whose
     rings wrap in prefill and in decode, and six of 32-200): weight
     bytes against bf16 dense, peak memory, decode ms a step, tok/s, the
     long prompts' prefill s (eager, at the exact length), launches (B1
     and B3, the attention kernels 0), the plain decode step at bf16
     within MIXTRAL_PLAIN_REL beside the share of top-2 routing choices
     that agree (two faulty controls above it) and at fp32 within 1e-3,
     graph_step over a ring, a replayed step's device time with the
     "other" kernels that take the most; then at 4 layers, full width:
     a paged ring (16-position blocks) with the contiguous ring's tokens
     exactly, kv_bits 8 and 4 rings and the split-pinned planner with
     their token agreement, and the split's decode step held to the
     fused one (bf16 within the phase's bound, with the share of routing
     choices that agree; fp32 within 1e-3); the check phase holds B1 at
     mixtral's decode
     linears (attention at M = 4, experts at M = 2) and B3 at an
     expert's gu at M = 1300;
  9. `serve_deepseek_v2_lite_16b`: deepseek-v2-lite-16b (multi-head
     latent attention over a 512-wide latent cache, a dense first layer,
     then 64 routed experts top-6 beside 2 shared) at full width, cut to
     14 of its 27 layers (DEEPSEEK_LAYERS, printed as "reduced"),
     `serve`'s traffic: weight bytes against bf16 dense, peak
     memory, the latent cache's bytes, decode ms a step, tok/s, prefill s
     (eager, exact length), launches (B1, with its count a replayed
     step equal to the model's count of decode linears, and B3; the
     attention kernels
     0: MLA attends in plain torch, as the reference), the plain decode
     step at bf16 within DEEPSEEK_PLAIN_REL beside the share of top-6
     routing choices that agree (two faulty controls above it) and at
     fp32 within 1e-3, graph_step, a replay profile with the "other"
     kernels that take the most; then the absorbed decode (`mla_absorb`)
     on the same weights, its token agreement with the expand form and
     its replayed step; then at 4 layers, full width: the paged latent
     cache with the contiguous run's tokens exactly, kv_bits 4 and the
     split-pinned planner with their token agreement, and the split's
     decode step held to the fused one as mixtral's; the check phase
     holds B1 at deepseek's decode linears (wq_kva's ragged N = 3648,
     wkv_b at M = 4 and at the expand decode's M = 2048, the experts at
     M = 1), B4, B5 and the pair at every one a step runs, and B3 at its
     prefill linears of a 200-token prompt;
  10. `serve_xlstm_125m`: xlstm-125m (alternating mLSTM / sLSTM blocks:
     recurrent state of a fixed size a slot, no attention) at full width
     and all 12 layers, `serve`'s traffic: weight bytes against bf16
     dense, peak memory, the state's bytes, decode ms a step, tok/s,
     prefill s (eager, exact length), launches (B1 54 a replayed step,
     B3; the attention kernels 0), the caches after the decode graph's
     build as init_cache made them, the plain decode step at bf16 within
     XLSTM_PLAIN_REL (two faulty controls above it: the step from
     init_cache's state and with the next token id) and at fp32 within
     1e-3, graph_step over the recurrent state, a replay profile with the
     "other" kernels that take the most; then on the same weights the
     paged engine (pass-through state) with the contiguous run's tokens
     exactly, the split-pinned planner with its token agreement and its
     step held to the fused one, INT8 prefill (B6 at the sLSTM gates'
     N = 4 and at the head), a snapshot mid-run restored into a fresh
     engine (tokens equal), kv_bits = 4 and speculate_k = 3 refused
     with the reference's messages, and the CLI (`--arch xlstm-125m
     --full`); the check phase holds B1, B4, B5 and the pair at its
     decode linears, B3 at its prefill linears of a 200-token prompt and
     B6 at its gates and head;
  11. `serve_recurrentgemma_2b`: recurrentgemma-2b (RG-LRU recurrent
     layers and local-attention rings in one cache tree) at full width
     and all 26 layers, `serve`'s traffic: weight bytes against bf16
     dense, peak memory, the state's and the rings' bytes, decode ms a
     step, tok/s, prefill s (eager, exact length), launches (B1 158 a
     replayed step, B3 158 a prompt; the attention kernels 0: rings
     attend in plain torch), the caches after the decode graph's build as
     init_cache made them, the plain decode step at bf16 within
     RGLRU_PLAIN_REL (two faulty controls above it) and at fp32 within
     1e-3, graph_step over the mixed tree, a replay profile with the
     "other" kernels that take the most; then on the same weights the
     paged engine (rings through the block table, the state
     pass-through) with the contiguous run's tokens exactly, the
     split-pinned planner with its step held to the fused one, INT8
     prefill (B6 at the head), rings of 2048 that wrap in a 2100-token
     prefill and in a 2030-token prompt's decode (paged == contiguous), a
     snapshot restored, kv_bits = 4 and speculate_k = 3 refused with the
     reference's messages, and the CLI (`--arch recurrentgemma-2b
     --full`); the check phase holds B1, B4, B5 and the pair at its
     decode linears, B3 at its prefill linears of a 200-token prompt and
     B6 at its head;
  12. `serve_whisper_medium`: whisper-medium (an encoder-decoder: the
     encoder over one set of 1500 frames, drawn on the card and given to
     the engine as its extras, read by every request's prefill; the
     decoder's self-attention cache beside 1500-row cross memories that a
     prefill writes once and decode only reads) at full width and 12 +
     12 of its 24 + 24 layers (WHISPER_LAYERS), `serve`'s traffic
     through the graphed engine: weight
     bytes against bf16 dense, the cross memories' and the self cache's
     bytes, peak memory, decode ms a step, tok/s, prefill s, launches (B1
     72 and B2 12 a replayed step, at head dim 64; B3 144 a prefill;
     144, 24 and 288 at 24 + 24 layers),
     the caches after the decode graph's build as init_cache made them,
     the plain decode step at bf16 within WHISPER_PLAIN_REL (two faulty
     controls above it) and at fp32 within 1e-3, graph_step (decode and
     every bucket, bitwise), the replays' profiles, and a replayed
     decode step's and a replayed 128-token prefill's device time with
     the "other" kernels that take the most; then on
     the same weights the paged engine with prefill_chunk 64 (each chunk
     re-encodes the frames; B2's paged entry) with the contiguous run's
     tokens exactly, the split-pinned planner with its step held to the
     fused one, INT8 prefill (B6 at frontend.proj and the head), a
     snapshot restored, kv_bits = 4 and speculate_k = 3 refused with the
     reference's messages, and the CLI (`--arch whisper-medium --full`);
     the check phase holds B1, B4, B5 and the pair at its decode
     linears, B3 at its decoder's prefill linears of a 200-token prompt
     and at the encoder's and the cross memory's of 1500 rows, B2 and its
     paged entry at head dim 64 with one query head a kv head, and B6 at
     frontend.proj (1500 rows) and the head;
  13. `serve_llama_3_2_vision_11b`: llama-3.2-vision-11b (8 groups of
     four self layers and one gated cross-attention layer over one image
     of 1601 patch embeddings, drawn on the card and given to the engine
     as its extras, projected by every request's prefill; the self caches
     beside 1601-row image memories that a prefill writes once and decode
     only reads) at full width and 20 of its 40 layers (VISION_LAYERS),
     the cross layers' gates
     set non-zero (the reference draws them at zero, which leaves the
     image unread), `serve`'s traffic through the graphed engine: weight
     bytes against bf16 dense, the image memories' and the self caches'
     bytes, peak memory, decode ms a step, tok/s, prefill s, launches (B1
     80 and B2 16 a replayed step; B3 88 a prefill; 160, 32 and 176 at
     40 layers), the caches after
     the decode graph's build as init_cache made them, the plain decode
     step at bf16 within VISION_PLAIN_REL (three faulty controls above
     it, one with the memories zeroed) and at fp32 within 1e-3,
     graph_step (decode and every bucket, bitwise), the replays'
     profiles with the "other" kernels that take the most; then on the
     same weights the paged engine with the contiguous run's tokens
     exactly, the paged engine with prefill_chunk 64 (each chunk
     re-projects the image) and its step after a chunked prefill held to
     the one-shot one (bf16 within the bound, fp32 within 1e-3), the
     split-pinned planner with its step held to the fused one, INT8
     prefill (B6 at img_proj and the head), a snapshot restored, kv_bits
     = 4 and speculate_k = 3 refused with the reference's messages, and
     the CLI (`--arch llama-3.2-vision-11b --full`); the check phase
     holds B1, B4, B5 and the pair at its decode linears, B3 at its
     prefill linears of a 200-token prompt and at the cross wk/wv of 1601
     image rows, and B6 at img_proj (1601 rows) and the head; then
     `serve_llama2_7b_fit` (llama2-7b cut to FIT_LAYERS layers, its
     dense weights fitted on the card and served, ``serve_fit``);
  6b. `dryrun_serve` (after `serve`): the port's dry run
     (``launch/dryrun.py``'s counting, ``steps.lower_serve_decode_step``)
     of the exact `serve` decode step, llama2-7b at SLOTS slots and
     MAX_LEN on a one-rank mesh over meta tensors: its compute, memory
     and collective terms at the H100 data-sheet rates and its
     bottleneck, beside the `serve` replay's measured busy ms a step;
     the bound must not exceed that busy time (a bound above the card's
     own time is a wrong count);
  13b. `train_qwen3_0_6b` (``train_qwen3``): qwen3-0.6b trained at full
     width and depth (751.6 M fp32 params, bf16 activations, AdamW under
     warmup_cosine, remat, 16 steps of 8 x 1024 tokens of the affine
     task over TRAIN_DATA_VOCAB ids): the loss a step (finite, the last
     below 0.95x the first), median step ms, tokens/s, the share of the
     fp32 peak, of the bf16 peak and of the step's mixed bound (the
     head's product in fp32, the rest in bf16), peak bytes with remat on
     and off (off runs out of the card's memory), one profiled step's
     idle share; its params and AdamW state saved and restored (bitwise,
     bytes and s); the step itself at full width and STEP_LAYERS layers
     against the plain fp32 step on the CPU (loss, gnorm, every
     gradient leaf), beside two processes: a SMOKE run restarted from
     its checkpoint equal to an uninterrupted one under deterministic
     algorithms, and the training CLI (`--full --steps 5 --seq-len
     256`); the trained params fitted and
     served (B1, B2, B3 required) beside the dense model: the losses on
     a held-out batch under the reference's three conditions, the share
     of greedy tokens that follow the affine rule, their agreement;
  14. a {"kernels": [...]} summary line (fused_vq_matmul's row also
     sums its verify-window rows, `verify_window`; B1's and B3's carry
     their mixtral, deepseek, xlstm, recurrentgemma, whisper and vision
     rows, B4's and B5's their deepseek, xlstm, recurrentgemma, whisper
     and vision rows, B6's its xlstm, recurrentgemma, whisper and vision
     rows, B2's and its paged entry's their whisper rows, each with its
     decode step's sum where it has one), the card line, and the result
     line {"ok": true, "device": {...}} last.

Without a CUDA device, or outside a checkout of the repository, it fails
before printing any result.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM data-sheet rates, kept in one place with the dry run's roofline
from repro_torch.roofline.analysis import (  # noqa: E402
    HBM_BW as HBM_BYTES_PER_S, PEAK_FLOPS as BF16_FLOPS,
    PEAK_FLOPS_FP32 as FP32_FLOPS, PEAK_INT8_OPS as INT8_OPS)
SLOTS, MAX_LEN, N_REQUESTS, MAX_NEW = 4, 512, 8, 32
BLOCK = 16                     # paged KV: positions a block
PREFILL_CHUNK = 64             # chunked prefill (prompts of 32-200 tokens)
TIGHT_BLOCKS = 40              # serve_paged_tight's pool (W = 32): it preempts
GRAPH_STEPS = 8                # decode replays held to eager steps
PROFILE_BUCKET = 128           # the prefill replay that is profiled
HOST_REPS = 50                 # back-to-back calls per host-clock timing
PROFILE_ATTEMPTS = 3           # profiles taken while one records no event
PLAIN_REL = 0.05               # a bf16 decode step against its plain version
QWEN2_PLAIN_REL = 0.15         # the same through 80 random layers (direct order)
SEED = 0
LOOKUP_M = (1, 2, SLOTS, 8)    # rows of M the lookup kernels are checked at
SPEC_K = 3                     # serve_spec's drafts a step
# B1's rows in a speculative verify window, M = slots x (K + 1), K = 2, 3
SPEC_M = tuple(SLOTS * (k + 1) for k in (2, SPEC_K))
VQL_KC = 2048                  # serve_vql's codewords (a 32000-row vocab)
# the VQ-Logits head against its expansion, both bf16 GEMMs rounded to
# bf16: one bf16 ulp of the largest logit
VQL_REL = 2.0 ** -7
# serve_mixtral_8x22b: full width, rings of 4096 positions;
# two prompts past the window (the first wraps in its prefill's ring
# conversion, the second in decode) among six of 32-200 tokens
MIXTRAL = "mixtral_8x22b"
# its depth, cut from 56 to keep the whole run in its time limit (full
# width; printed as "reduced" beside the weights)
MIXTRAL_LAYERS = 28
MIXTRAL_MAX_LEN = 4608
MIXTRAL_LONG = (4160, 4080)
# its bf16 plain decode step against the kernels' step: a top-2 routing
# choice near a tie flips on bf16 rounding alone and moves the logits far
# more than rounding does, so the bound is half the smallest faulty
# control on qwen2-72b (0.898), which the two controls must exceed here
MIXTRAL_PLAIN_REL = 0.45
# B1 at mixtral's decode linears (attention at M = slots, an expert at
# its capacity for 4 tokens) and B3 at an expert's gu at the capacity of
# a 4160-token prompt
MIXTRAL_B3_M = 1300
# serve_deepseek_v2_lite_16b: full width (MLA, a dense first
# layer, then 64 routed experts top-6 beside 2 shared), serve's traffic
DEEPSEEK = "deepseek_v2_lite_16b"
# its depth, cut from 27 (the dense first layer and 13 MoE layers)
DEEPSEEK_LAYERS = 14
# the MoE models' sub-phase depth (paged, kv_bits, split): deepseek's
# dense first layer and 3 MoE layers
MOE_SUB_LAYERS = 4
# a MoE model's served path: B1 and B3; never B2/B7 (rings and MLA attend
# in plain torch, as the reference gates them), B4/B5 (the fused planner)
# or B6 (no int8 prefill)
MOE_REQUIRED = ("fused_vq_matmul", "dequant_gemv")
MOE_ABSENT = ("flash_decode", "flash_decode_kvq", "flash_decode_paged",
              "flash_decode_kvq_paged", "vq_gemm", "oc_lookup", "int8_gemm")
# the split-pinned planner's path: B4 + B5 in decode, B3 in prefill
SPLIT_REQUIRED = ("vq_gemm", "oc_lookup", "dequant_gemv")
# its bf16 plain decode step against the kernels' step, within half the
# smaller of its two faulty controls (the plain step one position early:
# 0.250 of the max logit on the first run, NVIDIA H100 80GB HBM3, 700 W;
# the sound step read 0.059 there, 0.885 of its top-6 choices agreeing)
DEEPSEEK_PLAIN_REL = 0.125
# the prompt length the check phase holds B3 at deepseek's prefill
# linears (a routed expert at its capacity for it: 24 rows)
DEEPSEEK_B3_T = 200
# serve_xlstm_125m: 12 layers (6 mLSTM/sLSTM groups) at full width,
# serve's traffic; recurrent state of a fixed size a slot
XLSTM = "xlstm_125m"
# its bf16 plain decode step against the kernels' step: 7.5x the sound
# step's drift on the first run (0.0134 of the max logit) and under a
# tenth of the smaller of its two faulty controls there (the plain step
# from init_cache's state 1.045, with the next token id 1.217; NVIDIA
# H100 80GB HBM3, 700 W)
XLSTM_PLAIN_REL = 0.1
# the prompt length the check phase holds B3 and B6 at xlstm's prefill
# linears
XLSTM_B3_T = 200
# serve_recurrentgemma_2b: 26 layers (8 (rec, rec, attn) groups, then 2
# rec layers) at full width, serve's traffic; RG-LRU state and
# local-attention rings of min(max_len, 2048) positions in one cache tree
RGLRU = "recurrentgemma_2b"
# its bf16 plain decode step against the kernels' step: 3.4x the sound
# step's drift on the first run (0.0294 of the max logit) and under
# three fifths of the smaller of its two faulty controls there (the plain
# step one position early 0.174, with the next token id 1.356; NVIDIA
# H100 80GB HBM3, 700 W)
RGLRU_PLAIN_REL = 0.1
# its ring-wrap sub-run at full width: rings of 2048 (max_len 2560); the
# first long prompt wraps in its prefill's ring conversion, the second in
# decode, among two of 32-200 tokens
RGLRU_WRAP_MAX_LEN = 2560
RGLRU_WRAP = (2100, 2030)
# the prompt length the check phase holds B3 and B6 at its prefill
# linears
RGLRU_B3_T = 200
# serve_whisper_medium: 24 encoder and 24 decoder layers at full width,
# serve's traffic, one set of S_SRC frames (the engine's extras) for every
# request's prefill; the cache holds the S_SRC-row cross memories
WHISPER = "whisper_medium"
WHISPER_LAYERS = 12            # encoder and decoder, each of 24 since PR 30
WHISPER_FRAMES = 1500
# its bf16 plain decode step against the kernels' step: 2.4x the sound
# step's drift on the first run (0.0102 of the max logit) and under two
# thirds of the smaller of its two faulty controls there (the plain step
# one position early 0.0395: the position moves only rope and the
# sinusoid, small beside the 1500-row cross memories; from init_cache's
# state 1.110; NVIDIA H100 80GB HBM3, 700 W)
WHISPER_PLAIN_REL = 0.025
# the decoder prompt length the check phase holds B3 and B6 at (the
# encoder's linears at WHISPER_FRAMES rows)
WHISPER_B3_T = 200
# the kernels of its served path: B1, B2 (hd 64, one query head a kv
# head) and B3
WHISPER_REQUIRED = ("fused_vq_matmul", "flash_decode", "dequant_gemv")
# serve_llama_3_2_vision_11b: 8 groups of four self layers and one gated
# cross layer at full width, serve's traffic, one image of VISION_IMG
# patch embeddings (the engine's extras; one tile, the cache's capacity)
# for every request's prefill
VISION = "llama_3_2_vision_11b"
VISION_LAYERS = 20             # 4 of its 8 groups since PR 30
VISION_IMG = 1601
# the cross layers' (attn_gate, mlp_gate): the reference draws them at
# zero, which would leave the image path unread
VISION_GATES = (0.8, 0.6)
# the image: one shared row plus this much independent noise a patch, as
# a tile's patch embeddings share a component; independent rows average
# out in the cross attention's near-uniform softmax over 1601 random keys
# (zeroing the memories then moved the logits by 0.018 of the max logit,
# barely past the bf16 step's own drift, on an H100)
VISION_PATCH_NOISE = 0.5
# its bf16 plain decode step against the kernels' step: 2.5x the sound
# step's drift on the first run with a structured image (0.0162 of the max
# logit) and under a third of the smallest of its three faulty controls
# there (the plain step one position early 0.136, with the next token id
# 0.794, with the image memories zeroed 0.482; NVIDIA H100 80GB HBM3,
# 700 W); the step after a chunked prefill drifted 0.0112 from the
# one-shot one
VISION_PLAIN_REL = 0.04
# the prompt length the check phase holds B3 and B6 at (the cross wk and
# wv, and img_proj, at VISION_IMG rows)
VISION_B3_T = 200
# the kernels of its served path: B1, B2 (the self layers; the cross
# decode attends in plain torch, as the reference's) and B3
VISION_REQUIRED = ("fused_vq_matmul", "flash_decode", "dequant_gemv")
# serve_llama2_7b_fit: llama2-7b's dense block weights drawn on the card
# and fitted there (quantize(method="fit"): 10 Lloyd iterations, C = 2
# greedy residual stages); the int4, int8 and fp caches then decode
# FIT_KV_STEPS teacher-forced steps from one prefill, and the KV-VQ
# codebooks are calibrated on CALIB_ROWS prompts of CALIB_LEN tokens
FIT = "llama2_7b"
FIT_LAYERS = 16                # of 32 since PR 30: the run's time limit
# train_qwen3_0_6b: qwen3-0.6b at full width and depth, trained
TRAIN = "qwen3-0.6b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 8, 1024, 16, 1e-3
TRAIN_HELD_OUT = 99            # the data step whose batch the losses read
# the affine task over the first 512 token ids (the reference's SMOKE
# vocabulary, whose task its test_system trains): over all 151936 ids
# each step's 8192 pairs are new, and 16 steps at lr 1e-3 moved the loss
# 1.4%; over 4096 the model learned which ids occur but no pair (none of
# its greedy tokens followed the rule), and the fitted model's loss came
# out 0.2% below the dense one's (an H100 at 700 W, PR 30)
TRAIN_DATA_VOCAB = 512
RESTART_STEPS, RESTART_FAIL = 10, 6   # the restart identity (SMOKE config)
# the train step held against the plain fp32 step on the CPU: qwen3-0.6b
# at full width and STEP_LAYERS layers, STEP_BATCH x STEP_SEQ tokens.
# bf16 activations against fp32 put a gradient leaf within about 1e-2
# of the plain one (relative L2); a dropped or wrong layer gradient is
# about 1 off, a sign flip 2
STEP_LAYERS, STEP_BATCH, STEP_SEQ = 2, 2, 64
STEP_GRAD_REL = 0.1
STEP_LOSS_REL = 1e-2
FIT_KV_STEPS = 16
CALIB_ROWS, CALIB_LEN = 4, 128
LINEARS = (("wqkv", 4096, 12288), ("wo", 4096, 4096), ("gu", 4096, 22016),
           ("down", 11008, 4096))
# the dense configs served after llama2-7b, and the (H, Hk) of their
# grouped-query attention (g = H / Hk = 4, 2, 3, 8)
OTHER_ARCHS = ("llama3_8b", "qwen3_0_6b", "minitron_4b", "qwen2_72b")
GROUPS = ((32, 8), (16, 8), (24, 8), (64, 8))
REPLACES = {
    "fused_vq_matmul": "src/repro/kernels/fused_vq_matmul/kernel.py:49",
    "flash_decode": "src/repro/kernels/flash_decode/kernel.py:33",
    "dequant_gemv": "src/repro/kernels/dequant_gemv/kernel.py:20",
    "int8_gemm": "src/repro/kernels/int8_gemm/kernel.py:22",
    "flash_decode_kvq": "src/repro/kernels/flash_decode/kernel.py:73",
    "vq_gemm": "src/repro/kernels/vq_gemm/kernel.py:24",
    "oc_lookup": "src/repro/kernels/oc_lookup/kernel.py:33",
    "flash_decode_paged": "src/repro/kernels/flash_decode/ops.py:61",
    "flash_decode_kvq_paged": "src/repro/kernels/flash_decode/ops.py:154",
}
# the two EVA backends that match every decode VQ site
DECODE_BACKENDS = ("eva_fused", "eva_split")
# the kernels of the decode graph (the others run in the prefill graphs)
DECODE_KERNELS = ("fused_vq_matmul", "flash_decode", "flash_decode_kvq",
                  "vq_gemm", "oc_lookup", "flash_decode_paged",
                  "flash_decode_kvq_paged")
# the CUDA functions of each kernel, as the profiler names them
KERNEL_FUNCTIONS = {
    "fused_vq_kernel": "fused_vq_matmul", "split_reduce_kernel":
    "fused_vq_matmul (split reduce)", "flash_decode_kernel": "flash_decode",
    "flash_decode_merge_kernel": "flash_decode (merge)",
    "flash_decode_kvq_kernel": "flash_decode_kvq",
    "flash_decode_paged_kernel": "flash_decode_paged",
    "flash_decode_kvq_paged_kernel": "flash_decode_kvq_paged",
    "kvq_merge_kernel": "flash_decode_kvq (merge)",
    "dequant_gemv_kernel": "dequant_gemv",
    "dequant_reduce_kernel": "dequant_gemv (split reduce)",
    "dequant_split_x_kernel": "dequant_gemv (x split)",
    "int8_gemm_kernel": "int8_gemm",
    "vq_gemm_kernel": "vq_gemm", "oc_lookup_kernel": "oc_lookup",
    "oc_split_reduce_kernel": "oc_lookup (split reduce)",
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound_ms(nbytes: float, flops: float, peak: float = FP32_FLOPS) -> tuple:
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / peak
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
    from repro_torch.core.ops import quantize_int8
    from repro_torch.core.vq import (KVQuantConfig, dequantize, kv_decode,
                                     kv_encode, kv_grid_codebooks, synthetic_vq)
    from repro_torch.kernels.dequant_gemv import dequant_gemv
    from repro_torch.kernels.dequant_gemv.ops import (
        launch_shape as dequant_launch_shape)
    from repro_torch.kernels.flash_decode import (flash_decode,
                                                  flash_decode_kvq,
                                                  flash_decode_kvq_paged,
                                                  flash_decode_kvq_paged_ref,
                                                  flash_decode_kvq_ref,
                                                  flash_decode_paged,
                                                  flash_decode_paged_ref,
                                                  flash_decode_ref)
    from repro_torch.models.common import paged_view
    from repro_torch.kernels.int8_gemm import int8_gemm, int8_gemm_ref

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = {n: [] for n in (*REPLACES, "eva_split_matmul")}

    def record(kernel, case, got, want, tol, fn, plain, library, nbytes, flops,
               peak=FP32_FLOPS, extra=None):
        """``extra``: other PyTorch calls timed beside the library call,
        as {row key: call}."""
        err = (got.float() - want.float()).abs().max().item()
        again = fn()
        det = bool(torch.equal(got, again))
        b_ms, b_by = bound_ms(nbytes, flops, peak)
        row = {"kernel": kernel, "case": case, "max_abs_err": err, "tol": tol,
               "bitwise_equal": det, "kernel_ms": timer(fn),
               "plain_ms": timer(plain),
               "library_ms": timer(library) if library else None,
               **{k: timer(f) for k, f in (extra or {}).items()},
               "bound_ms": b_ms, "bound_by": b_by}
        emit(row)
        if not (err <= tol and det):
            raise AssertionError(f"{kernel} {case}: err {err} > tol {tol} "
                                 f"or not deterministic ({det})")
        rows[kernel].append(row)

    # B1 at the decode linears (check_b1)
    C = 2
    lookup_cases = [(M, name, K, N) for M in LOOKUP_M for name, K, N in LINEARS]
    lookup_cases.append((3, "ragged", 296, 1030))
    for M, name, K, N in lookup_cases:
        vq = synthetic_vq(gen, K, N, C=C, device="cuda")
        x = torch.randn((M, K), generator=gen, device="cuda")
        check_b1(torch, record, vq, x, {"linear": name})
        del vq

    # B3 at the prefill layer (M = MAX_LEN) with fp32 x (the reference's
    # precision: three bf16 products) and with bf16 x (the served dtype:
    # two), and with bf16 x at every bucket the served prefill runs (32,
    # 64, 128 and 256 tokens: one kernel instance, a token tile, each).
    # The library call computing the same function is fp32 torch.matmul on
    # the dequantized fp32 weights (TF32 off); bf16 torch.matmul on
    # bf16-rounded weights is timed beside it, at lower precision (it
    # misses the tolerance). Bound: the products' flops at the bf16
    # tensor-core rate. Last, bf16 x at M = SLOTS, the decode rows B3 serves
    # once both EVA backends are quarantined (serve_resilience), with the
    # launch shape its wrapper picks.
    for M, x_dtype in ((MAX_LEN, torch.float32), (MAX_LEN, torch.bfloat16),
                       *((m, torch.bfloat16) for m in (256, 128, 64, 32)),
                       (SLOTS, torch.bfloat16)):
        for name, K, N in LINEARS:
            vq = synthetic_vq(gen, K, N, C=C, device="cuda")
            x = torch.randn((M, K), generator=gen, device="cuda").to(x_dtype)
            x32, xb = x.float(), x.to(torch.bfloat16)
            w = dequantize(vq)
            wb = w.to(torch.bfloat16)
            run = lambda: dequant_gemv(x, vq, out_dtype=torch.float32)
            plain = lambda: dequant_gemv(x, vq, out_dtype=torch.float32,
                                         use_kernel=False)
            got, want = run(), plain()
            tol = 1e-4 * max(1.0, want.abs().max().item())
            V = K // 8
            products = 3 if x_dtype == torch.float32 else 2
            case = {"M": M, "linear": name, "K": K, "N": N,
                    "x": str(x_dtype).split(".")[-1]}
            if M == SLOTS:
                case["launch_shape"] = dequant_launch_shape(
                    M, V, N, torch.cuda.get_device_properties(
                        0).multi_processor_count)
            record("dequant_gemv", case,
                   got, want, tol, run, plain, lambda: torch.matmul(x32, w),
                   x.numel() * x.element_size() + C * V * N + C * 8 * 256 * 4
                   + N * 4 + M * N * 4, products * 2 * M * K * N,
                   peak=BF16_FLOPS,
                   extra={"library_bf16_ms": lambda: torch.matmul(xb, wb)})
            del vq, w, wb

    # the two-kernel split (check_split) at the decode linears and the
    # ragged shape, the pair against its plain version and B1 at M = slots
    for M, name, K, N in lookup_cases:
        check_split(torch, gen, record, K, N, M, {"linear": name},
                    pair=M == SLOTS)

    # B2 at mixed lengths (the summary's case) and with every row at
    # max_len (the cache the engine reaches as requests grow); the library
    # call is SDPA over the padded cache with the length mask
    B, H, hd = SLOTS, 32, 128
    q = torch.randn((B, H, hd), generator=gen, device="cuda").bfloat16()
    k = torch.randn((B, MAX_LEN, H, hd), generator=gen, device="cuda").bfloat16()
    v = torch.randn((B, MAX_LEN, H, hd), generator=gen, device="cuda").bfloat16()
    kt, vt, q4 = k.transpose(1, 2), v.transpose(1, 2), q[:, :, None, :]
    mask_of = lambda lens: (torch.arange(MAX_LEN, device="cuda")[None, :]
                            < lens[:, None])[:, None, None, :]
    mixed = torch.tensor([1, MAX_LEN, 200, 64], dtype=torch.int32, device="cuda")
    for lengths in (mixed, torch.full((B,), MAX_LEN, dtype=torch.int32,
                                      device="cuda")):
        mask = mask_of(lengths)
        run = lambda: flash_decode(q, k, v, lengths)
        got, want = run(), flash_decode_ref(q, k, v, lengths)
        tot = int(lengths.clamp(max=MAX_LEN).sum())
        record("flash_decode", {"B": B, "H": H, "Hk": H, "hd": hd,
                                "S": MAX_LEN, "lengths": lengths.tolist(),
                                "dtype": "bfloat16"},
               got, want, 2.0 ** -7 * max(1.0, want.float().abs().max().item()),
               run, lambda: flash_decode_ref(q, k, v, lengths),
               lambda: F.scaled_dot_product_attention(q4, kt, vt,
                                                      attn_mask=mask),
               2 * q.numel() * 2 + tot * 2 * H * hd * 2 + B * 4,
               tot * H * hd * 4)

    # KV-VQ decode attention over the same K/V at the mixed lengths,
    # encoded as the engine's cache holds it (uint8 indices, bf16 scales,
    # grid codebooks); the library call is SDPA over the cache dequantized
    # to bf16
    # the paged entries read the same K/V as block arenas (4 rows x 32
    # blocks of 16: a parity pool), through a shuffled table whose entries
    # past each row's length are the sentinel
    W, NB = MAX_LEN // BLOCK, SLOTS * MAX_LEN // BLOCK
    perm = torch.randperm(NB, generator=gen, device="cuda").int()
    table = torch.full((B, W), NB, dtype=torch.int32, device="cuda")
    used = 0
    for b, n in enumerate(mixed.tolist()):
        nb = -(-n // BLOCK)
        table[b, :nb] = perm[used:used + nb]
        used += nb
    arena = lambda t: t.reshape((NB, BLOCK) + t.shape[2:])
    view = lambda a: paged_view(a, table)
    tot = int(mixed.clamp(max=MAX_LEN).sum())
    ka, va = arena(k), arena(v)
    kv_, vv_ = view(ka), view(va)
    run = lambda: flash_decode_paged(q, ka, va, table, mixed)
    got, want = run(), flash_decode_paged_ref(q, ka, va, table, mixed)
    contiguous = flash_decode(q, kv_, vv_, mixed)
    emit({"phase": "paged_vs_contiguous_kernel", "kernel": "flash_decode_paged",
          "bitwise_equal": bool(torch.equal(got, contiguous))})
    assert torch.equal(got, contiguous), "flash_decode_paged != contiguous"
    # bound: the rows up to the lengths, q, o, the table and the lengths;
    # no one PyTorch call takes a block table: the yardsticks are the
    # contiguous kernel over the gathered view and the reference's route
    # (the gather, then that kernel)
    record("flash_decode_paged",
           {"B": B, "H": H, "Hk": H, "hd": hd, "blocks": NB, "block": BLOCK,
            "S": MAX_LEN, "lengths": mixed.tolist(), "dtype": "bfloat16"},
           got, want, 2.0 ** -7 * max(1.0, want.float().abs().max().item()),
           run, lambda: flash_decode_paged_ref(q, ka, va, table, mixed), None,
           2 * q.numel() * 2 + tot * 2 * H * hd * 2 + B * 4 + table.numel() * 4,
           tot * H * hd * 4,
           extra={"contiguous_ms": lambda: flash_decode(q, kv_, vv_, mixed),
                  "gather_kernel_ms": lambda: flash_decode(q, view(ka),
                                                           view(va), mixed)})
    del kv_, vv_

    lengths, mask = mixed, mask_of(mixed)
    for kv_bits in (4, 2):
        kvq = KVQuantConfig(kv_bits=kv_bits)
        cb = kv_grid_codebooks(H, hd, kvq, device="cuda")
        k_idx, k_s = kv_encode(k, cb)
        v_idx, v_s = kv_encode(v, cb)
        k_s, v_s = k_s.bfloat16(), v_s.bfloat16()
        ops = (q, k_idx, v_idx, k_s, v_s, lengths, cb, cb)
        kd = kv_decode(k_idx, k_s, cb).bfloat16().transpose(1, 2)
        vd = kv_decode(v_idx, v_s, cb).bfloat16().transpose(1, 2)
        run = lambda: flash_decode_kvq(*ops)
        got, want = run(), flash_decode_kvq_ref(*ops)
        RG = kvq.idx_width(hd)
        record("flash_decode_kvq",
               {"B": B, "H": H, "Hk": H, "hd": hd, "S": MAX_LEN,
                "lengths": lengths.tolist(), "kv_bits": kv_bits,
                "dtype": "bfloat16"},
               got, want, 2.0 ** -7 * max(1.0, want.float().abs().max().item()),
               run, lambda: flash_decode_kvq_ref(*ops),
               lambda: F.scaled_dot_product_attention(q4, kd, vd, attn_mask=mask),
               # the function's inputs — q, the index rows and bf16 scales up
               # to the lengths, both codebooks, the lengths — and its bf16
               # output; operations: the table (RG x 256 entries of vd FMAs
               # per query head) and per position the score gathers, the V
               # rebuild and the weighted sum
               q.numel() * 2 + tot * H * (2 * RG + 2 * 2) + 2 * cb.numel() * 4
               + B * 4 + q.numel() * 2,
               B * H * RG * 256 * 2 * kvq.vec_d
               + tot * H * (RG + 2 * hd + hd * kvq.residual))
        del kd, vd
        if kv_bits != 4:
            continue
        # the paged entry on the served layout (kv_bits=4), as B2's
        pops = (q, *(arena(t) for t in (k_idx, v_idx, k_s, v_s)), table,
                lengths, cb, cb)
        pview = (q, *(view(t) for t in pops[1:5]), lengths, cb, cb)
        run = lambda: flash_decode_kvq_paged(*pops)
        got, want = run(), flash_decode_kvq_paged_ref(*pops)
        contiguous = flash_decode_kvq(*pview)
        emit({"phase": "paged_vs_contiguous_kernel",
              "kernel": "flash_decode_kvq_paged",
              "bitwise_equal": bool(torch.equal(got, contiguous))})
        assert torch.equal(got, contiguous), "flash_decode_kvq_paged != contiguous"
        record("flash_decode_kvq_paged",
               {"B": B, "H": H, "Hk": H, "hd": hd, "blocks": NB,
                "block": BLOCK, "S": MAX_LEN, "lengths": lengths.tolist(),
                "kv_bits": kv_bits, "dtype": "bfloat16"},
               got, want, 2.0 ** -7 * max(1.0, want.float().abs().max().item()),
               run, lambda: flash_decode_kvq_paged_ref(*pops), None,
               q.numel() * 2 + tot * H * (2 * RG + 2 * 2) + 2 * cb.numel() * 4
               + B * 4 + table.numel() * 4 + q.numel() * 2,
               B * H * RG * 256 * 2 * kvq.vec_d
               + tot * H * (RG + 2 * hd + hd * kvq.residual),
               extra={"contiguous_ms": lambda: flash_decode_kvq(*pview),
                      "gather_kernel_ms": lambda: flash_decode_kvq(
                          q, *(view(t) for t in pops[1:5]), lengths, cb, cb)})
        del pops, pview

    check_grouped_attention(torch, gen, record)
    check_other_linears(torch, gen, record)
    check_mixtral_linears(torch, gen, record)
    check_deepseek_linears(torch, gen, record)
    check_xlstm_linears(torch, gen, record)
    check_rglru_linears(torch, gen, record)
    check_whisper_linears(torch, gen, record)
    check_vision_linears(torch, gen, record)

    # INT8 GEMM at the prefill lm_head shape, at every bucket the served
    # prefill runs (bf16 activations and head, quantized as the wrapper
    # quantizes them); the library call is
    # torch._int_mm on the same int8 operands (B column-major, the layout
    # cuBLAS's int8 GEMM takes) with the same two scale multiplies
    K, N = 4096, 32000
    w = torch.randn((K, N), generator=gen, device="cuda").bfloat16()
    wq, ws = quantize_int8(w, axis=0)
    wq_cm = wq.t().contiguous().t()
    emit({"phase": "int8_weight_quantization", "K": K, "N": N,
          "ms_per_call": timer(lambda: quantize_int8(w, axis=0))})
    for M in (32, 64, 128, 256):
        x = torch.randn((M, K), generator=gen, device="cuda").bfloat16()
        xq, xs = quantize_int8(x, axis=-1)
        run = lambda: int8_gemm(xq, wq, xs, ws)
        got, want = run(), int8_gemm_ref(xq, wq, xs, ws)
        record("int8_gemm", {"M": M, "K": K, "N": N}, got, want, 0.0, run,
               lambda: int8_gemm_ref(xq, wq, xs, ws),
               lambda: torch._int_mm(xq, wq_cm).float() * xs * ws,
               M * K + K * N + 4 * M + 4 * N + 4 * M * N, 2 * M * N * K,
               peak=INT8_OPS)
    check_verify_window_linears(torch, gen, record)
    rows["eva_plain"] = check_plain_epilogues(torch, gen, timer)
    return rows


def check_split(torch, gen, record, K, N, M, case, pair):
    """The two-kernel split on a fresh (K, N) weight with M rows of fp32
    x: vq_gemm (B4) with fp32 x and with bf16 x as served (read as
    stored, no cast kernel; the bf16 run bitwise equal to the fp32 run of
    the same values), and oc_lookup (B5) fed B4's output codebook, each
    against its plain version within 1e-4 x max|y|. ``pair``: also
    eva_split_matmul (B4 then B5) against its plain version and against
    B1 (the fused kernel) within the same tolerance. B4's library call is
    the batched fp32 matmul of the same (fp32) values; no single PyTorch
    call computes B5's lookup-and-add; the pair's is fp32 torch.matmul on
    the dequantized weight, bf16 timed beside it."""
    from repro_torch.core.vq import dequantize, synthetic_vq
    from repro_torch.kernels.fused_vq_matmul import fused_vq_matmul
    from repro_torch.kernels.oc_lookup import eva_split_matmul, oc_lookup
    from repro_torch.kernels.vq_gemm import vq_gemm

    C = 2
    vq = synthetic_vq(gen, K, N, C=C, device="cuda")
    vq.scale = torch.rand(N, generator=gen, device="cuda") + 0.5
    x = torch.randn((M, K), generator=gen, device="cuda")
    V, cb = K // 8, vq.codebooks
    case = {"M": M, **case, "K": K, "N": N}
    xb = x.to(torch.bfloat16)
    for xi in (x, xb):
        xf = xi.float().reshape(M * V, 8)
        run = lambda: vq_gemm(xi, cb)
        O, want = run(), vq_gemm(xi, cb, use_kernel=False)
        record("vq_gemm", {**case, "x": str(xi.dtype).split(".")[-1]}, O,
               want, 1e-4 * max(1.0, want.abs().max().item()), run,
               lambda: vq_gemm(xi, cb, use_kernel=False),
               lambda: torch.matmul(xf[None], cb),
               xi.numel() * xi.element_size() + C * 8 * 256 * 4
               + C * M * V * 256 * 4, C * M * V * 256 * 8 * 2)
        del O, want
    assert torch.equal(vq_gemm(xb, cb), vq_gemm(xb.float(), cb)), \
        f"vq_gemm bf16 x {case}"
    O = vq_gemm(x, cb)
    run = lambda: oc_lookup(O, vq.idx, vq.scale)
    got = run()
    want = oc_lookup(O, vq.idx, vq.scale, use_kernel=False)
    record("oc_lookup", case, got, want,
           1e-4 * max(1.0, want.abs().max().item()), run,
           lambda: oc_lookup(O, vq.idx, vq.scale, use_kernel=False), None,
           C * V * N + C * M * V * 256 * 4 + N * 4 + M * N * 4,
           C * M * V * N + M * N)
    del O, got, want
    if not pair:
        return
    w = dequantize(vq)
    wb = w.to(torch.bfloat16)
    run = lambda: eva_split_matmul(x, vq, out_dtype=torch.float32)
    got = run()
    want = eva_split_matmul(x, vq, out_dtype=torch.float32, use_kernel=False)
    tol = 1e-4 * max(1.0, want.abs().max().item())
    fused = fused_vq_matmul(x, vq, out_dtype=torch.float32)
    vs_fused = (got - fused).abs().max().item()
    emit({"phase": "eva_split_vs_fused", "case": case,
          "max_abs_diff": vs_fused, "tol": tol})
    assert vs_fused <= tol, f"eva_split vs fused {case}: {vs_fused}"
    record("eva_split_matmul", case, got, want, tol, run,
           lambda: eva_split_matmul(x, vq, out_dtype=torch.float32,
                                    use_kernel=False),
           lambda: torch.matmul(x, w),
           M * K * 4 + C * V * N + C * 8 * 256 * 4 + N * 4 + M * N * 4,
           C * M * V * 256 * 8 * 2 + C * M * V * N + M * N,
           extra={"library_bf16_ms": lambda: torch.matmul(xb, wb)})


def check_verify_window_linears(torch, gen, record):
    """B1 at llama2-7b's four decode linears with the rows of a
    speculative verify window, M = slots x (K + 1) (SPEC_M), as
    serve_spec runs it: against its plain version, bitwise equal from
    run to run, beside fp32 and bf16 torch.matmul on the dequantized
    weights; the bound from the bytes and from the products' and
    lookups' fp32 operations at that M; the launch shape the tile model
    picks (fitted at M <= 8, in tiles of 4 rows)."""
    from repro_torch.core.vq import synthetic_vq

    for M in SPEC_M:
        for name, K, N in LINEARS:
            vq = synthetic_vq(gen, K, N, C=2, device="cuda")
            x = torch.randn((M, K), generator=gen, device="cuda")
            check_b1(torch, record, vq, x,
                     {"speculate_k": M // SLOTS - 1, "linear": name},
                     launch_shape=True)
            del vq


def check_plain_epilogues(torch, gen, timer):
    """The plain EVA epilogues of ``core/ops.py`` (what the plain decode
    step runs under ``impl="torch"``, as the reference's jnp backends) at
    llama2-7b's four decode linears: direct and blocked at M = slots,
    recon at M = slots and at 16 (each v-block as the planner sizes it),
    against B1 on the same inputs (within B1's own tolerance) and timed
    beside it. Yardsticks, not library calls: each is plain PyTorch."""
    from repro_torch.core import ops
    from repro_torch.core.vq import synthetic_vq
    from repro_torch.kernels.fused_vq_matmul import fused_vq_matmul

    cases = {SLOTS: ("direct", "blocked", "recon"), 16: ("recon",)}
    out = []
    for name, K, N in LINEARS:
        vq = synthetic_vq(gen, K, N, C=2, device="cuda")
        for M, kinds in cases.items():
            x = torch.randn((M, K), generator=gen, device="cuda")
            b1 = lambda: fused_vq_matmul(x, vq, out_dtype=torch.float32)
            want, b1_ms = b1(), timer(b1)
            tol = 1e-4 * max(1.0, want.abs().max().item())
            for kind in kinds:
                bv = {"direct": None,
                      "blocked": ops.auto_block_v(M, vq.V, N, vq.C),
                      "recon": ops.auto_recon_block_v(vq.V, N, vq.d)}[kind]
                run = lambda: ops.eva_epilogue_exec(
                    x, vq, kind=kind, block_v=bv, out_dtype=torch.float32)
                row = {"yardstick": f"eva_{kind}",
                       "case": {"M": M, "linear": name, "K": K, "N": N,
                                "block_v": bv},
                       "selected": ops.select_epilogue(
                           M, vq.V, N, vq.C)[0] == kind,
                       "max_abs_err_vs_b1": (run() - want).abs().max().item(),
                       "tol": tol, "ms": timer(run), "b1_ms": b1_ms}
                emit(row)
                assert row["max_abs_err_vs_b1"] <= tol, row
                out.append(row)
        del vq
    return out


def check_b1(torch, record, vq, x, case, launch_shape=False):
    """B1 on fp32 ``x`` (M, K) against its plain version. The library call
    computing the same function is fp32 torch.matmul on the dequantized
    fp32 weights (TF32 off); bf16 torch.matmul on bf16-rounded weights is
    timed beside it, at lower precision (it misses the tolerance). The
    bound: x, the indices, codebooks and scales, y; the products and
    lookups at the fp32 rate. ``launch_shape``: the case also records
    the launch shape the tile model picks."""
    from repro_torch.core.vq import dequantize
    from repro_torch.kernels import build
    from repro_torch.kernels.eva_lookup import tiles
    from repro_torch.kernels.fused_vq_matmul import fused_vq_matmul
    from repro_torch.kernels.fused_vq_matmul.ops import select_split

    (M, K), N, C = x.shape, vq.N, vq.C
    V = K // 8
    xb = x.to(torch.bfloat16)
    w = dequantize(vq)
    wb = w.to(torch.bfloat16)
    run = lambda: fused_vq_matmul(x, vq, out_dtype=torch.float32)
    plain = lambda: fused_vq_matmul(x, vq, out_dtype=torch.float32,
                                    use_kernel=False)
    got, want = run(), plain()
    case = {"M": M, **case, "K": K, "N": N}
    if launch_shape:
        di = torch.cuda.current_device()
        case["launch_shape"] = select_split(
            M, V, N, C, build.device_sm_count(di),
            tiles.cluster_slots("fused_vq_matmul", di, M, C, True))._asdict()
    record("fused_vq_matmul", case, got, want,
           1e-4 * max(1.0, want.abs().max().item()), run, plain,
           lambda: torch.matmul(x, w),
           M * K * 4 + C * V * N + C * 8 * 256 * 4 + N * 4 + M * N * 4,
           C * M * V * 256 * 8 * 2 + C * M * V * N + M * N,
           extra={"library_bf16_ms": lambda: torch.matmul(xb, wb)})


def arch_linears(cfg):
    """(name, K, N) of the four decode linears of a dense config."""
    return (("wqkv", cfg.d_model, cfg.q_dim + 2 * cfg.kv_dim),
            ("wo", cfg.q_dim, cfg.d_model), ("gu", cfg.d_model, 2 * cfg.d_ff),
            ("down", cfg.d_ff, cfg.d_model))


def check_grouped_attention(torch, gen, record):
    """B2, B7 (kv_bits=4) and their paged entries at the other configs'
    grouped-query heads (GROUPS: g = 4, 2, 3, 8; hd 128), at the mixed
    lengths of the llama2 rows, against their plain versions (bitwise
    twice), the paged entries also bitwise against the contiguous kernel
    over the gathered view; yardsticks as the llama2 rows (SDPA with
    enable_gqa; the contiguous kernel on the view, and the gather with
    it). Bounds count the K/V bytes of the Hk kv heads."""
    import torch.nn.functional as F
    from repro_torch.core.vq import KVQuantConfig, kv_decode, kv_encode, kv_grid_codebooks
    from repro_torch.kernels.flash_decode import (flash_decode,
                                                  flash_decode_kvq,
                                                  flash_decode_kvq_paged,
                                                  flash_decode_kvq_paged_ref,
                                                  flash_decode_kvq_ref,
                                                  flash_decode_paged,
                                                  flash_decode_paged_ref,
                                                  flash_decode_ref)
    from repro_torch.models.common import paged_view

    B, hd = SLOTS, 128
    lengths = torch.tensor([1, MAX_LEN, 200, 64], dtype=torch.int32, device="cuda")
    tot = int(lengths.sum())
    mask = (torch.arange(MAX_LEN, device="cuda")[None, :]
            < lengths[:, None])[:, None, None, :]
    W, NB = MAX_LEN // BLOCK, SLOTS * MAX_LEN // BLOCK
    perm = torch.randperm(NB, generator=gen, device="cuda").int()
    table = torch.full((B, W), NB, dtype=torch.int32, device="cuda")
    used = 0
    for b, n in enumerate(lengths.tolist()):
        nb = -(-n // BLOCK)
        table[b, :nb] = perm[used:used + nb]
        used += nb
    arena = lambda t: t.reshape((NB, BLOCK) + t.shape[2:])
    view = lambda a: paged_view(a, table)
    kvq = KVQuantConfig(kv_bits=4)
    RG = kvq.idx_width(hd)
    for H, Hk in GROUPS:
        case = {"B": B, "H": H, "Hk": Hk, "group": H // Hk, "hd": hd,
                "S": MAX_LEN, "lengths": lengths.tolist(), "dtype": "bfloat16"}
        q = torch.randn((B, H, hd), generator=gen, device="cuda").bfloat16()
        k = torch.randn((B, MAX_LEN, Hk, hd), generator=gen, device="cuda").bfloat16()
        v = torch.randn((B, MAX_LEN, Hk, hd), generator=gen, device="cuda").bfloat16()
        q4, kt, vt = q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2)
        fp_bytes = 2 * q.numel() * 2 + tot * 2 * Hk * hd * 2 + B * 4
        fp_ops = tot * H * hd * 4
        tol = lambda want: 2.0 ** -7 * max(1.0, want.float().abs().max().item())
        run = lambda: flash_decode(q, k, v, lengths)
        got, want = run(), flash_decode_ref(q, k, v, lengths)
        record("flash_decode", case, got, want, tol(want), run,
               lambda: flash_decode_ref(q, k, v, lengths),
               lambda: F.scaled_dot_product_attention(q4, kt, vt, attn_mask=mask,
                                                      enable_gqa=True),
               fp_bytes, fp_ops)
        ka, va = arena(k), arena(v)
        run = lambda: flash_decode_paged(q, ka, va, table, lengths)
        got, want = run(), flash_decode_paged_ref(q, ka, va, table, lengths)
        assert torch.equal(got, flash_decode(q, view(ka), view(va), lengths)), \
            f"flash_decode_paged != contiguous at {H}/{Hk}"
        kv_, vv_ = view(ka), view(va)
        record("flash_decode_paged", {**case, "blocks": NB, "block": BLOCK}, got,
               want, tol(want), run,
               lambda: flash_decode_paged_ref(q, ka, va, table, lengths), None,
               fp_bytes + table.numel() * 4, fp_ops,
               extra={"contiguous_ms": lambda: flash_decode(q, kv_, vv_, lengths),
                      "gather_kernel_ms": lambda: flash_decode(
                          q, view(ka), view(va), lengths)})
        del kv_, vv_
        cb = kv_grid_codebooks(Hk, hd, kvq, device="cuda")
        (k_idx, k_s), (v_idx, v_s) = kv_encode(k, cb), kv_encode(v, cb)
        k_s, v_s = k_s.bfloat16(), v_s.bfloat16()
        ops = (q, k_idx, v_idx, k_s, v_s, lengths, cb, cb)
        kd = kv_decode(k_idx, k_s, cb).bfloat16().transpose(1, 2)
        vd = kv_decode(v_idx, v_s, cb).bfloat16().transpose(1, 2)
        # the table (RG x 256 entries per query head), per position the
        # query heads' score gathers and weighted sums and the kv heads'
        # V rebuild; bytes: q, the Hk heads' index rows and scales, both
        # codebooks, the lengths, o
        kvq_bytes = q.numel() * 4 + tot * Hk * (2 * RG + 2 * 2) \
            + 2 * cb.numel() * 4 + B * 4
        kvq_ops = B * H * RG * 256 * 2 * kvq.vec_d \
            + tot * (H * (RG + 2 * hd) + Hk * hd * kvq.residual)
        run = lambda: flash_decode_kvq(*ops)
        got, want = run(), flash_decode_kvq_ref(*ops)
        record("flash_decode_kvq", {**case, "kv_bits": 4}, got, want, tol(want),
               run, lambda: flash_decode_kvq_ref(*ops),
               lambda: F.scaled_dot_product_attention(q4, kd, vd, attn_mask=mask,
                                                      enable_gqa=True),
               kvq_bytes, kvq_ops)
        pops = (q, *(arena(t) for t in (k_idx, v_idx, k_s, v_s)), table,
                lengths, cb, cb)
        pview = (q, *(view(t) for t in pops[1:5]), lengths, cb, cb)
        run = lambda: flash_decode_kvq_paged(*pops)
        got, want = run(), flash_decode_kvq_paged_ref(*pops)
        assert torch.equal(got, flash_decode_kvq(*pview)), \
            f"flash_decode_kvq_paged != contiguous at {H}/{Hk}"
        record("flash_decode_kvq_paged",
               {**case, "kv_bits": 4, "blocks": NB, "block": BLOCK}, got, want,
               tol(want), run, lambda: flash_decode_kvq_paged_ref(*pops), None,
               kvq_bytes + table.numel() * 4, kvq_ops,
               extra={"contiguous_ms": lambda: flash_decode_kvq(*pview),
                      "gather_kernel_ms": lambda: flash_decode_kvq(
                          q, *(view(t) for t in pops[1:5]), lengths, cb, cb)})
        del k, v, kd, vd, pops, pview


def check_other_linears(torch, gen, record):
    """B1 at M = SLOTS (decode) and B3 at M = MAX_LEN with bf16 x
    (prefill) at the four linears of each of OTHER_ARCHS, against their
    plain versions, with the llama2 rows' yardsticks and bounds."""
    from repro_torch.configs import get_config
    from repro_torch.core.vq import dequantize, synthetic_vq
    from repro_torch.kernels.dequant_gemv import dequant_gemv

    C = 2
    for arch in OTHER_ARCHS:
        for name, K, N in arch_linears(get_config(arch)):
            vq = synthetic_vq(gen, K, N, C=C, device="cuda")
            w = dequantize(vq)
            wb = w.to(torch.bfloat16)
            V = K // 8
            w_bytes = C * V * N + C * 8 * 256 * 4 + N * 4
            # the launch shape the tile model picks (fitted at llama2's
            # linears only)
            x = torch.randn((SLOTS, K), generator=gen, device="cuda")
            check_b1(torch, record, vq, x, {"model": arch, "linear": name},
                     launch_shape=True)
            M = MAX_LEN
            xb = torch.randn((M, K), generator=gen, device="cuda").bfloat16()
            x32 = xb.float()
            run = lambda: dequant_gemv(xb, vq, out_dtype=torch.float32)
            plain = lambda: dequant_gemv(xb, vq, out_dtype=torch.float32,
                                         use_kernel=False)
            got, want = run(), plain()
            record("dequant_gemv", {"model": arch, "M": M, "linear": name,
                                    "K": K, "N": N, "x": "bfloat16"},
                   got, want, 1e-4 * max(1.0, want.abs().max().item()), run,
                   plain, lambda: torch.matmul(x32, w),
                   M * K * 2 + w_bytes + M * N * 4, 2 * 2 * M * K * N,
                   peak=BF16_FLOPS,
                   extra={"library_bf16_ms": lambda: torch.matmul(xb, wb)})
            del vq, w, wb, got, want


def breakdown(torch, timer):
    """Where the EVA kernels' time goes: B1 (fused_vq_matmul), B4
    (vq_gemm, bf16 x as served) and B5 (oc_lookup, fed vq_gemm's output
    codebook) against their timing-only variants (kernels/build.py
    VARIANTS: B1 and B5 without the lookup, the index loads, the output
    codebook or the split reduce; B4 without O's writes, without its
    loads, and empty) at the four decode linears x M in {1, SLOTS} and at
    the ragged case, with the same timer as the check phase. Rows, then
    one total per kernel and M."""
    from repro_torch.core.vq import synthetic_vq
    from repro_torch.kernels import build
    from repro_torch.kernels.fused_vq_matmul import fused_vq_matmul
    from repro_torch.kernels.fused_vq_matmul.ops import run_variant as fused_variant
    from repro_torch.kernels.oc_lookup import oc_lookup
    from repro_torch.kernels.oc_lookup.ops import run_variant as lookup_variant
    from repro_torch.kernels.vq_gemm import vq_gemm
    from repro_torch.kernels.vq_gemm.ops import run_variant as vq_variant

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    totals = {}
    cases = [(M, name, K, N) for M in (1, SLOTS) for name, K, N in LINEARS]
    for M, name, K, N in cases + [(3, "ragged", 296, 1030)]:
        vq = synthetic_vq(gen, K, N, C=2, device="cuda")
        x = torch.randn((M, K), generator=gen, device="cuda")
        xb, cb = x.to(torch.bfloat16), vq.codebooks
        O = vq_gemm(x, cb)
        calls = {
            "vq_gemm": (lambda: vq_gemm(xb, cb),
                        lambda v: (lambda: vq_variant(xb, cb, v))),
            "fused_vq_matmul": (
                lambda: fused_vq_matmul(x, vq, out_dtype=torch.float32),
                lambda v: (lambda: fused_variant(x, vq, v))),
            "oc_lookup": (lambda: oc_lookup(O, vq.idx, vq.scale),
                          lambda v: (lambda: lookup_variant(O, vq.idx,
                                                            vq.scale, v)))}
        for kernel, (full, variant) in calls.items():
            # twice back to back: a cost paid once per launch sequence
            # (shared-memory carveout, attribute calls) shows as a gap
            # between "twice" and 2 x "kernel"
            ms = {"kernel": timer(full), "twice": timer(lambda: (full(), full()))}
            for v in build.VARIANTS[kernel]:
                ms[v] = timer(variant(v))
            row = {"phase": "breakdown", "kernel": kernel, "linear": name,
                   "M": M, "K": K, "N": N, "ms": ms}
            if "trace" in build.VARIANTS[kernel]:
                row["trace_us"] = trace_stats(torch, timer, variant("trace"))
            emit(row)
            if name != "ragged":
                tot = totals.setdefault((kernel, M), {})
                for k, t in ms.items():
                    tot[k] = tot.get(k, 0.0) + t
        del vq, O
    for (kernel, M), ms in totals.items():
        emit({"phase": "breakdown_layer", "kernel": kernel, "M": M,
              "ms_per_decode_layer": ms})


def trace_stats(torch, timer, run) -> dict:
    """One run of a lookup kernel's trace variant, started as the timer
    starts a run (L2 flushed, stream held busy): from each CTA's
    %globaltimer stamps (entry, slab 0 landed, slab loop done, first
    cluster barrier, exit) the span of the launch, the spread of CTA
    starts and the median CTA's phases, in microseconds."""
    timer.flush.bitwise_not_()
    torch.cuda._sleep(Timer.SLEEP_CYCLES)
    _, stamps = run()
    torch.cuda.synchronize()
    t = stamps.cpu().double() / 1e3
    med = lambda a, b: float((t[:, b] - t[:, a]).median())
    return {"ctas": int(t.shape[0]), "span": float(t[:, 4].max() - t[:, 0].min()),
            "start_spread": float(t[:, 0].max() - t[:, 0].min()),
            "first_slab": med(0, 1), "slab_loop": med(1, 2),
            "to_cluster_barrier": med(2, 3), "cluster_reduce": med(3, 4)}


def serve(torch, timer):
    """Phases 4-6: full-width llama2-7b through the Engine, first with the
    fp KV cache, then with the 4-bit KV-VQ cache and INT8 prefill; the
    calibration of the decode backends; last, the fp cache again through
    the two-kernel split. Returns each serve phase's kernel launches."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.plan import PlanPolicy
    from repro_torch.models import RunConfig, build_model
    from repro_torch.serve import EngineConfig

    cfg = get_config("llama2_7b")
    model = build_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    t0 = time.perf_counter()
    params = model.quantize(model.init(gen, device="cuda", block_device="meta"),
                            method="synthetic", generator=gen, device="cuda")
    torch.cuda.synchronize()
    emit({"phase": "weights", "layers": cfg.num_layers, "d_model": cfg.d_model,
          "d_ff": cfg.d_ff, "vocab": cfg.vocab_size, "bits_per_weight": 2,
          "seconds": time.perf_counter() - t0,
          "device_bytes": torch.cuda.memory_allocated()})
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(32, 201, N_REQUESTS)]

    fp = serve_phase(
        torch, model, params, prompts, "serve",
        RunConfig(plan_policy=PlanPolicy(vq_mode="none", impl="cuda")),
        EngineConfig(num_slots=SLOTS, max_len=MAX_LEN),
        ("fused_vq_matmul", "flash_decode", "dequant_gemv"))
    dryrun_serve(torch, fp["decode_busy_ms"])
    kvq = serve_phase(
        torch, model, params, prompts, "serve_kvq",
        RunConfig(plan_policy=PlanPolicy(vq_mode="none", impl="cuda",
                                         int8_prefill=True)),
        EngineConfig(num_slots=SLOTS, max_len=MAX_LEN, kv_bits=4),
        ("fused_vq_matmul", "flash_decode_kvq", "dequant_gemv", "int8_gemm"))
    same = [sum(a == b for a, b in zip(fp["tokens"][i], kvq["tokens"][i]))
            for i in range(N_REQUESTS)]
    first = [next((j for j, (a, b) in enumerate(zip(fp["tokens"][i],
                                                     kvq["tokens"][i]))
                   if a != b), MAX_NEW) for i in range(N_REQUESTS)]
    emit({"phase": "kv_bits_4_vs_16", "greedy_token_agreement":
          sum(same) / (N_REQUESTS * MAX_NEW), "first_divergence": first,
          "kv_bytes_in_use": {"16": fp["kv_bytes"], "4": kvq["kv_bytes"]},
          "kv_bytes_ratio": fp["kv_bytes"] / kvq["kv_bytes"]})
    paged = serve_paged(torch, model, params, prompts, fp, kvq)
    calibration(torch, timer, cfg, params)
    split = serve_split(torch, model, params, prompts)
    emit({"phase": "split_vs_fused",
          "greedy_token_agreement": agreement(fp, split)})
    spec = serve_spec(torch, model, params, prompts, fp)
    vql = serve_vql(torch, timer, model, params, prompts)
    resilience = serve_resilience(torch, model, params, prompts, fp, spec)
    return {"serve": fp["launches"], "serve_kvq": kvq["launches"],
            "serve_split": split["launches"],
            **{k: v["launches"] for k, v in paged.items()},
            "serve_spec": spec["launches"], "serve_vql": vql["launches"],
            "serve_resilience": resilience}


def serve_spec(torch, model, params, prompts, fp):
    """`serve_spec`: `serve`'s configuration and traffic with speculate_k
    = SPEC_K. The decode graph is built once, at K + 1 tokens a slot;
    each replay runs every VQ linear through the EVA backend the planner
    ranks first at M = slots x (K + 1) (printed) and flash_decode never
    (the window attends through plain torch, as the reference's does);
    drafted = accepted + rejected; every request gets its tokens. The
    serve phase's checks run on it with the speculative step (graph_step
    replays the verify window against ``verify_logits`` run eagerly,
    with the eager part applied to both; row 0 of a window held within
    PLAIN_REL of `serve`'s step on the same cache). Then the plain
    window attention's device time, and the phase beside `serve`."""
    from repro_torch.core import plan as plan_mod
    from repro_torch.core.plan import PlanPolicy
    from repro_torch.models import RunConfig
    from repro_torch.models.common import decode_attention
    from repro_torch.serve import EngineConfig

    t0 = time.perf_counter()
    cfg = model.cfg
    rc = RunConfig(plan_policy=PlanPolicy(vq_mode="none", impl="cuda"))
    M = SLOTS * (SPEC_K + 1)
    ranked = sorted({pl.backend for _, pl in plan_mod.preplan_params(
        params, rc.policy, mode="decode", m=M, act_dtype=cfg.act_dtype)
        if pl.spec.kind == "vq"})
    eva = {"eva_fused": ("fused_vq_matmul",),
           "eva_split": ("vq_gemm", "oc_lookup")}
    eva_kernels = tuple(k for b in ranked for k in eva[b])
    emit({"phase": "serve_spec_plan", "M": M, "vq_backends": ranked})
    out = serve_phase(torch, model, params, prompts, "serve_spec", rc,
                      EngineConfig(num_slots=SLOTS, max_len=MAX_LEN,
                                   speculate_k=SPEC_K),
                      eva_kernels + ("dequant_gemv",), absent=("flash_decode",))
    m, per_replay = out["metrics"], out["decode_launches"]
    linears = 4 * cfg.num_layers
    row = {"phase": "serve_spec_checks", "speculate_k": SPEC_K,
           "decode_launches_per_replay": per_replay,
           "vq_linears_per_step": linears, "trace_counts": out["trace_counts"],
           **{k: m[k] for k in ("drafted_tokens", "accepted_draft_tokens",
                                "rejected_draft_tokens", "extra_decode_tokens",
                                "tokens_generated")}}
    emit(row)
    assert out["trace_counts"]["decode"] == 1, row
    assert "flash_decode" not in per_replay, row
    assert all(per_replay.get(k) == linears for k in eva_kernels), row
    assert m["drafted_tokens"] == (m["accepted_draft_tokens"]
                                   + m["rejected_draft_tokens"]) > 0, row
    assert m["tokens_generated"] == N_REQUESTS * MAX_NEW, row

    # the window's attention runs through plain torch: its device time at
    # the served shapes (4 slots x K + 1 queries over the 512-position
    # cache, 32 heads), a layer and a step
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    H, Hk, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = torch.randn((SLOTS, SPEC_K + 1, H, hd), generator=gen,
                    device="cuda").bfloat16()
    kv = torch.randn((2, SLOTS, MAX_LEN, Hk, hd), generator=gen,
                     device="cuda").bfloat16()
    lens = torch.tensor([1, MAX_LEN, 200, 64], dtype=torch.int32,
                        device="cuda") + SPEC_K + 1
    attn = device_profile(torch, lambda: decode_attention(
        q, kv[0], kv[1], lens.clamp(max=MAX_LEN)))
    emit({"phase": "serve_spec_window_attention", "queries": SPEC_K + 1,
          "device_ms_per_layer": attn["device_busy_ms_per_step"],
          "device_ms_per_step": attn["device_busy_ms_per_step"] * cfg.num_layers,
          "kernels_per_layer": attn["device_kernels_per_step"]})
    del q, kv

    fm = fp["metrics"]
    emit({"phase": "spec_vs_serve", "speculate_k": SPEC_K,
          "greedy_token_agreement": agreement(fp, out),
          "decode_ms_per_step": {
              "serve": fm["decode_s"] * 1e3 / fm["decode_steps"],
              "serve_spec": m["decode_s"] * 1e3 / m["decode_steps"]},
          "decode_steps": {"serve": fm["decode_steps"],
                           "serve_spec": m["decode_steps"]},
          "decode_tokens_per_step": {
              "serve": fm["decode_tokens_per_step"],
              "serve_spec": m["decode_tokens_per_step"]},
          "draft_acceptance_rate": m["draft_acceptance_rate"],
          "tok_per_s": {"serve": fm["tokens_generated"] / fp["wall_s"],
                        "serve_spec": m["tokens_generated"] / out["wall_s"]}})
    phase_seconds("serve_spec (+ checks)", t0)
    return out


def serve_vql(torch, timer, model, params, prompts):
    """`serve_vql`: `serve`'s traffic with a synthetic VQ-Logits head
    (VQL_KC bf16 codewords for the 32000-row vocab, drawn from SEED + 7)
    in place of the dense head, through the serve phase's checks; then
    the same model with the head's expansion ``{"w": expand(head)}``
    (bf16, dense): greedy tokens (agreement printed), prefill logits of
    the same prompts within VQL_REL of the largest, and the head's
    device time (profiled alone at M = slots,
    as decode runs it) beside the dense bf16 head's, with their
    bytes; then the dense head alone with ``timer`` (CUDA events, L2
    flushed): its fp32 accumulator, beside its product rounded to bf16
    before the cast (the form it took before), with the largest
    difference the rounding makes, relative to the largest logit."""
    import numpy as np
    from repro_torch.core import plan as plan_mod
    from repro_torch.core.logits_vq import expand, synthetic_logits_vq
    from repro_torch.core.plan import PlanPolicy
    from repro_torch.models import RunConfig
    from repro_torch.models.common import linear
    from repro_torch.serve import Engine, EngineConfig

    t0 = time.perf_counter()
    cfg = model.cfg
    rc = RunConfig(plan_policy=PlanPolicy(vq_mode="none", impl="cuda"))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    head = synthetic_logits_vq(gen, cfg.d_model, cfg.padded_vocab, VQL_KC,
                               dtype=torch.bfloat16, device="cuda")
    p_vql = {**params, "lm_head": {"vql": head}}
    ecfg = EngineConfig(num_slots=SLOTS, max_len=MAX_LEN)
    plans = {pl.backend: pl.describe_ranking()
             for path, pl in plan_mod.preplan_params(
                 p_vql, rc.policy, mode="decode", m=SLOTS,
                 act_dtype=cfg.act_dtype) if path == ("lm_head",)}
    vql = serve_phase(torch, model, p_vql, prompts, "serve_vql", rc, ecfg,
                      ("fused_vq_matmul", "flash_decode", "dequant_gemv"),
                      eager_profiles=False)
    w = expand(head)
    p_dense = {**params, "lm_head": {"w": w}}
    eng = Engine(model, p_dense, rc, ecfg, device="cuda")
    dense = {"tokens": list(eng.generate(prompts, MAX_NEW).values())}
    del eng
    toks = torch.tensor(np.stack([p[:64] for p in prompts[:SLOTS]]),
                        dtype=torch.int32, device="cuda")
    with torch.no_grad():
        lv, _ = model.prefill(p_vql, {"tokens": toks}, rc)
        ld, _ = model.prefill(p_dense, {"tokens": toks}, rc)
    lv, ld = lv[..., :cfg.vocab_size], ld[..., :cfg.vocab_size]
    drift = (lv - ld).abs().max().item()
    rel = drift / ld.abs().max().item()
    agree = (lv.argmax(-1) == ld.argmax(-1)).float().mean().item()
    finite = bool(torch.isfinite(lv).all())
    del lv, ld
    x = torch.randn((SLOTS, cfg.d_model), generator=gen,
                    device="cuda").bfloat16()
    rc_dec = rc.replace(mode="decode")
    head_prof = device_profile(torch, lambda: linear(
        {"vql": head}, x, rc_dec, out_dtype=torch.float32))
    dense_prof = device_profile(torch, lambda: linear(
        {"w": w}, x, rc_dec, out_dtype=torch.float32))
    # the dense head's fp32 accumulator against its product rounded to
    # bf16 before the cast to fp32, as fp_matmul gave it before
    dense_ms = timer(lambda: linear({"w": w}, x, rc_dec,
                                    out_dtype=torch.float32))
    rounded_ms = timer(lambda: torch.matmul(x, w).float())
    with torch.no_grad():
        y = linear({"w": w}, x, rc_dec, out_dtype=torch.float32)
        rounding = ((torch.matmul(x, w).float() - y).abs().max()
                    / y.abs().max()).item()
    del y
    nbytes = lambda *ts: sum(t.numel() * t.element_size() for t in ts)
    row = {"phase": "serve_vql_vs_dense_head", "kc": VQL_KC,
           "vocab": cfg.padded_vocab, "head_plan": plans,
           "greedy_token_agreement": agreement(vql, dense),
           "prefill_max_abs_logit_drift": drift, "rel_drift": rel,
           "rel_bound": VQL_REL, "prefill_argmax_agreement": agree,
           "finite": finite,
           "head_device_ms": head_prof["device_busy_ms_per_step"],
           "head_kernels": head_prof["device_kernels_per_step"],
           "dense_head_device_ms": dense_prof["device_busy_ms_per_step"],
           "dense_head_kernels": dense_prof["device_kernels_per_step"],
           "dense_head_ms": dense_ms,
           "dense_head_bf16_product_ms": rounded_ms,
           "dense_head_bf16_product_rel_diff": rounding,
           "head_bytes": nbytes(head.codebook, head.assign, head.scale),
           "dense_head_bytes": nbytes(w)}
    emit(row)
    assert list(plans) == ["vql_gather_torch"], row
    assert finite and rel <= VQL_REL, row
    del w, p_dense, x
    phase_seconds("serve_vql (+ dense head)", t0)
    return vql


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


class Routing:
    """Records the top-k expert ids of every MoE routing call made inside
    the block (``models.common.moe_route``, wrapped, put back at exit),
    so two runs can count the (token, layer) choices they agree on."""

    def __enter__(self):
        from repro_torch.models import common as cm

        self.calls, self._cm, real = [], cm, cm.moe_route

        def route(logits, cfg):
            out = real(logits, cfg)
            self.calls.append(out[0].sort(dim=-1).values.clone())
            return out

        self._real, cm.moe_route = real, route
        return self

    def __exit__(self, *exc):
        self._cm.moe_route = self._real

    def agreement(self, other: "Routing"):
        """Share of (token, layer) top-k sets equal in both runs."""
        same = sum(int((a == b).all(-1).sum())
                   for a, b in zip(self.calls, other.calls))
        total = sum(a.shape[0] for a in self.calls)
        assert len(self.calls) == len(other.calls)
        return same / total if total else None


class Uncounted:
    """Kernel launches inside the block are taken back out of the counts
    (the checks beside a served path, not the path)."""

    def __enter__(self):
        from repro_torch import kernels

        self.counts = kernels.launch_counts()

    def __exit__(self, *exc):
        from repro_torch import kernels

        kernels.set_launch_counts(self.counts)


def kept_caches(torch, eng, fn):
    """Run ``fn`` (which may write the engine's caches: graph replays)
    with every cache leaf and ``succ`` put back afterwards."""
    from repro_torch.serve.graphs import tensor_leaves

    leaves = list(tensor_leaves(eng.caches))
    if eng.succ is not None:
        leaves.append(eng.succ)
    saved = [t.clone() for t in leaves]
    try:
        return fn()
    finally:
        for t, s in zip(leaves, saved):
            t.copy_(s)
        del saved
        torch.cuda.synchronize()


def serve_resilience(torch, model, params, prompts, fp, spec):
    """`serve_resilience`: the resilience layer on `serve`'s weights and
    traffic (4 slots, max_len 512, 8 greedy requests of 32-200 prompt
    tokens, MAX_NEW new tokens each), every kernel count set to 0 at its
    start and read at its end (the checks beside the path uncounted):
      (a) serve_with_restarts, a snapshot every tick, one scripted fault
          at each raise boundary (a prefill fault on one uid, a decode
          and a sample fault): 3 restarts, every failure an
          InjectedFault, each fresh engine's decode graph built once, the
          peak device memory within `serve`'s plus one snapshot, and the
          tokens `serve`'s exactly; then the snapshot's bytes and its
          device-to-host ms, an engine's rebuild seconds and the
          restore's host-to-device ms;
      (b) a nan poison on one uid: it finishes "error", the others'
          tokens are `serve`'s; then breaker_k poisoned ticks in a row
          trip the breaker: the queue is rejected and submit refuses;
      (c) a backend fault mid-decode quarantines eva_fused (the decode
          graph rebuilt over the live caches: vq_gemm and oc_lookup
          launch, fused_vq_matmul does not), a second quarantines
          eva_split (decode through dequant_gemv at M = 4); at each
          switch the decode step before and after it, eager on the same
          cache, within PLAIN_REL, the tokens before the first switch
          `serve`'s, the new backend's kernels among the replay's device
          events, decode ms a step per backend; the quarantine is reset
          after;
      (d) `serve_paged_tight` snapshotted after its preemption while a
          chunk is in flight, restored into a fresh engine: the tokens of
          the uninterrupted run exactly;
      (e) `serve_spec` snapshotted mid-run and restored: the same.
    Returns the phase's kernel launches."""
    import gc

    import numpy as np
    from repro_torch import kernels
    from repro_torch.core import plan as plan_mod
    from repro_torch.core.plan import PlanPolicy
    from repro_torch.models import RunConfig
    from repro_torch.serve import (Engine, EngineConfig, FaultPlan, FaultSpec,
                                   GenerationRequest, serve_with_restarts)
    from repro_torch.serve.graphs import tensor_leaves

    t_phase = time.perf_counter()
    card = card_line()
    rc = RunConfig(plan_policy=PlanPolicy(vq_mode="none", impl="cuda"))
    ecfg = lambda **kw: EngineConfig(num_slots=SLOTS, max_len=MAX_LEN, **kw)
    mk = lambda **kw: Engine(model, params, rc, ecfg(**kw), device="cuda")
    reqs = lambda: [GenerationRequest(prompt=p, max_new_tokens=MAX_NEW)
                    for p in prompts]
    want = {i + 1: tuple(t) for i, t in enumerate(fp["tokens"])}

    def drain(eng):
        while not eng.idle:
            eng.step()
        torch.cuda.synchronize()

    kernels.reset_launch_counts()

    # (a) restarts at each raise boundary
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    plan = FaultPlan.scripted(FaultSpec("prefill", tick=0, uid=6),
                              FaultSpec("decode", tick=10),
                              FaultSpec("sample", tick=20))
    builds = []

    def factory():
        eng = mk(fault_plan=plan)
        builds.append(eng.trace_counts)
        return eng

    t0 = time.perf_counter()
    eng, outs, stats = serve_with_restarts(factory, reqs(), snapshot_every=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    snap = eng.snapshot()
    row = {"phase": "serve_resilience_restarts", "card": card,
           "restarts": stats.restarts, "snapshots": stats.snapshots,
           "failures": stats.failures,
           "decode_builds": [b["decode"] for b in builds],
           "tokens_equal_serve": all(outs[u].tokens == want[u] for u in want),
           "finish": sorted({o.finish_reason for o in outs.values()}),
           "wall_s": wall, "peak_device_bytes_over_params": peak,
           "serve_peak_device_bytes_over_params": fp["peak_over_base"],
           "snapshot_bytes": snap.nbytes}
    emit(row)
    assert stats.restarts == 3 and plan.exhausted, row
    assert all(f.startswith("InjectedFault:") for f in stats.failures), row
    assert row["decode_builds"] == [1] * 4 and row["tokens_equal_serve"], row
    assert peak <= row["serve_peak_device_bytes_over_params"] + snap.nbytes, row
    del eng, outs, snap
    gc.collect()

    # the snapshot's and the restore's cost on a mid-run engine
    eng = mk()
    for r in reqs():
        eng.submit(r)
    for _ in range(6):
        eng.step()
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        snap = eng.snapshot()
        times.append(time.perf_counter() - t0)
    del eng
    gc.collect()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = mk()
    torch.cuda.synchronize()
    rebuild_s = time.perf_counter() - t0
    ptrs = [t.data_ptr() for t in tensor_leaves(eng.caches)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.restore(snap)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    row = {"phase": "serve_resilience_snapshot_cost", "card": card,
           "snapshot_bytes": snap.nbytes,
           "snapshot_ms": statistics.median(times) * 1e3,
           "snapshot_ms_runs": [t * 1e3 for t in times],
           "restore_ms": restore_s * 1e3, "engine_rebuild_s": rebuild_s,
           "decode_ms_per_step_serve":
               fp["metrics"]["decode_s"] * 1e3 / fp["metrics"]["decode_steps"],
           "restore_in_place": [t.data_ptr() for t in
                                tensor_leaves(eng.caches)] == ptrs}
    emit(row)
    assert row["restore_in_place"], row
    drain(eng)
    assert all(eng.output(u).tokens == want[u] for u in want), "restored"
    del eng, snap
    gc.collect()

    # (b) poison, then the breaker
    eng = mk(fault_plan=FaultPlan.scripted(FaultSpec("poison", tick=5, uid=3)))
    uids = [eng.submit(r) for r in reqs()]
    drain(eng)
    reasons = {u: eng.output(u).finish_reason for u in uids}
    row = {"phase": "serve_resilience_poison", "card": card,
           "finish": reasons,
           "poisoned_slot_steps": eng.metrics()["poisoned_slot_steps"],
           "others_equal_serve": all(eng.output(u).tokens == want[u]
                                     for u in uids if u != 3)}
    del eng
    eng = mk(breaker_k=3, fault_plan=FaultPlan.scripted(
        *(FaultSpec("poison", tick=2 + i, uid=1 + i) for i in range(3))))
    uids = [eng.submit(r) for r in reqs()]
    drain(eng)
    refused = eng.submit(reqs()[0])
    row.update({"breaker_finish": {u: eng.output(u).finish_reason
                                   for u in uids},
                "healthy": eng.healthy,
                "submit_after_trip": eng.output(refused).finish_reason,
                "uid4_equal_serve": eng.output(4).tokens == want[4]})
    emit(row)
    assert reasons[3] == "error" and row["others_equal_serve"], row
    # uids 1-3 poisoned on ticks 2, 3 and 4; 5 and 6 took the freed slots
    # before the trip, 7 and 8 were queued at it
    assert [row["breaker_finish"][u] for u in uids] == (
        ["error"] * 3 + ["length"] * 3 + ["rejected"] * 2), row
    assert not row["healthy"] and row["submit_after_trip"] == "rejected", row
    assert row["uid4_equal_serve"], row
    del eng
    gc.collect()

    # (c) backend faults: eva_fused, then eva_split, quarantined
    t1, t2 = 8, 16
    eng = mk(fault_plan=FaultPlan.scripted(
        FaultSpec("backend", tick=t1, backend="eva_fused"),
        FaultSpec("backend", tick=t2, backend="eva_split")))
    uids = [eng.submit(r) for r in reqs()]
    segments, switch = [], []

    def run_to(tick):
        m0 = eng.metrics()
        c0 = kernels.launch_counts()
        while eng._tick < tick and not eng.idle:
            eng.step()
        torch.cuda.synchronize()
        m1, c1 = eng.metrics(), kernels.launch_counts()
        steps = m1["decode_steps"] - m0["decode_steps"]
        return {"decode_steps": steps,
                "decode_ms_per_step": (m1["decode_s"] - m0["decode_s"])
                * 1e3 / max(1, steps),
                "launches": {k: c1[k] - c0[k] for k in c1 if c1[k] != c0[k]}}

    def eager_decode(caches, tok, pos):
        """A decode step on ``caches`` through the kernels the planner
        ranks now, eager and uncounted."""
        with torch.no_grad(), Uncounted():
            out, _ = model.decode(eng.params, torch.as_tensor(tok, device="cuda"),
                                  torch.as_tensor(pos, device="cuda"), caches,
                                  eng.rc)
        return out

    segments.append(("eva_fused", run_to(t1)))
    pre = {tr.uid: list(tr.generated) for tr in eng.sched.slots if tr}
    for tick, backend, expect in ((t1, "eva_split", ("vq_gemm", "oc_lookup")),
                                  (t2, "dequant", ("dequant_gemv",))):
        if tick == t2:
            segments.append(("eva_split", run_to(t2)))
        # the step the engine takes next, eager on clones of its caches,
        # through the backend serving now and, after the tick's fault, the
        # next one
        act = eng.active.copy()
        tok = np.where(act, eng.last_token, 0)[:, None]
        pos = np.where(act, eng.positions, 0)[:, None]
        clone = lambda: {"body": {n: t.clone()
                                  for n, t in eng.caches["body"].items()}}
        before = eager_decode(clone(), tok, pos)
        kept = clone()
        eng.step()                   # the fault fires first: rebuild, step
        torch.cuda.synchronize()
        after = eager_decode(kept, tok, pos)
        del kept
        drift, rel, agree, finite = logit_drift(torch, after, before,
                                                model.cfg.vocab_size)
        stats = plan_mod.default_planner().backend_stats()
        backends = sorted({pl.backend for _, pl in eng.plans["decode"]
                           if pl.spec.kind == "vq"})
        with Uncounted():
            prof = kept_caches(torch, eng, lambda: device_profile(
                torch, lambda: eng.decode_graph(tokens=tok, positions=pos)))
        row = {"phase": "serve_resilience_backend_switch", "card": card,
               "tick": tick, "decode_vq_backends": backends,
               "backend_fallbacks": eng.metrics()["backend_fallbacks"],
               "quarantined": stats["quarantined"],
               "failures": stats["failures"],
               "trace_counts": dict(eng.trace_counts),
               "switch_step_rel_drift": rel, "max_abs_logit_drift": drift,
               "argmax_agreement": agree, "finite": finite,
               "rel_bound": PLAIN_REL, "replay": prof}
        emit(row)
        assert backends == [backend], row
        assert finite and rel <= PLAIN_REL, row
        assert all(k in prof["device_ms_by_kernel"] for k in expect), row
        switch.append(row)
    segments.append(("dequant", run_to(10 ** 9)))
    m = eng.metrics()
    fused_seg, split_seg, deq_seg = (s for _, s in segments)
    agreement_after = sum(a == b for u in uids for a, b in zip(
        eng.output(u).tokens, want[u])) / (N_REQUESTS * MAX_NEW)
    row = {"phase": "serve_resilience_backends", "card": card,
           "segments": {n: s for n, s in segments},
           "backend_fallbacks": m["backend_fallbacks"],
           "trace_counts": dict(eng.trace_counts),
           "tokens_before_first_switch_equal_serve": all(
               list(want[u][:len(g)]) == g for u, g in pre.items()),
           "greedy_token_agreement_with_serve": agreement_after,
           "finish": sorted({eng.output(u).finish_reason for u in uids})}
    emit(row)
    assert m["backend_fallbacks"] == 2, row
    assert switch[0]["trace_counts"]["decode"] == 2, row
    assert eng.trace_counts["decode"] == 3, row
    assert row["tokens_before_first_switch_equal_serve"], row
    assert fused_seg["launches"].get("fused_vq_matmul", 0) > 0, row
    for seg in (split_seg, deq_seg):
        assert seg["launches"].get("fused_vq_matmul", 0) == 0, row
    assert all(split_seg["launches"].get(k, 0) > 0
               for k in ("vq_gemm", "oc_lookup")), row
    assert all(deq_seg["launches"].get(k, 0) == 0
               for k in ("vq_gemm", "oc_lookup")), row
    assert deq_seg["launches"].get("dequant_gemv", 0) > 0, row
    assert all(eng.output(u).num_tokens == MAX_NEW for u in uids), row
    del eng
    plan_mod.reset_quarantine()
    stats = plan_mod.default_planner().backend_stats()
    emit({"phase": "serve_resilience_quarantine_reset", "stats": stats})
    assert stats["quarantined"] == () and stats["failures"] == {}, stats
    gc.collect()

    # (d) the tight paged engine, snapshotted after a preemption while a
    # chunk is in flight
    tight = dict(paged=True, block_size=BLOCK, num_blocks=TIGHT_BLOCKS,
                 prefill_chunk=PREFILL_CHUNK)
    eng = mk(**tight)
    uids = [eng.submit(r) for r in reqs()]
    snap, at = None, None
    while not eng.idle:
        eng.step()
        mid_chunk = any(tr is not None and not eng.active[b]
                        and tr.prefill_pos > 0
                        for b, tr in enumerate(eng.sched.slots))
        if (snap is None and mid_chunk
                and eng.metrics()["preemptions"] >= 1):
            snap, at = eng.snapshot(), eng._tick
    torch.cuda.synchronize()
    ref = {u: eng.output(u).tokens for u in uids}
    del eng
    gc.collect()
    assert snap is not None, "serve_resilience: no chunk after a preemption"
    eng = mk(**tight)
    eng.restore(snap)
    drain(eng)
    row = {"phase": "serve_resilience_paged", "card": card,
           "snapshot_tick": at, "snapshot_bytes": snap.nbytes,
           "preemptions_at_snapshot": snap.metrics["preemptions"],
           "tokens_equal_uninterrupted": all(
               eng.output(u).tokens == ref[u] for u in uids),
           "greedy_token_agreement_with_serve": sum(
               a == b for u in uids for a, b in zip(ref[u], want[u]))
           / (N_REQUESTS * MAX_NEW),
           "trace_counts": dict(eng.trace_counts)}
    emit(row)
    assert row["tokens_equal_uninterrupted"], row
    del eng, snap
    gc.collect()

    # (e) the speculative engine
    eng = mk(speculate_k=SPEC_K)
    uids = [eng.submit(r) for r in reqs()]
    for _ in range(5):
        eng.step()
    snap = eng.snapshot()
    drain(eng)
    ref = {u: eng.output(u).tokens for u in uids}
    del eng
    gc.collect()
    eng = mk(speculate_k=SPEC_K)
    eng.restore(snap)
    drain(eng)
    row = {"phase": "serve_resilience_spec", "card": card,
           "snapshot_bytes": snap.nbytes,
           "tokens_equal_uninterrupted": all(
               eng.output(u).tokens == ref[u] for u in uids),
           "tokens_equal_serve_spec": all(
               list(ref[u]) == spec["tokens"][u - 1] for u in uids),
           "trace_counts": dict(eng.trace_counts)}
    emit(row)
    assert row["tokens_equal_uninterrupted"], row
    del eng, snap
    gc.collect()
    launches = kernels.launch_counts()
    emit({"phase": "serve_resilience", "card": card, "launches": launches,
          "wall_s": time.perf_counter() - t_phase})
    missing = [k for k in ("fused_vq_matmul", "flash_decode", "flash_decode_paged",
                           "dequant_gemv", "vq_gemm", "oc_lookup")
               if launches[k] == 0]
    assert not missing, f"serve_resilience: never launched: {missing}"
    phase_seconds("serve_resilience", t_phase)
    return launches


def dryrun_serve(torch, busy: float) -> None:
    """Phase 6b: the dry run of ``serve``'s decode step (module
    docstring), held to ``busy``, the replay's busy ms a step that
    ``profile_decode`` measured in the ``serve`` phase."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.launch.dryrun import fake_mesh
    from repro_torch.models import build_model
    from repro_torch.roofline.analysis import analyze_counted

    t0 = time.perf_counter()
    model = build_model(get_config("llama2_7b"))
    meta = lambda shape: torch.empty(shape, dtype=torch.int32, device="meta")
    specs = {"tokens": meta((SLOTS, 1)), "positions": meta((SLOTS, 1)),
             "caches": model.cache_specs(SLOTS, MAX_LEN)}
    try:
        low = steps.lower_serve_decode_step(
            model, fake_mesh({"data": 1, "model": 1}), specs)
    finally:
        dist.destroy_process_group()
    rep = analyze_counted(low.costs, arch="llama2_7b",
                          shape=f"serve_{SLOTS}x{MAX_LEN}", mesh_name="one",
                          chips=1, step_kind="decode")
    seconds = time.perf_counter() - t0
    emit({"phase": "dryrun_serve", "t_compute_ms": rep.t_compute * 1e3,
          "t_memory_ms": rep.t_memory * 1e3,
          "t_collective_ms": rep.t_collective * 1e3,
          "bottleneck": rep.bottleneck, "bound_ms": rep.bound_time * 1e3,
          "flops": rep.flops_per_device,
          "hbm_bytes": rep.hbm_bytes_per_device,
          "argument_bytes": rep.argument_bytes,
          "serve_replay_busy_ms": busy, "bound_share_of_busy":
          rep.bound_time * 1e3 / busy, "seconds": seconds})
    assert rep.bound_time * 1e3 <= busy, (rep.bound_time * 1e3, busy)
    assert seconds <= 15.0, seconds
    phase_seconds("dryrun_serve", t0)


def phase_seconds(name, t0) -> None:
    emit({"phase_seconds": name, "seconds": time.perf_counter() - t0})


def reduced(arch, layers):
    """``arch``'s config at full width cut to ``layers`` layers, with a
    line naming the cut."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    emit({"phase": f"serve_{arch}", "reduced": {
        "num_layers": [cfg.num_layers, layers],
        "why": "the whole run's time limit"}})
    return dataclasses.replace(cfg, num_layers=layers)


def build_weights(torch, arch, cfg=None):
    """``arch`` at full width and depth (or ``cfg``, a cut of it) with
    random 2-bit VQ block weights drawn on the card from SEED (block
    linears built from their shapes); one line with the weights' bytes on
    the card against the same model dense in bf16. Returns the model, its
    params and the phase's prompts (the llama2 phases' lengths)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = cfg or get_config(arch)
    model = build_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    t0 = time.perf_counter()
    params = model.quantize(model.init(gen, device="cuda", block_device="meta"),
                            method="synthetic", generator=gen, device="cuda")
    torch.cuda.synchronize()
    emit({"phase": "weights", "model": arch, **weight_bytes(torch, params),
          "layers": cfg.num_layers, "d_model": cfg.d_model,
          "heads": [cfg.num_heads, cfg.num_kv_heads], "d_ff": cfg.d_ff,
          "vocab": cfg.vocab_size, "seconds": time.perf_counter() - t0})
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(32, 201, N_REQUESTS)]
    return model, params, prompts


def weight_bytes(torch, params) -> dict:
    """The params' bytes on the card, their VQ'd part, the same model dense
    in bf16, and counts."""
    from repro_torch.core.quantize import (compressed_model_bytes,
                                           count_vq_layers, vq_nodes)
    from repro_torch.models.api import param_count, param_tensors

    vq_b, vq_dense_b = compressed_model_bytes(params)
    vq = [node["vq"] for node in vq_nodes(params)]
    return {"weight_bytes_on_card": sum(t.numel() * t.element_size()
                                        for t in param_tensors(params)),
            "vq_bytes": vq_b,
            # the VQ'd linears dense in bf16, and every other tensor in bf16
            "bf16_dense_bytes": vq_dense_b + 2 * (param_count(params)
                                                  - param_count(vq)),
            "vq_linears": count_vq_layers(params),
            "param_count": param_count(params),
            "device_bytes": torch.cuda.memory_allocated()}


def serve_other_configs(torch, timer):
    """Phase 7: the other dense configs at full width, GQA in the
    engine's stream. Returns each phase's kernel launches."""
    import gc

    from repro_torch.core.plan import PlanPolicy
    from repro_torch.core.ops import quantize_int8
    from repro_torch.models import RunConfig
    from repro_torch.serve import EngineConfig

    rc = RunConfig(plan_policy=PlanPolicy(vq_mode="none", impl="cuda"))
    rc_kvq = RunConfig(plan_policy=PlanPolicy(vq_mode="none", impl="cuda",
                                              int8_prefill=True))
    fp_kernels = ("fused_vq_matmul", "flash_decode", "dequant_gemv")
    out = {}

    def fresh():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    # llama3-8b: g = 4, vocab 128256; fp cache, then KV-VQ + INT8 prefill
    t0 = time.perf_counter()
    fresh()
    model, params, prompts = build_weights(torch, "llama3_8b")
    head = params["lm_head"]["w"]
    emit({"phase": "int8_weight_quantization", "model": "llama3_8b",
          "K": head.shape[0], "N": head.shape[1],
          "ms_per_call": timer(lambda: quantize_int8(head, axis=0))})
    fp = serve_phase(torch, model, params, prompts, "serve_llama3_8b", rc,
                     EngineConfig(num_slots=SLOTS, max_len=MAX_LEN), fp_kernels,
                     eager_profiles=False)
    kvq = serve_phase(torch, model, params, prompts, "serve_llama3_8b_kvq",
                      rc_kvq, EngineConfig(num_slots=SLOTS, max_len=MAX_LEN,
                                           kv_bits=4),
                      ("fused_vq_matmul", "flash_decode_kvq", "dequant_gemv",
                       "int8_gemm"), eager_profiles=False)
    emit({"phase": "llama3_8b_kv_bits_4_vs_16",
          "greedy_token_agreement": agreement(fp, kvq)})
    out["serve_llama3_8b"], out["serve_llama3_8b_kvq"] = (fp["launches"],
                                                          kvq["launches"])
    del model, params, head, fp, kvq
    phase_seconds("serve_llama3_8b (+ weights, _kvq)", t0)

    t0 = time.perf_counter()
    fresh()
    out["serve_qwen3_0_6b"] = serve_qwen3_ckpt(torch, rc, fp_kernels)
    phase_seconds("serve_qwen3_0_6b (+ weights, _ckpt, cli)", t0)

    t0 = time.perf_counter()
    fresh()
    out["serve_qwen2_72b"] = serve_qwen2(torch, fp_kernels)
    phase_seconds("serve_qwen2_72b", t0)

    t0 = time.perf_counter()
    fresh()
    model, params, prompts = build_weights(torch, "minitron_4b")
    out["serve_minitron_4b"] = serve_phase(
        torch, model, params, prompts, "serve_minitron_4b", rc,
        EngineConfig(num_slots=SLOTS, max_len=MAX_LEN), fp_kernels,
        eager_profiles=False)["launches"]
    del model, params
    phase_seconds("serve_minitron_4b (+ weights)", t0)
    fresh()
    return out


def check_mixtral_linears(torch, gen, record):
    """B1 at mixtral-8x22b's decode linears: wqkv and wo at M = SLOTS, an
    expert's gu and down at M = 2 (its capacity for SLOTS tokens); B3 at
    an expert's gu with bf16 x at M = MIXTRAL_B3_M (its capacity for a
    4160-token prompt); each against its plain version, beside fp32 and
    bf16 torch.matmul on the dequantized weight, with its launch shape;
    each B1 case carries its launches a decode step (``per_step``: L for
    the attention's, E x L for an expert's)."""
    from repro_torch.configs import get_config
    from repro_torch.core.vq import synthetic_vq
    from repro_torch.models.common import moe_capacity

    cfg = get_config(MIXTRAL)
    cap = moe_capacity(cfg, SLOTS)
    L, E = cfg.num_layers, cfg.num_experts
    assert moe_capacity(cfg, MIXTRAL_LONG[0]) == MIXTRAL_B3_M
    for name, K, N in arch_linears(dataclasses.replace(cfg, d_ff=cfg.moe_d_ff)):
        vq = synthetic_vq(gen, K, N, C=2, device="cuda")
        expert = name in ("gu", "down")
        M = cap if expert else SLOTS
        x = torch.randn((M, K), generator=gen, device="cuda")
        case = {"model": MIXTRAL, "linear": name,
                "per_step": E * L if expert else L}
        check_b1(torch, record, vq, x, case, launch_shape=True)
        if name == "gu":
            check_b3(torch, record, vq, torch.randn(
                (MIXTRAL_B3_M, K), generator=gen, device="cuda").bfloat16(),
                case)
        del vq


def check_b3(torch, record, vq, xb, case):
    """B3 on bf16 ``xb`` (M, K) against its plain version, beside fp32 and
    bf16 torch.matmul on the dequantized weight, with its launch shape;
    the bound: the products' flops at the bf16 tensor-core rate. A
    prefill linear runs in no decode step: ``case``'s ``per_step`` is
    dropped."""
    from repro_torch.core.vq import dequantize
    from repro_torch.kernels.dequant_gemv import dequant_gemv
    from repro_torch.kernels.dequant_gemv.ops import (
        launch_shape as dequant_launch_shape)

    (M, K), N = xb.shape, vq.N
    V = K // 8
    case = {k: v for k, v in case.items() if k != "per_step"}
    x32 = xb.float()
    w = dequantize(vq)
    wb = w.to(torch.bfloat16)
    run = lambda: dequant_gemv(xb, vq, out_dtype=torch.float32)
    plain = lambda: dequant_gemv(xb, vq, out_dtype=torch.float32,
                                 use_kernel=False)
    got, want = run(), plain()
    record("dequant_gemv", {
        "M": M, **case, "K": K, "N": N, "x": "bfloat16",
        "launch_shape": dequant_launch_shape(M, V, N, torch.cuda.
                                             get_device_properties(0)
                                             .multi_processor_count)},
        got, want, 1e-4 * max(1.0, want.abs().max().item()), run, plain,
        lambda: torch.matmul(x32, w),
        M * K * 2 + 2 * V * N + 2 * 8 * 256 * 4 + N * 4 + M * N * 4,
        2 * 2 * M * K * N, peak=BF16_FLOPS,
        extra={"library_bf16_ms": lambda: torch.matmul(xb, wb)})


def check_b6(torch, gen, record, model, name, M, K, N, per_prefill=1):
    """B6 at one dense linear of ``model``'s INT8 prefill: bf16 w (K, N)
    and x (M, K) drawn from ``gen`` and quantized as the wrapper
    quantizes them, bit-equal to the plain version, beside torch._int_mm
    with the same scales (none at N not a multiple of 8, which cuBLAS's
    int8 GEMM does not take)."""
    from repro_torch.core.ops import quantize_int8
    from repro_torch.kernels.int8_gemm import int8_gemm, int8_gemm_ref

    w = torch.randn((K, N), generator=gen, device="cuda").bfloat16()
    x = torch.randn((M, K), generator=gen, device="cuda").bfloat16()
    (xq, xs), (wq, ws) = quantize_int8(x, axis=-1), quantize_int8(w, axis=0)
    del w
    wq_cm = wq.t().contiguous().t()
    run = lambda: int8_gemm(xq, wq, xs, ws)
    plain = lambda: int8_gemm_ref(xq, wq, xs, ws)
    record("int8_gemm", {"model": model, "linear": name, "M": M, "K": K,
                         "N": N, "per_prefill": per_prefill},
           run(), plain(), 0.0, run, plain,
           (lambda: torch._int_mm(xq, wq_cm).float() * xs * ws)
           if N % 8 == 0 else None,
           M * K + K * N + 4 * M + 4 * N + 4 * M * N, 2 * M * N * K,
           peak=INT8_OPS)


def deepseek_linears(cfg):
    """(name, K, N, decode M, times a decode step, prefill M) of every VQ
    linear deepseek-v2-lite-16b runs, at 4 slots, max_len MAX_LEN and a
    DEEPSEEK_B3_T-token prompt: the attention's grouped wq|wkv_a, wkv_b
    (decode: over the whole latent cache, M = slots x max_len, in the
    expand form; M = slots is its absorbed or prefill shape, no step
    runs it there), wo; the dense first layer's and the shared experts'
    MLPs; a routed expert at its capacity."""
    from repro_torch.models.common import moe_capacity

    H, r, D = cfg.num_heads, cfg.kv_lora_rank, cfg.d_model
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    dff, L, E = cfg.moe_d_ff, cfg.num_layers, cfg.num_experts
    sh, pre = dff * cfg.num_shared_experts, cfg.first_dense_layers
    cap, T = moe_capacity(cfg, SLOTS), DEEPSEEK_B3_T
    cap_t = moe_capacity(cfg, T)
    return (("wq_kva", D, H * (dn + dr) + r + dr, SLOTS, L, T),
            ("wkv_b", r, H * (dn + dv), SLOTS, 0, T),
            ("wkv_b_expand", r, H * (dn + dv), SLOTS * MAX_LEN, L, None),
            ("wo", H * dv, D, SLOTS, L, T),
            ("dense_gu", D, 2 * cfg.d_ff, SLOTS, pre, T),
            ("dense_down", cfg.d_ff, D, SLOTS, pre, T),
            ("shared_gu", D, 2 * sh, SLOTS, L - pre, T),
            ("shared_down", sh, D, SLOTS, L - pre, T),
            ("expert_gu", D, 2 * dff, cap, E * (L - pre), cap_t),
            ("expert_down", dff, D, cap, E * (L - pre), cap_t))


def check_deepseek_linears(torch, gen, record):
    """B1 at deepseek-v2-lite-16b's decode linears (``deepseek_linears``:
    wq_kva's N = 3648 is ragged at both column tiles; wkv_b at M = 2048,
    the expand decode, far past the M <= 16 the tile model was fitted
    at; the experts at M = 1) and B3 at its prefill linears of a
    DEEPSEEK_B3_T-token prompt (the first layer's down at V = 1368, an
    expert's down at V = 176, at M = 24), each against its plain
    version, beside fp32 and bf16 torch.matmul on the dequantized
    weight, with its launch shape. Then the split-pinned planner's pair,
    B4 and B5 (``check_split``), at every decode linear a step runs
    (wkv_b at M = 2048: M x V = 131072 rows of B4's output codebook),
    each against its plain version and the pair against B1."""
    from repro_torch.configs import get_config
    from repro_torch.core.vq import synthetic_vq

    cfg = get_config(DEEPSEEK)
    for name, K, N, M, per_step, m_pre in deepseek_linears(cfg):
        vq = synthetic_vq(gen, K, N, C=2, device="cuda")
        case = {"model": DEEPSEEK, "linear": name, "per_step": per_step}
        x = torch.randn((M, K), generator=gen, device="cuda")
        check_b1(torch, record, vq, x, case, launch_shape=True)
        del x
        if m_pre is not None:
            check_b3(torch, record, vq, torch.randn(
                (m_pre, K), generator=gen, device="cuda").bfloat16(), case)
        del vq
    for name, K, N, M, per_step, _ in deepseek_linears(cfg):
        if per_step:
            check_split(torch, gen, record, K, N, M, {
                "model": DEEPSEEK, "linear": name, "per_step": per_step},
                pair=True)


def serve_qwen3_ckpt(torch, rc, required):
    """qwen3-0.6b at full width and depth (qk_norm, q_dim 2048 != d_model
    1024, vocab 151936): served, saved with the port's CheckpointManager,
    restored (bit for bit), and served again from the restored params:
    the greedy tokens must be equal. Then the port's CLI serves it once
    in a subprocess, which must exit 0 and print the reference CLI's two
    lines."""
    import os
    import tempfile

    from repro_torch import kernels
    from repro_torch.checkpoint import CheckpointManager, flatten_with_paths
    from repro_torch.serve import Engine, EngineConfig

    model, params, prompts = build_weights(torch, "qwen3_0_6b")
    ecfg = EngineConfig(num_slots=SLOTS, max_len=MAX_LEN)
    before = serve_phase(torch, model, params, prompts, "serve_qwen3_0_6b", rc,
                         ecfg, required, eager_profiles=False)
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        t0 = time.perf_counter()
        mgr.save(0, {"params": params})
        save_s = time.perf_counter() - t0
        disk = sum(os.path.getsize(os.path.join(root, f))
                   for root, _, files in os.walk(d) for f in files)
        t0 = time.perf_counter()
        step, state = mgr.restore(device="cuda")
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    restored = state["params"]
    a, b = dict(flatten_with_paths(params)), dict(flatten_with_paths(restored))
    same = a.keys() == b.keys() and all(
        (x.dtype == y.dtype and x.shape == y.shape and bool(torch.equal(x, y)))
        if isinstance(x, torch.Tensor) else bool((x == y).all())
        for x, y in ((a[k], b[k]) for k in a))
    kernels.reset_launch_counts()
    eng = Engine(model, restored, rc, ecfg, device="cuda")
    tokens = list(eng.generate(prompts, MAX_NEW).values())
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    emit({"phase": "serve_qwen3_0_6b_ckpt", "step": step, "disk_bytes": disk,
          "weight_bytes_on_card": weight_bytes(torch, params)[
              "weight_bytes_on_card"],
          "save_s": save_s, "restore_s": restore_s,
          "restored_bitwise_equal": same,
          "tokens_equal_before_save": tokens == before["tokens"],
          "launches": launches})
    assert same, "qwen3-0.6b: the restored params differ from the saved ones"
    assert tokens == before["tokens"], "qwen3-0.6b: restored params serve other tokens"
    missing = [k for k in required if launches[k] == 0]
    assert not missing, f"serve_qwen3_0_6b_ckpt: never launched: {missing}"
    del eng, restored, state, params, a, b
    serve_cli(torch, ["--arch", "qwen3-0.6b", "--full"])
    return before["launches"]


def serve_cli(torch, argv):
    """``python -m repro_torch.launch.serve`` in a subprocess (the kernels
    built above are loaded from build/): exit 0 and the reference CLI's
    two lines."""
    import gc
    import os

    gc.collect()
    torch.cuda.empty_cache()
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", *argv]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=600, env={**os.environ,
                                           "PYTHONPATH": str(ROOT / "src")})
    lines = res.stdout.strip().splitlines()
    ok = (res.returncode == 0 and len(lines) >= 2
          and re.fullmatch(r"served \d+ requests, \d+ tokens, [\d.]+ tok/s",
                           lines[-2]) is not None
          and re.fullmatch(r"engine: admitted=\d+ rejected=0 finished=\d+ "
                           r"\(stop=\d+ length=\d+\) decode_steps=\d+ "
                           r"occupancy=\d\.\d\d", lines[-1]) is not None)
    emit({"phase": "serve_cli", "argv": argv, "returncode": res.returncode,
          "stdout": lines[-2:], "seconds": time.perf_counter() - t0})
    assert ok, f"the CLI failed: {res.returncode}\n{res.stderr[-3000:]}"


def serve_qwen2(torch, required):
    """qwen2-72b at full width (80 layers, d_model 8192, 64/8 heads, d_ff
    29568, vocab 152064, qkv biases) through the port's launch entry
    point, ``launch.serve.serve(..., smoke=False, device="cuda")``: its
    synthetic trace (8 requests, 32 new tokens, 4 slots) with prompts of
    up to MAX_LEN - MAX_NEW - 8 tokens, so that max_len is MAX_LEN as in
    the other serve phases; EVA decode and dequant_gemv prefill (vq_mode
    "none", as the other serve phases); the weights' bytes on the card
    against the model dense in bf16, the peak device memory, decode ms a
    step and tok/s; then the engine's checks (plain decode step within
    QWEN2_PLAIN_REL, graph_step, profiles)."""
    from repro_torch import kernels
    from repro_torch.launch.serve import serve as launch_serve

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = launch_serve("qwen2-72b", smoke=False, requests=N_REQUESTS,
                       max_new=MAX_NEW, prompt_len=MAX_LEN - MAX_NEW - 8,
                       vq_mode="none", device="cuda")
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    eng = out["engine"]
    m = out["metrics"]
    assert eng.ecfg.max_len == MAX_LEN, eng.ecfg.max_len
    emit({"phase": "serve_qwen2_72b", **weight_bytes(torch, eng.params),
          "peak_device_bytes": torch.cuda.max_memory_allocated(),
          "requests": N_REQUESTS, "slots": eng.ecfg.num_slots,
          "max_len": eng.ecfg.max_len,
          "prompt_tokens": m["prefill_prompt_tokens"],
          "build_and_serve_s": total_s,
          "wall_s": out["wall_s"], "tokens_generated": out["tokens"],
          "tok_per_s": out["tok_per_s"], "decode_steps": m["decode_steps"],
          "decode_ms_per_step": m["decode_s"] * 1e3 / m["decode_steps"],
          "prefill_s": m["prefill_s"], "slot_occupancy": m["slot_occupancy"],
          "kv_bytes_in_use": m["kv_bytes_in_use"], "launches": launches})
    assert all(o.finish_reason == "length" and o.num_tokens == MAX_NEW
               for o in out["outputs"].values()), "qwen2-72b: a request fell short"
    missing = [k for k in required if launches[k] == 0]
    assert not missing, f"serve_qwen2_72b: never launched: {missing}"
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    toks = torch.randint(0, eng.model.cfg.vocab_size, (SLOTS, 16), generator=gen,
                         device="cuda", dtype=torch.int32)
    engine_checks(torch, eng.model, eng, toks, "serve_qwen2_72b", required,
                  rel=QWEN2_PLAIN_REL, fp32_plain=True, eager_profiles=False)
    return launches


def mixtral_prompts(cfg):
    """serve_mixtral_8x22b's traffic: the two long prompts and six of
    32-200 tokens, drawn from SEED."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    lens = [MIXTRAL_LONG[0], *rng.integers(32, 201, 3), MIXTRAL_LONG[1],
            *rng.integers(32, 201, 3)]
    return [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
            for n in lens]


def drain(torch, eng, prompts):
    """Serve ``prompts`` greedily to MAX_NEW tokens on ``eng`` with every
    kernel count set to 0 first. Returns (per-request outputs, launches,
    wall seconds)."""
    from repro_torch import kernels
    from repro_torch.serve import GenerationRequest

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    uids = [eng.submit(GenerationRequest(prompt=p, max_new_tokens=MAX_NEW))
            for p in prompts]
    while not eng.idle:
        eng.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    outs = [eng.output(u) for u in uids]
    assert all(o.finish_reason == "length" and o.num_tokens == MAX_NEW
               for o in outs), [(o.finish_reason, o.num_tokens) for o in outs]
    return outs, kernels.launch_counts(), wall


def serve_moe(torch, model, params, prompts, label, rc, ecfg, row,
              fresh=None):
    """Serve ``prompts`` greedily on a fresh Engine of a model that
    prefills at the exact length (MoE, xLSTM; ``drain``) and print its
    row: ``row`` (the caller's keys), peak device memory (since the
    caller's reset), cache bytes, the engine's and the decode graph's
    build s and pool bytes, wall s, tok/s, decode ms a step, prefill s
    by prompt length, a replay's launches and the run's. Asserts the
    decode graph's build left the caches as init_cache made them (zeros;
    or ``fresh``, a cache tree of those values), MOE_REQUIRED launched
    and MOE_ABSENT not, and one eager prefill trace a distinct prompt
    length. Returns (engine, tokens, launches)."""
    from repro_torch.serve import Engine, cache_bytes
    from repro_torch.serve.graphs import tensor_leaves

    t0 = time.perf_counter()
    eng = Engine(model, params, rc, ecfg, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    leaves = list(tensor_leaves(eng.caches))
    assert all(torch.equal(t, f) for t, f in zip(
        leaves, tensor_leaves(fresh))) if fresh is not None else \
        not any(bool(t.any()) for t in leaves), \
        f"{label}: the decode graph's build left the caches written"
    outs, launches, wall = drain(torch, eng, prompts)
    m = eng.metrics()
    emit({"phase": label, **row, "layers": model.cfg.num_layers,
          "peak_device_bytes": torch.cuda.max_memory_allocated(),
          "cache_bytes": cache_bytes(eng.caches),
          "requests": len(prompts), "slots": SLOTS,
          "max_len": ecfg.max_len, "engine_build_s": build_s,
          "decode_graph_build_s": eng.decode_graph.build_s,
          "decode_graph_pool_bytes": pool_bytes(
              torch, eng.decode_graph.graph.pool()),
          "wall_s": wall, "tokens_generated": m["tokens_generated"],
          "tok_per_s": m["tokens_generated"] / wall,
          "decode_steps": m["decode_steps"],
          "decode_ms_per_step": m["decode_s"] * 1e3 / m["decode_steps"],
          "prefill_s": m["prefill_s"],
          "prefill_s_by_prompt_len": {len(p): o.prefill_s
                                      for o, p in zip(outs, prompts)},
          "decode_launches_per_step": eng.decode_graph.launches,
          "trace_counts": eng.trace_counts, "launches": launches})
    missing = [k for k in MOE_REQUIRED if launches[k] == 0]
    assert not missing, f"{label}: kernels never launched on its path: " \
                        f"{missing}"
    ran = [k for k in MOE_ABSENT if launches[k]]
    assert not ran, f"{label}: kernels off its path launched: {ran}"
    assert eng.trace_counts["prefill"] == len({len(p) for p in prompts})
    return eng, {"tokens": [list(o.tokens) for o in outs]}, launches


def moe_checks(torch, model, eng, name, rel):
    """``engine_checks`` on a served MoE engine (the bf16 plain step
    within ``rel`` with the routing agreement and two faulty controls, at
    fp32 within 1e-3; graph_step; the replays' profiles), then a
    replayed decode step's device time with the "other" kernels that take
    the most. Returns that step's (tokens, positions)."""
    import numpy as np

    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    toks = torch.randint(0, model.cfg.vocab_size, (SLOTS, 64), generator=gen,
                         device="cuda", dtype=torch.int32)
    engine_checks(torch, model, eng, toks, name, MOE_REQUIRED, rel=rel,
                  fp32_plain=True, eager_profiles=False)
    tok = toks[:, -1:].cpu().numpy()
    pos = np.full((SLOTS, 1), 64, np.int32)
    emit({"phase": f"{name}_replay_profile", **device_profile(
        torch, lambda: eng.decode_graph(tokens=tok, positions=pos),
        top_other=16)})
    return tok, pos


def moe_sub_phase(torch, arch, max_len, prompts, kv_bits, rel):
    """A MoE model at MOE_SUB_LAYERS layers, full width: ``prompts``
    served greedily with the fp cache, a paged one (16-position blocks;
    its tokens must equal the fp run's exactly), each of ``kv_bits`` and
    the split-pinned planner (B4 + B5, no B1), each with its token
    agreement with the fp run; then ``split_step`` on the split run's
    engine (``rel``: its bf16 bound). Returns each run's launches."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.core.plan import PlanPolicy
    from repro_torch.models import RunConfig

    t_phase = time.perf_counter()
    sub = f"serve_{arch}_{MOE_SUB_LAYERS}l"
    rc = RunConfig(plan_policy=PlanPolicy(vq_mode="none", impl="cuda"))
    model, params, _ = build_weights(torch, arch, dataclasses.replace(
        get_config(arch), num_layers=MOE_SUB_LAYERS))
    runs = {"fp": ({}, MOE_REQUIRED),
            "paged": ({"paged": True, "block_size": BLOCK}, MOE_REQUIRED),
            **{f"kv_bits_{b}": ({"kv_bits": b}, MOE_REQUIRED)
               for b in kv_bits},
            "split": ({}, SPLIT_REQUIRED)}
    out = sub_runs(torch, model, params, rc, prompts, max_len, sub, runs,
                   rel)[0]
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    phase_seconds(sub, t_phase)
    return out


def sub_runs(torch, model, params, rc, prompts, max_len, sub, runs, rel,
             tokens=None, extras=None):
    """Serve ``prompts`` greedily on a fresh engine a run of ``runs``
    (label -> (EngineConfig kwargs, kernels that must launch[, its run
    config in place of ``rc``])), each with its token agreement with the
    "fp" run (the first, or given in ``tokens``); the paged run's tokens
    must equal it exactly; a run with ``prefill_chunk`` must chunk; the
    split run (the default planner pinned to B4 + B5) ends with
    ``split_step`` and a "chunk" run with ``chunk_step`` (``rel``: their
    bf16 bound). ``extras``: the engines' prefill extras. Returns (each
    run's launches, each run's tokens)."""
    from repro_torch.serve import Engine, EngineConfig, cache_bytes

    tokens, out = dict(tokens or {}), {}
    for label, (kw, need, *run_rc) in runs.items():
        pinned = pin_split() if label == "split" else None
        try:
            eng = Engine(model, params, run_rc[0] if run_rc else rc,
                         EngineConfig(num_slots=SLOTS, max_len=max_len, **kw),
                         extras, device="cuda")
            outs, launches, wall = drain(torch, eng, prompts)
        finally:
            if pinned is not None:
                pinned()
        tokens[label] = {"tokens": [list(o.tokens) for o in outs]}
        m = eng.metrics()
        emit({"phase": sub, "run": label, "wall_s": wall,
              "decode_ms_per_step": m["decode_s"] * 1e3 / m["decode_steps"],
              "tok_per_s": m["tokens_generated"] / wall,
              "cache_bytes": cache_bytes(eng.caches),
              "peak_kv_bytes_in_use": m["peak_kv_bytes_in_use"],
              "peak_blocks_in_use": m["peak_blocks_in_use"],
              "prefill_chunks": m["prefill_chunks"],
              "preemptions": m["preemptions"],
              **({"page_len": eng.paging.page_len,
                  "blocks_per_slot": eng.paging.blocks_per_slot,
                  "bytes_per_block": eng.paging.bytes_per_block}
                 if eng.paging is not None else {}),
              "agreement_with_fp": agreement(tokens[label], tokens["fp"]),
              "launches": launches})
        missing = [k for k in need if launches[k] == 0]
        assert not missing, f"{sub} {label}: never launched: {missing}"
        assert not kw.get("prefill_chunk") or m["prefill_chunks"] > 0, \
            f"{sub} {label}: no prompt was chunked"
        off = [k for k in MOE_ABSENT if launches[k] and k not in need]
        off += ["fused_vq_matmul"] * bool(label == "split"
                                           and launches["fused_vq_matmul"])
        assert not off, f"{sub} {label}: kernels off its path launched: {off}"
        out[f"{sub}_{label}"] = launches
        if label == "split":
            split_step(torch, eng, sub, rel)
        if label == "chunk":
            chunk_step(torch, eng, sub, rel)
        del eng
    assert tokens["paged"] == tokens["fp"], f"{sub}: the paged cache differs"
    return out, tokens


def chunk_step(torch, eng, name, rel):
    """The witness beside a chunked run's token agreement: SLOTS prompts
    of 1.5 chunks (the engine's ``prefill_chunk``) stepped through
    ``eng``, and through an engine of its layout with fp32 activations
    (the same params), until every slot has taken both chunks (the
    prefill graph, then the chunk graph) and its first decode step
    (the decode graph); then one plain decode step over the engine's
    caches from the token that step sampled, held against the same two
    decode steps after a one-shot prefill into a contiguous cache: bf16
    within ``rel`` of max|logit| (argmax on 3 of 4 rows), fp32 within
    1e-3. A chunk's linears run B3 at another M than the one-shot
    prefill's, whose K splits differ (``dequant_gemv.ops.launch_shape``),
    so the two prefills differ by rounding: a token agreement below 1 is
    near-tie flips, not a wrong chunk. Its launches are not counted."""
    import numpy as np
    from repro_torch.models import build_model
    from repro_torch.serve import Engine, GenerationRequest
    from repro_torch.serve.kvcache import pad_prefill_cache

    cfg, ecfg = eng.model.cfg, eng.ecfg
    c = ecfg.prefill_chunk
    n = c + c // 2
    # the plain step writes position n + 1 into the block the engine gave
    # its decode step at position n
    assert (n + 1) % ecfg.block_size, (n, ecfg.block_size)
    prompts = np.random.default_rng(SEED + 8).integers(
        0, cfg.vocab_size, (SLOTS, n)).astype(np.int32)
    extras = {k: v[0] for k, v in eng._extra_batch.items()}
    rc = eng.rc.replace(mode="prefill")
    at = lambda p: torch.full((SLOTS, 1), p, dtype=torch.int32,
                              device="cuda")
    row = {"phase": f"{name}_chunked_vs_one_shot_step", "chunk": c,
           "prompt": n, "rel_bound": rel}
    for dtype in ("bf16", "fp32"):
        with torch.no_grad(), Uncounted():
            e = eng if dtype == "bf16" else Engine(
                build_model(dataclasses.replace(cfg, dtype="float32")),
                eng.params, eng.rc, ecfg, extras, device="cuda")
            chunks = e.metrics()["prefill_chunks"]
            for p in prompts:
                e.submit(GenerationRequest(prompt=p, max_new_tokens=MAX_NEW))
            while not e.active.all():
                e.step()
            trs = e.sched.slots
            assert (e.positions == n + 1).all() and \
                e.metrics()["prefill_chunks"] == chunks + SLOTS, \
                (e.positions, e.metrics()["prefill_chunks"], chunks)
            toks = torch.tensor(np.stack([tr.request.prompt for tr in trs]),
                                dtype=torch.int32, device="cuda")
            first, second = (torch.tensor([[tr.generated[i]] for tr in trs],
                                          dtype=torch.int32, device="cuda")
                             for i in (0, 1))
            chunked, _ = e.model.decode(e.params, second, at(n + 1),
                                        e.caches, e.rc)
            _, cache = e.model.prefill(e.params, prefill_batch(e, toks), rc)
            _, cache = e.model.decode(e.params, first, at(n), pad_prefill_cache(
                cache, ecfg.max_len), e.rc)
            one, _ = e.model.decode(e.params, second, at(n + 1), cache, e.rc)
        drift, rel_drift, agree, finite = logit_drift(torch, chunked, one,
                                                      cfg.vocab_size)
        row[dtype] = {"max_abs_logit_drift": drift, "rel_drift": rel_drift,
                      "argmax_agreement": agree, "finite": finite}
        del one, chunked, cache, e
    emit(row)
    assert row["bf16"]["finite"] and row["bf16"]["rel_drift"] <= rel \
        and row["bf16"]["argmax_agreement"] >= 0.75, row
    assert row["fp32"]["finite"] and row["fp32"]["rel_drift"] <= 1e-3 \
        and row["fp32"]["argmax_agreement"] >= 0.75, row


def split_step(torch, eng, name, rel):
    """The witness beside the split run's token agreement: one decode
    step on ``eng``'s params and run config, from one prefilled cache
    (SLOTS rows of 64 tokens), with the default planner pinned to the
    split (B4 + B5) and with it fused (B1), each asserted to launch its
    own kernels only; held with bf16 activations within ``rel`` of
    max|logit| (argmax on 3 of 4 rows), beside the share of (token,
    layer) top-k routing choices the two agree on, and with fp32
    activations within 1e-3. A low agreement of the split's greedy
    streams with a sound step is near-tie routing flips on bf16
    rounding, not a wrong B4 or B5. Its launches are not counted."""
    from repro_torch import kernels
    from repro_torch.models import build_model
    from repro_torch.serve.kvcache import pad_prefill_cache

    cfg = eng.model.cfg
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    toks = torch.randint(0, cfg.vocab_size, (SLOTS, 64), generator=gen,
                         device="cuda", dtype=torch.int32)
    step = (toks[:, -1:], torch.full((SLOTS, 1), 64, dtype=torch.int32,
                                     device="cuda"))
    row = {"phase": f"{name}_split_vs_fused_step", "rel_bound": rel}
    for dtype, model in (("bf16", eng.model), ("fp32", build_model(
            dataclasses.replace(cfg, dtype="float32")))):
        with torch.no_grad(), Uncounted():
            _, cache = model.prefill(eng.params, prefill_batch(eng, toks),
                                     eng.rc)
            base = pad_prefill_cache(cache, eng.ecfg.max_len,
                                     window=eng.window)
            logits, routes = {}, {}
            for backend, want in (("fused", "fused_vq_matmul"),
                                  ("split", "vq_gemm")):
                pinned = pin_split() if backend == "split" else None
                try:
                    kernels.reset_launch_counts()
                    with Routing() as routes[backend]:
                        logits[backend], _ = model.decode(
                            eng.params, *step,
                            map_cache(lambda t: t.clone(), base), eng.rc)
                    ran = kernels.launch_counts()
                finally:
                    if pinned is not None:
                        pinned()
                other = "vq_gemm" if backend == "fused" else "fused_vq_matmul"
                assert ran[want] and not ran[other], (name, backend, ran)
        drift, rel_drift, agree, finite = logit_drift(
            torch, logits["split"], logits["fused"], cfg.vocab_size)
        row[dtype] = {"max_abs_logit_drift": drift, "rel_drift": rel_drift,
                      "argmax_agreement": agree, "finite": finite,
                      "routing_agreement": routes["split"].agreement(
                          routes["fused"])}
        del logits, cache, base
    emit(row)
    assert row["bf16"]["finite"] and row["bf16"]["rel_drift"] <= rel \
        and row["bf16"]["argmax_agreement"] >= 0.75, row
    assert row["fp32"]["finite"] and row["fp32"]["rel_drift"] <= 1e-3 \
        and row["fp32"]["argmax_agreement"] >= 0.75, row


def serve_mixtral(torch):
    """Phase 8: mixtral-8x22b (top-2 MoE over 8 experts, sliding-window
    rings) at full width and MIXTRAL_LAYERS of its 56 layers, 2-bit VQ
    weights drawn on the
    card from their shapes, bf16 activations, a dense bf16 head, 4 slots,
    greedy, max_len MIXTRAL_MAX_LEN (rings of 4096): the weights' bytes
    against bf16 dense, peak device memory, decode ms a step, tok/s, the
    long prompts' prefill s, the launches (``serve_moe``), the engine's
    checks (``moe_checks``, the bf16 bound MIXTRAL_PLAIN_REL) and a
    replayed step's device time by kernel with the "other" kernels that
    take the most. Then the sub-phase (``moe_sub_phase``): a paged ring
    gives the contiguous ring's tokens exactly; kv_bits 8 and 4 and the
    split-pinned planner. Returns each run's launches."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.core.plan import PlanPolicy
    from repro_torch.models import RunConfig
    from repro_torch.serve import EngineConfig

    t_phase = time.perf_counter()
    name = f"serve_{MIXTRAL}"
    rc = RunConfig(plan_policy=PlanPolicy(vq_mode="none", impl="cuda"))
    torch.cuda.reset_peak_memory_stats()
    model, params, _ = build_weights(torch, MIXTRAL, reduced(
        MIXTRAL, MIXTRAL_LAYERS))
    cfg = model.cfg
    prompts = mixtral_prompts(cfg)
    wb = weight_bytes(torch, params)
    # 35.96 GB at all 56 layers: 0.628 a layer, 0.81 of bf16 vocab tables
    L = cfg.num_layers
    assert 0.6e9 * L < wb["weight_bytes_on_card"] < 0.7e9 * L + 1e9, wb
    # the long prompts wrap the ring: one in its prefill, one in decode
    ring = min(MIXTRAL_MAX_LEN, cfg.sliding_window)
    assert ring == 4096 and MIXTRAL_LONG[0] > ring and \
        MIXTRAL_LONG[1] < ring < MIXTRAL_LONG[1] + MAX_NEW - 1
    eng, _, launches = serve_moe(
        torch, model, params, prompts, name, rc,
        EngineConfig(num_slots=SLOTS, max_len=MIXTRAL_MAX_LEN),
        {**wb, "ring": ring})
    assert eng.caches["body"]["k"].shape[2] == ring
    out = {name: launches}
    moe_checks(torch, model, eng, name, MIXTRAL_PLAIN_REL)
    del eng, model, params
    gc.collect()
    torch.cuda.empty_cache()
    phase_seconds(name, t_phase)
    out.update(moe_sub_phase(torch, MIXTRAL, MIXTRAL_MAX_LEN, prompts,
                             (8, 4), MIXTRAL_PLAIN_REL))
    return out


def serve_deepseek(torch):
    """Phase 9: deepseek-v2-lite-16b (MLA with a 512-wide latent cache, a
    dense first layer, then 64 routed experts top-6 beside 2 shared) at
    full width and DEEPSEEK_LAYERS of its 27 layers, 2-bit VQ weights
    drawn on the card from
    their shapes, bf16 activations, a dense bf16 head; serve's traffic (4
    slots, max_len MAX_LEN, 8 greedy requests of 32-200 prompt tokens,
    MAX_NEW each): the weights' bytes against bf16 dense, peak device
    memory, the latent cache's bytes, decode ms a step, tok/s, prefill s
    (eager, at the exact length), the launches (``serve_moe``; B1's in a
    replay equal to the model's count of decode linears), the engine's
    checks (``moe_checks``, the bf16 bound DEEPSEEK_PLAIN_REL), a
    replayed step's device time with the "other" kernels that take the
    most; then the absorbed decode (``mla_absorb``) on the same weights:
    its token agreement with the expand form and its step. Then the
    sub-phase (``moe_sub_phase``): the paged latent cache gives the
    contiguous run's tokens exactly; kv_bits 4 and the split-pinned
    planner. Returns each run's launches."""
    import gc

    from repro_torch.core.plan import PlanPolicy
    from repro_torch.models import RunConfig
    from repro_torch.serve import EngineConfig

    t_phase = time.perf_counter()
    name = f"serve_{DEEPSEEK}"
    rc = RunConfig(plan_policy=PlanPolicy(vq_mode="none", impl="cuda"))
    model, params, prompts = build_weights(torch, DEEPSEEK, reduced(
        DEEPSEEK, DEEPSEEK_LAYERS))
    cfg = model.cfg
    wb = weight_bytes(torch, params)
    # 4.76 GB at all 27 layers: ~0.145 a layer, 0.84 of bf16 vocab tables
    L = cfg.num_layers
    assert 0.12e9 * L + 0.7e9 < wb["weight_bytes_on_card"] < \
        0.16e9 * L + 1.0e9, wb
    # B1 a decode step: every linear of deepseek_linears times its count;
    # the absorbed decode runs no wkv_b (one a layer)
    b1_step = sum(n for *_, n, _ in deepseek_linears(cfg))
    ecfg = EngineConfig(num_slots=SLOTS, max_len=MAX_LEN)
    out = {}
    for label, run_rc, b1 in ((name, rc, b1_step), (
            f"{name}_absorb", rc.replace(mla_absorb=True),
            b1_step - cfg.num_layers)):
        torch.cuda.reset_peak_memory_stats()   # the weights stay counted
        eng, tokens, out[label] = serve_moe(
            torch, model, params, prompts, label, run_rc, ecfg,
            {**wb, "mla_absorb": run_rc.mla_absorb})
        assert set(eng.caches) == {"pre", "body"}, set(eng.caches)
        assert eng.decode_graph.launches["fused_vq_matmul"] == b1, \
            (label, eng.decode_graph.launches, b1)
        if not run_rc.mla_absorb:
            expand = tokens
            tok, pos = moe_checks(torch, model, eng, name, DEEPSEEK_PLAIN_REL)
        else:
            emit({"phase": label, "agreement_with_expand":
                  agreement(tokens, expand), **device_profile(
                      torch, lambda: eng.decode_graph(
                          tokens=tok, positions=pos), top_other=8)})
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    phase_seconds(f"{name} (+ _absorb)", t_phase)
    out.update(moe_sub_phase(torch, DEEPSEEK, MAX_LEN, prompts, (4,),
                             DEEPSEEK_PLAIN_REL))
    return out


def xlstm_linears(cfg):
    """(name, K, N, times a decode step) of every VQ linear xlstm-125m
    runs: an mLSTM block's up_h and up_g (one shape), its grouped
    wq|wk|wv and down; an sLSTM block's wz, wo and out (one shape) and
    its GELU FFN's up and down: 9 a group."""
    D, G = cfg.d_model, cfg.num_layers // len(cfg.xlstm_pattern)
    di, ffn = 2 * D, int(4 / 3 * D) // 8 * 8
    return (("up_h|up_g", D, di, 2 * G), ("wqkv", di, 3 * di, G),
            ("down", di, D, G), ("wz|wo|out", D, D, 3 * G),
            ("ffn_up", D, ffn, G), ("ffn_down", ffn, D, G))


def check_xlstm_linears(torch, gen, record):
    """B1 at xlstm-125m's decode linears (``xlstm_linears``, M = SLOTS:
    N = 768 is ragged at the 1024-column tile) and B3 at its prefill
    linears of an XLSTM_B3_T-token prompt, each against its plain
    version, beside fp32 and bf16 torch.matmul on the dequantized
    weight, with its launch shape; the split-pinned planner's pair, B4
    and B5 (``check_split``), at every decode linear, each against its
    plain version and the pair against B1; then B6 at the dense linears
    an INT8 prefill runs: the sLSTM gates wi|wf (K = 768, N = 4: the
    wrapper pads the operands to 16 columns; cuBLAS's int8 GEMM takes no
    N = 4, so no library call) and the head (N = 50304), bit-equal to
    the plain version."""
    from repro_torch.configs import get_config
    from repro_torch.core.vq import synthetic_vq

    cfg = get_config(XLSTM)
    T, G = XLSTM_B3_T, cfg.num_layers // len(cfg.xlstm_pattern)
    for name, K, N, per_step in xlstm_linears(cfg):
        vq = synthetic_vq(gen, K, N, C=2, device="cuda")
        case = {"model": XLSTM, "linear": name, "per_step": per_step}
        check_b1(torch, record, vq, torch.randn(
            (SLOTS, K), generator=gen, device="cuda"), case,
            launch_shape=True)
        check_b3(torch, record, vq, torch.randn(
            (T, K), generator=gen, device="cuda").bfloat16(), case)
        del vq
        check_split(torch, gen, record, K, N, SLOTS, case, pair=True)
    for name, N, per_prefill in (("wi|wf", cfg.num_heads, 2 * G),
                                 ("lm_head", cfg.padded_vocab, 1)):
        check_b6(torch, gen, record, XLSTM, name, T, cfg.d_model, N,
                 per_prefill)


def serve_xlstm(torch):
    """Phase 10: xlstm-125m (alternating mLSTM / sLSTM blocks, recurrent
    state of a fixed size a slot, no attention) at full width and all 12
    layers, 2-bit VQ weights drawn on the card from their shapes, bf16
    activations, a dense bf16 head; serve's traffic (4 slots, max_len
    MAX_LEN, 8 greedy requests of 32-200 prompt tokens, MAX_NEW each):
    the weights' bytes against bf16 dense, peak device memory, the
    state's bytes, decode ms a step, tok/s, prefill s (eager, at the
    exact length), the launches (``serve_moe``: B1 54 a replayed step,
    B3; never B2/B7), the caches after the decode graph's build as
    init_cache made them (sLSTM's n = 1e-6), the engine's checks
    (``moe_checks``: the bf16 plain step within XLSTM_PLAIN_REL with two
    faulty controls, fp32 within 1e-3, graph_step over the recurrent
    state, the replays' profiles); then on the same weights
    (``sub_runs``): the paged engine (pass-through state, no block
    bytes) with the contiguous run's tokens exactly, the split-pinned
    planner (B4 + B5) with its token agreement and its step held to the
    fused one, and INT8 prefill (B6 at the sLSTM gates, N = 4, and the
    head: 2 x 6 + 1 launches a prefill); a snapshot mid-run restored
    into a fresh engine (tokens equal the uninterrupted run's); kv_bits
    = 4 and speculate_k = 3 refused with the reference's messages; and
    the CLI at full width. Returns each run's launches."""
    import gc

    from repro_torch.core.plan import PlanPolicy
    from repro_torch.models import RunConfig
    from repro_torch.serve import EngineConfig

    t_phase = time.perf_counter()
    name = f"serve_{XLSTM}"
    rc = RunConfig(plan_policy=PlanPolicy(vq_mode="none", impl="cuda"))
    torch.cuda.reset_peak_memory_stats()
    model, params, prompts = build_weights(torch, XLSTM)
    cfg = model.cfg
    wb = weight_bytes(torch, params)
    assert 0.15e9 < wb["weight_bytes_on_card"] < 0.25e9, wb
    b1_step = sum(n for *_, n in xlstm_linears(cfg))
    assert b1_step == wb["vq_linears"] == 54, (b1_step, wb)
    ecfg = EngineConfig(num_slots=SLOTS, max_len=MAX_LEN)
    eng, tokens, launches = serve_moe(
        torch, model, params, prompts, name, rc, ecfg, wb,
        fresh=model.init_cache(SLOTS, MAX_LEN, device="cuda"))
    assert set(eng.caches) == {"b0_mlstm", "b1_slstm"}, set(eng.caches)
    assert eng.decode_graph.launches["fused_vq_matmul"] == b1_step, \
        eng.decode_graph.launches
    out = {name: launches}
    moe_checks(torch, model, eng, name, XLSTM_PLAIN_REL)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    G = cfg.num_layers // len(cfg.xlstm_pattern)
    int8_rc = rc.replace_policy(int8_prefill=True)
    runs = {"paged": ({"paged": True, "block_size": BLOCK}, MOE_REQUIRED),
            "split": ({}, SPLIT_REQUIRED),
            "int8_prefill": ({}, MOE_REQUIRED + ("int8_gemm",), int8_rc)}
    sub, got = sub_runs(torch, model, params, rc, prompts, MAX_LEN, name,
                        runs, XLSTM_PLAIN_REL, tokens={"fp": tokens})
    assert sub[f"{name}_int8_prefill"]["int8_gemm"] == \
        len(prompts) * (2 * G + 1), sub[f"{name}_int8_prefill"]
    out.update(sub)

    snapshot_restored(torch, model, params, rc, ecfg, prompts, tokens, name)
    refusals(torch, model, params, rc, ecfg, name,
             "speculate_k > 0 requires family='dense'")
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    serve_cli(torch, ["--arch", "xlstm-125m", "--full"])
    phase_seconds(name, t_phase)
    return out


def snapshot_restored(torch, model, params, rc, ecfg, prompts, tokens, name,
                      extras=None):
    """A snapshot of an engine serving ``prompts`` greedily, taken after 12
    ticks, restored into a fresh engine: its tokens must equal the
    uninterrupted run's. One line: the snapshot's cache bytes, its
    device-to-host ms, the restore ms and the agreement with ``tokens``
    (the phase's fp run). Its launches are not counted. ``extras``: the
    engines' prefill extras."""
    from repro_torch.serve import Engine, GenerationRequest

    reqs = [GenerationRequest(prompt=p, max_new_tokens=MAX_NEW)
            for p in prompts]
    with Uncounted():
        eng = Engine(model, params, rc, ecfg, extras, device="cuda")
        uids = [eng.submit(r) for r in reqs]
        for _ in range(12):
            eng.step()
        t0 = time.perf_counter()
        snap = eng.snapshot()
        snap_ms = (time.perf_counter() - t0) * 1e3
        while not eng.idle:
            eng.step()
        want = [list(eng.output(u).tokens) for u in uids]
        del eng
        eng = Engine(model, params, rc, ecfg, extras, device="cuda")
        t0 = time.perf_counter()
        eng.restore(snap)
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        while not eng.idle:
            eng.step()
        restored = [list(eng.output(u).tokens) for u in uids]
        del eng
    emit({"phase": f"{name}_snapshot", "after_ticks": 12,
          "snapshot_cache_bytes": sum(
              a.nbytes for p, a in snap.arrays.items()
              if p.startswith("/caches/") and a is not None),
          "snapshot_ms": snap_ms, "restore_ms": restore_ms,
          "tokens_equal": restored == want,
          "agreement_with_fp": agreement({"tokens": want}, tokens)})
    assert restored == want, f"{name}: restored differs from uninterrupted"


def refusals(torch, model, params, rc, ecfg, name, spec_match):
    """kv_bits = 4 and speculate_k = 3 must each raise the reference's
    message (``spec_match``: the speculation gate's); one line with
    both."""
    from repro_torch.serve import Engine

    refused = {}
    for kw, match in (({"kv_bits": 4}, "requires an attention-cache family"),
                      ({"speculate_k": 3}, spec_match)):
        try:
            Engine(model, params, rc, dataclasses.replace(ecfg, **kw),
                   device="cuda")
        except ValueError as e:
            refused[str(kw)] = str(e)
            assert match in str(e), e
        else:
            raise AssertionError(f"{name}: {kw} was not refused")
    emit({"phase": f"{name}_refusals", **refused})


def rglru_linears(cfg):
    """(name, K, N, times a decode step) of every VQ linear
    recurrentgemma-2b runs: a rec layer's gate_proj, x_proj, wa, wx and
    out and attention's wo (one shape: d_model = d_rnn = the query
    width), attention's grouped wq|wk|wv (MQA: N = 3072) and every
    layer's gu and down: 7 a rec layer, 4 an attention layer, 158 a
    step."""
    D, F, period = cfg.d_model, cfg.d_ff, len(cfg.rec_pattern)
    G, T = cfg.num_layers // period, cfg.num_layers % period
    n_rec = G * cfg.rec_pattern.count("rec") + T
    n_attn = G * cfg.rec_pattern.count("attn")
    assert D == cfg.d_rnn == cfg.q_dim
    return (("gate_proj|x_proj|wa|wx|out|wo", D, D, 5 * n_rec + n_attn),
            ("wqkv", D, cfg.q_dim + 2 * cfg.kv_dim, n_attn),
            ("gu", D, 2 * F, n_rec + n_attn), ("down", F, D, n_rec + n_attn))


def check_rglru_linears(torch, gen, record):
    """B1 at recurrentgemma-2b's decode linears (``rglru_linears``, M =
    SLOTS) with its launch shape and B3 at its prefill linears of an
    RGLRU_B3_T-token prompt (bf16 x), each against its plain version
    beside fp32 and bf16 torch.matmul on the dequantized weight; the
    split-pinned planner's pair, B4 and B5 (``check_split``), at every
    decode linear; then B6 at the one dense linear an INT8 prefill runs,
    the head (K = 2560, N = 256000), bit-equal to the plain version,
    beside torch._int_mm with the same scales."""
    from repro_torch.configs import get_config
    from repro_torch.core.vq import synthetic_vq

    cfg = get_config(RGLRU)
    T = RGLRU_B3_T
    for name, K, N, per_step in rglru_linears(cfg):
        vq = synthetic_vq(gen, K, N, C=2, device="cuda")
        case = {"model": RGLRU, "linear": name, "per_step": per_step}
        check_b1(torch, record, vq, torch.randn(
            (SLOTS, K), generator=gen, device="cuda"), case,
            launch_shape=True)
        check_b3(torch, record, vq, torch.randn(
            (T, K), generator=gen, device="cuda").bfloat16(), case)
        del vq
        check_split(torch, gen, record, K, N, SLOTS, case, pair=True)
    check_b6(torch, gen, record, RGLRU, "lm_head", T, cfg.d_model,
             cfg.padded_vocab)


def serve_rglru(torch):
    """Phase 11: recurrentgemma-2b (RG-LRU recurrent layers and
    local-attention rings in one cache tree) at full width and all 26
    layers, 2-bit VQ weights drawn on the card from their shapes, bf16
    activations, a dense bf16 head; serve's traffic (4 slots, max_len
    MAX_LEN: rings of 512; 8 greedy requests of 32-200 prompt tokens,
    MAX_NEW each): the weights' bytes against bf16 dense, peak device
    memory, the state's and the rings' bytes, decode ms a step, tok/s,
    prefill s (eager, at the exact length), the launches (``serve_moe``:
    B1 158 a replayed step, B3 158 a prompt; never B2/B7: rings attend
    in plain torch), the caches after the decode graph's build as
    init_cache made them, the engine's checks (``moe_checks``: the bf16
    plain step within RGLRU_PLAIN_REL with two faulty controls, fp32
    within 1e-3, graph_step over the mixed tree, the replays'
    profiles); then on the same weights (``sub_runs``): the paged engine
    (rings through the block table, h and conv pass-through) with the
    contiguous run's tokens exactly, the split-pinned planner (B4 + B5)
    with its token agreement and its step held to the fused one, INT8
    prefill (B6 at the head, one a prefill); the ring-wrap sub-run
    (max_len RGLRU_WRAP_MAX_LEN: rings of 2048, prompts of RGLRU_WRAP
    among two short ones, contiguous and paged, tokens equal); a
    snapshot mid-run restored into a fresh engine; kv_bits = 4 and
    speculate_k = 3 refused with the reference's messages; and the CLI
    at full width. Returns each run's launches."""
    import gc

    import numpy as np
    from repro_torch.core.plan import PlanPolicy
    from repro_torch.models import RunConfig
    from repro_torch.serve import EngineConfig
    from repro_torch.serve.graphs import tensor_leaves

    t_phase = time.perf_counter()
    name = f"serve_{RGLRU}"
    rc = RunConfig(plan_policy=PlanPolicy(vq_mode="none", impl="cuda"))
    torch.cuda.reset_peak_memory_stats()
    model, params, prompts = build_weights(torch, RGLRU)
    cfg = model.cfg
    wb = weight_bytes(torch, params)
    assert 3.0e9 < wb["weight_bytes_on_card"] < 3.4e9, wb
    b1_step = sum(n for *_, n in rglru_linears(cfg))
    assert b1_step == wb["vq_linears"] == 158, (b1_step, wb)
    ecfg = EngineConfig(num_slots=SLOTS, max_len=MAX_LEN)
    fresh = model.init_cache(SLOTS, MAX_LEN, device="cuda")
    nbytes = lambda node: sum(t.numel() * t.element_size()
                              for t in tensor_leaves(node))
    rings = fresh["groups"]["b2_attn"]
    sizes = {"state_bytes": nbytes(fresh) - nbytes(rings),
             "ring_bytes": nbytes(rings), "ring": rings["k"].shape[2]}
    eng, tokens, launches = serve_moe(torch, model, params, prompts, name,
                                      rc, ecfg, {**wb, **sizes}, fresh=fresh)
    del fresh, rings
    assert set(eng.caches) == {"groups", "trail"}, set(eng.caches)
    assert eng.decode_graph.launches["fused_vq_matmul"] == b1_step, \
        eng.decode_graph.launches
    assert launches["dequant_gemv"] == b1_step * len(prompts), launches
    out = {name: launches}
    moe_checks(torch, model, eng, name, RGLRU_PLAIN_REL)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    int8_rc = rc.replace_policy(int8_prefill=True)
    runs = {"paged": ({"paged": True, "block_size": BLOCK}, MOE_REQUIRED),
            "split": ({}, SPLIT_REQUIRED),
            "int8_prefill": ({}, MOE_REQUIRED + ("int8_gemm",), int8_rc)}
    sub, _ = sub_runs(torch, model, params, rc, prompts, MAX_LEN, name, runs,
                      RGLRU_PLAIN_REL, tokens={"fp": tokens})
    assert sub[f"{name}_int8_prefill"]["int8_gemm"] == len(prompts), \
        sub[f"{name}_int8_prefill"]
    out.update(sub)

    # the rings wrap: one long prompt in its prefill, one in decode
    ring = min(RGLRU_WRAP_MAX_LEN, cfg.local_window)
    assert ring == 2048 and RGLRU_WRAP[0] > ring and \
        RGLRU_WRAP[1] < ring < RGLRU_WRAP[1] + MAX_NEW - 1
    rng = np.random.default_rng(SEED + 8)
    lens = [RGLRU_WRAP[0], *rng.integers(32, 201, 1), RGLRU_WRAP[1],
            *rng.integers(32, 201, 1)]
    wrap_prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
                    for n in lens]
    wrap = {"fp": ({}, MOE_REQUIRED),
            "paged": ({"paged": True, "block_size": BLOCK}, MOE_REQUIRED)}
    out.update(sub_runs(torch, model, params, rc, wrap_prompts,
                        RGLRU_WRAP_MAX_LEN, f"{name}_wrap", wrap,
                        RGLRU_PLAIN_REL)[0])

    snapshot_restored(torch, model, params, rc, ecfg, prompts, tokens, name)
    refusals(torch, model, params, rc, ecfg, name,
             "speculate_k > 0 requires a full (non-windowed) cache")
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    serve_cli(torch, ["--arch", "recurrentgemma-2b", "--full"])
    phase_seconds(name, t_phase)
    return out


def whisper_linears(cfg):
    """(name, K, N, times a decode step, times a prefill, rows in prefill)
    of every VQ linear whisper-medium runs, one entry a shape: the
    decoder's decode linears (self-attention wqkv, then self wo, cross wq
    and cross wo of one shape, up, down: 6 a layer, 144 a step), each
    also a prefill linear at the prompt's rows; the encoder's and the
    cross memory's at WHISPER_FRAMES rows (encoder wqkv, wo|cross wk|cross
    wv, up, down)."""
    D, F, L, E = cfg.d_model, cfg.d_ff, cfg.num_layers, cfg.encoder_layers
    return (("wqkv", D, 3 * D, L, L, "prompt"),
            ("wo|cross_wq|cross_wo", D, D, 3 * L, 3 * L, "prompt"),
            ("up", D, F, L, L, "prompt"), ("down", F, D, L, L, "prompt"),
            ("enc_wqkv", D, 3 * D, 0, E, "frames"),
            ("enc_wo|cross_wk|cross_wv", D, D, 0, E + 2 * L, "frames"),
            ("enc_up", D, F, 0, E, "frames"),
            ("enc_down", F, D, 0, E, "frames"))


def check_whisper_linears(torch, gen, record):
    """Whisper-medium's kernels at its shapes: B1 at its decode linears (M
    = SLOTS) with its launch shape, the split pair B4 and B5
    (``check_split``) at each; B3 at the decoder's prefill linears of a
    WHISPER_B3_T-token prompt and at the encoder's and the cross memory's
    of WHISPER_FRAMES rows (bf16 x), each against its plain version beside
    fp32 and bf16 torch.matmul on the dequantized weight; B2 and its paged
    entry at head dim 64 with one query head a kv head (16 heads, SLOTS
    rows at lengths 1/512/200/64; the paged one over a shuffled table of
    16-position blocks, bitwise against the contiguous kernel over the
    gathered view) against their plain versions beside SDPA; and B6 at
    the dense linears an INT8 prefill runs: frontend.proj at
    WHISPER_FRAMES rows and the head (N = 51968) at WHISPER_B3_T,
    bit-equal to the plain version, beside torch._int_mm with the same
    scales."""
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.core.vq import synthetic_vq
    from repro_torch.kernels.flash_decode import (flash_decode,
                                                  flash_decode_paged,
                                                  flash_decode_paged_ref,
                                                  flash_decode_ref)
    from repro_torch.models.common import paged_view

    cfg = get_config(WHISPER)
    for name, K, N, per_step, per_prefill, rows in whisper_linears(cfg):
        vq = synthetic_vq(gen, K, N, C=2, device="cuda")
        case = {"model": WHISPER, "linear": name}
        if per_step:
            check_b1(torch, record, vq, torch.randn(
                (SLOTS, K), generator=gen, device="cuda"),
                {**case, "per_step": per_step}, launch_shape=True)
        M = WHISPER_B3_T if rows == "prompt" else WHISPER_FRAMES
        check_b3(torch, record, vq, torch.randn(
            (M, K), generator=gen, device="cuda").bfloat16(),
            {**case, "per_prefill": per_prefill})
        del vq
        if per_step:
            check_split(torch, gen, record, K, N, SLOTS,
                        {**case, "per_step": per_step}, pair=True)

    # B2 at hd 64, g 1: the decoder's self-attention
    B, H, hd, L = SLOTS, cfg.num_heads, cfg.head_dim, cfg.num_layers
    lengths = torch.tensor([1, MAX_LEN, 200, 64], dtype=torch.int32,
                           device="cuda")
    tot = int(lengths.sum())
    mask = (torch.arange(MAX_LEN, device="cuda")[None, :]
            < lengths[:, None])[:, None, None, :]
    W, NB = MAX_LEN // BLOCK, SLOTS * MAX_LEN // BLOCK
    perm = torch.randperm(NB, generator=gen, device="cuda").int()
    table = torch.full((B, W), NB, dtype=torch.int32, device="cuda")
    used = 0
    for b, n in enumerate(lengths.tolist()):
        nb = -(-n // BLOCK)
        table[b, :nb] = perm[used:used + nb]
        used += nb
    case = {"model": WHISPER, "linear": "self_attn", "M": B, "B": B, "H": H,
            "Hk": H, "group": 1, "hd": hd, "S": MAX_LEN,
            "lengths": lengths.tolist(), "dtype": "bfloat16", "per_step": L}
    q = torch.randn((B, H, hd), generator=gen, device="cuda").bfloat16()
    k = torch.randn((B, MAX_LEN, H, hd), generator=gen, device="cuda").bfloat16()
    v = torch.randn((B, MAX_LEN, H, hd), generator=gen, device="cuda").bfloat16()
    q4, kt, vt = q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2)
    fp_bytes = 2 * q.numel() * 2 + tot * 2 * H * hd * 2 + B * 4
    fp_ops = tot * H * hd * 4
    tol = lambda want: 2.0 ** -7 * max(1.0, want.float().abs().max().item())
    run = lambda: flash_decode(q, k, v, lengths)
    got, want = run(), flash_decode_ref(q, k, v, lengths)
    record("flash_decode", case, got, want, tol(want), run,
           lambda: flash_decode_ref(q, k, v, lengths),
           lambda: F.scaled_dot_product_attention(q4, kt, vt, attn_mask=mask),
           fp_bytes, fp_ops)
    ka, va = (t.reshape((NB, BLOCK) + t.shape[2:]) for t in (k, v))
    kv_, vv_ = paged_view(ka, table), paged_view(va, table)
    run = lambda: flash_decode_paged(q, ka, va, table, lengths)
    got, want = run(), flash_decode_paged_ref(q, ka, va, table, lengths)
    assert torch.equal(got, flash_decode(q, kv_, vv_, lengths)), \
        "flash_decode_paged != contiguous at hd 64"
    record("flash_decode_paged", {**case, "blocks": NB, "block": BLOCK}, got,
           want, tol(want), run,
           lambda: flash_decode_paged_ref(q, ka, va, table, lengths), None,
           fp_bytes + table.numel() * 4, fp_ops,
           extra={"contiguous_ms": lambda: flash_decode(q, kv_, vv_, lengths),
                  "gather_kernel_ms": lambda: flash_decode(
                      q, paged_view(ka, table), paged_view(va, table),
                      lengths)})
    del k, v, ka, va, kv_, vv_

    # B6: the dense linears of an INT8 prefill
    check_b6(torch, gen, record, WHISPER, "frontend.proj", WHISPER_FRAMES,
             cfg.d_model, cfg.d_model)
    check_b6(torch, gen, record, WHISPER, "lm_head", WHISPER_B3_T,
             cfg.d_model, cfg.padded_vocab)


def serve_whisper(torch):
    """Phase 12: whisper-medium (an encoder-decoder: the encoder over one
    set of WHISPER_FRAMES frames, given to the engine as its extras and
    read by every request's prefill; the decoder's self-attention cache
    beside the S_SRC-row cross memories a prefill writes once and decode
    only reads) at full width and WHISPER_LAYERS + WHISPER_LAYERS of its
    24 + 24 layers (the run's time limit, since PR 30), 2-bit VQ weights
    drawn on the card from their shapes, bf16 activations, a dense bf16
    head; serve's traffic (4 slots, max_len MAX_LEN, 8 greedy requests of
    32-200 prompt tokens, MAX_NEW each) through the graphed engine (decode
    captured at construction, prefill buckets at first use): the weights'
    bytes against bf16 dense, the cross memories' and the self cache's
    bytes, peak memory, decode ms a step, tok/s, prefill s, the launches
    (B1 6 a decoder layer a replayed step, B2 one at head dim 64, B3 6 a
    layer a prefill: 144, 24 and 288 at 24 + 24 layers), the
    caches after the decode graph's build as init_cache made them
    (``cross_len`` S_SRC); the engine's checks (``engine_checks``: the
    bf16 plain step within WHISPER_PLAIN_REL with two faulty controls,
    fp32 within 1e-3, graph_step over the self cache and the memories,
    the replays' profiles), a replayed decode step's and a replayed
    PROFILE_BUCKET-token prefill's device time with the "other" kernels
    that take the most; then on the same weights
    (``sub_runs``): the paged engine with prefill_chunk PREFILL_CHUNK
    (each chunk re-encodes the frames; B2's paged entry) with the
    contiguous run's tokens exactly and chunks above 0, the split-pinned
    planner (B4 + B5) with its token agreement and its step held to the
    fused one, INT8 prefill (B6 at frontend.proj and the head: 2 a
    prefill); a snapshot mid-run restored into a fresh engine (tokens
    equal); kv_bits = 4 and speculate_k = 3 refused with the reference's
    messages; and the CLI at full width. Returns each run's launches."""
    import gc

    import numpy as np
    from repro_torch.core.plan import PlanPolicy
    from repro_torch.models import RunConfig
    from repro_torch.configs import get_config
    from repro_torch.models.whisper import S_SRC
    from repro_torch.serve import Engine, EngineConfig, cache_bytes
    from repro_torch.serve.graphs import tensor_leaves

    t_phase = time.perf_counter()
    name = f"serve_{WHISPER}"
    rc = RunConfig(plan_policy=PlanPolicy(vq_mode="none", impl="cuda"))
    torch.cuda.reset_peak_memory_stats()
    full = get_config(WHISPER)
    emit({"phase": name, "reduced": {
        "encoder_layers": [full.encoder_layers, WHISPER_LAYERS],
        "num_layers": [full.num_layers, WHISPER_LAYERS],
        "why": "the whole run's time limit"}})
    model, params, prompts = build_weights(torch, WHISPER, dataclasses.replace(
        full, encoder_layers=WHISPER_LAYERS, num_layers=WHISPER_LAYERS))
    cfg = model.cfg
    wb = weight_bytes(torch, params)
    # 0.401 GB at 24 + 24 layers, 0.308 at 12 + 12
    assert 0.28e9 < wb["weight_bytes_on_card"] < 0.34e9, wb
    lin = whisper_linears(cfg)
    b1_step = sum(ln[3] for ln in lin)
    b3_prefill = sum(ln[4] for ln in lin)
    # 144 and 288 at 24 + 24 layers: 6 a decoder layer, 6 an encoder one
    assert b1_step == 6 * cfg.num_layers and b3_prefill == \
        wb["vq_linears"] == 6 * (cfg.num_layers + cfg.encoder_layers), \
        (b1_step, b3_prefill, wb)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    extras = {"frames": torch.randn((WHISPER_FRAMES, cfg.d_model),
                                    generator=gen, device="cuda")}
    ecfg = EngineConfig(num_slots=SLOTS, max_len=MAX_LEN)
    fresh = model.init_cache(SLOTS, MAX_LEN, device="cuda")
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)
    sizes = {"cross_memory_bytes": nbytes(
        [fresh[n] for n in ("cross_k", "cross_v", "cross_len")]),
        "self_cache_bytes": nbytes(tensor_leaves(fresh["self"])),
        "frames": WHISPER_FRAMES}

    t0 = time.perf_counter()
    eng = Engine(model, params, rc, ecfg, extras, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    assert all(torch.equal(t, f) for t, f in zip(
        tensor_leaves(eng.caches), tensor_leaves(fresh))), \
        f"{name}: the decode graph's build left the caches written"
    assert bool((eng.caches["cross_len"] == S_SRC).all())
    del fresh
    outs, launches, wall = drain(torch, eng, prompts)
    m = eng.metrics()
    tokens = {"tokens": [list(o.tokens) for o in outs]}
    emit({"phase": name, **wb, **sizes, "layers": [cfg.encoder_layers,
                                                   cfg.num_layers],
          "peak_device_bytes": torch.cuda.max_memory_allocated(),
          "cache_bytes": cache_bytes(eng.caches),
          "requests": len(prompts), "slots": SLOTS, "max_len": MAX_LEN,
          "engine_build_s": build_s,
          "decode_graph_build_s": eng.decode_graph.build_s,
          "decode_graph_pool_bytes": pool_bytes(
              torch, eng.decode_graph.graph.pool()),
          "prefill_graph_pool_bytes": pool_bytes(torch, eng.prefill_pool),
          "wall_s": wall, "tokens_generated": m["tokens_generated"],
          "tok_per_s": m["tokens_generated"] / wall,
          "decode_steps": m["decode_steps"],
          "decode_ms_per_step": m["decode_s"] * 1e3 / m["decode_steps"],
          "prefill_s": m["prefill_s"],
          "prefill_build_s": sum(g.build_s
                                 for g in eng.prefill_graphs.values()),
          "prefill_s_by_prompt_len": {len(p): o.prefill_s
                                      for o, p in zip(outs, prompts)},
          "decode_launches_per_step": eng.decode_graph.launches,
          "trace_counts": eng.trace_counts, "launches": launches})
    missing = [k for k in WHISPER_REQUIRED if launches[k] == 0]
    assert not missing, f"{name}: kernels never launched on its path: " \
                        f"{missing}"
    ran = [k for k in MOE_ABSENT if launches[k] and k not in WHISPER_REQUIRED]
    assert not ran, f"{name}: kernels off its path launched: {ran}"
    dl = eng.decode_graph.launches
    assert dl["fused_vq_matmul"] == b1_step and \
        dl["flash_decode"] == cfg.num_layers, dl
    assert launches["dequant_gemv"] == b3_prefill * len(prompts), launches
    out = {name: launches}

    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    toks = torch.randint(0, cfg.vocab_size, (SLOTS, 64), generator=gen,
                         device="cuda", dtype=torch.int32)
    engine_checks(torch, model, eng, toks, name, WHISPER_REQUIRED,
                  rel=WHISPER_PLAIN_REL, fp32_plain=True,
                  eager_profiles=False,
                  control_names=("position_minus_1", "init_state"))
    tok = toks[:, -1:].cpu().numpy()
    pos = np.full((SLOTS, 1), 64, np.int32)
    emit({"phase": f"{name}_replay_profile", **device_profile(
        torch, lambda: eng.decode_graph(tokens=tok, positions=pos),
        top_other=16)})
    # a prefill replay's "other" (the encoder's plain attention over the
    # frames), by kernel
    arrays = step_inputs(eng, PROFILE_BUCKET, np.random.default_rng(SEED + 4))
    prefill = eng.prefill_graph(PROFILE_BUCKET)
    emit({"phase": f"{name}_prefill_replay_profile", "bucket": PROFILE_BUCKET,
          **device_profile(torch, lambda: prefill(**arrays), top_other=8)})
    del eng, prefill
    gc.collect()
    torch.cuda.empty_cache()

    int8_rc = rc.replace_policy(int8_prefill=True)
    paged = ("fused_vq_matmul", "flash_decode_paged", "dequant_gemv")
    runs = {"paged": ({"paged": True, "block_size": BLOCK,
                       "prefill_chunk": PREFILL_CHUNK}, paged),
            "split": ({}, SPLIT_REQUIRED + ("flash_decode",)),
            "int8_prefill": ({}, WHISPER_REQUIRED + ("int8_gemm",), int8_rc)}
    sub, _ = sub_runs(torch, model, params, rc, prompts, MAX_LEN, name, runs,
                      WHISPER_PLAIN_REL, tokens={"fp": tokens}, extras=extras)
    assert sub[f"{name}_int8_prefill"]["int8_gemm"] == 2 * len(prompts), \
        sub[f"{name}_int8_prefill"]
    out.update(sub)

    snapshot_restored(torch, model, params, rc, ecfg, prompts, tokens, name,
                      extras=extras)
    refusals(torch, model, params, rc, ecfg, name,
             "speculate_k > 0 requires family='dense'")
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    serve_cli(torch, ["--arch", "whisper-medium", "--full"])
    phase_seconds(name, t_phase)
    return out


def vision_linears(cfg):
    """(name, K, N, times a decode step, times a prefill, rows in prefill)
    of every VQ linear llama-3.2-vision-11b runs, one entry a shape: the
    self layers' wqkv; wo, the cross wq and the cross wo of one shape
    (D x D); gu and down of every layer (4 a self layer and 4 a cross
    layer in decode: 160 a step), each also a prefill linear at the
    prompt's rows; the cross wk and wv at the image's VISION_IMG rows
    (prefill only: 176 a prompt)."""
    D, F = cfg.d_model, cfg.d_ff
    G = cfg.num_layers // cfg.cross_attn_period
    S = cfg.num_layers - G
    return (("wqkv", D, cfg.q_dim + 2 * cfg.kv_dim, S, S, "prompt"),
            ("wo|cross_wq|cross_wo", D, D, S + 2 * G, S + 2 * G, "prompt"),
            ("gu", D, 2 * F, S + G, S + G, "prompt"),
            ("down", F, D, S + G, S + G, "prompt"),
            ("cross_wk|cross_wv", D, cfg.kv_dim, 0, 2 * G, "image"))


def check_vision_linears(torch, gen, record):
    """llama-3.2-vision-11b's kernels at its shapes: B1 at its decode
    linears (M = SLOTS) with its launch shape and the split pair B4 and
    B5 (``check_split``) at each; B3 at its prefill linears of a
    VISION_B3_T-token prompt and at the cross wk/wv of VISION_IMG image
    rows (bf16 x), each against its plain version beside fp32 and bf16
    torch.matmul on the dequantized weight; and B6 at the dense linears an
    INT8 prefill runs: img_proj at VISION_IMG rows and the head (N =
    128256) at VISION_B3_T, bit-equal to the plain version, beside
    torch._int_mm with the same scales. B2 runs at llama3-8b's shapes
    (hd 128, g = 4), whose rows the grouped-heads check holds."""
    from repro_torch.configs import get_config
    from repro_torch.core.vq import synthetic_vq

    cfg = get_config(VISION)
    for name, K, N, per_step, per_prefill, rows in vision_linears(cfg):
        vq = synthetic_vq(gen, K, N, C=2, device="cuda")
        case = {"model": VISION, "linear": name}
        if per_step:
            check_b1(torch, record, vq, torch.randn(
                (SLOTS, K), generator=gen, device="cuda"),
                {**case, "per_step": per_step}, launch_shape=True)
        M = VISION_B3_T if rows == "prompt" else VISION_IMG
        check_b3(torch, record, vq, torch.randn(
            (M, K), generator=gen, device="cuda").bfloat16(),
            {**case, "per_prefill": per_prefill})
        del vq
        if per_step:
            check_split(torch, gen, record, K, N, SLOTS,
                        {**case, "per_step": per_step}, pair=True)

    # B6: the dense linears of an INT8 prefill
    check_b6(torch, gen, record, VISION, "img_proj", VISION_IMG, cfg.d_model,
             cfg.d_model)
    check_b6(torch, gen, record, VISION, "lm_head", VISION_B3_T, cfg.d_model,
             cfg.padded_vocab)


def serve_vision(torch):
    """Phase 13: llama-3.2-vision-11b (8 groups of four self layers and
    one gated cross-attention layer over one image of VISION_IMG patch
    embeddings, drawn on the card (a shared row plus VISION_PATCH_NOISE
    a patch) and given to the engine as its extras,
    projected by every request's prefill; the self-attention caches
    beside VISION_IMG-row image memories that a prefill writes once and
    decode only reads) at full width and VISION_LAYERS of its 40 layers
    (the run's time limit, since PR 30), 2-bit VQ weights
    drawn on the card from their shapes with the cross layers' gates set
    to VISION_GATES (zero at init: the image would change nothing), bf16
    activations, a dense bf16 head; serve's traffic (4 slots, max_len
    MAX_LEN, 8 greedy requests of 32-200 prompt tokens, MAX_NEW each)
    through the graphed engine: the weights' bytes against bf16 dense,
    the image memories' and the self cache's bytes, peak memory, decode
    ms a step, tok/s, prefill s, the launches (B1 4 a layer and B2 one a
    self layer a replayed step, B3 4 a layer and 2 a cross layer a
    prefill: 160, 32 and 176 at 40 layers), the caches after the decode
    graph's build as init_cache made them (``xlen`` VISION_IMG); the
    engine's
    checks (``engine_checks``: the bf16 plain step within
    VISION_PLAIN_REL with three faulty controls, the third the memories
    zeroed, fp32 within 1e-3, graph_step over the self caches and the
    memories), a replayed decode step's and a replayed PROFILE_BUCKET-
    token prefill's device time with the "other" kernels that take the
    most; then on the same weights (``sub_runs``): the paged engine (B2's
    paged entry) with the contiguous run's tokens exactly, the paged
    engine with prefill_chunk PREFILL_CHUNK (each chunk re-projects the
    image) with chunks above 0 and its decode step after a chunked
    prefill held to the one-shot one (``chunk_step``), the split-pinned
    planner (B4 + B5) with its token agreement
    and its step held to the fused one, INT8 prefill (B6 at img_proj and
    the head: 2 a prefill); a snapshot mid-run restored into a fresh
    engine (tokens equal); kv_bits = 4 and speculate_k = 3 refused with
    the reference's messages; and the CLI at full width. Returns each
    run's launches."""
    import gc

    import numpy as np
    from repro_torch.core.plan import PlanPolicy
    from repro_torch.models import RunConfig
    from repro_torch.models.vision import N_IMG_TOKENS
    from repro_torch.serve import Engine, EngineConfig, cache_bytes
    from repro_torch.serve.graphs import tensor_leaves

    t_phase = time.perf_counter()
    name = f"serve_{VISION}"
    rc = RunConfig(plan_policy=PlanPolicy(vq_mode="none", impl="cuda"))
    torch.cuda.reset_peak_memory_stats()
    model, params, prompts = build_weights(torch, VISION,
                                           reduced(VISION, VISION_LAYERS))
    cfg = model.cfg
    for g in params["groups"]:
        g["cross"]["attn_gate"].fill_(VISION_GATES[0])
        g["cross"]["mlp_gate"].fill_(VISION_GATES[1])
    wb = weight_bytes(torch, params)
    # 4.33 GB at 40 layers, 3.23 at 20
    assert 3.0e9 < wb["weight_bytes_on_card"] < 3.5e9, wb
    lin = vision_linears(cfg)
    b1_step = sum(ln[3] for ln in lin)
    b3_prefill = sum(ln[4] for ln in lin)
    # 160 and 176 at 40 layers: 4 a layer, and 2 (wk, wv) a cross layer
    assert b1_step == 4 * cfg.num_layers and b3_prefill == \
        wb["vq_linears"] == b1_step + 2 * (cfg.num_layers
                                           // cfg.cross_attn_period), \
        (b1_step, b3_prefill, wb)
    n_self = cfg.num_layers - cfg.num_layers // cfg.cross_attn_period
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    shared = torch.randn((1, cfg.d_model), generator=gen, device="cuda")
    extras = {"image_embeds": shared + VISION_PATCH_NOISE * torch.randn(
        (VISION_IMG, cfg.d_model), generator=gen, device="cuda")}
    ecfg = EngineConfig(num_slots=SLOTS, max_len=MAX_LEN)
    fresh = model.init_cache(SLOTS, MAX_LEN, device="cuda")
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)
    sizes = {"image_memory_bytes": nbytes(tensor_leaves(fresh["cross"])),
             "self_cache_bytes": nbytes(tensor_leaves(
                 {n: c for n, c in fresh.items() if n != "cross"})),
             "image_rows": VISION_IMG, "gates": VISION_GATES}

    t0 = time.perf_counter()
    eng = Engine(model, params, rc, ecfg, extras, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    assert all(torch.equal(t, f) for t, f in zip(
        tensor_leaves(eng.caches), tensor_leaves(fresh))), \
        f"{name}: the decode graph's build left the caches written"
    assert bool((eng.caches["cross"]["xlen"] == N_IMG_TOKENS).all())
    del fresh
    outs, launches, wall = drain(torch, eng, prompts)
    m = eng.metrics()
    tokens = {"tokens": [list(o.tokens) for o in outs]}
    emit({"phase": name, **wb, **sizes, "layers": cfg.num_layers,
          "peak_device_bytes": torch.cuda.max_memory_allocated(),
          "cache_bytes": cache_bytes(eng.caches),
          "requests": len(prompts), "slots": SLOTS, "max_len": MAX_LEN,
          "engine_build_s": build_s,
          "decode_graph_build_s": eng.decode_graph.build_s,
          "decode_graph_pool_bytes": pool_bytes(
              torch, eng.decode_graph.graph.pool()),
          "prefill_graph_pool_bytes": pool_bytes(torch, eng.prefill_pool),
          "wall_s": wall, "tokens_generated": m["tokens_generated"],
          "tok_per_s": m["tokens_generated"] / wall,
          "decode_steps": m["decode_steps"],
          "decode_ms_per_step": m["decode_s"] * 1e3 / m["decode_steps"],
          "prefill_s": m["prefill_s"],
          "prefill_build_s": sum(g.build_s
                                 for g in eng.prefill_graphs.values()),
          "prefill_s_by_prompt_len": {len(p): o.prefill_s
                                      for o, p in zip(outs, prompts)},
          "decode_launches_per_step": eng.decode_graph.launches,
          "trace_counts": eng.trace_counts, "launches": launches})
    missing = [k for k in VISION_REQUIRED if launches[k] == 0]
    assert not missing, f"{name}: kernels never launched on its path: " \
                        f"{missing}"
    ran = [k for k in MOE_ABSENT if launches[k] and k not in VISION_REQUIRED]
    assert not ran, f"{name}: kernels off its path launched: {ran}"
    dl = eng.decode_graph.launches
    assert dl["fused_vq_matmul"] == b1_step and \
        dl["flash_decode"] == n_self, dl
    assert launches["dequant_gemv"] == b3_prefill * len(prompts), launches
    out = {name: launches}

    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    toks = torch.randint(0, cfg.vocab_size, (SLOTS, 64), generator=gen,
                         device="cuda", dtype=torch.int32)
    engine_checks(torch, model, eng, toks, name, VISION_REQUIRED,
                  rel=VISION_PLAIN_REL, fp32_plain=True,
                  eager_profiles=False,
                  control_names=("position_minus_1", "next_token_id",
                                 "memories_zeroed"))
    tok = toks[:, -1:].cpu().numpy()
    pos = np.full((SLOTS, 1), 64, np.int32)
    emit({"phase": f"{name}_replay_profile", **device_profile(
        torch, lambda: eng.decode_graph(tokens=tok, positions=pos),
        top_other=16)})
    # a prefill replay's "other" (the image projection and the cross
    # layers' plain attention over the image), by kernel
    arrays = step_inputs(eng, PROFILE_BUCKET, np.random.default_rng(SEED + 4))
    prefill = eng.prefill_graph(PROFILE_BUCKET)
    emit({"phase": f"{name}_prefill_replay_profile", "bucket": PROFILE_BUCKET,
          **device_profile(torch, lambda: prefill(**arrays), top_other=8)})
    del eng, prefill
    gc.collect()
    torch.cuda.empty_cache()

    int8_rc = rc.replace_policy(int8_prefill=True)
    paged = ("fused_vq_matmul", "flash_decode_paged", "dequant_gemv")
    # the chunks' linears run B3 at another M than a one-shot prefill
    # (other K splits), so a chunked run differs from the contiguous one
    # by rounding: the paged run without chunks must give its tokens
    # exactly, the chunked run is held by chunk_step
    runs = {"paged": ({"paged": True, "block_size": BLOCK}, paged),
            "chunk": ({"paged": True, "block_size": BLOCK,
                       "prefill_chunk": PREFILL_CHUNK}, paged),
            "split": ({}, SPLIT_REQUIRED + ("flash_decode",)),
            "int8_prefill": ({}, VISION_REQUIRED + ("int8_gemm",), int8_rc)}
    sub, _ = sub_runs(torch, model, params, rc, prompts, MAX_LEN, name, runs,
                      VISION_PLAIN_REL, tokens={"fp": tokens}, extras=extras)
    assert sub[f"{name}_int8_prefill"]["int8_gemm"] == 2 * len(prompts), \
        sub[f"{name}_int8_prefill"]
    out.update(sub)

    snapshot_restored(torch, model, params, rc, ecfg, prompts, tokens, name,
                      extras=extras)
    refusals(torch, model, params, rc, ecfg, name,
             "speculate_k > 0 requires family='dense'")
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    serve_cli(torch, ["--arch", "llama-3.2-vision-11b", "--full"])
    phase_seconds(name, t_phase)
    return out


def fit_errors(torch, dense, params):
    """Relative reconstruction error of every fitted block linear against
    its dense weight (a grouped family against its members side by side),
    mean and max over the layers, by linear."""
    from repro_torch.core.vq import reconstruction_error

    members = {"wqkv": ("attn", ("wq", "wk", "wv")), "wo": ("attn", ("wo",)),
               "gu": ("mlp", ("gate", "up")), "down": ("mlp", ("down",))}
    errs = {k: [] for k in members}
    for lp, dp in zip(params["layers"], dense["layers"]):
        for kind, (block, names) in members.items():
            w = torch.cat([dp[block][n]["w"] for n in names], dim=-1)
            errs[kind].append(reconstruction_error(w, lp[block][kind]["vq"])
                              .item())
            del w
    return {k: {"mean": sum(v) / len(v), "max": max(v)}
            for k, v in errs.items()}


def kv_layout_runs(torch, model, runs, toks, steps):
    """``steps`` decode steps from one prefill of ``toks`` (SLOTS, n) over
    each of ``runs`` ({label: (params, rc, encode)}: the prefill cache
    quantized by ``encode``; the first run's greedy tokens every later
    run is fed),
    contiguous caches of max_len MAX_LEN. Returns {label: (the steps'
    logits (steps, SLOTS, vocab), the cache after, its bytes)}."""
    from repro_torch.serve import cache_bytes, pad_prefill_cache

    n, vocab = toks.shape[1], model.cfg.vocab_size
    out, fed = {}, None
    for label, (params, rc, encode) in runs.items():
        with torch.no_grad():
            _, cache = model.prefill(params, {"tokens": toks}, rc)
            cache = pad_prefill_cache(encode(cache), MAX_LEN)
            tok, logits = toks[:, -1:], []
            for i in range(steps):
                pos = torch.full((SLOTS, 1), n + i, dtype=torch.int32,
                                 device="cuda")
                step, cache = model.decode(params, tok, pos, cache, rc)
                logits.append(step[:, 0, :vocab].float())
                tok = (step[:, :, :vocab].argmax(-1).to(torch.int32)
                       if fed is None else fed[i])
            if fed is None:
                fed = [l.argmax(-1, keepdim=True).to(torch.int32)
                       for l in logits]
        out[label] = (torch.stack(logits), cache, cache_bytes(cache))
    return out


def drift_from(got, want) -> dict:
    """Max |got - want| over every step, relative to max |want|, and the
    share of greedy choices that agree."""
    return {"rel_drift": ((got - want).abs().max()
                          / want.abs().max()).item(),
            "argmax_agreement": (got.argmax(-1) == want.argmax(-1))
            .float().mean().item()}


def serve_fit(torch):
    """Phase 14, `serve_llama2_7b_fit`: llama2-7b at full width, cut to
    FIT_LAYERS of its 32 layers (the run's time limit), FITTED on the
    card. Its dense block weights (3.24 G at 16 layers, fp32) are drawn
    on the card from SEED and quantized there by k-means
    (``Model.quantize(method="fit")``): the seconds, the peak device
    bytes, bits a weight and each linear's relative reconstruction error
    (mean and max over the layers). `serve`'s traffic through the
    graphed engine (B1, B2, B3; ``serve_phase``: replays bitwise equal to
    the eager steps, the plain ``impl="torch"`` step within PLAIN_REL);
    the same model dense in bf16 served beside it: its greedy token
    agreement and the first decode step's drift (random weights: printed,
    not bounded). On the same params through ``Model.prefill`` /
    ``Model.decode``: the int4 cache (``quantize_prefill_cache_int8(...,
    int4=True)``) FIT_KV_STEPS steps contiguous and paged (a shuffled
    table; the logits bitwise equal), beside the int8 and fp caches: each
    cache's bytes and drift from the fp cache. Last, KV-VQ codebooks
    calibrated (``calibrate_kv_codebooks``) on CALIB_ROWS x CALIB_LEN
    tokens: the seconds, the drift of the calibrated and of the grid
    codebooks from the fp cache, and the engine at kv_bits 4 with the
    calibrated codebooks (B7 must launch). Returns its runs' launches."""
    import functools
    import gc

    import numpy as np
    from repro_torch.core.plan import PlanPolicy
    from repro_torch.core.quantize import (attach_kv_codebooks,
                                           calibrate_kv_codebooks,
                                           kv_codebook_tree)
    from repro_torch.core.vq import KVQuantConfig
    from repro_torch.models import RunConfig, build_model
    from repro_torch.serve import Engine, EngineConfig, paging
    from repro_torch.serve.kvcache import (encode_prefill_cache,
                                           quantize_prefill_cache_int8)

    t_phase = time.perf_counter()
    name = f"serve_{FIT}_fit"
    cfg = reduced(FIT, FIT_LAYERS)
    model = build_model(cfg)
    rc = RunConfig(plan_policy=PlanPolicy(vq_mode="none", impl="cuda"))
    ecfg = EngineConfig(num_slots=SLOTS, max_len=MAX_LEN)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dense = model.init(gen, device="cuda")
    torch.cuda.synchronize()
    init_s, t0 = time.perf_counter() - t0, time.perf_counter()
    params = model.quantize(dense, generator=gen, device="cuda")
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    errors = fit_errors(torch, dense, params)
    vq = params["layers"][0]["attn"]["wqkv"]["vq"]
    emit({"phase": name, "dense_init_s": init_s, "fit_s": fit_s,
          "fit_peak_device_bytes": peak,
          "bits_per_weight": vq.bits_per_weight, "rel_error": errors,
          "dense_block_params": sum(
              t.numel() for lp in dense["layers"] for blk in lp.values()
              for node in blk.values() if isinstance(node, dict)
              for t in node.values()),
          **weight_bytes(torch, params)})
    assert vq.bits_per_weight == 2.0
    assert all(0 < e["mean"] <= e["max"] < 1 for e in errors.values()), errors
    # the same model dense, its weights in bf16 as a served model's
    bf16 = lambda t: (t.to(torch.bfloat16)
                      if t.dtype == torch.float32 and t.dim() >= 2 else t)
    def tree_map(fn, t):
        if isinstance(t, dict):
            return {k: tree_map(fn, v) for k, v in t.items()}
        return [tree_map(fn, v) for v in t] if isinstance(t, list) else fn(t)

    dense = tree_map(bf16, dense)
    gc.collect()
    torch.cuda.empty_cache()
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(32, 201, N_REQUESTS)]
    phase_seconds(f"{name} (weights and fit)", t_phase)

    fitted = serve_phase(torch, model, params, prompts, name, rc, ecfg,
                         ("fused_vq_matmul", "flash_decode", "dequant_gemv"),
                         eager_profiles=False)
    t0 = time.perf_counter()
    eng = Engine(model, dense, rc, ecfg, device="cuda")
    outs, _, wall = drain(torch, eng, prompts)
    del eng
    toks = torch.tensor(np.stack([p[:64] for p in prompts[:SLOTS]]),
                        dtype=torch.int32, device="cuda")
    runs = kv_layout_runs(torch, model, {
        "dense": (dense, rc, lambda c: c),
        "fitted": (params, rc, lambda c: c)}, toks, 1)
    emit({"phase": f"{name}_vs_dense", "dense_wall_s": wall,
          "greedy_token_agreement": agreement(
              fitted, {"tokens": [list(o.tokens) for o in outs]}),
          "first_step": drift_from(runs["fitted"][0], runs["dense"][0])})
    del dense, runs, outs
    gc.collect()
    torch.cuda.empty_cache()
    phase_seconds(f"{name}_vs_dense", t0)

    # the int4 cache on the fitted params, beside int8 and fp
    t0 = time.perf_counter()
    int4 = functools.partial(quantize_prefill_cache_int8, int4=True)
    runs = kv_layout_runs(torch, model, {
        "fp": (params, rc, lambda c: c),
        "int8": (params, rc, quantize_prefill_cache_int8),
        "int4": (params, rc, int4)}, toks, FIT_KV_STEPS)
    # paged: the fp prefill's int4 rows written through a shuffled table,
    # then the same steps on the same tokens
    meta = paging.make_paging_config(model, SLOTS, MAX_LEN, block_size=BLOCK,
                                     kv_int4=True)
    paged = model.init_cache(SLOTS, MAX_LEN, device="cuda", paging=meta,
                             kv_int4=True)
    perm = torch.randperm(meta.num_blocks, generator=torch.Generator(
        device="cuda").manual_seed(SEED + 9), device="cuda")
    tables = perm.reshape(SLOTS, meta.blocks_per_slot).cpu().numpy()
    n = toks.shape[1]
    with torch.no_grad():
        _, fresh = model.prefill(params, {"tokens": toks}, rc)
        fresh = int4(fresh)
        for b in range(SLOTS):
            paging.write_prefill_into_blocks(
                paged, map_cache(lambda t: t[:, b:b + 1], fresh),
                torch.tensor([b], device="cuda"),
                torch.from_numpy(tables[b]).to("cuda"),
                torch.tensor([n], dtype=torch.int32, device="cuda"), meta)
        paging.set_block_tables(paged, tables)
        fed = runs["fp"][0].argmax(-1).to(torch.int32)       # (steps, SLOTS)
        tok, same = toks[:, -1:], True
        for i in range(FIT_KV_STEPS):
            pos = torch.full((SLOTS, 1), n + i, dtype=torch.int32,
                             device="cuda")
            step, paged = model.decode(params, tok, pos, paged, rc)
            same &= bool(torch.equal(step[:, 0, :cfg.vocab_size].float(),
                                     runs["int4"][0][i]))
            tok = fed[i][:, None]
    row = {"phase": f"{name}_kv_int4", "steps": FIT_KV_STEPS,
           "paged_equals_contiguous": same,
           "bytes_per_block": meta.bytes_per_block,
           "cache_bytes": {k: v[2] for k, v in runs.items()},
           # the k and v leaves alone (the int8 and int4 caches share
           # their bf16 scale leaves)
           "value_bytes": {k: sum(v[1]["body"][n].numel()
                                  * v[1]["body"][n].element_size()
                                  for n in ("k", "v"))
                           for k, v in runs.items()},
           **{f"{k}_vs_fp": drift_from(v[0], runs["fp"][0])
              for k, v in runs.items() if k != "fp"}}
    emit(row)
    assert same, row
    assert 2 * row["value_bytes"]["int4"] == row["value_bytes"]["int8"], row
    del runs, paged, fresh
    phase_seconds(f"{name}_kv_int4", t0)

    # KV-VQ codebooks calibrated on the fitted model, against the grid's
    t0 = time.perf_counter()
    kvq = KVQuantConfig(kv_bits=4)
    batch = {"tokens": torch.randint(
        0, cfg.vocab_size, (CALIB_ROWS, CALIB_LEN), device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(SEED + 7),
        dtype=torch.int32)}
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    calibrated = calibrate_kv_codebooks(
        model, params, batch, kvq,
        generator=torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t1
    with_cb = {"grid": attach_kv_codebooks(params, cfg, kvq),
               "calibrated": attach_kv_codebooks(params, cfg, kvq,
                                                 codebooks=calibrated)}
    kv_rc = rc.replace(kv_vq=kvq)
    runs = kv_layout_runs(torch, model, {
        "fp": (params, rc, lambda c: c),
        **{k: (p, kv_rc, functools.partial(
            encode_prefill_cache, codebooks=kv_codebook_tree(p), kvq=kvq))
           for k, p in with_cb.items()}}, toks, FIT_KV_STEPS)
    kv_eng = Engine(model, with_cb["calibrated"], rc,
                    dataclasses.replace(ecfg, kv_bits=4), device="cuda")
    outs, launches, wall = drain(torch, kv_eng, prompts)
    emit({"phase": f"{name}_kvq_calibrated", "calibrate_s": calib_s,
          "calibration_tokens": [CALIB_ROWS, CALIB_LEN],
          "codebooks": {k: list(v.shape)
                        for k, v in calibrated["body"].items()},
          **{f"{k}_vs_fp": drift_from(v[0], runs["fp"][0])
             for k, v in runs.items() if k != "fp"},
          "wall_s": wall, "launches": launches,
          "greedy_token_agreement_with_fp": agreement(
              fitted, {"tokens": [list(o.tokens) for o in outs]})})
    assert launches["flash_decode_kvq"] > 0 and \
        launches["fused_vq_matmul"] > 0, launches
    del kv_eng, runs, with_cb, params, model
    gc.collect()
    torch.cuda.empty_cache()
    phase_seconds(f"{name}_kvq_calibrated", t0)
    phase_seconds(f"{name} (+ fit, dense, int4, calibrated)", t_phase)
    return {name: fitted["launches"], f"{name}_kvq_calibrated": launches}


def train_flops(cfg, params, batch, seq, remat) -> float:
    """Operations of one train step: 6 N per token (N every param, the
    embedding and the head included), the attention's score and value
    products over the full S x S square that ``blocked_attention``
    visits (forward 4 B H S^2 hd a layer, backward twice that), and with
    ``remat`` the attention forward once more (the linears' outputs are
    kept, ``common.remat_layer``)."""
    from repro_torch.models.api import param_count

    attn = 4 * batch * cfg.num_heads * seq * seq * cfg.head_dim \
        * cfg.num_layers
    return 6 * param_count(params) * batch * seq + 3 * attn \
        + (attn if remat else 0)


def step_profile(torch, run) -> dict:
    """One call of ``run`` (a train step) under torch.profiler (device
    activity): its host wall, the device's busy ms (the kernels on the
    one stream) and the idle share."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = sum(ev.time_range.elapsed_us() for ev in prof.events()
               if ev.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    return {"wall_ms": wall, "device_busy_ms": busy,
            "idle_share": 1 - busy / wall if busy else None}


def restart_identity() -> None:
    """`train_qwen3_0_6b_restart`: ``launch.train.train`` of the SMOKE
    config (RESTART_STEPS steps, a checkpoint every 4) with one injected
    failure at RESTART_FAIL, restarted from its checkpoint, against the
    same run uninterrupted, under ``torch.use_deterministic_algorithms``
    (the embedding's and ``gather``'s backward otherwise add with float
    atomics): the losses and the final params must be equal exactly. Run
    by ``train_qwen3`` in a process of its own with
    ``CUBLAS_WORKSPACE_CONFIG`` set; raises on a failed check, an op of
    the step without a deterministic CUDA version included."""
    import tempfile

    import torch
    from repro_torch.checkpoint import flatten_with_paths
    from repro_torch.launch.train import train

    t0 = time.perf_counter()
    kw = dict(smoke=True, steps=RESTART_STEPS, seq_len=64, global_batch=8,
              lr=3e-3, ckpt_every=4, log_every=0, device="cuda")
    torch.use_deterministic_algorithms(True)
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        runs = {label: train(TRAIN, ckpt_dir=f"{d}/{label}", fail_at=fail,
                             **kw)
                for label, fail in (("uninterrupted", None),
                                    ("restarted", RESTART_FAIL))}
    a, b = (dict(flatten_with_paths(runs[k]["params"]))
            for k in ("uninterrupted", "restarted"))
    exact = (runs["restarted"]["losses"] == runs["uninterrupted"]["losses"]
             and a.keys() == b.keys()
             and all(torch.equal(a[k], b[k]) for k in a))
    emit({"phase": "train_qwen3_0_6b_restart", "deterministic": True,
          "restarts": runs["restarted"]["restarts"],
          "losses": {k: [r["losses"][s] for s in sorted(r["losses"])]
                     for k, r in runs.items()},
          "exact": exact, "seconds": time.perf_counter() - t0})
    assert runs["restarted"]["restarts"] == 1
    assert exact


def train_step_vs_plain(torch, cfg=None, device="cuda") -> dict:
    """`train_qwen3_0_6b_step`: the train step itself held against a
    plain computation. qwen3-0.6b at full width cut to STEP_LAYERS layers
    (or ``cfg``), params drawn on ``device`` from SEED: one
    ``launch.steps.make_train_step`` step there (bf16 activations, remat
    on, as the main path) and its gradients by autograd, against the same
    params copied to the CPU and run at fp32 with remat off: the step's
    loss within STEP_LOSS_REL, its gnorm and every gradient leaf within
    STEP_GRAD_REL (relative L2 distance). The affine task's falling loss
    shows only that the embedding and the head learn which ids occur; a
    layer whose gradient is dropped or wrong fails here."""
    from repro_torch.checkpoint import flatten_with_paths
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, global_batch_at
    from repro_torch.launch.steps import make_train_step, value_and_grad
    from repro_torch.launch.train import device_batch
    from repro_torch.models import RunConfig, build_model
    from repro_torch.optim import (AdamWConfig, adamw_init, global_norm,
                                   map_leaves)

    t0 = time.perf_counter()
    cfg = cfg or dataclasses.replace(get_config(TRAIN),
                                     num_layers=STEP_LAYERS)
    model = build_model(cfg)
    rc = RunConfig(mode="train", remat=True, attn_chunk=STEP_SEQ)
    ocfg = AdamWConfig(lr=TRAIN_LR)
    params = model.init(torch.Generator(device=device).manual_seed(SEED),
                        device=device)
    batch = global_batch_at(DataConfig(vocab_size=cfg.vocab_size,
                                       seq_len=STEP_SEQ,
                                       global_batch=STEP_BATCH), 0)
    on_dev = device_batch(batch, device)
    step = make_train_step(model, ocfg, rc, total_steps=TRAIN_STEPS,
                           warmup=1)
    _, _, met = step(params, adamw_init(params, ocfg), on_dev)
    _, grads = value_and_grad(model, params, on_dev, rc)
    plain = build_model(dataclasses.replace(cfg, dtype="float32"))
    cpu = map_leaves(lambda x: x.detach().cpu(), params)
    del params
    loss, want = value_and_grad(plain, cpu, device_batch(batch, "cpu"),
                                rc.replace(remat=False))
    got = dict(flatten_with_paths(grads))
    rel = {}
    for k, w in flatten_with_paths(want):
        g = got[k].float().cpu()
        rel[k] = ((g - w).norm() / w.norm()).item() if w.norm() > 0 \
            else g.norm().item()
    worst = max(rel, key=rel.get)
    row = {"phase": "train_qwen3_0_6b_step", "layers": cfg.num_layers,
           "d_model": cfg.d_model, "vocab": cfg.vocab_size,
           "tokens": STEP_BATCH * STEP_SEQ,
           "loss": [met["loss"].item(), loss.item()],
           "gnorm": [met["gnorm"].item(), global_norm(want).item()],
           "leaves": len(rel), "max_grad_rel": rel[worst],
           "worst_leaf": worst, "median_grad_rel": statistics.median(
               rel.values()),
           "bounds": {"loss_rel": STEP_LOSS_REL, "grad_rel": STEP_GRAD_REL},
           "seconds": time.perf_counter() - t0}
    emit(row)
    (l_dev, l_cpu), (n_dev, n_cpu) = row["loss"], row["gnorm"]
    assert abs(l_dev - l_cpu) <= STEP_LOSS_REL * abs(l_cpu), row["loss"]
    assert abs(n_dev - n_cpu) <= STEP_GRAD_REL * n_cpu, row["gnorm"]
    assert rel[worst] <= STEP_GRAD_REL, (worst, rel[worst])
    return row


def _wait(proc, t0, timeout):
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
    return proc.returncode, out, err, time.perf_counter() - t0


def start_beside(cmds: dict, timeout: float = 600):
    """Start every ``name: (argv, env)`` of ``cmds`` at once from the
    repo's root, each drained by a thread of its own and killed past
    ``timeout``: (the processes, and futures of their (returncode,
    stdout, stderr, seconds))."""
    from concurrent.futures import ThreadPoolExecutor

    pool = ThreadPoolExecutor(len(cmds))
    procs, futs = {}, {}
    for k, (argv, env) in cmds.items():
        t0 = time.perf_counter()
        procs[k] = subprocess.Popen(argv, cwd=ROOT, env=env, text=True,
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE)
        futs[k] = pool.submit(_wait, procs[k], t0, timeout)
    pool.shutdown(wait=False)
    return procs, futs


def train_qwen3(torch):
    """Phase 15, `train_qwen3_0_6b`: training, then the trained model
    fitted and served. qwen3-0.6b at full width and depth (28 layers, d
    1024, untied head, vocab 151936), params drawn on the card from SEED
    in fp32, bf16 activations; AdamW (lr TRAIN_LR) under warmup_cosine,
    remat on, the affine task over TRAIN_DATA_VOCAB token ids,
    TRAIN_BATCH x TRAIN_SEQ tokens a step,
    TRAIN_STEPS steps through ``launch.steps.make_train_step``: the loss
    at every step, the median step ms, tokens/s, the shares of the fp32
    and bf16 peaks and of the mixed bound of ``train_flops``, the peak
    device bytes, one profiled step's idle share, and one step's peak
    with remat off. The loss must be finite and fall below 0.95x the
    first (the reference's rule). Then: the trained params and AdamW
    state saved and restored at full width (bitwise; bytes and seconds);
    ``train_step_vs_plain``, while two processes run beside it:
    ``launch.train.train`` with ``fail_at`` restarted from its
    checkpoint against an uninterrupted run (SMOKE config, 10 steps,
    ``restart_identity``) under ``torch.use_deterministic_algorithms``:
    losses and final params equal exactly; and the training CLI; then
    the trained params fitted to 2-bit VQ
    (``quantize(method="fit")``) and served (8 affine prompts, 4 slots,
    greedy, MAX_NEW tokens) through the engine, B1, B2 and B3 required,
    beside the dense model: the share of generated tokens that follow
    the affine rule, their greedy agreement, and the dense and VQ losses
    on the held-out batch under the reference's three conditions.
    Returns the served run's launches."""
    import gc
    import statistics as stats
    import tempfile

    import numpy as np
    from repro_torch.checkpoint import CheckpointManager, flatten_with_paths
    from repro_torch.core.plan import PlanPolicy
    from repro_torch.data import DataPipeline, global_batch_at
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import build_trainer, device_batch
    from repro_torch.models import RunConfig
    from repro_torch.models.api import param_count
    from repro_torch.optim import adamw_init
    from repro_torch.serve import Engine, EngineConfig

    name = "train_qwen3_0_6b"
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    model, _, rc, ocfg, dcfg = build_trainer(
        TRAIN, smoke=False, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
        lr=TRAIN_LR)
    cfg = model.cfg
    dcfg = dataclasses.replace(dcfg, vocab_size=TRAIN_DATA_VOCAB)
    sched = dict(total_steps=TRAIN_STEPS, warmup=max(TRAIN_STEPS // 10, 1))
    step = make_train_step(model, ocfg, rc, **sched)
    torch.cuda.reset_peak_memory_stats()
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED),
                        device="cuda")
    opt = adamw_init(params, ocfg)
    n_params = param_count(params)
    state_bytes = torch.cuda.memory_allocated()
    pipe = DataPipeline(dcfg)
    losses, times = [], []
    try:
        for i in range(TRAIN_STEPS):
            batch = device_batch(next(pipe), "cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, met = step(params, opt, batch)
            loss = met["loss"].item()
            times.append(time.perf_counter() - t0)
            losses.append(loss)
            emit({"phase": name, "step": i, "loss": loss,
                  "gnorm": met["gnorm"].item(),
                  "lr_scale": met["lr_scale"].item(), "ms": times[-1] * 1e3})
    finally:
        pipe.close()
    peak = torch.cuda.max_memory_allocated()
    med = stats.median(times[1:])
    flops = train_flops(cfg, params, TRAIN_BATCH, TRAIN_SEQ, rc.remat)
    # the head's product runs in fp32 (fp32 logits; TF32 is off), every
    # other product in bf16 on the tensor cores: the step's bound
    head = 6 * cfg.d_model * cfg.vocab_size * TRAIN_BATCH * TRAIN_SEQ
    mixed_ms = (head / FP32_FLOPS + (flops - head) / BF16_FLOPS) * 1e3
    batch = device_batch(global_batch_at(dcfg, TRAIN_STEPS), "cuda")
    prof = step_profile(torch, lambda: step(params, opt, batch))
    # one step with remat off: its peak (the step's outputs dropped)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    plain = make_train_step(model, ocfg, rc.replace(remat=False), **sched)
    no_remat = {"out_of_memory": False}
    try:
        out = plain(params, opt, batch)
        torch.cuda.synchronize()
        del out
    except torch.cuda.OutOfMemoryError as e:
        no_remat = {"out_of_memory": True, "error": str(e).splitlines()[0]}
    # at an OOM: the peak reached before the allocation that failed
    no_remat["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()
    row = {"phase": name, "params": n_params, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "vocab": cfg.vocab_size,
           "tokens_per_step": TRAIN_BATCH * TRAIN_SEQ, "losses": losses,
           "median_step_ms": med * 1e3, "first_step_ms": times[0] * 1e3,
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / med,
           "step_flops": flops, "fp32_peak_share": flops / med / FP32_FLOPS,
           "bf16_peak_share": flops / med / BF16_FLOPS,
           "mixed_bound_ms": mixed_ms, "mixed_peak_share": mixed_ms / med
           / 1e3,
           "state_bytes": state_bytes, "peak_device_bytes": peak,
           "no_remat_step": no_remat, "data_vocab": dcfg.vocab_size,
           "profiled_step": prof}
    emit(row)
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < 0.95 * losses[0], (losses[0], losses[-1])
    phase_seconds(f"{name} (training)", t_phase)

    # the trained state saved and restored at full width, bit for bit
    t0 = time.perf_counter()
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        mgr = CheckpointManager(d)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        mgr.save(TRAIN_STEPS, {"params": params, "opt": opt}, block=True)
        save_s = time.perf_counter() - t1
        files = Path(d) / f"step_{TRAIN_STEPS:010d}"
        nbytes = sum(f.stat().st_size for f in files.iterdir())
        t1 = time.perf_counter()
        _, back = mgr.restore(device="cuda")
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t1
    want = dict(flatten_with_paths({"params": params, "opt": opt}))
    got = dict(flatten_with_paths(back))
    same = want.keys() == got.keys() and all(
        torch.equal(got[k], want[k]) for k in want if want[k] is not None)
    del back, got, want
    emit({"phase": f"{name}_checkpoint", "bytes": nbytes, "save_s": save_s,
          "restore_s": restore_s, "bitwise": same})
    assert same
    phase_seconds(f"{name}_checkpoint", t0)

    # restarted == uninterrupted (the SMOKE config: exactness, not size)
    # in a process of its own, since cuBLAS's fixed workspaces, which
    # deterministic algorithms need, are read when its first handle is
    # made; and the training CLI (five steps: the reference logs every
    # fifth). Both run beside the step check.
    t0 = time.perf_counter()
    argv = ["--arch", TRAIN, "--full", "--steps", "5", "--seq-len", "256"]
    procs, futs = start_beside({
        "restart": ([sys.executable, "-c",
                     "import chip_smoke; chip_smoke.restart_identity()"],
                    {**os.environ, "CUBLAS_WORKSPACE_CONFIG": ":4096:8"}),
        "cli": ([sys.executable, "-m", "repro_torch.launch.train", *argv],
                {**os.environ, "PYTHONPATH": str(ROOT / "src")})})
    try:
        train_step_vs_plain(torch)
    except BaseException:
        for p in procs.values():
            p.kill()
        raise
    finally:
        done = {k: f.result() for k, f in futs.items()}
        gc.collect()
        torch.cuda.empty_cache()
    code, out, err, secs = done["restart"]
    print(out.strip(), flush=True)
    assert code == 0, f"the restart identity failed\n{err[-3000:]}"
    emit({"phase": f"{name}_restart_process", "seconds": secs})
    code, out, err, secs = done["cli"]
    lines = out.strip().splitlines()
    ok = (code == 0 and len(lines) == 2
          and re.fullmatch(r"step +5 loss \d+\.\d{4} gnorm \d+\.\d{3}",
                           lines[0]) is not None
          and re.fullmatch(r"final loss: \d+\.\d{4} restarts: 0",
                           lines[1]) is not None)
    emit({"phase": f"{name}_cli", "argv": argv, "returncode": code,
          "stdout": lines, "seconds": secs})
    assert ok, f"the training CLI failed: {code}\n{err[-3000:]}"
    phase_seconds(f"{name}_step, _restart and _cli", t0)

    # train -> fit -> serve
    t0 = time.perf_counter()
    del opt
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    qparams = model.quantize(params, generator=torch.Generator(
        device="cuda").manual_seed(SEED + 1), device="cuda")
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t1
    errors = fit_errors(torch, params, qparams)
    held = {k: torch.from_numpy(v).to("cuda")
            for k, v in global_batch_at(dcfg, TRAIN_HELD_OUT).items()}
    with torch.no_grad():
        dense_loss = model.loss(params, held, rc).item()
        vq_loss = model.loss(qparams, held, rc.replace_policy(
            vq_mode="eva")).item()
    # the dense model in bf16, as a served model's weights
    bf16 = lambda t: (t.to(torch.bfloat16)
                      if t.dtype == torch.float32 and t.dim() >= 2 else t)

    def tree_map(fn, t):
        if isinstance(t, dict):
            return {k: tree_map(fn, v) for k, v in t.items()}
        return [tree_map(fn, v) for v in t] if isinstance(t, list) else fn(t)

    dense = tree_map(bf16, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    rng = np.random.default_rng(SEED)
    rows = held["tokens"].cpu().numpy()
    prompts = [rows[i, :int(n)] for i, n in
               enumerate(rng.integers(32, 201, N_REQUESTS))]
    srv = RunConfig(plan_policy=PlanPolicy(vq_mode="none", impl="cuda"))
    ecfg = EngineConfig(num_slots=SLOTS, max_len=MAX_LEN)
    toks = {}
    for label, p in (("vq", qparams), ("dense", dense)):
        eng = Engine(model, p, srv, ecfg, device="cuda")
        outs, counts, wall = drain(torch, eng, prompts)
        toks[label] = [list(o.tokens) for o in outs]
        if label == "vq":
            launches, vq_wall = counts, wall
        del eng
        gc.collect()
        torch.cuda.empty_cache()

    def affine_share(streams):
        hit = n = 0
        for prompt, out in zip(prompts, streams):
            prev = [int(prompt[-1])] + out[:-1]
            hit += sum((31 * a + 17) % dcfg.vocab_size == b
                       for a, b in zip(prev, out))
            n += len(out)
        return hit / n

    row = {"phase": f"{name}_fit_serve", "fit_s": fit_s,
           "rel_error": errors,
           "mean_rel_error": sum(e["mean"] for e in errors.values())
           / len(errors),
           "dense_loss": dense_loss, "vq_loss": vq_loss,
           "ln_vocab": float(np.log(cfg.vocab_size)),
           "affine_share": {k: affine_share(v) for k, v in toks.items()},
           "greedy_token_agreement": sum(
               x == y for a, b in zip(toks["vq"], toks["dense"])
               for x, y in zip(a, b)) / (N_REQUESTS * MAX_NEW),
           "vq_wall_s": vq_wall, "launches": launches}
    emit(row)
    assert all(launches[k] > 0 for k in ("fused_vq_matmul", "flash_decode",
                                          "dequant_gemv")), launches
    assert np.isfinite(vq_loss) and vq_loss < 1.2 * np.log(cfg.vocab_size)
    assert dense_loss <= vq_loss, (dense_loss, vq_loss)
    del qparams, dense
    gc.collect()
    torch.cuda.empty_cache()
    phase_seconds(f"{name}_fit_serve", t0)
    phase_seconds(name, t_phase)
    return {name: launches}


def pin_split():
    """Pin the default planner to the two-kernel split (a calibration that
    prices eva_fused above eva_split, as serve_split); returns the call
    that puts the planner back."""
    from repro_torch.core import calibrate
    from repro_torch.core import plan as plan_mod

    planner = plan_mod.default_planner()
    before = planner.calibration
    entry = lambda us: calibrate.BackendCalibration(
        overhead_us=us, us_per_mac=0.0, us_per_add=0.0, us_per_byte=0.0,
        rows=calibrate.MIN_FIT_ROWS)
    planner.reload_calibration(calibrate.Calibration(
        calibrate.SCHEMA, "pinned: eva_split below eva_fused",
        {"eva_fused": entry(1e6), "eva_split": entry(1.0)}))
    planner.cache_clear()

    def restore():
        planner.reload_calibration(before)
        planner.cache_clear()

    return restore


def agreement(a, b) -> float:
    """Share of the greedy tokens two serve phases agree on."""
    n = len(a["tokens"])
    same = sum(x == y for i in range(n)
               for x, y in zip(a["tokens"][i], b["tokens"][i]))
    return same / (n * MAX_NEW)


def serve_paged(torch, model, params, prompts, fp, kvq):
    """The paged phases (16-position blocks): `serve_paged` and
    `serve_kvq_paged` with a parity pool (the contiguous cache's 128
    blocks, shared), whose greedy tokens must equal `serve`'s and
    `serve_kvq`'s; `serve_paged_tight` with chunked prefill (64) and a
    pool of TIGHT_BLOCKS, which must preempt and chunk and finish every
    request. On each the contiguous attention kernels must launch 0
    times. Returns each phase's kernel launches."""
    from repro_torch.core.plan import PlanPolicy
    from repro_torch.models import RunConfig
    from repro_torch.serve import EngineConfig

    rc = RunConfig(plan_policy=PlanPolicy(vq_mode="none", impl="cuda"))
    rc_kvq = RunConfig(plan_policy=PlanPolicy(vq_mode="none", impl="cuda",
                                              int8_prefill=True))
    paged = lambda **kw: EngineConfig(num_slots=SLOTS, max_len=MAX_LEN,
                                      paged=True, block_size=BLOCK, **kw)
    contiguous = ("flash_decode", "flash_decode_kvq")
    out = {
        "serve_paged": serve_phase(
            torch, model, params, prompts, "serve_paged", rc, paged(),
            ("fused_vq_matmul", "flash_decode_paged", "dequant_gemv"),
            absent=contiguous),
        "serve_kvq_paged": serve_phase(
            torch, model, params, prompts, "serve_kvq_paged", rc_kvq,
            paged(kv_bits=4), ("fused_vq_matmul", "flash_decode_kvq_paged",
                               "dequant_gemv", "int8_gemm"),
            absent=contiguous),
        "serve_paged_tight": serve_phase(
            torch, model, params, prompts, "serve_paged_tight", rc,
            paged(num_blocks=TIGHT_BLOCKS, prefill_chunk=PREFILL_CHUNK),
            ("fused_vq_matmul", "flash_decode_paged", "dequant_gemv"),
            absent=contiguous)}
    tight = out["serve_paged_tight"]["metrics"]
    emit({"phase": "paged_vs_contiguous",
          "serve_paged_tokens_equal_serve":
              out["serve_paged"]["tokens"] == fp["tokens"],
          "serve_kvq_paged_tokens_equal_serve_kvq":
              out["serve_kvq_paged"]["tokens"] == kvq["tokens"],
          "tight_greedy_token_agreement_with_serve":
              agreement(fp, out["serve_paged_tight"]),
          "tight_num_blocks": TIGHT_BLOCKS,
          "tight_preemptions": tight["preemptions"],
          "tight_prefill_chunks": tight["prefill_chunks"],
          "tight_peak_blocks_in_use": tight["peak_blocks_in_use"],
          "tight_peak_kv_bytes_in_use": tight["peak_kv_bytes_in_use"],
          "serve_kv_bytes_in_use": fp["kv_bytes"]})
    assert out["serve_paged"]["tokens"] == fp["tokens"], "serve_paged != serve"
    assert out["serve_kvq_paged"]["tokens"] == kvq["tokens"], \
        "serve_kvq_paged != serve_kvq"
    assert tight["preemptions"] >= 1 and tight["prefill_chunks"] >= 1, tight
    return out


def calibration(torch, timer, cfg, params):
    """Phase 5: time each decode EVA backend's ``plan.execute`` at the four
    decode linears x M in {1, 2, 4, 8} (eva-bench-rows/v1 rows), fit the
    port's cost model to them and print the choice the fitted model makes
    at every decode site of the served model. The fit is saved under
    build/, never at the default calibration path."""
    from repro_torch.core import calibrate
    from repro_torch.core import plan as plan_mod
    from repro_torch.core.vq import synthetic_vq

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    act = cfg.act_dtype
    policy = plan_mod.PlanPolicy(vq_mode="eva", impl="cuda")
    rows = []
    for name, K, N in LINEARS:
        vq = synthetic_vq(gen, K, N, C=2, device="cuda")
        for M in (1, 2, 4, 8):
            x = torch.randn((M, K), generator=gen, device="cuda").to(act)
            spec = plan_mod.LinearSpec.for_vq(vq, M=M, x_dtype=act,
                                              out_dtype=act)
            plans = plan_mod.candidate_plans(spec, policy)
            for backend in DECODE_BACKENDS:
                pl = plans[backend]
                us = timer(lambda: pl.execute(x, vq)) * 1e3
                # back to back on the host clock: the decode step is
                # host-bound, so the host's cost per call is shown too
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(HOST_REPS):
                    pl.execute(x, vq)
                torch.cuda.synchronize()
                host_us = (time.perf_counter() - t0) * 1e6 / HOST_REPS
                c = pl.cost
                rows.append({
                    "module": "chip_smoke", "name": f"calibration/{name}/M{M}",
                    "us_per_call": us,
                    "derived": {"backend": backend, "plan": pl.describe(),
                                "macs": c.macs, "lookup_adds": c.lookup_adds,
                                "weight_bytes": c.weight_bytes,
                                "intermediate_bytes": c.intermediate_bytes,
                                "launches": c.launches}})
                emit({"phase": "calibration_row", "backend": backend,
                      "linear": name, "M": M, "us_per_call": us,
                      "host_clock_us_per_call": host_us})
        del vq
    fit = calibrate.fit_calibration({"schema": "eva-bench-rows/v1",
                                     "rows": rows},
                                    source="chip_smoke.py calibration phase")
    for backend in DECODE_BACKENDS:
        e = fit.get(backend)
        assert e is not None and e.rows >= calibrate.MIN_FIT_ROWS, backend
        emit({"phase": "calibration_fit", "backend": backend,
              "overhead_us": e.overhead_us, "us_per_mac": e.us_per_mac,
              "us_per_add": e.us_per_add, "us_per_byte": e.us_per_byte,
              "rows": e.rows, "mean_abs_rel_err": e.mean_abs_rel_err})
    planner = plan_mod.Planner(calibration=fit)
    choice = {}
    for path, pl in plan_mod.preplan_params(params, policy, mode="decode",
                                            m=SLOTS, act_dtype=act,
                                            planner=planner):
        if pl.spec.kind == "vq":
            choice.setdefault(path[-1], (pl.backend, pl.provenance,
                                         pl.describe_ranking()))
    emit({"phase": "calibration_choice", "M": SLOTS,
          "sites": {k: {"backend": b, "provenance": p, "ranking": r}
                    for k, (b, p, r) in choice.items()}})
    out = ROOT / "build" / "calibration_torch.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    calibrate.save_calibration(fit, str(out))


def serve_split(torch, model, params, prompts):
    """Phase 6: the fp-cache serve phase with the default planner pinned
    to the two-kernel split (a calibration that prices eva_fused above
    eva_split, with enough rows to be used); the planner is restored
    after, whatever happens."""
    from repro_torch.core.plan import PlanPolicy
    from repro_torch.models import RunConfig
    from repro_torch.serve import EngineConfig

    restore = pin_split()
    try:
        out = serve_phase(
            torch, model, params, prompts, "serve_split",
            RunConfig(plan_policy=PlanPolicy(vq_mode="none", impl="cuda")),
            EngineConfig(num_slots=SLOTS, max_len=MAX_LEN),
            ("vq_gemm", "oc_lookup", "flash_decode", "dequant_gemv"))
    finally:
        restore()
    assert out["launches"]["fused_vq_matmul"] == 0, out["launches"]
    return out


def serve_phase(torch, model, params, prompts, name, rc, ecfg, required,
                absent=(), eager_profiles=True):
    """Serve ``prompts`` greedily to MAX_NEW tokens through a fresh Engine
    (after a short warm-up one), with every kernel count set to 0 just
    before and read just after; fail unless each kernel in ``required``
    launched and each in ``absent`` did not. Then one decode step through
    the kernels and through the plain versions (on a paged engine over a
    paged cache, where the step must run no index_select: no view is
    gathered), graph_step and the profiles (``eager_profiles``: also
    of the eager steps)."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.serve import Engine, GenerationRequest, cache_bytes

    t_phase = time.perf_counter()
    cfg = model.cfg
    Engine(model, params, rc, ecfg, device="cuda").generate([prompts[0][:16]], 2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    eng = Engine(model, params, rc, ecfg, device="cuda")
    torch.cuda.synchronize()
    paged = eng.paging is not None
    # what the construction held at its peak beyond what it keeps: the
    # cache is allocated once, so this stays below one cache's bytes
    build_peak = torch.cuda.max_memory_allocated() - before
    alloc = cache_bytes(eng.caches)
    emit({"phase": name, "engine_build_peak_bytes": build_peak,
          "cache_bytes_allocated": alloc,
          "kv_bytes_in_use": eng.metrics()["kv_bytes_in_use"],
          **({"num_blocks": eng.paging.num_blocks,
              "bytes_per_block": eng.paging.bytes_per_block} if paged else {}),
          "decode_graph_pool_bytes": pool_bytes(
              torch, eng.decode_graph.graph.pool())})
    assert build_peak < 2 * alloc, (name, build_peak, alloc)
    # the decode capture's warm-up wrote every slot (a paged engine: into
    # the sink); the engine zeroes the caches and puts back the sentinel
    body = eng.caches["body"]
    assert not any(bool(t.any()) for n, t in body.items()
                   if n != "block_table"), \
        f"{name}: the decode graph's build left the caches written"
    assert not paged or bool((body["block_table"] == eng.paging.sentinel).all())
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
    build_s = sum(g.build_s for g in (*eng.prefill_graphs.values(),
                                      *eng.chunk_graphs.values()))
    tokens = []
    for uid, p in zip(uids, prompts):
        out = eng.output(uid)
        emit({"phase": name, "request": uid, "prompt_len": len(p),
              "tokens": out.num_tokens, "finish": out.finish_reason,
              "prefill_ms": out.prefill_s * 1e3,
              "decode_ms_per_step": out.decode_s * 1e3 / max(1, out.num_tokens - 1),
              "decode_tok_per_s": out.decode_tokens_per_s})
        assert out.finish_reason == "length" and out.num_tokens == MAX_NEW
        assert all(0 <= t < cfg.vocab_size for t in out.tokens)
        tokens.append(list(out.tokens))
    emit({"phase": name, "requests": N_REQUESTS, "slots": SLOTS,
          "max_len": ecfg.max_len, "kv_bits": ecfg.kv_bits, "paged": paged,
          "int8_prefill": rc.policy.int8_prefill, "wall_s": wall,
          "tokens_generated": m["tokens_generated"],
          "tok_per_s": m["tokens_generated"] / wall,
          "decode_steps": m["decode_steps"],
          "decode_ms_per_step": m["decode_s"] * 1e3 / m["decode_steps"],
          "prefill_s": m["prefill_s"],
          # the buckets' builds (warm-up + capture) at first use, inside
          # prefill_s
          "prefill_build_s": build_s,
          "prefill_s_replays": m["prefill_s"] - build_s,
          "decode_graph_build_s": eng.decode_graph.build_s,
          "decode_graph_pool_bytes": pool_bytes(
              torch, eng.decode_graph.graph.pool()),
          "prefill_graph_pool_bytes": pool_bytes(torch, eng.prefill_pool),
          "trace_counts": eng.trace_counts,
          "slot_occupancy": m["slot_occupancy"],
          "kv_bytes_in_use": m["kv_bytes_in_use"],
          "peak_kv_bytes_in_use": m["peak_kv_bytes_in_use"],
          **{k: m[k] for k in ("preemptions", "prefill_chunks",
                               "peak_blocks_in_use", "blocks_in_use",
                               "decode_tokens_per_step",
                               "draft_acceptance_rate", "drafted_tokens",
                               "accepted_draft_tokens",
                               "rejected_draft_tokens")},
          "launches": launches,
          "peak_device_bytes": torch.cuda.max_memory_allocated()})
    missing = [k for k in required if launches[k] == 0]
    assert not missing, f"{name}: kernels never launched on its path: {missing}"
    ran = [k for k in absent if launches[k]]
    assert not ran, f"{name}: kernels off its path launched: {ran}"
    if paged:
        assert m["blocks_in_use"] == m["kv_bytes_in_use"] == 0, m

    # the construction's and the serving's peak beyond what was held
    # before (the weights)
    peak_over_base = torch.cuda.max_memory_allocated() - before
    toks = torch.tensor(np.stack([p[:64] for p in prompts[:SLOTS]]),
                        dtype=torch.int32, device="cuda")
    busy = engine_checks(torch, model, eng, toks, name, required,
                         eager_profiles=eager_profiles, auto_plain=True)
    phase_seconds(name, t_phase)
    return {"launches": launches, "tokens": tokens, "metrics": m,
            "decode_busy_ms": busy,
            "kv_bytes": m["kv_bytes_in_use"] or alloc, "wall_s": wall,
            "peak_over_base": peak_over_base,
            "decode_launches": eng.decode_graph.launches,
            "trace_counts": dict(eng.trace_counts)}


def engine_checks(torch, model, eng, toks, name, required, rel=PLAIN_REL,
                  fp32_plain=False, eager_profiles=True, control_names=None,
                  auto_plain=False):
    """One decode step through the kernels and through the plain versions
    (``impl="torch"``, the VQ linears through the direct epilogue; the
    others ``select_epilogue`` picks are held against B1 by
    ``check_plain_epilogues``), on the engine's params and run config
    (codebooks attached, kv_vq
    set), from ``toks`` (SLOTS rows of n prompt tokens) in each slot of
    a cache of the engine's layout (on a paged engine over a paged
    cache, where the step must run no index_select: no view is
    gathered), held within ``rel`` of max|logit| with the argmax agreeing
    on 3 of 4 rows; then graph_step and the profiles. ``fp32_plain``
    (a deep model, whose bf16 rounding flips alone move the logits past
    PLAIN_REL): ``rel`` is wider, and two controls show that it still
    tells a fault apart (the plain step one position early, and with the
    next token id, must both drift past ``rel``; a model without
    attention reads no position: its first control is the plain step
    from init_cache's state, as if the prompt's state were never
    inserted); ``control_names`` names the controls in their place, of
    those three and ``memories_zeroed``, the plain step with every cross
    memory zeroed (whisper: its token embedding is small beside the
    sinusoid, so the next token id moves little; vision: the memories
    must be read); the two steps are also
    held to each other with fp32 activations (the same params) within
    1e-3, and so is the plain step through the epilogues
    ``select_epilogue`` picks (``impl="torch"``'s default).
    ``auto_plain``: the bf16 plain step through those epilogues is also
    held within ``rel``. ``eager_profiles=False``: only the replays are
    profiled."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.core.quantize import kv_codebook_tree
    from repro_torch.serve.kvcache import encode_prefill_cache, pad_prefill_cache
    from repro_torch.serve.paging import attn_nodes

    cfg = model.cfg
    paged = eng.paging is not None
    params, rc = eng.params, eng.rc
    # the plain step's VQ linears run the direct epilogue, B1's plain
    # version, the formula every bound was set against. Each epilogue sums
    # in its own fp32 order, and at bf16 any two orders (B1, direct,
    # blocked, recon) drift apart alike: 0.012-0.020 on the 4-8B models,
    # 0.022-0.027 on qwen2-72b's other prompts (tools/epilogue_drift.py).
    # This check's qwen2-72b prompt amplifies every such difference from
    # layer 40 on, at fp32 too: B1 against direct 0.080, blocked 0.254,
    # recon 0.478, so QWEN2_PLAIN_REL holds there for the direct order
    # only. auto_rc runs what select_epilogue picks (impl="torch"'s
    # default), held within rel with auto_plain and at fp32 within 1e-3.
    plain_rc = rc.replace_policy(impl="torch", epilogue="direct")
    auto_rc = rc.replace_policy(impl="torch", epilogue="auto")
    n = toks.shape[1]
    controls = {}
    with torch.no_grad():
        _, cache = model.prefill(params, prefill_batch(eng, toks), rc)
        if eng.kvq is not None:
            cache = encode_prefill_cache(cache, kv_codebook_tree(params),
                                         eng.kvq)
        base = (paged_base(torch, model, eng, cache, n) if paged
                else pad_prefill_cache(cache, eng.ecfg.max_len,
                                       window=eng.window))
        clone = lambda: map_cache(lambda t: t.clone(), base)
        step = (toks[:, -1:], torch.full((SLOTS, 1), n, dtype=torch.int32,
                                         device="cuda"))
        with Routing() as r_got:
            got, _ = model.decode(params, *step, clone(), rc)
        with Routing() as r_want:
            want, _ = model.decode(params, *step, clone(), plain_rc)
        if auto_plain:
            auto, _ = model.decode(params, *step, clone(), auto_rc)
        if fp32_plain:
            faults = {
                "position_minus_1": ((step[0], step[1] - 1), clone),
                "init_state": (step, lambda: model.init_cache(
                    SLOTS, eng.ecfg.max_len, device="cuda")),
                "memories_zeroed": (step, lambda: zeroed_memories(clone())),
                "next_token_id": (((step[0] + 1) % cfg.vocab_size, step[1]),
                                  clone)}
            names = control_names or (
                "position_minus_1" if attn_nodes(base) else "init_state",
                "next_token_id")
            for key in names:
                faulty, cache_of = faults[key]
                ctl, _ = model.decode(params, *faulty, cache_of(), plain_rc)
                controls[key] = logit_drift(torch, got, ctl, cfg.vocab_size)[1]
                del ctl
    drift, rel_drift, agree, finite = logit_drift(torch, got, want,
                                                  cfg.vocab_size)
    row = {"phase": f"{name}_plain_decode_step", "max_abs_logit_drift": drift,
           "rel_drift": rel_drift, "rel_bound": rel,
           "argmax_agreement": agree, "finite": finite}
    if r_got.calls:  # a MoE model: (token, layer) top-k choices that agree
        row["routing_agreement"] = r_got.agreement(r_want)
    if auto_plain:
        row["auto_epilogue"] = drift_row(torch, got, auto, cfg.vocab_size)
        del auto
    if eng.spec_k:
        # row 0 of a verify window (no drafts: its rows past 0 read token
        # 0) against the one-token step above, on the same cache: plain
        # attention and B1 at M = slots x (K + 1) against flash_decode and
        # B1 at M = slots
        from repro_torch.serve import speculative

        with torch.no_grad():
            win, _ = speculative.verify_logits(
                model, params, clone(), torch.full_like(eng.succ, -1), *step,
                rc, eng.spec_k)
        w_drift, w_rel, w_agree, w_finite = logit_drift(torch, win[:, :1],
                                                        got, cfg.vocab_size)
        row["window_row0"] = {"max_abs_logit_drift": w_drift,
                              "rel_drift": w_rel, "argmax_agreement": w_agree,
                              "finite": w_finite}
        del win
    del got, want
    if fp32_plain:
        from repro_torch.models import build_model

        row["control_rel_drift"] = controls
        m32 = build_model(dataclasses.replace(cfg, dtype="float32"))
        with torch.no_grad():
            _, c32 = m32.prefill(params, prefill_batch(eng, toks), rc)
            c32 = pad_prefill_cache(c32, eng.ecfg.max_len, window=eng.window)
            with Routing() as r_got:
                got, _ = m32.decode(params, *step, c32, rc)
            _, c32 = m32.prefill(params, prefill_batch(eng, toks), rc)
            c32 = pad_prefill_cache(c32, eng.ecfg.max_len, window=eng.window)
            with Routing() as r_want:
                want, _ = m32.decode(params, *step,
                                     map_cache(lambda t: t.clone(), c32),
                                     plain_rc)
            auto, _ = m32.decode(params, *step, c32, auto_rc)
        drift32, rel32, agree32, finite32 = logit_drift(torch, got, want,
                                                        cfg.vocab_size)
        row["fp32"] = {"max_abs_logit_drift": drift32, "rel_drift": rel32,
                       "argmax_agreement": agree32, "finite": finite32,
                       "auto_epilogue": drift_row(torch, got, auto,
                                                  cfg.vocab_size)}
        if r_got.calls:
            row["fp32"]["routing_agreement"] = r_got.agreement(r_want)
        del got, want, auto, c32
    emit(row)
    assert finite and rel_drift <= rel and agree >= 0.75, row
    assert all(c > rel for c in controls.values()), row
    w = row.get("window_row0")
    assert w is None or (w["finite"] and w["rel_drift"] <= rel
                         and w["argmax_agreement"] >= 0.75), row
    a = row.get("auto_epilogue")
    assert a is None or (a["finite"] and a["rel_drift"] <= rel
                         and a["argmax_agreement"] >= 0.75), row
    if fp32_plain:
        assert finite32 and rel32 <= 1e-3 and agree32 >= 0.75, row
        a = row["fp32"]["auto_epilogue"]
        assert a["finite"] and a["rel_drift"] <= 1e-3 \
            and a["argmax_agreement"] >= 0.75, row
    if paged:  # no view gathered on the card: no index_select in the step
        class Ops(TorchDispatchMode):
            seen = []

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                Ops.seen.append(str(func.overloadpacket))
                return func(*args, **(kwargs or {}))

        with torch.no_grad(), Ops():
            model.decode(params, *step, clone(), rc)
        gathers = Ops.seen.count("aten.index_select")
        emit({"phase": f"{name}_decode_step_ops", "ops": len(Ops.seen),
              "index_select": gathers})
        assert gathers == 0, f"{name}: the paged decode step gathers a view"
    graph_step(torch, model, eng, base, clone, name)
    return profile_decode(torch, model, eng, clone(), step, name, required,
                          eager_profiles=eager_profiles)


def zeroed_memories(caches):
    """``caches`` with every image memory leaf (vision's ``xk``/``xv``)
    zeroed in place."""
    for path, t in cache_leaves(caches).items():
        if path.split("/")[-1] in ("xk", "xv"):
            t.zero_()
    return caches


def drift_row(torch, got, want, vocab) -> dict:
    """``logit_drift`` as a row's keys."""
    drift, rel, agree, finite = logit_drift(torch, got, want, vocab)
    return {"max_abs_logit_drift": drift, "rel_drift": rel,
            "argmax_agreement": agree, "finite": finite}


def logit_drift(torch, got, want, vocab):
    """Max |got - want| over the vocab of a (B, 1, V) step, relative to
    max |want|, the argmax agreement, and whether got is finite."""
    got, want = got[:, 0, :vocab], want[:, 0, :vocab]
    drift = (got - want).abs().max().item()
    return (drift, drift / want.abs().max().item(),
            (got.argmax(-1) == want.argmax(-1)).float().mean().item(),
            bool(torch.isfinite(got).all()))


def paged_base(torch, model, eng, cache, n):
    """A paged cache of the engine's layout holding ``cache`` (a prefill
    cache of SLOTS rows of ``n`` positions): each slot gets 8 blocks
    from a shuffled pool (room for the graph steps), the rest of its
    table row on the sentinel."""
    import numpy as np
    from repro_torch.serve import paging

    meta = eng.paging
    base = model.init_cache(SLOTS, eng.ecfg.max_len, device="cuda", paging=meta,
                            **eng._cache_kw)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    perm = torch.randperm(meta.num_blocks, generator=gen, device="cuda")
    tables = np.full((SLOTS, meta.blocks_per_slot), meta.sentinel, np.int32)
    tables[:, :8] = perm[:SLOTS * 8].reshape(SLOTS, 8).cpu().numpy()
    for b in range(SLOTS):
        paging.write_prefill_into_blocks(
            base, map_cache(lambda t: t[:, b:b + 1], cache),
            torch.tensor([b], device="cuda"),
            torch.from_numpy(tables[b]).to("cuda"),
            torch.tensor([n], dtype=torch.int32, device="cuda"), meta,
            window=eng.window)
    paging.set_block_tables(base, tables)
    return base


def prefill_batch(eng, toks):
    """A model prefill's batch of ``toks`` (B, n) with the engine's
    extras (whisper's frames, vision's image) broadcast to B rows."""
    return {"tokens": toks, **{k: v.expand(toks.shape[0], *v.shape[1:])
                               for k, v in eng._extra_batch.items()}}


def step_inputs(eng, bucket, rng, chunk=False):
    """Host inputs of a prefill step of ``bucket`` tokens: the tokens; on a
    paged engine also slot 1, its table row and a true length 3 short of
    the bucket, and for a chunk continuation 64 committed positions."""
    import numpy as np
    from repro_torch.serve.paging import attn_nodes

    t = rng.integers(0, eng.model.cfg.vocab_size, (1, bucket)).astype(np.int32)
    if eng.paging is None:
        return {"tokens": t}
    row = attn_nodes(eng.caches)[0]["block_table"][0, 1].cpu().numpy()
    arrays = {"tokens": t, "slot": [1], "bt_row": row,
              "true_len": [bucket - 3]}
    if chunk:
        arrays["hist"] = [64]
    return arrays


def device_inputs(torch, step, arrays):
    """``arrays`` as device tensors shaped like ``step``'s static inputs."""
    import numpy as np

    return {n: torch.as_tensor(np.asarray(arrays[n])).reshape(buf.shape).to(buf)
            for n, buf in step.inputs.dev.items()}


def cache_leaves(caches, prefix=""):
    """path -> leaf of every node of a cache tree ("body", "pre" before
    deepseek's MoE layers, rglru's "groups" and "trail"), a paged arena
    without its sink (the last block: dropped writes land there in no
    fixed order, and nothing reads it)."""
    arenas = ("k", "v", "k_s", "v_s", "latent", "k_rope", "latent_s")
    out = {}
    for n, t in caches.items():
        if isinstance(t, dict):
            out.update(cache_leaves(t, f"{prefix}{n}/"))
        else:
            out[prefix + n] = (t[:, :-1] if "block_table" in caches
                               and n in arenas else t)
    return out


def map_cache(fn, tree):
    """A cache tree with ``fn`` applied to every leaf."""
    if isinstance(tree, dict):
        return {k: map_cache(fn, v) for k, v in tree.items()}
    return fn(tree)


def copy_cache(dst, src):
    """Copy every leaf of cache tree ``src`` into the leaf at the same
    path of ``dst``, in place (matched by key, whatever the trees' key
    order)."""
    for k, t in dst.items():
        if isinstance(t, dict):
            copy_cache(t, src[k])
        else:
            t.copy_(src[k])


def replay_vs_eager(torch, eng, step, arrays):
    """A replay of ``step`` against its function run eagerly on the same
    inputs, bitwise: the outputs and, on a paged engine (whose prefill
    steps write into the caches), every cache leaf after the step, from
    the same caches before it."""
    from repro_torch.serve.graphs import tensor_leaves

    paged = eng.paging is not None
    saved = [t.clone() for t in tensor_leaves(eng.caches)] if paged else []
    got = [x.clone() for x in tensor_leaves(step(**arrays))]
    if paged:
        got += [t.clone() for t in cache_leaves(eng.caches).values()]
        for t, s in zip(tensor_leaves(eng.caches), saved):
            t.copy_(s)
    with torch.no_grad():
        want = list(tensor_leaves(step.fn(**device_inputs(torch, step,
                                                           arrays))))
    if paged:
        want += list(cache_leaves(eng.caches).values())
    return len(got) == len(want) and all(torch.equal(a, b)
                                         for a, b in zip(got, want))


def graph_step(torch, model, eng, base, clone, name):
    """The engine's graphs against the eager steps they capture, bitwise
    (every kernel is deterministic: fixed summation orders, no atomics).
    Decode: ``base`` (a prefilled cache of the engine's layout, paged or
    not) goes into the engine's caches and into a clone; GRAPH_STEPS
    decode replays on the first and as many eager ``model.decode`` steps
    on the clone, with the same random tokens, must give equal logits at
    every step and equal cache leaves (``len`` included) after the last,
    and the replays must count the capture's launches times GRAPH_STEPS.
    Prefill: each bucket of 32 tokens and more up to the engine's max_len
    (the largest bucket, which the prompts do not use: built here),
    replayed against the eager prefill (and the cache's quantization
    under kv_bits < 16, the graph's own function run eagerly): equal
    logits and cache leaves (on a paged engine the caches the step
    writes); and every chunk-continuation bucket the engine built. One
    line per graph with its build time and the bytes of its pool (the
    prefill buckets share one) after it was built. A speculative
    engine's decode graph is held by ``spec_replays``."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.serve.paging import attn_nodes

    params, vocab = eng.params, model.cfg.vocab_size
    rc_decode = eng.rc.replace(mode="decode")
    rng = np.random.default_rng(SEED + 3)
    dev = lambda a: torch.from_numpy(a).to("cuda")
    failed = []

    plain = clone()
    copy_cache(eng.caches, base)
    # a model without attention (xLSTM) reads no position
    lens = [node["len"] for node in attn_nodes(base)]
    start = int(lens[0][0, 0]) if lens else 0
    toks = rng.integers(0, vocab, (GRAPH_STEPS, SLOTS, 1)).astype(np.int32)
    pos = np.broadcast_to(start + np.arange(GRAPH_STEPS, dtype=np.int32)[
        :, None, None], toks.shape).copy()
    g = eng.decode_graph
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    spec = {}
    if eng.spec_k:
        steps_equal, spec = spec_replays(torch, model, eng, plain, toks[:, :, 0],
                                         start)
        counts = kernels.launch_counts()
    else:
        got = [g(tokens=toks[i], positions=pos[i]).clone()
               for i in range(GRAPH_STEPS)]
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        steps_equal = []
        with torch.no_grad():
            for i in range(GRAPH_STEPS):
                want, _ = model.decode(params, dev(toks[i]), dev(pos[i]),
                                       plain, rc_decode)
                steps_equal.append(bool(torch.equal(got[i],
                                                    want[:, 0, :vocab])))
        del got
    want_counts = {k: GRAPH_STEPS * g.launches.get(k, 0) for k in counts}
    want_leaves = cache_leaves(plain)
    cache_equal = {n: bool(torch.equal(t, want_leaves[n]))
                   for n, t in cache_leaves(eng.caches).items()}
    emit({"phase": "graph_step", "serve": name, "graph": "decode",
          "steps": GRAPH_STEPS, "logits_bitwise_equal": steps_equal,
          "cache_bitwise_equal": cache_equal,
          "launches_per_replay": g.launches, "launches": counts,
          "build_s": g.build_s,
          "pool_bytes": pool_bytes(torch, g.graph.pool()),
          "trace_counts": eng.trace_counts, **spec})
    if not (all(steps_equal) and all(cache_equal.values())
            and spec.get("succ_bitwise_equal", True)):
        failed.append("decode")
    if counts != want_counts or not g.launches:
        failed.append(f"decode launches {counts} != {want_counts}")
    del plain

    steps = [(f"prefill@{b}", b, False) for b in eng._buckets if b >= 32]
    steps += [(f"chunk@{b}", b, True) for b in sorted(eng.chunk_graphs)]
    for label, bucket, chunk in steps:
        graphs = eng.chunk_graphs if chunk else eng.prefill_graphs
        built = bucket in graphs
        pool_before = pool_bytes(torch, eng.prefill_pool)
        step = (eng.chunk_graph if chunk else eng.prefill_graph)(bucket)
        equal = replay_vs_eager(torch, eng, step,
                                step_inputs(eng, bucket, rng, chunk))
        emit({"phase": "graph_step", "serve": name, "graph": label,
              "bitwise_equal": bool(equal),
              "launches_per_replay": step.launches,
              "build_s": step.build_s, "built_while_serving": built,
              "shared_pool_bytes_before": pool_before,
              "shared_pool_bytes": pool_bytes(torch, eng.prefill_pool)})
        if not equal:
            failed.append(label)
    assert eng.trace_counts["decode"] == 1, eng.trace_counts
    # an unbucketed (MoE) engine's prefill is eager: no prefill graph
    assert not eng._buckets or sorted(eng.prefill_graphs)[-1] == \
        eng.ecfg.max_len, eng.prefill_graphs
    assert not failed, f"{name} graph_step: replay differs from eager: {failed}"


def spec_replays(torch, model, eng, plain, toks, start):
    """graph_step's decode part on a speculative engine: GRAPH_STEPS
    replays of the verify graph on the engine's caches and successor
    table, each against ``speculative.verify_logits`` run eagerly on
    ``plain`` and a copy of the table (the logits and the window,
    bitwise), each followed on both sides by the eager part
    (``settle_window``, greedy slots, every slot active and speculating:
    the same acceptance, ``len`` rollback and successor update). ``toks``
    (GRAPH_STEPS, SLOTS) are the steps' last tokens; positions start at
    ``start`` and advance by the tokens each step emitted. The eager
    steps' kernel launches are taken back out of the counts. Returns
    (per-step equality, a dict of what the steps emitted and whether
    the tables ended equal)."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.serve import speculative

    B = SLOTS
    on = lambda a, dt: torch.as_tensor(a, dtype=dt, device="cuda")
    knobs = {"generators": [None] * B, "greedy": [True] * B,
             "temperature": on([1.0] * B, torch.float32),
             "top_k": on([0] * B, torch.int32),
             "top_p": on([1.0] * B, torch.float32),
             "stop_ids": on([[-1]] * B, torch.int32),
             "remaining": on([MAX_LEN] * B, torch.int32),
             "active": on([True] * B, torch.bool),
             "spec_on": on([True] * B, torch.bool)}
    succ = eng.succ.clone()
    pos = np.full((B, 1), start, np.int32)
    equal, emitted = [], []
    for i in range(GRAPH_STEPS):
        replay = [t.clone() for t in eng.decode_graph(tokens=toks[i][:, None],
                                                      positions=pos)]
        counts = kernels.launch_counts()
        with torch.no_grad():
            eager = speculative.verify_logits(
                model, eng.params, plain, succ, on(toks[i][:, None], torch.int32),
                on(pos, torch.int32), eng._rc_decode, eng.spec_k)
            e = [speculative.settle_window(*out, caches, table, **knobs)[2]
                 for out, caches, table in ((replay, eng.caches, eng.succ),
                                            (eager, plain, succ))]
        kernels.set_launch_counts(counts)
        equal.append(all(bool(torch.equal(a, b)) for a, b in zip(replay, eager))
                     and bool(torch.equal(e[0], e[1])))
        step = e[0].cpu().numpy()
        emitted.append(step.tolist())
        pos = pos + step[:, None]
    torch.cuda.synchronize()
    return equal, {"emitted": emitted,
                   "succ_bitwise_equal": bool(torch.equal(eng.succ, succ))}


def pool_bytes(torch, pool):
    """Device bytes the caching allocator holds for the CUDA graph memory
    pool ``pool`` (a pool handle: ``CUDAGraph.pool()``), summed over its
    segments in the allocator's snapshot."""
    pool = tuple(pool)
    return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
               if tuple(s["segment_pool_id"]) == pool)


def device_profile(torch, run, steps: int = 5, top_other: int = 0) -> dict:
    """Host wall per call of ``run`` over ``steps`` back-to-back calls
    (synchronized at the end, no profiler) against the device time of
    the kernels the calls ran (torch.profiler, device activity only: the
    host's op events are not read, and recording them costs seconds a
    call), grouped by the port's kernels (each CUDA function matched by
    its whole name) and everything else; ``profile_s``: the host seconds
    the profiled calls and the reading of their events took.
    ``top_other``: also the ms a call and launches of that many of the
    "other" CUDA functions that take the most time. A profile that
    records no device event at all is the tracer's failure, not the
    calls' (CUPTI has once dropped every event of a replay that ran):
    it is taken again, up to PROFILE_ATTEMPTS times in all
    (``profile_attempts``)."""
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad():
        run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
        for attempt in range(1, PROFILE_ATTEMPTS + 1):
            t0 = time.perf_counter()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(steps):
                    run()
                torch.cuda.synchronize()
            device = [ev for ev in prof.events()
                      if ev.device_type == torch.autograd.DeviceType.CUDA]
            if device:
                break
    groups, label, other = {}, {}, {}
    n_kernels = 0
    for ev in device:
        n_kernels += 1
        if ev.name not in label:
            label[ev.name] = next((lab for fn, lab in KERNEL_FUNCTIONS.items()
                                   if re.search(rf"\b{fn}\b", ev.name)), "other")
        key = label[ev.name]
        us = ev.time_range.elapsed_us()
        groups[key] = groups.get(key, 0.0) + us
        if key == "other":
            t, c = other.get(ev.name, (0.0, 0))
            other[ev.name] = (t + us, c + 1)
    busy_ms = sum(groups.values()) / 1e3 / steps
    return {"profile_s": time.perf_counter() - t0,
            "profile_attempts": attempt, "wall_ms_per_step": wall_ms,
            "device_busy_ms_per_step": busy_ms if n_kernels else None,
            "idle_share": (1 - busy_ms / wall_ms) if n_kernels else None,
            "device_kernels_per_step": n_kernels / steps,
            "device_ms_by_kernel": {k: v / 1e3 / steps
                                    for k, v in sorted(groups.items())},
            **({"top_other": [
                {"name": n[:120], "ms": t / 1e3 / steps, "launches": c / steps}
                for n, (t, c) in sorted(other.items(),
                                        key=lambda kv: -kv[1][0])[:top_other]]}
               if top_other else {})}


def profile_decode(torch, model, eng, cache, step, name, required,
                   eager_profiles=True):
    """Where a batched decode step's time goes, eager (``model.decode`` on
    ``cache``), replayed (the engine's decode graph on its caches) and as
    the engine runs it (the replay, then the eager sampling epilogue and
    one readback, with every slot active), and a replayed prefill bucket
    beside the eager prefill. Fails unless
    each kernel in ``required`` shows by its CUDA function among the
    device events of the replay that runs it: the device's own proof
    that the graph holds the kernel. ``eager_profiles=False`` skips the
    two eager profiles (the other configs' phases: the replays are what
    they serve)."""
    import numpy as np

    params, rc = eng.params, eng.rc
    tok, pos = (t.cpu().numpy() for t in step)
    if eng.spec_k:
        from repro_torch.serve import speculative

        succ = eng.succ.clone()
        eager_step = lambda: speculative.verify_logits(
            model, params, cache, succ, *step, rc, eng.spec_k)
    else:
        eager_step = lambda: model.decode(params, *step, cache, rc)
    eager = device_profile(torch, eager_step) if eager_profiles else None
    replay = device_profile(
        torch, lambda: eng.decode_graph(tokens=tok, positions=pos))
    # the engine's own step, its slots set active by hand (the engine is
    # idle after its serve phase) and put back after
    eng.active[:], eng.greedy[:], eng.stop_ids[:] = True, True, -1
    eng.remaining[:] = MAX_LEN
    eng.last_token[:], eng.positions[:] = tok[:, 0], pos[:, 0]
    engine_step = device_profile(torch, eng._decode)
    eng.active[:] = False
    # an unbucketed (MoE) engine prefills eagerly at the exact length
    bucket = (max(b for b in eng._buckets if b <= PROFILE_BUCKET)
              if eng._buckets else PROFILE_BUCKET)
    arrays = step_inputs(eng, bucket, np.random.default_rng(SEED + 4))
    prefill = eng.prefill_graph(bucket)
    dt = device_inputs(torch, prefill, arrays)
    prefill_eager = (device_profile(torch, lambda: prefill.fn(**dt))
                     if eager_profiles else None)
    prefill_replay = device_profile(torch, lambda: prefill(**arrays))
    emit({"phase": f"{name}_decode_profile", "batch": SLOTS,
          "eager": eager, "replay": replay, "engine_step": engine_step})
    emit({"phase": f"{name}_prefill_profile", "bucket": bucket,
          "eager": prefill_eager, "replay": prefill_replay,
          "captured": bool(eng._buckets)})
    missing = [k for k in required
               if k not in (replay if k in DECODE_KERNELS else prefill_replay)[
                   "device_ms_by_kernel"]]
    assert not missing, (f"{name}: kernels absent from the replays' device "
                         f"events: {missing}")
    return replay["device_busy_ms_per_step"]


def model_rows(rows, model, name, phase) -> dict:
    """The check phase's rows of kernel ``name`` at ``model``'s linears
    (of B4 the served bf16 x) with the times every row has, the kernel's
    launches in ``phase`` (a serve phase's counts), and, where every row
    carries its launches a decode step (``per_step``), the sum of a
    decode step: each row's times by its count."""
    keys = ("kernel_ms", "plain_ms", "bound_ms", "library_ms",
            "library_bf16_ms")
    rs = [r for r in rows if r["case"].get("model") == model
          and r["case"].get("x", "bfloat16") == "bfloat16"]
    keys = [k for k in keys if all(r.get(k) is not None for r in rs)]
    out = {"linears": [{"linear": r["case"]["linear"], "M": r["case"]["M"],
                        "bound_by": r["bound_by"],
                        **{k: r[k] for k in keys}} for r in rs],
           "launches": phase[name]}
    if all("per_step" in r["case"] for r in rs):
        out["decode_step"] = {k: sum(r[k] * r["case"]["per_step"] for r in rs)
                              for k in keys}
    return out


def verify_window(rows) -> dict:
    """B1's check rows at SPEC_M summed over the four llama2-7b decode
    linears, one entry per M: kernel, plain, bound and library ms."""
    out = {}
    for M in SPEC_M:
        rs = [r for r in rows if r["case"].get("speculate_k") is not None
              and r["case"]["M"] == M]
        out[f"M{M}"] = {
            "speculate_k": M // SLOTS - 1,
            **{k: sum(r[k] for r in rs) for k in (
                "kernel_ms", "plain_ms", "bound_ms", "library_ms",
                "library_bf16_ms")},
            "bound_by": max(rs, key=lambda r: r["bound_ms"])["bound_by"]}
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.kernels import build  # fails outside a checkout

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    emit({"phase": "build", "seconds": build.build_all(),
          "ptxas": {n: [ln.strip() for ln in log.splitlines()
                        if "registers" in ln or "spill" in ln][:4]
                    for n, log in build.BUILD_LOG.items()}})
    timer = Timer(torch)
    t0 = time.perf_counter()
    rows = check_kernels(torch, timer)
    phase_seconds("check_kernels", t0)
    t0 = time.perf_counter()
    breakdown(torch, timer)
    phase_seconds("breakdown", t0)
    launches = serve(torch, timer)
    launches.update(serve_other_configs(torch, timer))
    launches.update(serve_mixtral(torch))
    launches.update(serve_deepseek(torch))
    launches.update(serve_xlstm(torch))
    launches.update(serve_rglru(torch))
    launches.update(serve_whisper(torch))
    launches.update(serve_vision(torch))
    launches.update(serve_fit(torch))
    launches.update(train_qwen3(torch))
    phase_of = {"flash_decode": "serve", "flash_decode_kvq": "serve_kvq",
                "int8_gemm": "serve_kvq", "vq_gemm": "serve_split",
                "oc_lookup": "serve_split",
                "flash_decode_paged": "serve_paged",
                "flash_decode_kvq_paged": "serve_kvq_paged"}

    summary = []
    for name, replaces in REPLACES.items():
        # llama2-7b's rows: the other configs' linears and the grouped
        # heads are reported beside them
        rs = [r for r in rows[name] if "model" not in r["case"]
              and r["case"].get("Hk") == r["case"].get("H")]
        others = {}
        for r in rows[name]:
            if "model" in r["case"]:
                key = r["case"]["model"]
            elif "group" in r["case"]:
                key = f"g{r['case']['group']}"
            else:
                continue
            others[key] = others.get(key, 0.0) + r["kernel_ms"]
        if name in ("fused_vq_matmul", "vq_gemm", "oc_lookup"):
            # one decode layer at M = slots (B4: the served bf16 x)
            rs = [r for r in rs if r["case"]["M"] == SLOTS
                  and r["case"].get("x", "bfloat16") == "bfloat16"]
        elif name in ("flash_decode_kvq", "int8_gemm"):  # the served case
            rs = [r for r in rs if r["case"].get("kv_bits", 4) == 4
                  and r["case"].get("M", 256) == 256]
        elif name == "flash_decode":  # the mixed lengths
            rs = [r for r in rs if len(set(r["case"]["lengths"])) > 1]
        elif name == "dequant_gemv":  # the prefill layer, served bf16 x
            rs = [r for r in rs if r["case"]["M"] == MAX_LEN
                  and r["case"]["x"] == "bfloat16"]
        tot = lambda key: sum(r[key] for r in rs)
        summary.append({
            "name": name, "route": "cuda",
            "source": str(build.source_path(name).relative_to(ROOT)),
            "replaces": replaces,
            "launches": launches[phase_of.get(name, "serve")][name],
            "max_abs_err": max(r["max_abs_err"] for r in rows[name]),
            "ms": tot("kernel_ms"), "plain_ms": tot("plain_ms"),
            "bound_ms": tot("bound_ms"),
            "bound_by": max(rs, key=lambda r: r["bound_ms"])["bound_by"],
            "library_ms": (None if any(r["library_ms"] is None for r in rs)
                           else tot("library_ms")),
            # B1, B3: bf16 torch.matmul on bf16-rounded weights, lower
            # precision; the paged entries: the contiguous kernel over the
            # gathered view, and the gather with it (the reference's route)
            **{k: tot(k) for k in ("library_bf16_ms", "contiguous_ms",
                                   "gather_kernel_ms") if k in rs[0]},
            # ms of the same case at the other configs (B1: a decode layer
            # at M = slots; B3: the prefill layer) and grouped heads
            **({"other_ms": others} if others else {}),
            # B1: a llama2-7b decode layer at the rows of a speculative
            # verify window, M = slots x (K + 1)
            **({"verify_window": verify_window(rows[name]),
                "plain_epilogues": [
                    {"name": r["yardstick"], **r["case"], "ms": r["ms"],
                     "b1_ms": r["b1_ms"],
                     "max_abs_err_vs_b1": r["max_abs_err_vs_b1"]}
                    for r in rows["eva_plain"]]}
               if name == "fused_vq_matmul" else {}),
            # B1 and B3 at mixtral-8x22b's, deepseek-v2-lite-16b's,
            # xlstm-125m's, recurrentgemma-2b's, whisper-medium's and
            # llama-3.2-vision-11b's linears, B4 and B5 at deepseek's,
            # xlstm's, recurrentgemma's, whisper's and vision's decode
            # linears (served in their split runs), B6 at xlstm's,
            # recurrentgemma's, whisper's and vision's INT8 prefill
            # (xlstm's N = 4 gates, whisper's frontend.proj, vision's
            # img_proj, each head),
            # B2 and its paged entry at whisper's head dim 64 (g = 1), and
            # B1's, B2's, B4's and B5's decode step
            **({m: model_rows(rows[name], m, name, launches[f"serve_{m}"])
                for m in (MIXTRAL, DEEPSEEK, XLSTM, RGLRU, WHISPER, VISION)}
               if name in ("fused_vq_matmul", "dequant_gemv") else {}),
            **({WHISPER: model_rows(rows[name], WHISPER, name, launches[
                f"serve_{WHISPER}" + ("_paged" if name.endswith("_paged")
                                      else "")])}
               if name in ("flash_decode", "flash_decode_paged") else {}),
            **({m: model_rows(rows[name], m, name, launches[
                f"serve_{m}_int8_prefill"])
                for m in (XLSTM, RGLRU, WHISPER, VISION)}
               if name == "int8_gemm" else {}),
            **({DEEPSEEK: model_rows(rows[name], DEEPSEEK, name, launches[
                f"serve_{DEEPSEEK}_{MOE_SUB_LAYERS}l_split"]),
                **{m: model_rows(rows[name], m, name,
                                 launches[f"serve_{m}_split"])
                   for m in (XLSTM, RGLRU, WHISPER, VISION)}}
               if name in ("vq_gemm", "oc_lookup") else {}),
            "launches_by_phase": {ph: c[name] for ph, c in launches.items()
                                  if c.get(name)}})
    emit({"kernels": summary})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
