#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. probe — the card's name and power limit, torch/CUDA/nvcc versions;
   TF32 off for matmuls and cuDNN.
2. build — every CUDA source in src/repro_torch/csrc, one nvcc each, all
   started together.
3. kernels — each kernel against its plain PyTorch version at the shapes
   the main paths give it (decode_attention at the engine's slot pool, bf16
   and int8 on the slot view, one long bf16 slot, and its paged entry on
   the engine's int8 page pools through a shuffled page table, at
   qwen3-8b's 8 kv heads x a GQA group of 4, phi4-mini's 8 x 3 and
   qwen2-moe-a2.7b's 16 x 1; both
   bodies of quant_matmul — int8dot and the dequant baseline — at
   qwen3-8b's seven linear shapes, decode and
   prefill M, channel and group:128, then the variant benchmark, the
   dequant body's only path; fake_quant forward and both backward rules at
   qwen3-8b's four layer-linear shapes with a full doubly-channelwise
   scale, the embedding with a per-row scale and the lm_head, and at the
   paper CNN's four weight views (each conv's HWIO kernel as [kh·kw,
   cin·cout] with one scale row, the fc [64, 10]), at qwen2-moe's
   (each expert stack [E, in, out] as one [E·in, out] view with its full
   scale, the 8-bit router, the shared experts) and at deepseek-v2-236b's
   six MLA weights (q_down, q_up, kv_down, k_up, v_up, wo; each with the
   train path's full scale and with a per-channel one beside the
   library's per-channel fake-quant), and at the four Mamba2 weights of
   mamba2-1.3b and zamba2-7b (in_proj, out_proj; the same two scales);
   flash_attention at the teacher's prefill, B 16 x S 512, and a ragged
   B 1 x S 300, 32/8 heads, f32 through its FMA body and bf16 through its
   tensor-core body, causal and not, and zamba2-7b's teacher shape, B 16 x
   S 512, 32/32 heads, hd 112, bf16 causal, through its FMA body;
   decode_attention at zamba2-7b's head dim 112, 32 kv heads x a group of
   1, bf16 and int8 on the slot view and the paged entry; decode_attention
   at qwen2-vl-7b's 4 kv heads x a group of 7 on the same entries;
   flash_attention's tensor-core body at qwen2-vl-7b's teacher shape (B 16
   x S 512, 28/4 heads, hd 128, causal), seamless-m4t-medium's
   self-attention (B 16 x S 512, 16/16 heads, hd 64, causal) and its cross
   attention (64 decoder queries over 512 encoder keys, non-causal);
   fake_quant at the two embeddings (152064 x 3584, 256206 x 1024, per-row
   scale) and seamless's up (1024 x 4096, full and per-channel scale));
   fake_quant's factored entry (S_wL x S_wR formed in the kernel, bf16
   out, both scale gradients reduced in it) at qwen3-8b's seven layer
   weights under DCHW and wq/wo under group:128, a qwen2-moe expert
   stack, deepseek-v2's kv_down, seamless's up and the tp-16 shards, each
   beside the old route (the full scale, the broadcast entry, the cast)
   timed as one call and the 16 B/elem bound),
   with the error,
   the kernel's, the plain version's and a library call's time (CUDA
   events, after warm-up) and the least time the card could take.
4. reference — a SMOKE-size model served on the card through the kernels
   and on the CPU through the plain route must emit the same greedy tokens
   (a token may differ only where the CPU's top-2 logit margin is within a
   few bf16 ulps).
5. main path — qwen3-8b at full width (36 layers, random W4 weights from a
   seed): init on the card, export, the evaluate stage's kernel-route check
   (quant_matmul), then 4 greedy requests through the continuous-batching
   engine with paged int8 KV (decode_attention's paged entry every layer
   of every decode step), counting each kernel's launches; the same
   requests again through the plain route, tokens compared: where a
   request's tokens differ, the request is served alone through both
   routes, and at the first step whose token differs the plain route's
   logits must have a top-2 margin within a few bf16 ulps.
6. train path — QFT on qwen3-8b at full width, depth cut to 4 of 36
   layers (the f32 training state of 36 layers does not fit one card):
   f32 teacher from a seed → student → activation calibration → APQ/MMSE
   scale init → 6 steps of joint finetuning (batch 16 x 512 tokens, 4
   microbatches, the paper's Adam recipe), every quantized weight's
   fake-quant forward and backward through fake_quant (its factored entry
   for every weight but the embedding's per-row scale) and the teacher's
   attention through flash_attention's tensor-core body, launches counted
   per body; one microbatch profiled on the new fake-quant route and on
   the old one, and the chain of a layer's seven weights profiled alone
   on both; then export, the
   route check and 2 greedy requests served from the trained artifact
   (quant_matmul, decode_attention); then the teacher's hidden states
   through flash_attention and through the plain route, compared, and one
   more step's loss and gradients through both student routes on those
   same teacher targets, compared.
7. pipeline — run_pipeline, the path of `python -m repro_torch quantize`,
   at full width with the depth cut to 3 layers (calibrate, APQ/MMSE init,
   4 finetune steps of batch 16 x 512, export, evaluate with the serve
   smoke) in a temporary workdir, launches counted per stage (every
   flash_attention launch the teacher's, on the tensor-core body; evaluate
   keeps the student on _sdpa); then again on the same workdir, which
   skips calibrate, init and finetune and must give the same evaluate
   metrics, and also reports them with the student's attention on
   flash_attention, for the record.
8. paper CNN — run_pipeline on paper-cnn at its full width with the paper
   example's knobs (w4a8, 600 QFT steps, a 300-step teacher, 4096
   calibration images, CLE, lr 1e-3) in a temporary workdir, fake_quant's
   launches counted per stage (a forward and a backward per conv and
   finetune step; the loss reads the pre-pool features, so the fc is not
   run); again on the same workdir (calibrate, init and
   finetune skipped, the same evaluate metrics); w4chw and w4a8 with no
   finetune (the pre-QFT accuracy); one step's loss and gradients through
   fake_quant and through the plain route on one batch, compared.
9. phi4-mini — phase 5's main path on phi4-mini-3.8b at full width and
   depth (32 layers, d 3072, vocab 200064, the head tied to the
   embedding): decode_attention's paged entry at a GQA group of 3 in every
   layer of every decode step, quant_matmul through the route check,
   tokens against the plain route under the same margin rule.
10. qwen2-moe — phase 5's main path on qwen2-moe-a2.7b at full width and
   depth (24 layers, 60 routed experts top-4 + 4 shared, 14.3 B
   parameters) at capacity factor 15 (dropless; the config's 1.25 is
   refused by the engine at 8 slots): the sort-based dispatch in every
   layer of every prefill chunk and decode step, decode_attention's paged
   entry at a GQA group of 1.  Where a request's tokens differ from the
   plain route's, both routes serve it alone, recording every routing
   decision: the first decision that differs, an expert choice or a
   token, must be at a plain-route margin within a few bf16 ulps.
11. qwen2-moe QFT — phase 6's train path on qwen2-moe-a2.7b at full
   width, depth cut to 2 of 24 layers, 3 steps: each expert stack's
   fake-quant one fake_quant launch a pass, the stacked APQ init with
   the experts' geometric-mean S_wL, the teacher's 16/16-head attention
   on flash_attention's tensor-core body; export (the expert stacks'
   parity too) and 2 greedy requests from the trained artifact.
12. deepseek-v2 — phase 5's main path on deepseek-v2-236b at full width
   (d 5120, 128 heads, MLA kv_lora 512 / q_lora 1536 / nope 128 + rope
   64 / v 128, 160 routed experts top-6 + 2 shared, vocab 102400),
   depth cut to 3 of 60 layers (12.97 B parameters; the f32 masters of a
   fourth layer would not fit beside the export), at capacity factor 27:
   the monolithic bf16 latent cache, MLA's attention as einsums (no
   decode_attention and no flash_attention launch: the reference's
   decode_route excludes MLA), quant_matmul once through the route
   check.  Served three ways: the kernel route, the plain route (the
   same computation here: tokens must be identical, or split at a
   near-tie), and the absorbed decode form (mla_absorb; held to the
   default form's tokens up to the first decision that differs, which
   must be a near-tie); a profile of four decode steps with the
   k_up/v_up products over the latent cache and the experts' FFN as
   separate ranges.
13. deepseek-v2 QFT — phase 6's train path on the MLA student at full
   MLA and model width, experts cut from 160 to 16 (top-6, 2 shared, ff
   1536, capacity factor 3), 2 layers, 3 steps: every MLA weight and
   expert stack through fake_quant (1 + 13 x 2 launches a microbatch each
   way), no flash_attention launch (the teacher's MLA is einsums on both
   routes, so its hidden states must agree exactly), export and 2 greedy
   requests from the trained artifact.
14. mamba2 — phase 5's main path on mamba2-1.3b at full width and depth
   (48 layers, d 2048, 64 SSM heads x 64, d_state 128, the head tied to
   the embedding): the monolithic cache of f32 Mamba2 state, prefill in
   exact-length 128-token chunks (the 300- and 1000-token prompts cross
   several), no kernel in a decode step (so the kernel and plain routes
   must give identical tokens), quant_matmul once through the route
   check; a profile of four decode steps with the recurrent state update
   as a range.
15. mamba2 QFT — phase 6's train path on mamba2-1.3b at full width and
   depth (48 layers), 3 steps of the batch in 8 microbatches: in_proj and
   out_proj of every layer through fake_quant (1 + 2 x 48 launches a
   microbatch each way, the tied head
   not run), no attention kernel (the teacher's hidden states must agree
   exactly across routes), export and 2 greedy requests.
16. zamba2 — phase 5's main path on zamba2-7b at full width and depth (81
   layers: 13 groups of 6 Mamba2 layers, each followed by the one shared
   attention block, then 3 tail layers): decode_attention at hd 112 on
   the monolithic bf16 KV cache in all 13 shared-attention calls of every
   decode step (stats() reports 13 kernel layers), exact-length chunked
   prefill, tokens against the plain route under phase 5's margin rule.
17. zamba2 QFT — phase 6's train path on zamba2-7b at full width, depth
   cut to 7 layers (one group of 6 and one tail layer, so the tail runs),
   3 steps: every weight through fake_quant (the shared block's seven
   once per group call), the teacher's shared attention through
   flash_attention's FMA body (hd 112), its hidden states against the
   plain route, export (the [G, 6] Mamba2 stack's parity) and 2 greedy
   requests.
18. qwen2-vl — phase 5's main path on qwen2-vl-7b at full width and depth
   (28 layers, d 3584, 28/4 heads, biased q/k/v, M-RoPE, vocab 152064),
   text-only requests: decode_attention's paged entry at a GQA group of 7
   in every layer of every decode step, quant_matmul once through the
   route check (on the biased wk), tokens against the plain route under
   phase 5's margin rule.
19. qwen2-vl QFT — phase 6's train path on qwen2-vl-7b at full width, 4
   of 28 layers, on input_specs' train form with a quarter of the context
   as image: 16 x (384 tokens + 128 patch embeddings), positions [16, 3,
   512] with three different streams (the patches on an 8 x 16 grid), so
   that M-RoPE's sections rotate by different positions; the teacher's
   28/4-head attention on flash_attention's tensor-core body.
20. seamless QFT — phase 6's train path on seamless-m4t-medium at full
   width and depth (12 encoder + 12 decoder layers, d 1024, 16/16 heads of
   64, GELU, vocab 256206), 3 steps of 16 x (512 frames -> 64 tokens) in
   4 microbatches: every weight through fake_quant (frame_proj, 6 a
   encoder layer, 10 a decoder layer), the teacher's 36 attention calls a
   forward on flash_attention's tensor-core body (12 causal encoder, 12
   causal decoder, 12 non-causal cross); export and quant_matmul once
   through the route check; then the cache-mode forward on the trained
   artifact (batch 2, 512 frames, a 16-token prompt, prefill, 16 greedy
   decode steps over the cached cross K/V) against one cache-free forward
   (argmax equal, or a near-tie), and the engine's refusal of the family.
21. command-r-plus and qwen3-32b — phase 5's main path on
   command-r-plus-104b at full width (d 12288, 96/8 heads: a GQA group of
   12, ff 33792, vocab 256000, untied) on 2 of 64 layers, and on
   qwen3-32b at full width (d 5120, 64/8 heads, qk-norm, ff 25600) on 16
   of 64: decode_attention's paged entry in every layer of every decode
   step (at G 12 in two query chunks of 8), tokens against the plain
   route under phase 5's near-tie rule.  Phase 3 adds decode_attention at
   8 kv heads x G 12 and G 16 on the slot view (bf16, int8) and the paged
   entry, its bound counting the chunks' K/V re-reads.
22. remat — one microbatch's loss and gradients of a 4-layer full-width
   qwen3-8b student under the remat policies none, full and save_dots
   (held to each other: loss 1e-6 relative, each leaf 1e-5 relative L2);
   then the deepest full-width qwen3-8b student that trains (2 steps of
   phase 6's batch) under full remat, deeper depths tried first.  Every
   train phase remats as the reference's trainer does, so fake_quant's
   forward launches a step count each layer's weights twice; phase 15
   trains mamba2 at full depth in 4 microbatches (8 without remat).
23. the sharded path at world size 1 — one NCCL rank on a localhost
   store, make_elastic_mesh(1, 1): the launcher's build_step (student,
   teacher and Adam state as DTensors) on a 2-layer full-width qwen3-8b
   against the QFTTrainer's step (loss 1e-6 relative), a step with the
   int8 error-feedback compressor, make_ep_moe at tp 1 on a 2-layer
   qwen2-moe against the in-graph MoE, and the elastic runner with an
   injected failure and a real checkpoint restore at SMOKE width (a few
   MB written) against the run without the failure.

24. the launcher and the analyzer — `python -m repro_torch.launch.serve
   --arch qwen3-8b --full --use-kernels --show-plan` at full width and
   depth (calibrate, init and export on the card, the plan table, the
   route check through quant_matmul, 2 greedy requests with
   decode_attention's paged entry in every layer of every decode step),
   its tokens against the same artifact on the plain route under phase
   5's rule; a SMOKE `--ckpt-dir` restore from a SMOKE pipeline workdir;
   `python -m repro_torch check --config qwen3-8b` with the card present,
   its kernel-route prediction held against the decode_attention launches
   of one real SMOKE decode step.  Phase 3 adds quant_matmul's int8 entry
   (K1 on unpacked int8 weights) at deepseek-v2's k_up, kv_down and
   q_down and the CNN fc, M 4 and 8, f32 and bf16, beside the deploy
   view's bf16 torch.matmul, and the operator layer's host cost a call of
   decode_attention's paged entry; phase 8's route check on the CNN's
   int8 fc launches the int8 entry.
25. tensor parallelism over model (sharding.tp) at tp 2 and 4 on the one
   card, each rank a thread of this process under torch's threaded
   process group: build_step on a 2-layer full-width qwen3-8b student,
   phase 6's batch in 4 microbatches, its loss and every gradient leaf
   against the unsharded step the QFTTrainer runs, in bf16 and f32 (the
   step's distance from the f32 step at most twice the bf16 step's);
   each rank's fake_quant and flash_attention launches and the shard
   shapes they ran at.  Phase 3 adds fake_quant at qwen3-8b's tp-16
   shards (wq's and gate/up's columns, wo's and down's rows, a whole KV
   head, the embedding's vocabulary rows) and flash_attention at a tp-16
   rank's 2 query heads over 1 KV head.
26. tensor parallelism in the forward with a cache, ranks as threads as
   in phase 25: a 2-layer full-width qwen3-8b's exported artifact stored
   as params_shardings places it (its q leaves over model only), the
   monolithic bf16 cache (4 rows x depth 1024) as cache_shardings places
   it; 4 rows prefilled with 512 tokens each at scalar pos, then 16
   decode steps at per-slot pos through forward on the kernel route: at
   tp 2 and 4 the KV heads split, every rank launching decode_attention
   on its own [4, 1024, 8/tp, 128] cache in every layer of every step; at
   tp 16 the cache split over the sequence (the dry-run's decode_32k
   layout) with its cross-rank combine.  The logits, gathered over the
   vocabulary for the check only, within twice the bf16 unsharded steps'
   distance from the f32 ones (all fed the f32 steps' greedy tokens);
   decode_attention at a tp rank's shard (4 x 1024, Hkv 4 and 2, G 4)
   against its plain version.
27. the MoE experts and MLA in the forward with a cache on shards, ranks
   as threads as in phase 26: a 2-layer full-width qwen2-moe artifact
   (phase 10's capacity factor 15) at tp 2 and 4 — each rank its 30 or 15
   experts and its shared experts' columns and rows, one g a layer, its
   KV heads of the cache with decode_attention on them in every layer of
   every decode step — and a 2-layer full-width deepseek-v2 artifact
   (phase 12's capacity factor 27) at tp 2 and 4 with the latent cache
   whole on every rank (the dry-run's prefill_32k layout) and at tp 16
   split over the sequence (decode_32k's: k_up/v_up gathered, the
   flash-decoding combine), and in the absorbed form over the sequence at
   tp 4 (each rank's latent queries gathered); phase 26's rows,
   prompt, per-slot pos and 16 decode steps.  The logits, gathered over
   the vocabulary for the check only, within twice the bf16 unsharded
   steps' distance from the f32 ones, the sharded steps replaying the
   unsharded bf16 step's expert choices; rank 0's free choice is counted
   where it differs.

The last line is {"ok": true, "device": {...}}; the line before it holds
the per-kernel JSON record.  Exits non-zero, printing no result, without a
CUDA device or without the repository beside this file.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
# the phases allocate and free tens of GiB in turn; fixed-size segments
# left deepseek-v2's export (phase 12, ~73 GiB at its peak) 6.6 GiB
# reserved but unusable after the remat train phases, and it ran out of
# memory
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

#: H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, bf16 and int8
#: tensor-core operations/s
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}

TRAIN_LAYERS = 4
TRAIN_STEPS = 6
TRAIN_MICROBATCHES = 4
TRAIN_DATA = dict(n_samples=256, seq_len=512, batch_size=16, seed=0)
#: teacher hidden states, flash_attention vs the plain route (bf16 compute,
#: 4 layers): relative L2.  Both round the probabilities to bf16 before P.V,
#: the kernel the unnormalised ones of its online softmax, the plain route
#: the normalised ones; tests/test_torch_flash_attention.py bounds the
#: plain version's gap (f32 probabilities) on the CPU.
TEACHER_HIDDEN_BOUND = 3e-2
#: phase 7: the pipeline's own knobs (PipelineConfig), on qwen3-8b at full
#: width with the depth cut to PIPELINE_LAYERS.  Run 1 writes three stage
#: checkpoints of the f32 student and one of student + Adam state: 40.8 GiB
#: at 3 layers, 45.1 GiB at 4, which is more than the 45 GiB of disk writes
#: the whole script may make (the fixed embedding and head are 68 % of the
#: student at 3 layers, so depth buys little)
PIPELINE_LAYERS = 3
PIPELINE = dict(calib_seq_len=512, calib_batch_size=16, calib_batches=2,
                eval_batches=2, steps=4, serve_smoke=True)

#: phase 8: examples/cnn_paper_repro.py's pipeline knobs for paper-cnn
CNN_PIPELINE = dict(mode="w4a8", steps=600, teacher_steps=300,
                    calib_samples=4096, cle=True, base_lr=1e-3)

#: phases 10-11: qwen2-moe-a2.7b at capacity_factor n_experts/top_k =
#: 15, the remedy the engine's capacity refusal names (the config's 1.25
#: gives a capacity of 1 < 8 slots) and the published model's dropless
#: routing: int(T·4/60·15) = T, so no token drops in a decode step or a
#: prefill chunk.  Phase 11 trains 2 of 24 layers (the f32 training state
#: of 24 is ~286 GB) for 3 steps.
MOE_CAPACITY_FACTOR = 15.0
MOE_TRAIN_LAYERS = 2
MOE_TRAIN_STEPS = 3
#: phase 12: deepseek-v2-236b at full width, 3 of 60 layers (3.97 B
#: parameters a layer, 1.05 B in the embedding and head: 12.97 B, whose f32
#: masters and export peak at ~73 GiB), at capacity factor 27, the least
#: whole one above 160 experts / top-6 = 26.67: int(T·6/160·27) >= T at 8
#: slots and at every prefill bucket up to the 128-token chunk.
DS_LAYERS = 3
DS_CAPACITY_FACTOR = 27.0
#: phase 13: the MLA student at full width with 16 of the 160 experts
#: (2.20 B parameters at 2 layers; one full-width layer would be 5.0 B,
#: ~100 GB of f32 training state), capacity factor 3: C = int(2048·6/16·3)
#: = 2304 >= the 2048 tokens of a microbatch
DS_TRAIN_EXPERTS = 16
DS_TRAIN_CAPACITY_FACTOR = 3.0
DS_TRAIN_LAYERS = 2
DS_TRAIN_STEPS = 3
#: phase 15: mamba2-1.3b's QFT at its full 48 layers (1.34 B parameters,
#: ~27 GB of f32 teacher, student, Adam state and gradients); phase 17:
#: zamba2-7b's at 7 of 81 layers (one group of 6 and one tail layer)
MAMBA_TRAIN_LAYERS = 48
#: the batch (16 x 512) in 4 microbatches, as phase 6's: without remat the
#: SSD scan's f32 intermediates that autograd keeps ([4 sequences, 4
#: chunks, 128, 128, 64 heads] a tensor) outgrew the card at 48 layers and
#: 8 were needed; under remat only the layer boundaries are kept
MAMBA_TRAIN_MICROBATCHES = 4
ZAMBA_TRAIN_LAYERS = 7
SSM_TRAIN_STEPS = 3
# phase 19: qwen2-vl QFT at 4 layers, input_specs' train form with 1/4 of
# the context as image: 16 x (384 tokens + 128 patches on an 8 x 16 grid)
VLM_PATCHES = 128
VLM_GRID = (8, 16)
VLM_TRAIN_DATA = dict(TRAIN_DATA, seq_len=384)
# phase 20: seamless QFT at full depth, input_specs' train form at S 512:
# 512 frames and 64 decoder tokens; then the cache-mode forward
ENCDEC_FRAMES = 512
ENCDEC_TRAIN_DATA = dict(TRAIN_DATA, seq_len=64)
ENCDEC_TRAIN_STEPS = 3
ENCDEC_SERVE_BATCH = 2
ENCDEC_PROMPT = 16
ENCDEC_NEW = 16
#: phase 21: command-r-plus-104b at full width on 2 of 64 layers (1.573 B
#: parameters a layer, 6.29 B in the untied embedding and head: 9.44 B);
#: at 3 layers (11.0 B) init + export peaked at 76.24 GiB of the card's
#: 79.18, under the 5 GiB of headroom a phase keeps; and qwen3-32b on 16
#: of 64 (0.488 B a layer, 1.56 B in the embedding and head: 9.37 B)
CMDR_LAYERS = 2
QWEN32_LAYERS = 16
#: phase 22: the depths tried for qwen3-8b's QFT under remat, deepest
#: first (≈ 3.6 GiB of f32 training state a layer, 23 GiB fixed in the
#: embedding and head)
REMAT_DEPTHS = (14, 13, 12, 11, 10)
#: phase 23: the sharded step's depth; the elastic run at SMOKE width
SHARDED_LAYERS = 2
ELASTIC_STEPS = 5
ELASTIC_CKPT_EVERY = 2
ELASTIC_FAIL_AT = 3
#: phase 25: tensor parallelism over model on the one card, each rank a
#: thread of this process; qwen3-8b at full width on 2 layers, phase 6's
#: batch; the shard shapes of phase 3's rows are qwen3-8b's at tp 16
TP_SIZES = (2, 4)
TP_LAYERS = 2
TP_SHARDS = 16
#: phase 26: the forward with a cache on shards, ranks as threads; the KV
#: heads split at TP_SIZES, the sequence at TP_SEQ (decode_32k's layout)
TP_SEQ = 16
TP_SERVE = dict(rows=4, prompt=512, depth=1024, steps=16)
#: each row's first decode position (per-slot pos): a row may rewrite the
#: tail of its prefilled prompt
TP_SERVE_POS = (512, 448, 384, 320)
#: phase 27: the MoE experts and MLA in the forward with a cache on shards,
#: TP_SERVE's rows, prompt and steps on 2-layer full-width artifacts
#: (qwen2-moe at phase 10's capacity factor, deepseek-v2 at phase 12's:
#: dropless at 4 rows and at the 2048-token prefill).  qwen2-moe at tp 2
#: and 4 (its 16 KV heads split, K2 on each rank's); deepseek-v2 at tp 2
#: and 4 with the latent cache whole on every rank (prefill_32k's layout)
#: and at tp 16 split over the sequence (decode_32k's); the absorbed form
#: over the sequence at tp 4 (at tp 16 its 16 threads took 39.4 s of the
#: phase's 130.1 on an H100).  Each entry: (tp, the cache's split,
#: mla_absorb)
TP_MOE_LAYOUTS = ((2, "heads", False), (4, "heads", False))
TP_MLA_LAYOUTS = ((2, None, False), (4, None, False), (16, "seq", False),
                  (4, "seq", True))
MAIN_PROMPTS = (17, 130, 300, 1000)
NEW_TOKENS = 16
MAIN_SERVE = dict(max_slots=8, max_len=2048, prefill_chunk=128)
MARGIN_ULPS = 4
DEVICE = "cuda"
#: the card's name and power limit (nvidia-smi), read by probe()
CARD = "not read"


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, ops: float, kind: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 1-2
# ---------------------------------------------------------------------------

def probe() -> None:
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    global CARD
    CARD = smi.stdout.strip().splitlines()[0]
    say(CARD)
    say(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  device {torch.cuda.get_device_name(0)}  "
        f"count {torch.cuda.device_count()}")
    from repro_torch.kernels import _build
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60)
    say("nvcc " + nvcc.stdout.strip().splitlines()[-1])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def build() -> None:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build(force=True)
    say(f"[build] {', '.join(_build.KERNELS)} built for sm_90a in "
        f"{time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------

def device_ms(fn, names: tuple, iters: int = 20) -> float:
    """Device time per call of the kernels whose name holds one of
    ``names``, summed over ``iters`` calls of ``fn`` under torch.profiler
    (no host time in it); None if the profiler recorded none."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    us = 0.0
    for _ in range(2):          # a window the profiler dropped is taken again
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA and any(n in e.key
                                                        for n in names):
                us += getattr(e, "self_device_time_total",
                              getattr(e, "self_cuda_time_total", 0))
        if us:
            break
    return us / iters / 1e3 if us else None


def check_decode_attention(kv, G: int = 4, tag: str = "",
                           Hkv: int = 8, hd: int = 128) -> dict:
    """K2's rows at ``Hkv`` kv heads, a GQA group of ``G`` query heads
    per kv head and head dim ``hd`` (qwen3-8b 8 x 4, phi4-mini 8 x 3,
    qwen2-moe 16 x 1, zamba2 32 x 1 at hd 112): bf16
    and int8 on the slot view at the engine's slot
    pool (S 8 x T ``kv.view_len``), one long bf16 slot (S 1 x T 2048), and
    the paged entry at the engine's geometry (``kv``: P 16, pt [8, 128])
    with shuffled page ids, a retired slot on the trash page and a trash
    page of 127s.  Returns the paged row's record, the main path's body,
    with the bf16 row's numbers beside it."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_paged,
                                                      query_chunks,
                                                      split_rows, tile_rows)
    from repro_torch.kernels.ref import (decode_attention_paged_ref,
                                         decode_attention_ref)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    S, T = 8, kv.view_len
    P, n_pg = kv.page_size, kv.max_pages_per_slot
    # the main path's four requests mid-decode, a fresh slot (length 1), a
    # full slot (T) and two split edges
    lengths = torch.tensor([1, 25, 138, 308, 1008, 33, T - 1, T],
                           dtype=torch.int32, device=dev)
    q = torch.randn((S, Hkv, G, hd), generator=g, device=dev).bfloat16()
    names = ("fd_split", "fd_combine")

    def int8(shape):
        return torch.randint(-127, 128, shape, generator=g, device=dev,
                             dtype=torch.int8)

    def scales(n):
        return torch.rand((n, Hkv), generator=g, device=dev) * 0.02 + 0.005

    def sdpa(q, k, v, lengths):
        n, t = k.shape[0], k.shape[1]
        qh = q.reshape(n, Hkv * G, 1, hd)
        mask = (torch.arange(t, device=dev)[None, :]
                < lengths[:, None])[:, None, None, :]
        kt, vt = k.transpose(1, 2), v.transpose(1, 2)
        return lambda: F.scaled_dot_product_attention(
            qh, kt, vt, attn_mask=mask, enable_gqa=G > 1)

    def row(kind, fn, ref_fn, args, lens, t, elt, extra_bytes, lib=None):
        out = fn(*args)
        ref = ref_fn(*args)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        tol = 1e-2 * float(ref.float().abs().max())   # one bf16 rounding
        if not math.isfinite(err) or err > tol:
            fail(f"decode_attention {kind}: max_abs_err {err} > {tol}")
        ms = time_ms(lambda: fn(*args))
        dev_ms = device_ms(lambda: fn(*args), names)
        plain_ms = time_ms(lambda: ref_fn(*args), iters=5)
        lib_ms = None if lib is None else time_ms(lib)
        live = int(torch.clamp(lens, max=t).sum())
        n = lens.numel()
        tile = tile_rows(args[1].dtype, hd, G)
        # the function reads each K/V row once; a group above 8 runs in
        # query chunks of 8 whose blocks each read the rows again, a cost of
        # the kernel's design that the bound does not count
        kv_bytes = 2 * live * Hkv * hd * elt
        rest = 2 * q[:n].numel() * 2 + n * 4 + extra_bytes
        b_ms, b_by = bound(kv_bytes + rest, 4 * live * Hkv * G * hd,
                           "int8" if elt == 1 else "bf16")
        kernel_bytes = kv_bytes * query_chunks(G) + rest
        dev_txt = "not measured" if dev_ms is None else f"{dev_ms:.4f}"
        say(f"[kernel] decode_attention{tag} {kind} S={n} Hkv={Hkv} G={G} "
            f"hd={hd} T={t} split="
            f"{split_rows(t, n * Hkv * query_chunks(G), tile)} rows "
            f"max_abs_err={err:.3e} (tol {tol:.3e}) ms={ms:.4f} "
            f"device_ms={dev_txt} plain_ms={plain_ms:.4f} library_ms="
            f"{'null' if lib_ms is None else f'{lib_ms:.4f}'} "
            f"bound_ms={b_ms:.4f} ({b_by}) kernel_read_bytes={kernel_bytes}")
        return {"max_abs_err": err, "ms": ms, "device_ms": dev_ms,
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": lib_ms, "kernel_read_bytes": kernel_bytes}

    k = torch.randn((S, T, Hkv, hd), generator=g, device=dev).bfloat16()
    v = torch.randn((S, T, Hkv, hd), generator=g, device=dev).bfloat16()
    bf16 = row("bf16", decode_attention, decode_attention_ref,
               (q, k, v, lengths), lengths, T, 2, 0, lib=sdpa(q, k, v,
                                                             lengths))
    ks, vs = scales(S), scales(S)
    k8, v8 = int8((S, T, Hkv, hd)), int8((S, T, Hkv, hd))
    i8 = row("int8", decode_attention, decode_attention_ref,
             (q, k8, v8, lengths, ks, vs), lengths, T, 1, 2 * S * Hkv * 4)
    del k, v, k8, v8
    # one long slot: split across blocks
    T1 = 2048
    l1 = torch.tensor([T1], dtype=torch.int32, device=dev)
    k1 = torch.randn((1, T1, Hkv, hd), generator=g, device=dev).bfloat16()
    v1 = torch.randn((1, T1, Hkv, hd), generator=g, device=dev).bfloat16()
    long = row("bf16 one slot", decode_attention, decode_attention_ref,
               (q[:1].contiguous(), k1, v1, l1), l1, T1, 2, 0,
               lib=sdpa(q[:1], k1, v1, l1))
    del k1, v1
    # the paged entry at the engine's geometry: every slot's pages shuffled
    # over the whole pool, slot 0 retired (all its entries on the trash
    # page, length 1, as the engine leaves it), a trash page of 127s
    n_pages = S * n_pg
    pool_k, pool_v = int8((n_pages + 1, P, Hkv, hd)), int8(
        (n_pages + 1, P, Hkv, hd))
    pool_k[n_pages] = 127
    pool_v[n_pages] = 127
    pt = torch.randperm(n_pages, generator=g, device=dev).to(
        torch.int32).reshape(S, n_pg)
    used = (lengths + P - 1) // P
    pt[torch.arange(n_pg, device=dev)[None, :] >= used[:, None]] = n_pages
    pt[0] = n_pages
    args = (q, pool_k, pool_v, pt, lengths, ks, vs)
    paged = row("paged int8", decode_attention_paged,
                decode_attention_paged_ref, args, lengths, T, 1,
                2 * S * Hkv * 4 + int(used.sum()) * 4)

    def gather_route():
        return decode_attention(q, pool_k[pt].reshape(S, T, Hkv, hd),
                                pool_v[pt].reshape(S, T, Hkv, hd), lengths,
                                ks, vs)
    route_ms = time_ms(gather_route)
    say(f"[kernel] decode_attention{tag} paged int8, the route before this "
        f"entry (pool[pt] gather + the slot-view kernel): ms={route_ms:.4f} "
        f"(for comparison; the yardstick is the plain version)")
    return dict(paged, G=G, bf16_max_abs_err=bf16["max_abs_err"],
                bf16_ms=bf16["ms"], bf16_device_ms=bf16["device_ms"],
                bf16_bound_ms=bf16["bound_ms"],
                bf16_library_ms=bf16["library_ms"],
                bf16_plain_ms=bf16["plain_ms"], int8_ms=i8["ms"],
                int8_device_ms=i8["device_ms"], int8_bound_ms=i8["bound_ms"],
                int8_plain_ms=i8["plain_ms"],
                one_slot_ms=long["ms"], gather_route_ms=route_ms)


def _int4pack_route(x, qw, s_wl, s_wr):
    """torch._weight_int4pack_mm set up to compute quant_matmul's function
    (the yardstick, never called by the port): q + 8 in [0, 15] packed
    for the op, zero 0, s_wr repeated over groups of 128 for the channel
    layout, x * s_wl formed before the call.  Returns (fn, None) or (None,
    the reason the op cannot serve)."""
    import torch
    from repro_torch.core.fakequant import unpack_int4
    op = getattr(torch.ops.aten, "_weight_int4pack_mm", None)
    conv = getattr(torch.ops.aten, "_convert_weight_to_int4pack", None)
    if op is None or conv is None:
        return None, "torch has no _weight_int4pack_mm"
    K, N = 2 * qw.shape[0], qw.shape[1]
    gs = 128
    qu = (unpack_int4(qw, axis=0).to(torch.int32) + 8).t().contiguous()
    w8 = ((qu[:, ::2] << 4) | qu[:, 1::2]).to(torch.uint8)    # [N, K/2]
    sc = (s_wr[None, :].expand(K // gs, N) if s_wr.ndim == 1
          else s_wr).float()
    sz = torch.stack([sc, torch.zeros_like(sc)], dim=-1).to(
        torch.bfloat16).contiguous()                          # [K/g, N, 2]
    xs = (x.float() * s_wl).to(x.dtype)
    try:
        packed = conv(w8, 8)
        fn = lambda: op(xs, packed, gs, sz)                   # noqa: E731
        fn()
    except RuntimeError as e:
        return None, f"refused: {str(e).splitlines()[0][:120]}"
    return fn, None


def _cold(make, n_bytes: int, names: tuple, reps: int = 3) -> tuple:
    """(event ms, profiler device ms) per call over enough copies of the
    inputs (``make(i)`` returns the i-th call) to pass twice the 50 MB L2,
    so that each call reads its weights from device memory as the real
    caller, 36 layers of weights, does."""
    import itertools
    import torch
    n = max(2, math.ceil(2 * 50e6 / n_bytes) + 1)
    calls = [make(i) for i in range(n)]
    for fn in calls:
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        for fn in calls:
            fn()
    end.record()
    torch.cuda.synchronize()
    it = itertools.cycle(calls)
    return (start.elapsed_time(end) / (reps * n),
            device_ms(lambda: next(it)(), names, iters=reps * n))


def _qmm_bodies() -> tuple:
    from repro_torch.kernels.quant_matmul import quant_matmul
    return tuple(getattr(quant_matmul, f"launches_{b}")
                 for b in ("mma", "mma_wide", "fma"))


def check_quant_matmul(cfg) -> tuple[dict, dict]:
    """Both entries of quant_matmul (K1 int8dot, K5 dequant) against the
    plain version at qwen3-8b's seven linear shapes, decode and prefill M,
    channel and group:128, plus the route check's f32 shape: the error,
    two launches' bits, the body each launch took (split-K mma at M <= 16,
    the wide mma body at prefill M, fma for f32); then the variant
    benchmark — the dequant entry's only caller (the JAX package's
    benchmarks/run.py:70-76), its launches counted from 0 over that run:
    the event time warm and, at M 8, L2-cold (weights rotated past the
    L2), the profiler's device time, the plain version, the int4
    yardstick torch._weight_int4pack_mm, the deploy view's torch.matmul on
    the dequantized weight, and the bound.  Returns (int8dot, dequant)
    records of the route-check shape."""
    import torch
    from repro_torch.core.fakequant import pack_int4, unpack_int4
    from repro_torch.kernels.quant_matmul import quant_matmul
    from repro_torch.kernels.ref import quant_matmul_ref
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    d, hq, hkv, ff = (cfg.d_model, cfg.n_heads * cfg.head_dim,
                      cfg.n_kv_heads * cfg.head_dim, cfg.d_ff)
    shapes = {"wq": (d, hq), "wk": (d, hkv), "wv": (d, hkv), "wo": (hq, d),
              "gate": (d, ff), "up": (d, ff), "down": (ff, d)}
    # (M, dtype, layouts): decode and prefill M in bf16, plus the shape and
    # type kernel_route_check drives (M=4 rows of f32 on layers.attn.wk)
    cases = [(name, M, torch.bfloat16, layout)
             for name in shapes for M in (8, 128)
             for layout in ("channel", "group:128")]
    cases.append(("wk", 4, torch.float32, "channel"))

    def make(name, M, dt, layout):
        K, N = shapes[name]
        x = torch.randn((M, K), generator=g, device=dev).to(dt)
        q4 = torch.randint(-8, 8, (K, N), generator=g, device=dev,
                           dtype=torch.int8)
        qw = pack_int4(q4, axis=0).contiguous()
        s_wl = torch.rand((K,), generator=g, device=dev) + 0.5
        swr_shape = (N,) if layout == "channel" else (K // 128, N)
        s_wr = (torch.rand(swr_shape, generator=g, device=dev) + 0.5) * 0.01
        return x, qw, s_wl, s_wr

    want_body = {True: "mma", False: "mma_wide"}
    inputs = [make(*c) for c in cases]
    errs, bodies = {}, {}
    for (name, M, dt, layout), args in zip(cases, inputs):
        ref = quant_matmul_ref(*args)
        scale = float(ref.float().abs().max())
        want = "fma" if dt == torch.float32 else want_body[M <= 16]
        for variant in ("int8dot", "dequant"):
            before = _qmm_bodies()
            y = quant_matmul(*args, variant=variant)
            again = quant_matmul(*args, variant=variant)
            torch.cuda.synchronize()
            ran = [b for b, x0, x1 in zip(("mma", "mma_wide", "fma"), before,
                                          _qmm_bodies()) if x1 == x0 + 2]
            if ran != [want]:
                fail(f"quant_matmul {variant} {name} M={M} {layout}: ran "
                     f"{ran}, want the {want} body")
            if not torch.equal(y, again):
                fail(f"quant_matmul {variant} {name} M={M} {layout}: two "
                     f"launches differ")
            err = float((y.float() - ref.float()).abs().max())
            # f32: summation order only; bf16: one rounding of the f32
            # result (the reference sweep's 2e-5 / 2e-2, of the output's
            # largest magnitude)
            tol = (2e-5 if dt == torch.float32 else 2e-2) * scale
            if not math.isfinite(err) or err > tol:
                fail(f"quant_matmul {variant} {name} M={M} {layout}: "
                     f"max_abs_err {err} > {tol}")
            errs[(name, M, dt, layout, variant)] = (err, tol)
            bodies[(name, M, dt, layout)] = want

    # --- the variant benchmark, with the dequant entry's count at 0
    quant_matmul.launches_dequant = 0
    per_body = {"int8dot": [0, 0, 0], "dequant": [0, 0, 0]}
    records = {}
    names = ("qmm_",)
    for (name, M, dt, layout), args in zip(cases, inputs):
        x, qw, s_wl, s_wr = args
        K, N = shapes[name]
        kind = str(dt).split(".")[-1]
        w = (unpack_int4(qw, axis=0).float() * s_wl[:, None]
             * (s_wr[None, :] if s_wr.ndim == 1
                else s_wr.repeat_interleave(K // s_wr.shape[0], 0))).to(dt)
        cold = M == 8
        copies = {}

        def copy(i):
            if i not in copies:
                copies[i] = [t.clone() for t in args]
            return copies[i]

        nbytes = (x.numel() * x.element_size() + qw.numel() + 4 * K
                  + 4 * s_wr.numel() + M * N * x.element_size())
        stats = {}
        for v in ("int8dot", "dequant"):
            run = lambda v=v: quant_matmul(*args, variant=v)   # noqa: E731
            b0 = _qmm_bodies()
            stats[v] = {"ms": time_ms(run), "device_ms": device_ms(run, names),
                        "cold": _cold(
                            lambda i, v=v: (lambda a=copy(i): quant_matmul(
                                *a, variant=v)), qw.numel(), names)
                        if cold else (None, None)}
            per_body[v] = [c + b - a for c, a, b in zip(
                per_body[v], b0, _qmm_bodies())]
        plain_ms = time_ms(lambda: quant_matmul_ref(*args), iters=10)
        lib, why = _int4pack_route(*args)
        lib_stats = (None, None, None)
        if lib is not None:
            ref = quant_matmul_ref(*args).float()
            lib_err = float((lib().float() - ref).abs().max())
            lib_tol = 2e-2 * float(ref.abs().max())
            if not lib_err <= lib_tol:
                why, lib = (f"disagrees with quant_matmul_ref: max_abs_err "
                            f"{lib_err:.3e} > {lib_tol:.3e}"), None
        if lib is not None:
            lib_stats = (time_ms(lib), device_ms(lib, ("",)),
                         _cold(lambda i: _int4pack_route(*copy(i))[0],
                               qw.numel(), ("",))[1] if cold else None)
        gemm = lambda: torch.matmul(x, w)                      # noqa: E731
        gemm_stats = (time_ms(gemm), device_ms(gemm, ("",)),
                      _cold(lambda i: (lambda xx=x, ww=w.clone():
                                       torch.matmul(xx, ww)),
                            w.numel() * w.element_size(), ("",))[1]
                      if cold else None)
        del copies
        b_ms, b_by = bound(nbytes, 2.0 * M * K * N,
                           "f32" if dt == torch.float32 else "bf16")

        def num(t):
            return "null" if t is None else f"{t:.4f}"
        for v in ("int8dot", "dequant"):
            err, tol = errs[(name, M, dt, layout, v)]
            st = stats[v]
            dev_ms = st["device_ms"]
            say(f"[kernel] quant_matmul {v} {name} M={M} K={K} N={N} "
                f"{layout} {kind} body={bodies[(name, M, dt, layout)]} "
                f"max_abs_err={err:.3e} (tol {tol:.3e}) bits=identical "
                f"ms={st['ms']:.4f} device_ms={num(dev_ms)} "
                f"cold_ms={num(st['cold'][0])} cold_device_ms="
                f"{num(st['cold'][1])} plain_ms={plain_ms:.4f} "
                f"library_ms={num(lib_stats[0])} library_device_ms="
                f"{num(lib_stats[1])} library_cold_device_ms="
                f"{num(lib_stats[2])}"
                f"{'' if lib is not None else f' ({why})'} "
                f"deploy_gemm_ms={gemm_stats[0]:.4f} deploy_gemm_device_ms="
                f"{num(gemm_stats[1])} deploy_gemm_cold_device_ms="
                f"{num(gemm_stats[2])} bound_ms={b_ms:.4f} ({b_by})"
                + ("" if dev_ms is None else
                   f" device/bound={dev_ms / b_ms:.1f}x"))
            if dt == torch.float32:   # what the main path's route check runs
                records[v] = {"max_abs_err": err, "ms": st["ms"],
                              "device_ms": dev_ms, "plain_ms": plain_ms,
                              "bound_ms": b_ms, "bound_by": b_by,
                              "library_ms": lib_stats[0],
                              "deploy_gemm_ms": gemm_stats[0],
                              "body": bodies[(name, M, dt, layout)]}
        del w
    records["dequant"]["launches"] = quant_matmul.launches_dequant
    records["dequant"].update(zip(
        ("launches_mma", "launches_mma_wide", "launches_fma"),
        per_body["dequant"]))
    # ---
    say(f"[kernel] quant_matmul variant benchmark: dequant launched "
        f"{quant_matmul.launches_dequant} times; per body (mma, mma_wide, "
        f"fma): int8dot {per_body['int8dot']}, dequant "
        f"{per_body['dequant']}")
    torch.cuda.empty_cache()
    return records["int8dot"], records["dequant"]


def check_quant_matmul_int8(ds_cfg, cnn_cfg) -> dict:
    """K1's int8 entry (the unpacked int8 weights the plan keeps at 8 bits)
    against its plain version at deepseek-v2-236b's MLA k_up, kv_down and
    q_down and the paper CNN's fc, M 4 and 8, f32 (the route check's type)
    and bf16, the channel layout the plan gives them; then, through
    ``qlinear_deployed``, two int4 shapes the int4 entry does not tile
    (SMOKE width's wk, N 32; a router's N 60), whose packed nibbles the
    entry reads in place (each call must add one launch of the int8 entry
    and none of the int4 one).  Each row: the error (f32 1e-5, bf16 2^-7
    of max|ref|), two launches' bits, the event and profiler device time,
    the plain version, the deploy view's bf16 torch.matmul at the same
    shape (the yardstick) and the bound: the weight read, x, the scales
    and y once, 2 M K N operations at the peak of the body's operands
    (``plan_int8``: the ``mma`` body's bf16 tensor cores for bf16 x on a
    tiled shape, else f32 CUDA cores).  Returns the record of the CNN
    fc's route-check shape (f32, M 4), with q_down's bf16 M 8 (the
    ``mma`` body) under ``mma`` and SMOKE wk's f32 M 4 under ``packed``."""
    import torch
    from repro_torch.core.fakequant import pack_int4
    from repro_torch.kernels.ops import qlinear_deployed
    from repro_torch.kernels.quant_matmul import (plan_int8, quant_matmul,
                                                  quant_matmul_int8)
    from repro_torch.kernels.ref import quant_matmul_int8_ref
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(28)
    m = ds_cfg.mla
    H = ds_cfg.n_heads_padded
    shapes = {"k_up": (m.kv_lora, H * m.d_nope),
              "kv_down": (ds_cfg.d_model, m.kv_lora + m.d_rope),
              "q_down": (ds_cfg.d_model, m.q_lora),
              "cnn_fc": (cnn_cfg.channels[-1], cnn_cfg.n_classes),
              "smoke_wk_int4": (64, 32), "router_int4": (2048, 60)}
    names = ("qmm_i8", "qmm_mma")
    records = {}
    before = quant_matmul.launches_int8
    for name, (K, N) in shapes.items():
        packed = name.endswith("_int4")
        q = torch.randint(-8 if packed else -128, 8 if packed else 128,
                          (K, N), generator=g, device=dev, dtype=torch.int8)
        s_wl = torch.rand((K,), generator=g, device=dev) + 0.5
        s_wr = (torch.rand((N,), generator=g, device=dev) + 0.5) * 0.01
        if packed:
            ex = {"q": pack_int4(q, axis=0), "s_wl": s_wl, "s_wr": s_wr}
            call = lambda x, ex=ex: qlinear_deployed(x, ex)  # noqa: E731
        else:
            call = lambda x, q=q, s_wl=s_wl, s_wr=s_wr: (  # noqa: E731
                quant_matmul_int8(x, q, s_wl, s_wr))
        for M in (4, 8):
            for dt in (torch.float32, torch.bfloat16):
                x = torch.randn((M, K), generator=g, device=dev).to(dt)
                body = plan_int8(M, N, K, None, dt, packed).body
                n0 = (quant_matmul.launches, quant_matmul.launches_int8)
                y = call(x)
                again = call(x)
                torch.cuda.synchronize()
                kind = str(dt).split(".")[-1]
                tag = f"quant_matmul int8 {name} M={M} {kind}"
                if (quant_matmul.launches, quant_matmul.launches_int8) != (
                        n0[0], n0[1] + 2):
                    fail(f"{tag}: two calls launched the int4 entry "
                         f"{quant_matmul.launches - n0[0]} and the int8 "
                         f"entry {quant_matmul.launches_int8 - n0[1]} "
                         f"times, want 0 and 2")
                ref = quant_matmul_int8_ref(x, q, s_wl, s_wr).float()
                scale = float(ref.abs().max())
                err = float((y.float() - ref).abs().max())
                tol = (1e-5 if dt == torch.float32 else 2 ** -7) * scale
                if not math.isfinite(err) or err > tol:
                    fail(f"{tag}: max_abs_err {err} > {tol}")
                if not torch.equal(y, again):
                    fail(f"{tag}: two launches differ")
                run = lambda x=x: call(x)                     # noqa: E731
                ms = time_ms(run)
                dev_ms = device_ms(run, names)
                plain_ms = time_ms(
                    lambda x=x: quant_matmul_int8_ref(x, q, s_wl, s_wr),
                    iters=10)
                w = (q.float() * s_wl[:, None] * s_wr[None, :]).to(
                    torch.bfloat16)
                xb = x.to(torch.bfloat16)
                gemm = lambda xb=xb, w=w: torch.matmul(xb, w)  # noqa: E731
                lib_ms = time_ms(gemm)
                lib_dev = device_ms(gemm, ("",))
                nbytes = (x.numel() * x.element_size()
                          + (K * N // 2 if packed else K * N) + 4 * K
                          + 4 * N + M * N * x.element_size())
                b_ms, b_by = bound(nbytes, 2.0 * M * K * N,
                                   "bf16" if body == "mma" else "f32")
                say(f"[kernel] quant_matmul int8 {name} M={M} K={K} N={N} "
                    f"channel {kind} body={body}"
                    + (" packed, via qlinear_deployed" if packed else "")
                    + f" max_abs_err={err:.3e} (tol {tol:.3e}) "
                    f"bits=identical ms={ms:.4f} device_ms="
                    f"{'null' if dev_ms is None else f'{dev_ms:.4f}'} "
                    f"plain_ms={plain_ms:.4f} bf16_matmul_ms={lib_ms:.4f} "
                    f"bf16_matmul_device_ms="
                    f"{'null' if lib_dev is None else f'{lib_dev:.4f}'} "
                    f"bound_ms={b_ms:.4f} ({b_by})"
                    + ("" if dev_ms is None else
                       f" device/bound={dev_ms / b_ms:.1f}x"))
                records[(name, M, kind)] = {
                    "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
                    "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": lib_ms, "library_device_ms": lib_dev,
                    "body": body}
                del w
    say(f"[kernel] quant_matmul int8 entry launched "
        f"{quant_matmul.launches_int8 - before} times in phase 3; the int4 "
        f"entry's counts untouched")
    return {**records[("cnn_fc", 4, "float32")],
            "mma": {"shape": "q_down M 8 bf16",
                    **records[("q_down", 8, "bfloat16")]},
            "packed": {"shape": "smoke_wk_int4 M 4 f32",
                       **records[("smoke_wk_int4", 4, "float32")]}}


def op_dispatch_overhead(kv) -> dict:
    """What the torch.library operator layer adds to a kernel call: host
    microseconds a call of decode_attention's paged entry through its
    operator (``repro_torch::decode_attention_paged``) against its CUDA
    implementation called directly, and through the whole wrapper (its
    argument checks, then the operator), at the engine's paged cache
    (qwen3-8b: 8 kv heads x G 4, hd 128); 400 calls a run, runs in the
    order wrapper, op, direct, direct, op, wrapper, each ended by a
    synchronize (the calls are host-bound at this size)."""
    import torch
    from repro_torch.kernels import decode_attention as fd
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(29)
    S, Hkv, G, hd = 8, 8, 4, 128
    P, n_pg = kv.page_size, kv.max_pages_per_slot
    q = torch.randn((S, Hkv, G, hd), generator=g, device=dev).to(
        torch.bfloat16)
    pool_k = torch.randint(-127, 128, (S * n_pg + 1, P, Hkv, hd),
                           generator=g, device=dev, dtype=torch.int8)
    pool_v = torch.randint_like(pool_k, -127, 128)
    pt = torch.randperm(S * n_pg, generator=g, device=dev).to(
        torch.int32).reshape(S, n_pg)
    lengths = torch.full((S,), n_pg * P, dtype=torch.int32, device=dev)
    ks = torch.rand((S, Hkv), generator=g, device=dev) * 0.01
    vs = torch.rand((S, Hkv), generator=g, device=dev) * 0.01
    args = (q, pool_k, pool_v, pt, lengths, ks, vs)
    ways = {"wrapper": lambda: fd.decode_attention_paged(*args),
            "op": lambda: fd._OP_PAGED(*args),
            "direct": lambda: fd._run_paged(*args)}
    if not (torch.equal(ways["op"](), ways["direct"]())
            and torch.equal(ways["wrapper"](), ways["direct"]())):
        fail("decode_attention_paged: the wrapper, the operator and the "
             "direct call differ")
    n = 400
    us: dict = {k: [] for k in ways}
    for way in ("wrapper", "op", "direct", "direct", "op", "wrapper"):
        for _ in range(20):
            ways[way]()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            ways[way]()
        torch.cuda.synchronize()
        us[way].append((time.perf_counter() - t0) / n * 1e6)
    mean = {k: sum(v) / len(v) for k, v in us.items()}
    out = {"wrapper_us": mean["wrapper"], "op_us": mean["op"],
           "direct_us": mean["direct"],
           "operator_added_us": mean["op"] - mean["direct"],
           "checks_added_us": mean["wrapper"] - mean["op"], "runs_us": us}
    say(f"[kernel] operator layer: decode_attention_paged host us a call: "
        f"wrapper {mean['wrapper']:.2f}, operator {mean['op']:.2f}, direct "
        f"{mean['direct']:.2f} (runs {us}): the operator adds "
        f"{out['operator_added_us']:+.2f} us, the wrapper's checks "
        f"{out['checks_added_us']:+.2f} us")
    return out


def check_flash_attention(cfg) -> dict:
    """flash_attention (through ops.attention_prefill, GQA read in the
    kernel) against its plain version at qwen3-8b's heads: the teacher's
    prefill (B 16 x S 512) and a ragged S (B 1 x S 300), f32 (the FMA body)
    and bf16 (the tensor-core body), causal and not, within the reference's
    own tolerances (f32 rtol 2e-4 atol 2e-5; bf16 3e-2); two runs' bits
    compared; the body each launch took read off its count.  Returns the
    teacher shape's bf16 causal record."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (attention_prefill,
                                                     flash_attention)
    from repro_torch.kernels.ref import (attention_prefill_ref,
                                         flash_attention_ref)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(9)
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    record = None

    def body_of(fn) -> str:
        before = flash_attention.launches_wgmma, flash_attention.launches_fma
        out = fn()
        ran = [n for n, b, a in zip(("wgmma", "fma"), before, (
            flash_attention.launches_wgmma, flash_attention.launches_fma))
            if a == b + 1]
        if len(ran) != 1:
            fail(f"flash_attention: one call counted {ran}")
        return out, ran[0]

    for (B, S) in ((16, 512), (1, 300)):
        base = [torch.randn((B, S, h, hd), generator=g, device=dev)
                for h in (H, Hkv, Hkv)]
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = (t.to(dt) for t in base)
            rtol, atol = (2e-4, 2e-5) if dt == torch.float32 else (3e-2, 3e-2)
            kind = "f32" if dt == torch.float32 else "bf16"
            for causal in (True, False):
                out, body = body_of(lambda: attention_prefill(
                    q, k, v, causal=causal))
                want = "fma" if kind == "f32" else "wgmma"
                if body != want:
                    fail(f"flash_attention {kind} B={B} S={S} ran the {body}"
                         f" body, want {want}")
                ref = attention_prefill_ref(q, k, v, causal=causal)
                torch.cuda.synchronize()
                diff = (out.float() - ref.float()).abs()
                excess = float((diff - rtol * ref.float().abs()).max())
                err = float(diff.max())
                if not math.isfinite(err) or excess > atol:
                    fail(f"flash_attention B={B} S={S} {dt} causal={causal}: "
                         f"max_abs_err {err}, beyond rtol {rtol} + atol "
                         f"{atol} by {excess - atol}")
                if not torch.equal(out, attention_prefill(q, k, v,
                                                          causal=causal)):
                    fail("flash_attention: two runs differ")
                ms = time_ms(lambda: attention_prefill(
                    q, k, v, causal=causal), iters=20)
                plain_ms = time_ms(lambda: attention_prefill_ref(
                    q, k, v, causal=causal), iters=5)
                qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
                lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, enable_gqa=True), iters=20)
                elt = q.element_size()
                nbytes = elt * hd * B * S * (2 * H + 2 * Hkv)
                pairs = S * (S + 1) // 2 if causal else S * S
                flops = 4.0 * B * H * pairs * hd
                b_ms, b_by = bound(nbytes, flops, kind)
                say(f"[kernel] flash_attention B={B} S={S} H={H} Hkv={Hkv} "
                    f"hd={hd} {kind} causal={causal} body={body} "
                    f"max_abs_err={err:.3e} (rtol {rtol} atol {atol}) "
                    f"ms={ms:.4f} ({flops / ms / 1e9:.1f} TFLOP/s) "
                    f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
                    f"(kernel/SDPA {ms / lib_ms:.2f}x) bound_ms={b_ms:.4f} "
                    f"({b_by})")
                if (B, S, kind, causal) == (16, 512, "bf16", True):
                    record = {"max_abs_err": err, "ms": ms,
                              "plain_ms": plain_ms, "bound_ms": b_ms,
                              "bound_by": b_by, "library_ms": lib_ms,
                              "body": body}
                del out, ref, diff
        del base, q, k, v
    # the reference's own [BH, S, hd] signature, on one small f32 case
    q3, k3, v3 = (torch.randn((4, 200, 64), generator=g, device=dev)
                  for _ in range(3))
    ref3 = flash_attention_ref(q3, k3, v3)
    out3, body = body_of(lambda: flash_attention(q3, k3, v3))
    excess = float(((out3 - ref3).abs() - 2e-4 * ref3.abs()).max())
    if body != "fma" or not excess <= 2e-5:
        fail(f"flash_attention [BH, S, hd] ({body} body): beyond rtol 2e-4 + "
             f"atol 2e-5 by {excess - 2e-5}")
    torch.cuda.empty_cache()
    return record


def check_flash_attention_fma(cfg) -> dict:
    """flash_attention's FMA body at zamba2-7b's teacher shape: B 16 x
    S 512, its 32/32 heads at hd 112 (the tensor-core body is built for
    hd 64 and 128 only), bf16, causal (:func:`check_flash_attention_at`).
    Returns the record."""
    return check_flash_attention_at("zamba2", 16, 512, 512, cfg.n_heads,
                                    cfg.n_kv_heads, cfg.head_dim, True,
                                    "fma", seed=19)


def check_flash_attention_at(tag: str, B: int, S: int, Sk: int, H: int,
                             Hkv: int, hd: int, causal: bool, body: str,
                             seed: int) -> dict:
    """flash_attention at one teacher shape: q ``[B, S, H, hd]`` over k, v
    ``[B, Sk, Hkv, hd]``, bf16, through ``body`` (read off its count);
    against the plain version within the bf16 tolerance of
    check_flash_attention, two runs' bits compared, beside SDPA.  Returns
    the record."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (attention_prefill,
                                                     flash_attention)
    from repro_torch.kernels.ref import attention_prefill_ref
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, S, H, hd), generator=g, device=dev).bfloat16()
    k, v = (torch.randn((B, Sk, Hkv, hd), generator=g, device=dev)
            .bfloat16() for _ in range(2))
    attr = f"launches_{body}"
    before = getattr(flash_attention, attr)
    out = attention_prefill(q, k, v, causal=causal)
    if getattr(flash_attention, attr) != before + 1:
        fail(f"flash_attention {tag} did not run the {body} body")
    ref = attention_prefill_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    rtol = atol = 3e-2
    diff = (out.float() - ref.float()).abs()
    excess = float((diff - rtol * ref.float().abs()).max())
    err = float(diff.max())
    if not math.isfinite(err) or excess > atol:
        fail(f"flash_attention {tag}: max_abs_err {err}, beyond rtol "
             f"{rtol} + atol {atol} by {excess - atol}")
    if not torch.equal(out, attention_prefill(q, k, v, causal=causal)):
        fail(f"flash_attention {tag}: two runs differ")
    ms = time_ms(lambda: attention_prefill(q, k, v, causal=causal),
                 iters=10)
    plain_ms = time_ms(lambda: attention_prefill_ref(q, k, v,
                                                     causal=causal), iters=3)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, enable_gqa=True), iters=20)
    nbytes = 2 * hd * B * (2 * S * H + 2 * Sk * Hkv)
    pairs = S * (S + 1) // 2 if causal else S * Sk
    flops = 4.0 * B * H * pairs * hd
    b_ms, b_by = bound(nbytes, flops, "bf16")
    say(f"[kernel] flash_attention {tag} B={B} S={S} Sk={Sk} H={H} "
        f"Hkv={Hkv} hd={hd} bf16 causal={causal} body={body} "
        f"max_abs_err={err:.3e} (rtol {rtol} atol {atol}) ms={ms:.4f} "
        f"({flops / ms / 1e9:.1f} TFLOP/s) plain_ms={plain_ms:.4f} "
        f"library_ms={lib_ms:.4f} (kernel/SDPA {ms / lib_ms:.2f}x) "
        f"bound_ms={b_ms:.4f} ({b_by})")
    del q, k, v, out, ref, diff
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            "body": body, "hd": hd, "causal": causal, "B": B, "S": S,
            "Sk": Sk, "H": H, "Hkv": Hkv}


def _fq_row(name: str, x, s, bits: int, exact_gs: bool,
            lib_axis: int | None = None) -> dict:
    """One fake_quant row: forward bit-equal, both backward rules (gx
    bit-equal, gs bit-equal when ``exact_gs`` — an elementwise scale —
    else within 1e-5 x max|ref|) against the plain versions; times of
    forward and backward (ste), plain and, with ``lib_axis``, the library's
    per-channel learnable fake-quant along that axis (forward +
    backward); bounds."""
    import torch
    from repro_torch.kernels.fake_quant import (fake_quant_bwd,
                                                fake_quant_fwd)
    from repro_torch.kernels.ref import fake_quant_grad_ref, fake_quant_ref
    R, C = x.shape
    qmax = 2 ** (bits - 1) - 1
    gy = torch.randn((R, C), generator=torch.Generator(
        device=x.device).manual_seed(R + C), device=x.device)
    y = fake_quant_fwd(x, s, bits)
    torch.cuda.synchronize()
    if not torch.equal(y, fake_quant_ref(x, s, bits)):
        fail(f"fake_quant {name}: forward differs from the plain version")
    del y
    err = 0.0
    for rule in ("kernel", "ste"):
        gx, gs = fake_quant_bwd(gy, x, s, bits, rule)
        rx, rs = fake_quant_grad_ref(gy, x, s, bits, rule)
        torch.cuda.synchronize()
        if not torch.equal(gx, rx):
            fail(f"fake_quant {name} {rule}: gx differs from the plain "
                 f"version")
        e = float((gs - rs).abs().max())
        tol = 0.0 if exact_gs else 1e-5 * float(rs.abs().max())
        if not math.isfinite(e) or e > tol:
            fail(f"fake_quant {name} {rule}: gs max_abs_err {e} > {tol}")
        err = max(err, e)
        del gx, gs, rx, rs
    fwd_ms = time_ms(lambda: fake_quant_fwd(x, s, bits))
    bwd_ms = time_ms(lambda: fake_quant_bwd(gy, x, s, bits, "ste"))
    pfwd_ms = time_ms(lambda: fake_quant_ref(x, s, bits), iters=5)
    pbwd_ms = time_ms(lambda: fake_quant_grad_ref(gy, x, s, bits, "ste"),
                      iters=5)
    n, ns = R * C, s.numel()
    # forward: x read, y written, the scale read; backward: g and x read,
    # gx written, the scale read and gs written
    f_ms, f_by = bound(8 * n + 4 * ns, 4 * n, "f32")
    b_ms, b_by = bound(12 * n + 8 * ns, 8 * n, "f32")
    lib_ms = None
    if lib_axis is not None:          # one PyTorch call: the per-channel
        xl = x.clone().requires_grad_()           # learnable fake-quant
        sl = (s[:, 0] if lib_axis == 0 else s[0]).clone().requires_grad_()
        zl = torch.zeros_like(sl)

        def lib():
            out = torch._fake_quantize_learnable_per_channel_affine(
                xl, sl, zl, lib_axis, -qmax, qmax, 1.0)
            torch.autograd.grad(out, (xl, sl), gy)
        lib_ms = time_ms(lib, iters=10)
        del xl, sl, zl
    say(f"[kernel] fake_quant {name} R={R} C={C} scale {tuple(s.shape)} "
        f"{bits}b max_abs_err={err:.3e} fwd ms={fwd_ms:.4f} plain_ms="
        f"{pfwd_ms:.4f} bound_ms={f_ms:.4f} ({f_by}); bwd(ste) ms="
        f"{bwd_ms:.4f} plain_ms={pbwd_ms:.4f} bound_ms={b_ms:.4f} "
        f"({b_by}); library_ms(fwd+bwd)="
        f"{'null' if lib_ms is None else f'{lib_ms:.4f}'}")
    return {"R": R, "C": C, "max_abs_err": err, "ms": fwd_ms + bwd_ms,
            "plain_ms": pfwd_ms + pbwd_ms, "bound_ms": f_ms + b_ms,
            "bound_by": "bytes" if "bytes" in (f_by, b_by)
            else "operations", "library_ms": lib_ms}


def check_fake_quant(cfg) -> tuple[dict, dict]:
    """fake_quant at the shapes the train path gives it: qwen3-8b's seven
    layer weights (wq, wk, wv, wo, gate, up, down) with a full
    doubly-channelwise scale and each again with a per-channel scale
    ``[1, out]`` beside the library's per-channel learnable fake-quant on
    axis 1, the embedding with a per-row scale, the lm_head.  Returns the
    embedding's record, the largest K3 call of the train path, and
    {weight: record} of the layer weights (per-channel rows under
    ``"<weight> channel"``)."""
    import torch
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(6)
    d, hq, hkv, ff, V = (cfg.d_model, cfg.n_heads * cfg.head_dim,
                         cfg.n_kv_heads * cfg.head_dim, cfg.d_ff, cfg.vocab)
    # (name, R, C, scale: "full" = s_wl ⊗ s_wr or "row" = per row, bits)
    cases = [("wq", d, hq, "full", 4), ("wk", d, hkv, "full", 4),
             ("wv", d, hkv, "full", 4), ("wo", hq, d, "full", 4),
             ("gate", d, ff, "full", 4), ("up", d, ff, "full", 4),
             ("down", ff, d, "full", 4),
             ("embed", V, d, "row", 8), ("lm_head", d, V, "full", 8)]
    record, layers = None, {}
    for name, R, C, kind, bits in cases:
        qmax = 2 ** (bits - 1) - 1
        x = torch.randn((R, C), generator=g, device=dev) * R ** -0.5
        if kind == "full":            # an MMSE-like grid: ~3 sigma at qmax
            s = (torch.rand((R, 1), generator=g, device=dev) + 0.5) * (
                torch.rand((1, C), generator=g, device=dev) + 0.5) * (
                3 * R ** -0.5 / qmax)
        else:
            s = (torch.rand((R, 1), generator=g, device=dev) + 0.5) * (
                3 * R ** -0.5 / qmax)
        rec = _fq_row(name, x, s, bits, exact_gs=kind == "full",
                      lib_axis=0 if kind == "row" else None)
        if kind == "row":
            record = rec
        elif name != "lm_head":
            layers[name] = rec
            col = (torch.rand((1, C), generator=g, device=dev) + 0.5) * (
                3 * R ** -0.5 / qmax)
            layers[f"{name} channel"] = _fq_row(
                f"{name} channel", x, col, bits, exact_gs=False, lib_axis=1)
            del col
        del x, s
        torch.cuda.empty_cache()
    return record, layers


def check_fake_quant_tp(cfg, tp: int = TP_SHARDS) -> dict:
    """fake_quant at the shards a rank of a ``tp``-rank model group runs it
    on in the sharded step (``sharding.tp``), qwen3-8b's: ``wq``'s columns
    of its query heads, ``wo``'s rows, the whole KV head that ``tp / Hkv``
    ranks gather for ``wk``/``wv`` (``[d, hd]``), ``gate``/``up``'s
    columns, ``down``'s rows, each with the doubly-channelwise scale and a
    per-channel row beside the library; the embedding's vocabulary rows
    with the per-row scale.  Returns {shard: record}."""
    import torch
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(26)
    c = cfg.with_padding(tp=tp)
    d, hd, ff = c.d_model, c.head_dim, c.d_ff
    hq = c.n_heads_padded * hd // tp
    hkv = max(c.n_kv_heads_padded * hd // tp, hd)
    cases = [("wq", d, hq), ("wk/wv (a KV head)", d, hkv), ("wo", hq, d),
             ("gate/up", d, ff // tp), ("down", ff // tp, d)]
    out = {}
    for name, R, C in cases:
        qmax = 7
        x = torch.randn((R, C), generator=g, device=dev) * R ** -0.5
        s = (torch.rand((R, 1), generator=g, device=dev) + 0.5) * (
            torch.rand((1, C), generator=g, device=dev) + 0.5) * (
            3 * R ** -0.5 / qmax)
        out[f"tp{tp} {name}"] = _fq_row(f"tp{tp} {name}", x, s, 4,
                                        exact_gs=True)
        col = (torch.rand((1, C), generator=g, device=dev) + 0.5) * (
            3 * R ** -0.5 / qmax)
        out[f"tp{tp} {name} channel"] = _fq_row(
            f"tp{tp} {name} channel", x, col, 4, exact_gs=False, lib_axis=1)
        del x, s, col
        torch.cuda.empty_cache()
    V = c.vocab_padded // tp
    x = torch.randn((V, d), generator=g, device=dev) * d ** -0.5
    s = (torch.rand((V, 1), generator=g, device=dev) + 0.5) * (
        3 * d ** -0.5 / 127)
    out[f"tp{tp} embed"] = _fq_row(f"tp{tp} embed", x, s, 8,
                                   exact_gs=False, lib_axis=0)
    del x, s
    torch.cuda.empty_cache()
    return out


def check_fake_quant_moe(cfg) -> dict:
    """fake_quant at qwen2-moe-a2.7b's weights as the train path hands
    them over: each expert stack ``[E, in, out]`` as one ``[E·in, out]``
    view with its full scale (``S_wL[in]``, shared by the experts, times
    ``S_wR[E, out]``), the 8-bit router and the shared experts with a full
    scale.  Returns {view: record}."""
    import torch
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(16)
    e = cfg.moe
    d, E, ff, fs = cfg.d_model, e.n_experts_padded, e.d_ff_expert, \
        e.d_ff_expert * e.n_shared
    cases = [("gate/up stack", E, d, ff, 4), ("down stack", E, ff, d, 4),
             ("router", 1, d, E, e.router_bits),
             ("shared gate/up", 1, d, fs, 4), ("shared down", 1, fs, d, 4)]
    out = {}
    for name, n, R, C, bits in cases:
        qmax = 2 ** (bits - 1) - 1
        x = torch.randn((n * R, C), generator=g, device=dev) * R ** -0.5
        s = ((torch.rand((1, R, 1), generator=g, device=dev) + 0.5)
             * (torch.rand((n, 1, C), generator=g, device=dev) + 0.5)
             * (3 * R ** -0.5 / qmax)).reshape(n * R, C)
        out[name] = _fq_row(f"qwen2-moe {name}", x, s, bits, exact_gs=True)
        del x, s
        torch.cuda.empty_cache()
    return out


def check_fake_quant_mla(cfg) -> dict:
    """fake_quant at deepseek-v2-236b's six MLA weights, at full width:
    each with the full scale the train path hands over (``S_wL[in]`` from
    the input stream times ``S_wR[out]``; at 4 bits, as an 8-bit exempt
    weight runs the same body), then with a per-channel scale ``[1, out]``
    beside the library's per-channel learnable fake-quant on axis 1.
    Returns {view: record} (the per-channel rows under ``"<view>
    channel"``)."""
    import torch
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(23)
    m, d, H = cfg.mla, cfg.d_model, cfg.n_heads
    views = {"q_down": (d, m.q_lora),
             "q_up": (m.q_lora, H * (m.d_nope + m.d_rope)),
             "kv_down": (d, m.kv_lora + m.d_rope),
             "k_up": (m.kv_lora, H * m.d_nope),
             "v_up": (m.kv_lora, H * m.d_v),
             "wo": (H * m.d_v, d)}
    out = {}
    for name, (R, C) in views.items():
        qmax = 7
        x = torch.randn((R, C), generator=g, device=dev) * R ** -0.5
        col = (torch.rand((1, C), generator=g, device=dev) + 0.5) * (
            3 * R ** -0.5 / qmax)
        s = (torch.rand((R, 1), generator=g, device=dev) + 0.5) * col
        out[name] = _fq_row(f"deepseek-v2 {name}", x, s, 4, exact_gs=True)
        out[f"{name} channel"] = _fq_row(f"deepseek-v2 {name} channel", x,
                                         col, 4, exact_gs=False, lib_axis=1)
        del x, s, col
        torch.cuda.empty_cache()
    return out


def check_fake_quant_ssm(*cfgs) -> dict:
    """fake_quant at the Mamba2 weights of each config (mamba2-1.3b's
    in_proj ``[2048, 8512]`` and out_proj ``[4096, 2048]``, zamba2-7b's
    ``[3584, 14704]`` and ``[7168, 3584]``), as the train path hands them
    over one layer at a time: with the full scale (``S_wL[in]`` from the
    stream times ``S_wR[out]``), then with a per-channel one beside the
    library's per-channel learnable fake-quant.  Returns {view: record}."""
    import torch
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(27)
    out = {}
    for cfg in cfgs:
        sc, d = cfg.ssm, cfg.d_model
        di = sc.d_inner(d)
        views = {"in_proj": (d, 2 * di + 2 * sc.n_groups * sc.d_state
                             + sc.n_heads(d)),
                 "out_proj": (di, d)}
        for name, (R, C) in views.items():
            tag = f"{cfg.name} {name}"
            x = torch.randn((R, C), generator=g, device=dev) * R ** -0.5
            col = (torch.rand((1, C), generator=g, device=dev) + 0.5) * (
                3 * R ** -0.5 / 7)
            s = (torch.rand((R, 1), generator=g, device=dev) + 0.5) * col
            out[tag] = _fq_row(tag, x, s, 4, exact_gs=True)
            out[f"{tag} channel"] = _fq_row(f"{tag} channel", x, col, 4,
                                            exact_gs=False, lib_axis=1)
            del x, s, col
            torch.cuda.empty_cache()
    return out


def check_fake_quant_vlm_encdec(vlm, encdec) -> dict:
    """fake_quant at qwen2-vl-7b's embedding ``[152064, 3584]`` and
    seamless-m4t-medium's ``[256206, 1024]`` (8 bits, the per-row scale,
    beside the library's per-channel fake-quant on axis 0), and at
    seamless's ``up`` ``[1024, 4096]`` with the full scale and with a
    per-channel one beside the library's (axis 1).  Returns {view:
    record}."""
    import torch
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(31)
    out = {}
    for cfg in (vlm, encdec):
        R, C = cfg.vocab_padded, cfg.d_model
        x = torch.randn((R, C), generator=g, device=dev) * 0.02
        s = (torch.rand((R, 1), generator=g, device=dev) + 0.5) * (
            3 * 0.02 / 127)
        tag = f"{cfg.name} embed"
        out[tag] = _fq_row(tag, x, s, 8, exact_gs=False, lib_axis=0)
        del x, s
        torch.cuda.empty_cache()
    R, C = encdec.d_model, encdec.d_ff
    tag = f"{encdec.name} up"
    x = torch.randn((R, C), generator=g, device=dev) * R ** -0.5
    col = (torch.rand((1, C), generator=g, device=dev) + 0.5) * (
        3 * R ** -0.5 / 7)
    s = (torch.rand((R, 1), generator=g, device=dev) + 0.5) * col
    out[tag] = _fq_row(tag, x, s, 4, exact_gs=True)
    out[f"{tag} channel"] = _fq_row(f"{tag} channel", x, col, 4,
                                    exact_gs=False, lib_axis=1)
    del x, s, col
    torch.cuda.empty_cache()
    return out


def check_fake_quant_cnn(ccfg) -> dict:
    """fake_quant at the paper CNN's weight views, as models/cnn.py hands
    them over: each conv's HWIO kernel as ``[kh·kw, cin·cout]`` with one
    scale row ``[1, cin·cout]`` (S_wL ⊗ S_wR broadcast), and the fc
    ``[64, 10]`` with its row scale; the library's per-channel learnable
    fake-quant on the same scale (axis 1 for a conv, 0 for the fc).
    Returns {view: record} with the time of forward + backward (ste)."""
    import torch
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(11)
    k, views, cin = ccfg.kernel, {}, ccfg.in_ch
    for i, cout in enumerate(ccfg.channels):
        views[f"conv{i}"] = (k * k, cin * cout, "col", 4)
        cin = cout
    views["fc"] = (cin, ccfg.n_classes, "row", 8)
    out = {}
    for name, (R, C, kind, bits) in views.items():
        qmax = 2 ** (bits - 1) - 1
        x = torch.randn((R, C), generator=g, device=dev) * R ** -0.5
        shape = (1, C) if kind == "col" else (R, 1)
        s = (torch.rand(shape, generator=g, device=dev) + 0.5) * (
            3 * R ** -0.5 / qmax)
        out[name] = _fq_row(f"cnn {name}", x, s, bits, exact_gs=False,
                            lib_axis=1 if kind == "col" else 0)
    return out


def _device_profile(fn, iters: int = 10) -> tuple:
    """(device ms, kernel launches) per call of ``fn``, every kernel it
    runs summed over ``iters`` calls under torch.profiler; (None, None)
    if the profiler recorded none."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(2):          # a window the profiler dropped is taken again
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us, n = 0.0, 0
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA:
                t = getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0))
                if t:
                    us += t
                    n += e.count
        if us:
            return us / iters / 1e3, n / iters
    return None, None


def _ff_row(name: str, w, s_wl, s_wr, bits: int = 4, out_dtype=None) -> dict:
    """One row of K3's factored entry at a weight of the train path: the
    kernel's forward + backward (the operators, as the autograd Function
    calls them) against the plain version — y and gx bit for bit, gs_wl
    and gs_wr within 1e-5 x max|ref|, two runs bitwise identical — then
    timed: events and profiler device time; the old route timed as one
    call (S_wL ⊗ S_wR as a full f32 scale, K3's broadcast entry, the cast,
    and autograd's backward through all three, as effective_weight ran
    before the factored entry); the plain version; the bound at 16 B an
    element (bf16 out)."""
    import torch
    from repro_torch.core import dof
    from repro_torch.kernels.fake_quant import (factored_geometry,
                                                fake_quant_factored,
                                                fake_quant_factored_bwd,
                                                fake_quant_factored_fwd)
    from repro_torch.kernels.ref import (factored_scale,
                                         fake_quant_factored_ref)
    out_dtype = out_dtype or torch.bfloat16
    code = 1 if out_dtype == torch.bfloat16 else 0
    C = w.shape[-1]
    R = w.numel() // C
    gy = torch.randn(w.shape, generator=torch.Generator(
        device=w.device).manual_seed(R + C), device=w.device).to(out_dtype)

    def leaves():
        return (w.clone().requires_grad_(),
                None if s_wl is None else s_wl.clone().requires_grad_(),
                s_wr.clone().requires_grad_())

    def run(fn):
        a, b, c = leaves()
        y = fn(a, b, c)
        y.backward(gy)
        torch.cuda.synchronize()
        return (y.detach(), a.grad, None if b is None else b.grad, c.grad)

    got = [run(lambda a, b, c: fake_quant_factored(a, b, c, bits, out_dtype))
           for _ in range(2)]
    ref = run(lambda a, b, c: fake_quant_factored_ref(a, b, c, bits,
                                                     out_dtype))
    if not (torch.equal(got[0][0], ref[0]) and torch.equal(got[0][1],
                                                           ref[1])):
        fail(f"fake_quant factored {name}: y or gx differs from the plain "
             f"version")
    err = 0.0
    for k in (2, 3):
        if ref[k] is None:
            continue
        e = float((got[0][k] - ref[k]).abs().max())
        if not math.isfinite(e) or e > 1e-5 * float(ref[k].abs().max()):
            fail(f"fake_quant factored {name}: scale gradient {k - 2} "
                 f"max_abs_err {e}")
        err = max(err, e)
    if not all(x is None and y is None or torch.equal(x, y)
               for x, y in zip(got[0], got[1])):
        fail(f"fake_quant factored {name}: two runs differ")
    del got, ref
    # the operators on the 2-D views, as _FactoredFakeQuant hands them over
    P, g, cs = factored_geometry(w, s_wl, s_wr)
    n_wr = s_wr.numel()
    w2, g2 = w.reshape(R, C), gy.reshape(R, C)
    wl = None if s_wl is None else s_wl.reshape(-1)
    wr = s_wr.reshape(R // g, C if cs else 1)

    def new():
        fake_quant_factored_fwd(w2, wl, wr, bits, code)
        fake_quant_factored_bwd(g2, w2, wl, wr, bits)

    wt = w.clone().requires_grad_()
    lt = None if s_wl is None else s_wl.clone().requires_grad_()
    rt = s_wr.clone().requires_grad_()
    ins = (wt, rt) if lt is None else (wt, lt, rt)

    def old():
        s = factored_scale(wt.shape, lt, rt)
        y = dof.weight_fake_quant(wt, s, bits, use_kernels=True)
        torch.autograd.grad(y.to(out_dtype), ins, gy)

    def plain():
        y = fake_quant_factored_ref(wt, lt, rt, bits, out_dtype)
        torch.autograd.grad(y, ins, gy)

    ms = time_ms(new)
    dev_ms, launches = _device_profile(new)
    old_ms = time_ms(old)
    old_dev_ms, old_launches = _device_profile(old)
    plain_ms = time_ms(plain, iters=5)
    n = R * C
    ob = out_dtype.itemsize
    # forward: w read, y written; backward: the gradient and w read, gx
    # written; the factors read twice and their gradients written
    nbytes = n * (4 + ob) + n * (ob + 4 + 4) + 4 * 3 * (P + n_wr)
    b_ms, b_by = bound(nbytes, 18 * n, "f32")
    say(f"[kernel] fake_quant factored {name} R={R} C={C} P={P} "
        f"s_wr={tuple(s_wr.shape)} out={str(out_dtype).split('.')[-1]} "
        f"{bits}b max_abs_err={err:.3e} y,gx=identical fwd+bwd ms={ms:.4f} "
        f"device_ms={dev_ms if dev_ms is None else f'{dev_ms:.4f}'} "
        f"launches={launches} old_route_ms={old_ms:.4f} old_device_ms="
        f"{old_dev_ms if old_dev_ms is None else f'{old_dev_ms:.4f}'} "
        f"old_launches={old_launches} plain_ms={plain_ms:.4f} "
        f"bound_ms={b_ms:.4f} ({b_by}, {nbytes / n:.2f} B/elem) "
        f"x_bound={(dev_ms or ms) / b_ms:.2f} "
        f"old/new={(old_dev_ms or old_ms) / (dev_ms or ms):.2f}")
    return {"R": R, "C": C, "P": P, "s_wr": list(s_wr.shape),
            "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
            "launches": launches, "old_route_ms": old_ms,
            "old_route_device_ms": old_dev_ms,
            "old_route_launches": old_launches, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def check_fake_quant_factored(cfg, moe, ds, encdec,
                              tp: int = TP_SHARDS) -> dict:
    """K3's factored entry at the train path's weights, bf16 out, each
    beside the old route and the 16 B/elem bound: qwen3-8b's seven layer
    weights under DCHW (S_wL from the input stream, S_wR per output
    channel), wq and wo under group:128; a qwen2-moe expert stack
    ``[E, 2048, 1408]`` (the stream's S_wL shared by the experts,
    ``S_wR [E, 1408]``); deepseek-v2's kv_down; seamless-m4t's up; the
    qwen3-8b shards a tp-16 rank runs.  Returns {row: record}."""
    import torch
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(36)

    def factors(lead, K, N, group=None):
        """w near an MMSE-like grid (~3 sigma at qmax), s_wl [K], s_wr in
        log_swr's shape."""
        s_wl = torch.rand((K,), generator=gen, device=dev) + 0.5
        wr_shape = lead + ((K // group, N) if group else (N,))
        s_wr = (torch.rand(wr_shape, generator=gen, device=dev) + 0.5) * (
            3 * K ** -0.5 / 7)
        w = torch.randn(lead + (K, N), generator=gen, device=dev) * K ** -0.5
        return w, s_wl, s_wr

    d, hq, hkv, ff = (cfg.d_model, cfg.n_heads * cfg.head_dim,
                      cfg.n_kv_heads * cfg.head_dim, cfg.d_ff)
    rows = [(f"qwen3-8b {n}", (), K, N, None) for n, K, N in (
        ("wq", d, hq), ("wk", d, hkv), ("wv", d, hkv), ("wo", hq, d),
        ("gate", d, ff), ("up", d, ff), ("down", ff, d))]
    rows += [(f"qwen3-8b {n} group:128", (), K, N, 128)
             for n, K, N in (("wq", d, hq), ("wo", hq, d))]
    e = moe.moe
    rows.append(("qwen2-moe gate/up stack", (e.n_experts_padded,),
                 moe.d_model, e.d_ff_expert, None))
    m = ds.mla
    rows.append(("deepseek-v2 kv_down", (), ds.d_model, m.kv_lora + m.d_rope,
                 None))
    rows.append((f"{encdec.name} up", (), encdec.d_model, encdec.d_ff, None))
    c = cfg.with_padding(tp=tp)
    hq_s = c.n_heads_padded * c.head_dim // tp
    hkv_s = max(c.n_kv_heads_padded * c.head_dim // tp, c.head_dim)
    rows += [(f"qwen3-8b tp{tp} {n}", (), K, N, None) for n, K, N in (
        ("wq", c.d_model, hq_s), ("wk/wv (a KV head)", c.d_model, hkv_s),
        ("wo", hq_s, c.d_model), ("gate/up", c.d_model, c.d_ff // tp),
        ("down", c.d_ff // tp, c.d_model))]
    out = {}
    for name, lead, K, N, group in rows:
        w, s_wl, s_wr = factors(lead, K, N, group)
        out[name] = _ff_row(name, w, s_wl, s_wr)
        del w, s_wl, s_wr
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 4: small model, card (kernels) vs CPU (plain route)
# ---------------------------------------------------------------------------

def check_reference() -> None:
    import torch
    from repro_torch.configs.qwen3_8b import SMOKE
    from repro_torch.core.qconfig import QuantConfig
    from repro_torch.models import forward, init_model
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.serve.deploy import (deploy_view, export_for_layers,
                                          make_deploy_plan, to_device)
    from repro_torch.serve.engine import Engine, Request, ServeConfig
    qcfg = QuantConfig()
    params = init_model(7, SMOKE, qcfg, device="cuda")
    plan = make_deploy_plan(qcfg, arch=SMOKE.name, params=params,
                            model_cfg=SMOKE)
    ex = export_for_layers(params, plan)
    scfg = ServeConfig(max_slots=4, max_len=128, prefill_chunk=16)
    rng = torch.Generator().manual_seed(3)
    prompts = [torch.randint(0, SMOKE.vocab, (n,), generator=rng).tolist()
               for n in (5, 17, 40, 70)]
    reqs = [Request(prompt=p, max_new_tokens=12) for p in prompts]
    before = decode_attention.launches
    card = Engine.from_artifact(SMOKE, plan, ex, scfg).generate(reqs)
    launched = decode_attention.launches - before
    cpu_ex = to_device(ex, "cpu")
    cpu_plan = dataclasses.replace(plan, use_kernels=False)
    ref = Engine.from_artifact(SMOKE, cpu_plan, cpu_ex, scfg,
                               device="cpu").generate(reqs)
    dv = deploy_view(cpu_ex, cpu_plan)
    near_ties = 0
    for p, a, b in zip(prompts, card, ref):
        i = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if i is None:
            continue
        with torch.no_grad():
            z = forward(dv, SMOKE, None, {"tokens": torch.tensor(
                [p + b[:i]])})["logits"][0, -1].float()
        top = torch.topk(z, 2).values
        ulp = 2.0 ** (math.floor(math.log2(abs(float(top[0])))) - 7)
        if float(top[0] - top[1]) > MARGIN_ULPS * ulp:
            fail(f"reference: card tokens {a} != CPU tokens {b} at step {i} "
                 f"(margin {float(top[0] - top[1])})")
        near_ties += 1
    if launched == 0:
        fail("reference: the card engine never launched decode_attention")
    say(f"[reference] SMOKE engine, card kernels vs CPU plain route: "
        f"{len(reqs) - near_ties}/{len(reqs)} requests identical, "
        f"{near_ties} diverged at a near-tie; decode_attention launches "
        f"{launched}")


# ---------------------------------------------------------------------------
# phase 5: the main path at full width
# ---------------------------------------------------------------------------

def _serve(engine, reqs, timing: dict) -> list[list[int]]:
    """Engine.generate with the prefill and decode calls timed (synchronized
    host clock around each)."""
    import torch

    def timed(fn, key):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            timing[key] = timing.get(key, 0.0) + time.perf_counter() - t0
            return out
        return run

    engine._prefill = timed(engine._prefill, "prefill_s")
    engine._decode = timed(engine._decode, "decode_s")
    return engine.generate(reqs)


def _profile(run, what: str, steps: int, watch: tuple = (),
             ranges: tuple = ()) -> dict:
    """Run ``run()`` (``steps`` steps of work) under torch.profiler: the
    device's busy share of the window, the kernels by device time, the
    share of each ``watch`` name (kernels whose name holds it) and the
    device span of each ``ranges`` name (a ``record_function`` range: from
    its first kernel's start to its last's end, gaps included).  Returns
    the step's device busy ms, kernel launches and each ``watch`` name's
    (ms, launches); empty if the profiler recorded no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows, spans = [], {}                  # device-side events only
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        if e.key in ranges:               # a range's span on the device
            spans[e.key] = (getattr(e, "device_time_total", None)
                            or getattr(e, "cuda_time_total", 0), e.count)
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        if dev_us:
            rows.append((dev_us, e.count, e.key))
    busy = sum(r[0] for r in rows)
    if busy == 0:
        say("[profile] torch.profiler recorded no device time")
        return {}
    rows.sort(reverse=True)
    say(f"[profile] {steps} {what}: wall {wall_us / steps / 1e3:.3f} ms/step,"
        f" device busy {busy / steps / 1e3:.3f} ms/step "
        f"({100 * busy / wall_us:.1f}% of the window), "
        f"{sum(r[1] for r in rows) // steps} kernel launches/step")
    for dev_us, count, key in rows[:8]:
        say(f"[profile]   {100 * dev_us / busy:5.1f}% {dev_us / steps:9.1f} "
            f"us/step x{count // steps:<4d} {key[:90]}")
    summary = {"busy_ms": busy / steps / 1e3,
               "launches": sum(r[1] for r in rows) / steps, "watch": {}}
    for name in watch:
        us = sum(r[0] for r in rows if name in r[2])
        n = sum(r[1] for r in rows if name in r[2])
        summary["watch"][name] = (us / steps / 1e3, n / steps)
        say(f"[profile]   {name}: {100 * us / busy:.2f}% of device time, "
            f"{us / steps:.1f} us/step over {n // steps} launches/step")
    for name in ranges:
        us, n = spans.get(name, (0, 0))
        say(f"[profile]   range {name}: " + (
            f"its device span {us / steps:.1f} us/step over {n // steps} "
            f"calls/step, {100 * us / busy:.2f}% of the kernels' device "
            f"time" if us else "device time not measured"))
    return summary


def profile_decode(engine, cfg, steps: int = 4) -> None:
    """Trace a few steady decode steps (8 live slots)."""
    import torch
    from repro_torch.core import dof
    from repro_torch.models import transformer
    from repro_torch.serve.engine import Request
    engine.reset()
    rng = torch.Generator().manual_seed(5)
    for _ in range(engine.scfg.max_slots):
        engine.submit(Request(prompt=torch.randint(
            0, cfg.vocab, (64,), generator=rng).tolist(),
            max_new_tokens=steps + 4))
    engine.step()                         # admit, prefill, install, decode
    engine.step()

    def run():
        for _ in range(steps):
            engine.step()
    # K2's two passes, and the index kernels: the paged write of each
    # step's K/V (the pool[pt] gather of the route before the paged entry
    # would show here too); a MoE's expert FFN (its three batched
    # products, silu and product) as one range
    # a MoE's expert FFN (its three batched products, silu and product) as
    # one range; MLA's attention as one, and inside it, in the default
    # form, the k_up/v_up products over the whole latent cache (the only
    # linears whose input is kv_lora wide) as another
    # the SSM's recurrent state update (the conv over the cached window,
    # h·exp(dt·A) + dt·B·x written into the cache, C·h + D·x) as one
    from repro_torch.models import moe, ssm
    ffn, qlinear, mla, step = moe._expert_ffn, dof.qlinear, \
        transformer.mla_attention, ssm._recurrent_step

    def ranged(fn, name, when=lambda *a, **k: True):
        def run(*a, **k):
            if not when(*a, **k):
                return fn(*a, **k)
            with torch.profiler.record_function(name):
                return fn(*a, **k)
        return run
    ranges = ("expert_ffn",) if cfg.moe is not None else ()
    moe._expert_ffn = ranged(ffn, "expert_ffn")
    if cfg.mla is not None:
        ranges += ("mla_attention",)
        transformer.mla_attention = ranged(mla, "mla_attention")
    if cfg.ssm is not None:
        ranges += ("ssm state update",)
        ssm._recurrent_step = ranged(step, "ssm state update")
    if cfg.mla is not None and not cfg.mla_absorb:
        ranges += ("k_up/v_up over the cache",)
        dof.qlinear = ranged(qlinear, "k_up/v_up over the cache",
                             lambda x, *a, **k: x.ndim == 3 and x.shape[1] > 1
                             and x.shape[-1] == cfg.mla.kv_lora)
    try:
        _profile(run, "decode steps, 8 live slots", steps,
                 watch=("fd_split", "fd_combine", "index", "gather"),
                 ranges=ranges)
    finally:
        moe._expert_ffn, dof.qlinear, transformer.mla_attention = \
            ffn, qlinear, mla
        ssm._recurrent_step = step


def _engine_as(engine, cfg, use_kernels: bool = True):
    """A second engine over ``engine``'s weights (no second deploy view)
    whose prefill and decode steps serve ``cfg`` (MLA's absorbed form)."""
    import copy
    from repro_torch.train.steps import (make_bucketed_prefill_step,
                                         make_slot_decode_step)
    alt = copy.copy(engine)
    alt.cfg = cfg
    alt._prefill = make_bucketed_prefill_step(cfg, None)
    alt._decode = make_slot_decode_step(cfg, None, use_kernels=use_kernels)
    alt.reset()
    return alt


def _serve_way(engine, reqs, what: str) -> tuple[list[list[int]], dict]:
    """Serve ``reqs`` through ``engine`` with the peak reset just before;
    print decode ms a step, prefill ms a token and the peak."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timing: dict = {}
    toks = _serve(engine, reqs, timing)
    n_prompt = sum(len(r.prompt) for r in reqs)
    timing.update(decode_ms=timing["decode_s"] * 1e3 / engine.decode_steps,
                  prefill_ms=timing["prefill_s"] * 1e3 / n_prompt,
                  peak=_gib())
    say(f"[main] {what}: decode {timing['decode_ms']:.3f} ms/step, prefill "
        f"{timing['prefill_ms']:.3f} ms/token, peak {timing['peak']:.2f} GiB")
    return toks, timing


def main_path(cfg, layers: int | None = None) -> dict:
    """Phase 5's path on ``cfg`` at full width, ``layers`` deep (None: the
    config's depth).  Returns the kernels' launch counts."""
    import torch
    from repro_torch.core.qconfig import QuantConfig
    from repro_torch.models import init_model
    from repro_torch.serve.deploy import (export_for_layers,
                                          kernel_route_check,
                                          make_deploy_plan)
    from repro_torch.serve.engine import (Engine, Request, ServeConfig,
                                          _attn_layer_count)
    from repro_torch.tree import tree_items
    full_depth = cfg.n_layers
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    mla = cfg.mla is not None
    gc.collect()
    torch.cuda.empty_cache()
    # attention calls of a decode step that decode_attention carries (MLA
    # and the SSM: none; the hybrid: one a group)
    n_routed = _attn_layer_count(cfg)
    qcfg = QuantConfig()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_model(gen, cfg, qcfg, device="cuda")
    n_params = sum(t.numel() for _, t in tree_items(params))
    plan = make_deploy_plan(qcfg, arch=cfg.name, family=cfg.family,
                            params=params, model_cfg=cfg)
    with torch.no_grad():
        exported = export_for_layers(params, plan)
    del params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    ff = (f"experts {cfg.moe.n_experts} top-{cfg.moe.top_k} + "
          f"{cfg.moe.n_shared} shared, ff {cfg.moe.d_ff_expert}, capacity "
          f"factor {cfg.moe.capacity_factor:g}" if cfg.moe is not None
          else f"ff={cfg.d_ff}")
    if mla:
        m = cfg.mla
        ff = (f"MLA kv_lora {m.kv_lora} q_lora {m.q_lora} nope {m.d_nope} "
              f"rope {m.d_rope} v {m.d_v}, " + ff)
    if cfg.ssm is not None:
        sc = cfg.ssm
        ff = (f"Mamba2 d_inner {sc.d_inner(cfg.d_model)} heads "
              f"{sc.n_heads(cfg.d_model)} x {sc.head_dim} d_state "
              f"{sc.d_state} groups {sc.n_groups} chunk {sc.chunk}"
              + (f", attention every {cfg.attn_every} layers (hd "
                 f"{cfg.head_dim}), " + ff if cfg.family == "hybrid" else ""))
    say(f"[main] {cfg.name} full width: {cfg.n_layers} of {full_depth} "
        f"layers ({n_params / 1e9:.2f} B parameters) d={cfg.d_model} "
        f"heads={cfg.n_heads}/{cfg.n_kv_heads} {ff} vocab={cfg.vocab};"
        f" init+export {time.perf_counter() - t0:.1f} s, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; f32 masters "
        f"freed")

    scfg = ServeConfig(**MAIN_SERVE)
    rng = torch.Generator().manual_seed(4)
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=rng).tolist()
               for n in MAIN_PROMPTS]
    reqs = [Request(prompt=p, max_new_tokens=NEW_TOKENS) for p in prompts]

    # --- the main path, with every kernel count at 0 just before it
    _zero_counts()
    torch.cuda.reset_peak_memory_stats()
    check = kernel_route_check(exported, plan)
    engine = Engine.from_artifact(cfg, plan, exported, scfg)
    timing: dict = {}
    t0 = time.perf_counter()
    toks = _serve(engine, reqs, timing)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    launches = {"decode_attention": counts["decode_attention"],
                "decode_attention_paged": counts["decode_attention_paged"],
                "flash_attention": counts["flash_attention"],
                "quant_matmul": counts["quant_matmul"],
                "quant_matmul_bodies": {
                    f"launches_{b}": counts[f"quant_matmul_{b}"]
                    for b in ("mma", "mma_wide", "fma")}}
    # ---
    stats = engine.stats()
    steps = engine.decode_steps
    n_paged = n_routed if engine._kv is not None else 0
    if not (check and check["kernel"]):
        fail(f"kernel_route_check did not run quant_matmul: {check}")
    if not check["max_err"] <= 1e-4:
        fail(f"kernel_route_check max_err {check['max_err']} > 1e-4")
    if stats["decode_attn_kernel_layers"] != n_routed:
        fail(f"decode_attn_kernel_layers {stats['decode_attn_kernel_layers']}"
             f" != {n_routed}")
    if launches["decode_attention"] != n_routed * steps or steps == 0:
        fail(f"decode_attention launched {launches['decode_attention']} "
             f"times over {steps} decode steps of {n_routed} routed layers")
    if launches["decode_attention_paged"] != n_paged * steps:
        fail(f"decode_attention's paged entry launched "
             f"{launches['decode_attention_paged']} times over {steps} "
             f"decode steps, want {n_paged} a step")
    if launches["flash_attention"]:
        fail(f"the engine launched flash_attention "
             f"{launches['flash_attention']} times")
    if launches["quant_matmul"] < 1 or (
            (mla or cfg.ssm is not None) and launches["quant_matmul"] != 1):
        fail(f"quant_matmul launched {launches['quant_matmul']} times on the "
             f"main path")
    for p, t in zip(prompts, toks):
        if len(t) != NEW_TOKENS or not all(0 <= x < cfg.vocab for x in t):
            fail(f"bad output for a {len(p)}-token prompt: {t}")
    n_prompt = sum(MAIN_PROMPTS)
    n_new = NEW_TOKENS * len(reqs)
    peak = torch.cuda.max_memory_allocated() / 2**30
    say(f"[main] kernel_route_check {check['path']} ({check['layout']}): "
        f"quant_matmul ran, max_err {check['max_err']:.3e}")
    say(f"[main] served {len(reqs)} greedy requests (prompts {MAIN_PROMPTS},"
        f" {NEW_TOKENS} new each) in {wall:.2f} s: {steps} decode steps; "
        f"decode_attn_kernel_layers={stats['decode_attn_kernel_layers']}; "
        f"launches decode_attention={launches['decode_attention']} "
        f"(= {n_routed} x {steps}; paged entry "
        f"{launches['decode_attention_paged']}) flash_attention="
        f"{launches['flash_attention']} quant_matmul="
        f"{launches['quant_matmul']} {launches['quant_matmul_bodies']}")
    say(f"[main] prefill {timing['prefill_s'] * 1e3 / n_prompt:.3f} ms/token "
        f"({n_prompt} prompt tokens, {timing['prefill_s']:.3f} s); decode "
        f"{timing['decode_s'] * 1e3 / steps:.3f} ms/step, "
        f"{timing['decode_s'] * 1e3 / (n_new - len(reqs)):.3f} ms/token; "
        f"peak {peak:.2f} GiB; slot cache "
        f"{stats['slot_cache_bytes'] / 2**30:.2f} GiB")

    profile_decode(engine, cfg)

    # --- the same requests through the plain route on the card
    del engine
    torch.cuda.empty_cache()
    before = _counts()
    plain = Engine.from_artifact(
        cfg, dataclasses.replace(plan, use_kernels=False), exported, scfg)
    ptoks, ptiming = _serve_way(plain, reqs, "plain route")
    if _counts()["decode_attention"] != before["decode_attention"]:
        fail("the plain route launched decode_attention")
    same = sum(a == b for a, b in zip(toks, ptoks))
    say(f"[main] plain route: {same}/{len(reqs)} requests token-identical to "
        f"the kernel route (greedy)")
    if n_routed == 0 and not mla and same != len(reqs):
        fail(f"{cfg.name}: no kernel runs in a decode step, yet the plain "
             f"route's tokens differ")
    for p, a, b in zip(prompts, toks, ptoks):
        if a != b:
            where = _first_split(cfg, p, ("plain", plain, False, b),
                                 ("kernel", plain, True, a))
            say(f"[main]   {a} vs {b}: the routes first split at {where} "
                f"(limit {MARGIN_ULPS})")
    if mla:
        # --- the absorbed decode form, over the same weights
        acfg = dataclasses.replace(cfg, mla_absorb=True)
        absorbed = _engine_as(plain, acfg)
        atoks, _ = _serve_way(absorbed, reqs, "absorbed form (mla_absorb)")
        same = sum(a == b for a, b in zip(toks, atoks))
        say(f"[main] absorbed form: {same}/{len(reqs)} requests "
            f"token-identical to the default form (greedy)")
        for p, a, b in zip(prompts, toks, atoks):
            if a != b:
                where = _first_split(cfg, p, ("default", plain, True, a),
                                     ("absorbed", absorbed, True, b))
                say(f"[main]   {a} vs {b}: the forms first split at {where} "
                    f"(limit {MARGIN_ULPS})")
        profile_decode(absorbed, acfg)
        del absorbed
    del plain
    torch.cuda.empty_cache()
    return launches


def _serve_recorded(engine, prompt: list[int], n: int, use_kernels: bool
                    ) -> tuple[list[int], list]:
    """Serve ``prompt`` alone (slot 0) through ``engine`` with the decode
    step of the kernel or the plain route, recording in call order each
    router call's f32 logits (``("r", ·)``; MoE only), each prefill
    chunk's logits (``("p", ·)``) and each decode step's (``("z", ·)``)."""
    import torch
    from repro_torch.models import moe
    from repro_torch.serve.engine import Request
    from repro_torch.train import steps
    events: list = []
    router, prefill, decode = moe._router_logits, engine._prefill, \
        engine._decode
    forward = steps.forward

    def rec_router(*a, **k):
        z = router(*a, **k)
        events.append(("r", z.float().cpu()))
        return z

    def rec_prefill(*a, **k):
        logits, cache = prefill(*a, **k)
        events.append(("p", logits.float().cpu()))
        return logits, cache

    def rec_forward(*a, **k):
        out = forward(*a, **k)
        # the slot decode step: its cache carries a per-slot pos vector
        # (the hybrid's under its shared attention's cache)
        cache = k.get("cache") or {}
        if isinstance(cache.get("pos", cache.get("attn", {}).get("pos")),
                      torch.Tensor):
            events.append(("z", out["logits"][:, -1].float().cpu()))
        return out

    moe._router_logits, engine._prefill, steps.forward = \
        rec_router, rec_prefill, rec_forward
    engine._decode = steps.make_slot_decode_step(engine.cfg, None,
                                                 use_kernels=use_kernels)
    try:
        engine.reset()
        toks = engine.generate([Request(prompt=prompt, max_new_tokens=n)])[0]
    finally:
        moe._router_logits, engine._prefill, steps.forward = \
            router, prefill, forward
        engine._decode = decode
    return toks, events


def _ulp(z: float) -> float:
    """One bf16 ulp at ``z``."""
    return 2.0 ** (math.floor(math.log2(max(abs(z), 1e-30))) - 7)


def _first_split(cfg, prompt: list[int], ref: tuple, other: tuple) -> str:
    """Where a request's tokens differ between two ways of serving it,
    each ``(label, engine, use_kernels, tokens in the batch)``: serve it
    alone both ways (recording every router call and every emitted token's
    logits), walk the two runs' decisions in call order — each real
    token's top-k experts in every layer (MoE), then each emitted token —
    and fail unless, at the first decision that differs, ``ref``'s own
    margin is within MARGIN_ULPS bf16 ulps of the row's largest logit in
    magnitude (the top logit, for a token): the k-th minus the (k+1)-th
    router logit, or the top-2 logit margin.  Returns a description of
    that decision."""
    import torch
    n = len(ref[3])
    got = {}
    for label, engine, use, want in (ref, other):
        got[label] = _serve_recorded(engine, prompt, n, use)
        if got[label][0] != want:
            fail(f"{cfg.name}: {label} served alone gave {got[label][0]}, "
                 f"in the batch {want}")
    a_run, b_run = got[ref[0]][1], got[other[0]][1]
    if [k for k, _ in a_run] != [k for k, _ in b_run]:
        fail(f"{cfg.name}: {ref[0]} and {other[0]} made different calls")
    K = cfg.moe.top_k if cfg.moe is not None else 0
    chunk = ref[1].scfg.prefill_chunk
    lens = [min(chunk, len(prompt) - o)
            for o in range(0, len(prompt), chunk)]
    f, tok = 0, 0                   # forward calls ended, tokens emitted
    for (kind, a), (_, b) in zip(a_run, b_run):
        prefill = f < len(lens)
        if kind == "r":
            for r in range(lens[f] if prefill else 1):
                pa = torch.argsort(-a[r], stable=True)[:K].tolist()
                pb = torch.argsort(-b[r], stable=True)[:K].tolist()
                if set(pa) == set(pb):
                    continue
                za = torch.sort(a[r], descending=True).values
                gap = float(za[K - 1] - za[K])
                ulp = _ulp(float(a[r].abs().max()))
                at = (f"prefill chunk {f}" if prefill
                      else f"decode step {f - len(lens)}")
                where = (f"routing, {at} row {r}: {ref[0]} experts "
                         f"{sorted(pa)}, {other[0]} {sorted(pb)}; the "
                         f"{ref[0]} k-th/(k+1)-th logit gap {gap:.6g} = "
                         f"{gap / ulp:.2f} bf16 ulps")
                if gap > MARGIN_ULPS * ulp:
                    fail(f"{cfg.name}: the two split at {where} (limit "
                         f"{MARGIN_ULPS})")
                return where
            continue
        f += 1
        if kind == "p" and f < len(lens):
            continue                  # an inner chunk: nothing emitted
        if int(torch.argmax(a[0])) != int(torch.argmax(b[0])):
            top = torch.topk(a[0], 2).values
            margin, ulp = float(top[0] - top[1]), _ulp(float(top[0]))
            where = (f"token {tok}: the {ref[0]} top-2 margin {margin:.6g} "
                     f"= {margin / ulp:.2f} bf16 ulps")
            if margin > MARGIN_ULPS * ulp:
                fail(f"{cfg.name}: the two split at {where} (limit "
                     f"{MARGIN_ULPS})")
            return where
        tok += 1
    fail(f"{cfg.name}: {other[0]} tokens {other[3]} != {ref[0]} tokens "
         f"{ref[3]}, but the requests served alone split nowhere")


# ---------------------------------------------------------------------------
# phase 6: the train path at full width
# ---------------------------------------------------------------------------

def _counters() -> dict:
    """Each kernel launch count: name -> (wrapper, attribute)."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.fake_quant import fake_quant_kernel
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.quant_matmul import quant_matmul
    return {"fake_quant_fwd": (fake_quant_kernel, "launches_fwd"),
            "fake_quant_bwd": (fake_quant_kernel, "launches_bwd"),
            "fake_quant_factored_fwd": (fake_quant_kernel,
                                        "launches_factored_fwd"),
            "fake_quant_factored_bwd": (fake_quant_kernel,
                                        "launches_factored_bwd"),
            "quant_matmul": (quant_matmul, "launches"),
            "quant_matmul_dequant": (quant_matmul, "launches_dequant"),
            "quant_matmul_int8": (quant_matmul, "launches_int8"),
            "quant_matmul_mma": (quant_matmul, "launches_mma"),
            "quant_matmul_mma_wide": (quant_matmul, "launches_mma_wide"),
            "quant_matmul_fma": (quant_matmul, "launches_fma"),
            "decode_attention": (decode_attention, "launches"),
            "decode_attention_paged": (decode_attention, "launches_paged"),
            "flash_attention": (flash_attention, "launches"),
            "flash_attention_wgmma": (flash_attention, "launches_wgmma"),
            "flash_attention_fma": (flash_attention, "launches_fma")}


def _counts() -> dict:
    return {k: getattr(fn, attr) for k, (fn, attr) in _counters().items()}


def _set_counts(values: dict) -> None:
    for k, (fn, attr) in _counters().items():
        setattr(fn, attr, values[k])


def _zero_counts() -> None:
    _set_counts(dict.fromkeys(_counters(), 0))


def _teacher_on_tensor_cores(counts: dict, where: str,
                             body: str = "wgmma") -> None:
    """Every flash_attention launch in ``counts`` went through ``body``:
    the tensor-core body for the teacher's bf16 attention at hd 128, the
    FMA body at hd 112 (zamba2)."""
    other = counts["flash_attention"] - counts[f"flash_attention_{body}"]
    if other:
        fail(f"{where}: {other} of {counts['flash_attention']} "
             f"flash_attention launches did not take the {body} body")


def _gib() -> float:
    import torch
    return torch.cuda.max_memory_allocated() / 2**30


@contextlib.contextmanager
def _routing(record: list | None = None, replay: list | None = None):
    """Within the block, every MoE routing call (``models.moe.top_k``)
    appends its expert indices to ``record``, or, with ``replay``, takes
    the next recorded indices instead of choosing (the gates then come
    from this run's probabilities at those experts)."""
    from repro_torch.models import moe
    top_k = moe.top_k
    pinned = None if replay is None else iter(replay)

    def routed(probs, k):
        if pinned is not None:
            i = next(pinned)
            v = probs.gather(-1, i)
        else:
            v, i = top_k(probs, k)
        if record is not None:
            record.append(i)
        return v, i
    moe.top_k = routed
    try:
        yield
    finally:
        moe.top_k = top_k


def _linears_per_layer(cfg) -> int:
    """Quantized weights a layer's forward fake-quantizes: wq, wk, wv, wo
    (MLA: q_down, q_up, kv_down, k_up, v_up, wo), then the MLP's three
    (dense), or the router, the three expert stacks (one K3 launch each)
    and the three shared experts' (MoE)."""
    attn = 6 if cfg.mla is not None else 4
    if cfg.moe is None:
        return attn + 3
    return attn + 1 + 3 + (3 if cfg.moe.n_shared else 0)


def _fq_per_forward(cfg) -> int:
    """fake_quant launches of one student forward that reads no head: the
    embedding, then each Mamba2 layer's in_proj and out_proj (SSM,
    hybrid) and each call of the hybrid's shared block (its seven
    weights, every group), or each layer's linears (the encoder-decoder:
    frame_proj, six in an encoder layer, ten in a decoder layer with its
    cross attention's four)."""
    if cfg.family == "encdec":
        return 2 + 6 * cfg.enc_layers + 10 * cfg.n_layers
    if cfg.family == "ssm":
        return 1 + 2 * cfg.n_layers
    if cfg.family == "hybrid":
        return 1 + 2 * cfg.n_layers + 7 * (cfg.n_layers // cfg.attn_every)
    return 1 + _linears_per_layer(cfg) * cfg.n_layers


def _fa_per_forward(cfg) -> int:
    """flash_attention launches of one teacher forward: its attention
    calls (``_attn_layer_count``), or the encoder-decoder's three a layer
    pair: the encoder's and the decoder's causal self-attention, the
    decoder's non-causal cross attention."""
    if cfg.family == "encdec":
        return cfg.enc_layers + 2 * cfg.n_layers
    from repro_torch.serve.engine import _attn_layer_count
    return _attn_layer_count(cfg)


@contextlib.contextmanager
def _causal_flags(record: list | None):
    """Within the block, each flash_attention call the model makes through
    ``ops.attention_prefill`` appends its ``causal`` flag to ``record``."""
    from repro_torch.models import attention
    launch = attention.attention_prefill

    def recorded(q, k, v, causal=True):
        if record is not None:
            record.append(bool(causal))
        return launch(q, k, v, causal=causal)
    attention.attention_prefill = recorded
    try:
        yield
    finally:
        attention.attention_prefill = launch


def _batches(tokens, augment=None):
    """The token batches of ``tokens`` (a CalibDataset), each through
    ``augment`` when given."""
    for batch in tokens:
        yield batch if augment is None else augment(batch)


def _parity_nodes(cfg, student, exported) -> list:
    """(name, student linear, its input stream, exported linear) for the
    export parity check: layer 0's first linear (wq; MLA's q_down; the
    Mamba2 in_proj — for the hybrid its group 0, the whole ``[6, in,
    out]`` stack — and the tail's and the shared block's first; the
    encoder's wq and the decoder's cross wk, whose s_wl comes from the
    stream that also quantizes the decoder's query input), and a MoE's up
    expert stack (its s_wl shared by the experts)."""
    from repro_torch.models.transformer import layer_slice
    if cfg.family == "encdec":
        mods = [("enc_layers", "attn", "wq"), ("dec_layers", "cross", "wk")]
    elif cfg.ssm is not None:
        mods = [("layers", "ssm", "in_proj")]
        if cfg.family == "hybrid":
            mods += [("tail", "ssm", "in_proj")] if "tail" in student else []
            mods += [("shared_attn", "attn", "wq")]
    else:
        mods = [("layers", "attn", "q_down" if cfg.mla is not None
                 else "wq")]
        mods += [("layers", "mlp", "up")] if cfg.moe is not None else []
    out = []
    for top, mod, lin in mods:
        s_node, e_node = student[top][mod], exported[top][mod][lin]
        if top != "shared_attn":
            s_node = layer_slice(s_node, 0)
            e_node = layer_slice(e_node, 0)
        out.append((f"{top} 0 {lin}", s_node[lin], s_node["in_stream"],
                    e_node))
    return out


@contextlib.contextmanager
def _old_fake_quant_route():
    """effective_weight as it ran before K3's factored entry: every weight
    through the assembled ``S_wL ⊗ S_wR``, the broadcast entry and the
    cast (``core.dof``'s route for a shape outside the factored form)."""
    from repro_torch.core import dof
    geometry = dof.factored_geometry
    dof.factored_geometry = lambda *a: None
    try:
        yield
    finally:
        dof.factored_geometry = geometry


def _chain_profile(cfg, qcfg, student, layers: int) -> dict:
    """The fake-quant chain of layer 0's seven weights in isolation, each
    through ``effective_weight`` on the kernel route as a microbatch runs
    it (bf16 out, its stream's S_wL): forward alone and forward +
    backward, device ms and launches under the profiler, on the new route
    and the old one; scaled to a microbatch under remat, where each
    layer's weights run forward twice and backward once: ``layers`` x
    (forward + forward-and-backward)."""
    import torch
    from repro_torch.core import dof
    from repro_torch.models.transformer import layer_slice
    lay = layer_slice(student["layers"], 0)
    weights = []
    for mod, names in (("attn", ("wq", "wk", "wv", "wo")),
                       ("mlp", ("gate", "up", "down"))):
        node = lay[mod]
        for n in names:
            stream = node.get("out_stream" if n == "wo" else
                              "act_stream" if n == "down" else "in_stream")
            weights.append((node[n], None if stream is None
                            else stream["log_sa"]))
    gen = torch.Generator(device=DEVICE).manual_seed(61)
    grads = [torch.randn(p["w"].shape, generator=gen, device=DEVICE).to(
        torch.bfloat16) for p, _ in weights]
    leaves = [({"w": p["w"].detach().clone().requires_grad_(),
                "log_swr": p["log_swr"].detach().clone().requires_grad_()},
               None if lsa is None else lsa.detach().clone()
               .requires_grad_()) for p, lsa in weights]

    def forward():
        with torch.no_grad():
            for p, lsa in leaves:
                dof.effective_weight(p, qcfg, lsa, torch.bfloat16,
                                     use_kernels=True)

    def both():
        for (p, lsa), gy in zip(leaves, grads):
            y = dof.effective_weight(p, qcfg, lsa, torch.bfloat16,
                                     use_kernels=True)
            ins = [p["w"], p["log_swr"]] + ([] if lsa is None else [lsa])
            torch.autograd.grad(y, ins, gy)

    out = {}
    for route in ("new", "old"):
        with (_old_fake_quant_route() if route == "old"
              else contextlib.nullcontext()):
            f_ms, f_n = _device_profile(forward, iters=5)
            b_ms, b_n = _device_profile(both, iters=5)
        if f_ms is None or b_ms is None:
            say("[train] the fake-quant chain: the profiler recorded no "
                "device time")
            return {}
        out[route] = {"fwd_ms": f_ms, "fwd_launches": f_n,
                      "fwd_bwd_ms": b_ms, "fwd_bwd_launches": b_n,
                      "microbatch_ms": layers * (f_ms + b_ms),
                      "microbatch_launches": layers * (f_n + b_n)}
    new, old = out["new"], out["old"]
    say(f"[train] the fake-quant chain of a layer's 7 weights (device, "
        f"profiler), new route vs old: forward {new['fwd_ms']:.4f} ms / "
        f"{new['fwd_launches']:.0f} launches vs {old['fwd_ms']:.4f} / "
        f"{old['fwd_launches']:.0f}; forward + backward "
        f"{new['fwd_bwd_ms']:.4f} / {new['fwd_bwd_launches']:.0f} vs "
        f"{old['fwd_bwd_ms']:.4f} / {old['fwd_bwd_launches']:.0f}; a "
        f"microbatch under remat ({layers} layers x (forward + forward and "
        f"backward)): {new['microbatch_ms']:.3f} ms / "
        f"{new['microbatch_launches']:.0f} launches vs "
        f"{old['microbatch_ms']:.3f} / {old['microbatch_launches']:.0f}")
    return out


def train_path(cfg, layers: int = TRAIN_LAYERS, steps: int = TRAIN_STEPS,
               microbatches: int = TRAIN_MICROBATCHES,
               data_cfg: dict = TRAIN_DATA, augment=None,
               shape: str = "", chain_ab: bool = False) -> dict:
    """QFT at full width, ``layers`` deep: prepare, ``steps`` steps of the
    batch in ``microbatches``, export and serve (the encoder-decoder: its
    cache-mode forward, and the engine's refusal), the plain-route
    comparison.  The batches are ``data_cfg``'s token batches, each passed
    through ``augment`` (the VLM's patch embeddings and positions, the
    encoder-decoder's frames) when given; ``shape`` describes them.
    With ``chain_ab`` the profiled microbatch runs again on the old
    fake-quant route, and the chain is profiled alone
    (:func:`_chain_profile`).  Returns the kernels' launch counts (and the
    chain's profile under ``"fake_quant_chain"``)."""
    import torch
    from repro_torch.core import dof
    from repro_torch.core.qconfig import QuantConfig
    from repro_torch.data.calib import CalibConfig, CalibDataset
    from repro_torch.models import forward, init_model
    from repro_torch.models.transformer import remat_configured
    from repro_torch.pipeline.adapters import resolve_quant_plan
    from repro_torch.serve.deploy import (export_for_layers,
                                          kernel_route_check,
                                          make_deploy_plan)
    from repro_torch.serve.engine import Engine, Request, ServeConfig
    from repro_torch.train.qft_trainer import QFTConfig, QFTTrainer
    from repro_torch.train.steps import make_value_and_grad
    from repro_torch.tree import tree_items
    from repro_torch.kernels.flash_attention import body_for
    from repro_torch.serve.engine import _attn_layer_count
    full_depth = cfg.n_layers
    cfg = dataclasses.replace(cfg, n_layers=layers)
    L = cfg.n_layers
    # attention calls of a decode step that K2 carries (MLA and the SSM:
    # none; MLA's attention is einsums on both routes; the hybrid: one a
    # group), and of a teacher forward that K4 carries (the same, but the
    # encoder-decoder's three a layer pair)
    L_attn = _attn_layer_count(cfg)
    fa_fwd = _fa_per_forward(cfg)
    shape = shape or f"{data_cfg['batch_size']} x {data_cfg['seq_len']}"
    # the teacher's bf16 attention: the tensor-core body at hd 64/128, the
    # FMA body otherwise (zamba2's hd 112)
    fa_body = body_for(torch.bfloat16, cfg.head_dim, "bshd")
    qcfg = QuantConfig()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    teacher = init_model(torch.Generator(device=DEVICE).manual_seed(0), cfg,
                         None, device=DEVICE)
    n_params = sum(t.numel() for _, t in tree_items(teacher))
    tokens = CalibDataset(CalibConfig(vocab=cfg.vocab, **data_cfg))
    data = _batches(tokens, augment)
    calib = _batches(CalibDataset(CalibConfig(vocab=cfg.vocab, **data_cfg)),
                     augment)
    # the plan resolved once from the student's shapes: the trainer's grid
    # and the export's (at 2 layers qwen2-moe's 1 % rule keeps attn.wk at
    # 8 bits)
    qplan = resolve_quant_plan(cfg, qcfg)
    trainer = QFTTrainer(cfg, qcfg, teacher, QFTConfig(),
                         steps_per_epoch=tokens.steps_per_epoch,
                         microbatches=microbatches, plan=qplan)

    # --- the path, with every kernel count at 0 just before it
    _zero_counts()
    student = trainer.prepare_student(1, [next(calib) for _ in range(2)])
    torch.cuda.synchronize()
    t_prep = time.perf_counter() - t0
    peak_prep = _gib()
    say(f"[train] {cfg.name} full width, {L} of {full_depth} layers "
        f"({n_params / 1e9:.3f}"
        f" B parameters): teacher + prepare_student (calibration on 2 "
        f"batches, APQ/MMSE init) {t_prep:.1f} s, peak {peak_prep:.2f} GiB")
    if _counts()["fake_quant_fwd"]:
        fail("prepare_student launched fake_quant: the teacher is FP")
    prep_fa = _counts()["flash_attention"]
    if prep_fa != 2 * fa_fwd:     # the teacher over 2 calibration batches
        fail(f"calibration launched flash_attention {prep_fa} times, want "
             f"{2 * fa_fwd}")
    _teacher_on_tensor_cores(_counts(), "calibration", fa_body)
    torch.cuda.reset_peak_memory_stats()
    student, hist = trainer.run(student, data, steps=steps, log_every=1)
    torch.cuda.synchronize()
    peak_run = _gib()
    losses = [h["loss"] for h in hist]
    ts = [h["t"] for h in hist]
    step_ms = [1e3 * (b - a) for a, b in zip([0.0] + ts[:-1], ts)]
    per_fwd = _fq_per_forward(cfg)    # embed + the layers'; no lm_head
    # remat: the backward runs every layer body's forward again, its
    # weights' fake-quant with it (not the embedding's, nor frame_proj's)
    recomputed = (per_fwd - (2 if cfg.family == "encdec" else 1)
                  if remat_configured(cfg) else 0)
    want = steps * microbatches * per_fwd
    run_counts = _counts()
    say(f"[train] {steps} steps, batch {shape} in {microbatches} "
        f"microbatches: "
        f"loss {', '.join(f'{x:.6f}' for x in losses)}; ms/step "
        f"{', '.join(f'{x:.1f}' for x in step_ms)} (steps 2-{steps} "
        f"mean {sum(step_ms[1:]) / (len(step_ms) - 1):.1f}); peak "
        f"{peak_run:.2f} GiB")
    fa_want = steps * microbatches * fa_fwd
    say(f"[train] fake_quant launches forward {run_counts['fake_quant_fwd']} "
        f"backward {run_counts['fake_quant_bwd']} (= {steps} steps x "
        f"{microbatches} microbatches x {per_fwd}: 1 embed + the "
        f"linears of {L} layers"
        + (f" + 7 x {L_attn} shared-block calls" if cfg.family == "hybrid"
           else " + frame_proj" if cfg.family == "encdec" else "") + "; "
        f"the forward also {steps} x {microbatches} x {recomputed} "
        f"recomputed by remat ({cfg.remat_policy})); "
        f"lm_head is not run: the backbone-L2 loss never reads it); "
        f"flash_attention (the teacher) {prep_fa} in calibration + "
        f"{run_counts['flash_attention'] - prep_fa} in the steps (= "
        f"{steps} x {microbatches} x {fa_fwd} attention calls, "
        f"{fa_body} body)")
    if run_counts["flash_attention"] - prep_fa != fa_want:
        fail(f"the steps launched flash_attention "
             f"{run_counts['flash_attention'] - prep_fa} times, want "
             f"{fa_want}")
    _teacher_on_tensor_cores(run_counts, "the train steps", fa_body)
    if len(losses) != steps or not all(map(math.isfinite, losses)):
        fail(f"train losses {losses}")
    want_fwd = want + steps * microbatches * recomputed
    if (run_counts["fake_quant_fwd"], run_counts["fake_quant_bwd"]) != (
            want_fwd, want):
        fail(f"fake_quant launched {run_counts['fake_quant_fwd']} forward / "
             f"{run_counts['fake_quant_bwd']} backward, want {want_fwd} / "
             f"{want}")
    # every weight but the embedding (a per-row scale: the broadcast
    # entry, once each way a microbatch) through the factored entry
    emb = steps * microbatches
    factored = (run_counts["fake_quant_factored_fwd"],
                run_counts["fake_quant_factored_bwd"])
    say(f"[train] fake_quant's factored entry: {factored[0]} forward / "
        f"{factored[1]} backward of those launches; the broadcast entry "
        f"{run_counts['fake_quant_fwd'] - factored[0]} / "
        f"{run_counts['fake_quant_bwd'] - factored[1]} (the embedding)")
    if factored != (want_fwd - emb, want - emb):
        fail(f"fake_quant's factored entry launched {factored}, want "
             f"{(want_fwd - emb, want - emb)}: every weight but the "
             f"embedding")

    # --- export the trained student and serve it
    plan = make_deploy_plan(qcfg, arch=cfg.name, family=cfg.family,
                            params=student, model_cfg=cfg)
    if dict(plan.quant_plan) != dict(qplan):
        fail("the export plan, resolved from the trained student, is not "
             "the plan it trained on")
    with torch.no_grad():
        exported = export_for_layers(student, plan, device=DEVICE)
        parities = []
        for lin, node, stream, ex in _parity_nodes(cfg, student, exported):
            w_eff = dof.effective_weight(node, qcfg, stream["log_sa"],
                                         compute_dtype=torch.float32)
            w_dq = dof.dequantize_export(ex, torch.float32)
            parity = float((w_eff - w_dq).abs().max())
            if parity > 1e-6 * float(w_eff.abs().max()):
                fail(f"export parity: {lin} dequantized export vs the "
                     f"trained effective weight, max err {parity}")
            parities.append(f"{lin} {tuple(w_eff.shape)} {parity:.3e}")
            del w_eff, w_dq
    check = kernel_route_check(exported, plan)
    if not (check and check["kernel"] and check["max_err"] <= 1e-4):
        fail(f"kernel_route_check on the trained artifact: {check}")
    if cfg.family == "encdec":
        served = encdec_cache_path(cfg, plan, exported, augment)
        counts = _counts()
        if counts["decode_attention"]:
            fail(f"the encoder-decoder's decode launched decode_attention "
                 f"{counts['decode_attention']} times (its scalar-pos "
                 f"decode takes _sdpa)")
        if counts["quant_matmul"] != 1:
            fail(f"quant_matmul launched {counts['quant_matmul']} times, "
                 f"want once (the route check)")
    else:
        scfg = ServeConfig(max_slots=2, max_len=256, prefill_chunk=128)
        rng = torch.Generator().manual_seed(8)
        reqs = [Request(prompt=torch.randint(0, cfg.vocab, (n,),
                                             generator=rng).tolist(),
                        max_new_tokens=NEW_TOKENS) for n in (40, 100)]
        engine = Engine.from_artifact(cfg, plan, exported, scfg,
                                      device=DEVICE)
        toks = engine.generate(reqs)
        torch.cuda.synchronize()
        counts = _counts()
        for t in toks:
            if len(t) != NEW_TOKENS or not all(0 <= x < cfg.vocab for x in t):
                fail(f"bad output from the trained artifact: {t}")
        if counts["decode_attention"] != L_attn * engine.decode_steps \
                or engine.decode_steps == 0:
            fail(f"decode_attention launched {counts['decode_attention']} "
                 f"times over {engine.decode_steps} decode steps of "
                 f"{L_attn} routed layers")
        served = (f"served {len(reqs)} greedy requests from the trained "
                  f"artifact: {toks}; launches decode_attention="
                  f"{counts['decode_attention']} (= {L_attn} x "
                  f"{engine.decode_steps})")
        del engine
    say(f"[train] export parity ({'; '.join(parities)}); "
        f"kernel_route_check {check['path']}: quant_matmul ran, max_err "
        f"{check['max_err']:.3e}; {served}; launches quant_matmul="
        f"{counts['quant_matmul']}; peak {_gib():.2f} GiB")
    del exported
    torch.cuda.empty_cache()

    # --- one more step's loss and gradients: kernel route (profiled) vs
    # plain route, from the trained state.  The teacher's hidden states are
    # compared route against route first; then both student routes take
    # the kernel route's targets, so their gap is fake_quant's alone.
    batch = {k: torch.as_tensor(v).to(DEVICE) for k, v in next(data).items()}
    causal_flags = []
    # a MoE teacher: the plain route's forward takes the kernel route's
    # expert choices (the same bf16 logit ties split the routes otherwise,
    # and one flipped expert moves a token's hidden state far more than
    # the attention's rounding does); the unpinned forward is reported
    hidden, routes = {}, {}
    runs = ((True, None), (False, True)) + (
        ((False, None),) if cfg.moe is not None else ())
    with torch.no_grad():
        for use, pin in runs:
            before = _counts()
            routes[use, pin] = []
            with _routing(record=routes[use, pin],
                          replay=routes[True, None] if pin else None), \
                    _causal_flags(causal_flags if use else None):
                hidden[use, pin] = forward(teacher, cfg, None, batch,
                                           use_kernels=use, logits=False)
            now = _counts()
            delta = {k: now[k] - before[k] for k in now}
            if delta["flash_attention"] != (fa_fwd if use else 0):
                fail(f"teacher forward (use_kernels={use}) launched "
                     f"flash_attention {delta['flash_attention']} times over "
                     f"{fa_fwd} routed attention calls")
            _teacher_on_tensor_cores(delta, "the teacher forward", fa_body)

    def rel(a, b):
        a, b = a["hidden"].float(), b["hidden"].float()
        return float((a - b).norm() / b.norm())
    hid_rel = rel(hidden[True, None], hidden[False, True])
    pinned = ""
    if cfg.moe is not None:
        flips = sum(int((torch.sort(a, -1).values != torch.sort(b, -1).values)
                        .any(-1).sum())
                    for a, b in zip(routes[True, None], routes[False, None]))
        n_dec = sum(a.shape[0] for a in routes[True, None])
        pinned = (f"; the plain route on the kernel route's expert choices "
                  f"— unpinned: rel L2 "
                  f"{rel(hidden[True, None], hidden[False, None]):.3e}, "
                  f"{flips} of {n_dec} token-layer expert sets differ")
    what = ("the kernel route (no attention kernel: MLA's is einsums, the "
            "SSM has none)" if fa_fwd == 0 else
            f"flash_attention ({fa_body} body)")
    say(f"[train] teacher hidden states, {what} vs the plain route "
        f"(bf16 compute, batch {shape}): rel L2 {hid_rel:.3e} (bound "
        f"{TEACHER_HIDDEN_BOUND:.0e}; both round P to bf16 before P.V, the "
        f"kernel unnormalised, the plain route normalised){pinned}")
    if not hid_rel <= TEACHER_HIDDEN_BOUND:
        fail(f"teacher hidden states: kernel vs plain route rel L2 {hid_rel}")
    if fa_fwd == 0 and not torch.equal(hidden[True, None]["hidden"],
                                       hidden[False, True]["hidden"]):
        fail(f"teacher hidden states: no kernel runs on either route, yet "
             f"they differ (rel L2 {hid_rel})")
    n_causal = sum(causal_flags)
    want_causal = fa_fwd - (cfg.n_layers if cfg.family == "encdec" else 0)
    if (n_causal, len(causal_flags)) != (want_causal, fa_fwd):
        fail(f"the teacher's flash_attention calls: {n_causal} causal of "
             f"{len(causal_flags)}, want {want_causal} of {fa_fwd}")
    if cfg.family == "encdec":
        say(f"[train] the teacher forward's {fa_fwd} flash_attention calls: "
            f"{n_causal} causal (encoder and decoder self-attention), "
            f"{fa_fwd - n_causal} non-causal (cross attention, Sq "
            f"{batch['tokens'].shape[1]} over Sk {batch['frames'].shape[1]})"
            f", all on the {fa_body} body")
    targets = hidden[True, None]
    del hidden
    # one microbatch profiled, not the step: the profiler's processing
    # grows with the events in its window, and a whole step of mamba2's 48
    # layers in 8 microbatches launches ~200,000 kernels
    rows = data_cfg["batch_size"] // microbatches
    mb = {k: v[:rows] for k, v in batch.items()}
    vg = make_value_and_grad(cfg, qcfg, plan=qplan)
    prof = _profile(lambda: vg(student, teacher, mb), f"microbatch forward+"
                    f"backward ({rows} rows of the {shape} batch, kernel "
                    f"route, teacher included, no optimizer)", 1,
                    watch=("fa_", "fq_"))
    chain = {}
    if chain_ab:
        with _old_fake_quant_route():
            prof_old = _profile(lambda: vg(student, teacher, mb),
                                "microbatch forward+backward, the old "
                                "fake-quant route", 1, watch=("fa_", "fq_"))
        if prof and prof_old:
            chain["microbatch"] = {"new": prof, "old": prof_old}
            say(f"[train] the profiled microbatch, new fake-quant route vs "
                f"old: device busy {prof['busy_ms']:.3f} vs "
                f"{prof_old['busy_ms']:.3f} ms, {prof['launches']:.0f} vs "
                f"{prof_old['launches']:.0f} launches; K3's kernels "
                f"{prof['watch']['fq_'][0]:.3f} ms / "
                f"{prof['watch']['fq_'][1]:.0f} vs "
                f"{prof_old['watch']['fq_'][0]:.3f} ms / "
                f"{prof_old['watch']['fq_'][1]:.0f}")
        chain.update(_chain_profile(cfg, qcfg, student, L))
    grads = {}
    for use in (True, False):
        before = _counts()
        vg = make_value_and_grad(cfg, qcfg, microbatches=microbatches,
                                 plan=qplan, use_kernels=use)
        grads[use] = vg(student, teacher, batch, targets=targets)
        torch.cuda.synchronize()
        if not use and _counts() != before:
            fail("the plain route launched a kernel")
    (lk, gk), (lp, gp) = grads[True], grads[False]
    loss_rel = abs(float(lk) - float(lp)) / abs(float(lp))
    plain = dict(tree_items(gp))
    worst, worst_at = 0.0, None
    for path, gr in tree_items(gk):
        ref = plain[path]
        if gr is None or ref is None:
            if (gr is None) != (ref is None):
                fail(f"gradient of {path}: one route has none")
            continue
        rel = float((gr - ref).norm()) / max(float(ref.norm()), 1e-30)
        if rel > worst:
            worst, worst_at = rel, ".".join(path)
    say(f"[train] step {steps + 1}, kernel vs plain route: loss "
        f"{float(lk):.8f} vs {float(lp):.8f} (rel {loss_rel:.2e}); "
        f"gradients: worst leaf {worst_at} rel L2 {worst:.2e}; phase "
        f"{time.perf_counter() - t0:.1f} s")
    if loss_rel > 1e-6:
        fail(f"train loss kernel route {float(lk)} vs plain {float(lp)}")
    if worst > 1e-4:
        fail(f"gradient of {worst_at}: rel L2 {worst} > 1e-4")
    return dict(counts, fake_quant_chain=chain) if chain else counts


# ---------------------------------------------------------------------------
# phases 19-20: the VLM's and the encoder-decoder's batches, the cache-mode
# forward
# ---------------------------------------------------------------------------

def vlm_augment(cfg, n_img: int = VLM_PATCHES, grid: tuple = VLM_GRID):
    """``batch -> batch`` for qwen2-vl: ``n_img`` patch embeddings (a fresh
    draw each batch) before the tokens, and ``positions [B, 3, n_img +
    S]`` with three different streams: the patches on a ``grid`` (t 0,
    h the row, w the column), the text after them at max + 1 + i on all
    three, so that M-RoPE's sections rotate by different positions."""
    import torch
    rows, cols = grid
    g = torch.Generator(device=DEVICE).manual_seed(17)
    ar = torch.arange(n_img, device=DEVICE)
    img = torch.stack([torch.zeros_like(ar), ar // cols, ar % cols])

    def augment(batch):
        tokens = torch.as_tensor(batch["tokens"]).to(DEVICE)
        B, S = tokens.shape
        txt = (int(img.max()) + 1 + torch.arange(S, device=DEVICE)).expand(
            3, S)
        pos = torch.cat([img, txt], 1).to(torch.int32)
        return {"tokens": tokens,
                "patch_embeds": torch.randn(
                    (B, n_img, cfg.d_model), generator=g,
                    device=DEVICE).bfloat16(),
                "positions": pos[None].expand(B, 3, n_img + S).contiguous()}
    return augment


def encdec_augment(cfg, n_frames: int = ENCDEC_FRAMES):
    """``batch -> batch`` for seamless: ``n_frames`` frame embeddings (a
    fresh draw each batch) for the encoder beside the decoder's tokens."""
    import torch
    g = torch.Generator(device=DEVICE).manual_seed(18)

    def augment(batch):
        tokens = torch.as_tensor(batch["tokens"]).to(DEVICE)
        return {"tokens": tokens,
                "frames": torch.randn((tokens.shape[0], n_frames,
                                       cfg.d_model), generator=g,
                                      device=DEVICE).bfloat16()}
    return augment


def encdec_cache_path(cfg, plan, exported, augment) -> str:
    """Phase 20's cache-mode forward on the trained artifact's deploy view
    (bf16): a batch of ENCDEC_SERVE_BATCH, each a ENCDEC_PROMPT-token
    prompt over ENCDEC_FRAMES frames, prefilled into ``init_cache(cfg, B,
    128)`` (the encoder runs and its cross K/V are written into the
    cache), then ENCDEC_NEW greedy decode steps that read them.  One
    cache-free forward over the same tokens must give logits within
    TEACHER_HIDDEN_BOUND relative L2 (the decoder's self-attention takes
    ``_sdpa`` over the cache, K4 without one) and the same argmax at
    every position, or there a top-2 margin within MARGIN_ULPS bf16 ulps.
    The prefill's encoder is a cache-free forward and the cross attention
    reads no cache of its own, so both take flash_attention; the
    decoder's self-attention over the cache takes ``_sdpa`` (the
    scalar-pos decode launches no decode_attention); the cache-free
    forward sends all its attention calls through flash_attention.  Last,
    the engine must refuse the family by name."""
    import torch
    from repro_torch.models import forward, init_cache
    from repro_torch.serve.deploy import deploy_view
    from repro_torch.serve.engine import Engine, ServeConfig
    with torch.no_grad():
        params = deploy_view(exported, plan)
    g = torch.Generator(device=DEVICE).manual_seed(12)
    B, P, N = ENCDEC_SERVE_BATCH, ENCDEC_PROMPT, ENCDEC_NEW
    batch = augment({"tokens": torch.randint(0, cfg.vocab, (B, P),
                                             generator=g, device=DEVICE)})
    cache = init_cache(cfg, B, 128, device=DEVICE)
    before = _counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        out = forward(params, cfg, None, batch, cache, use_kernels=True)
        want = (cfg.n_layers, B, ENCDEC_FRAMES, cfg.n_kv_heads_padded,
                cfg.head_dim)
        if cache["cross"] is None or tuple(cache["cross"]["k"].shape) != want:
            fail(f"prefill did not write the cross K/V {want} into the "
                 f"cache")
        rows = [out["logits"][:, -1].float()]
        toks = [torch.argmax(rows[-1], -1)]
        for _ in range(N):
            out = forward(params, cfg, None, {"tokens": toks[-1][:, None]},
                          cache, use_kernels=True)
            if out["enc_out"] is not None:
                fail("a decode step ran the encoder")
            rows.append(out["logits"][:, -1].float())
            toks.append(torch.argmax(rows[-1], -1))
        torch.cuda.synchronize()
        t_cache = time.perf_counter() - t0
        if cache["self"]["pos"] != P + N:
            fail(f"the cache's pos is {cache['self']['pos']}, want {P + N}")
        mid = _counts()
        fa_cache = mid["flash_attention"] - before["flash_attention"]
        fa_want = cfg.enc_layers + cfg.n_layers * (1 + N)
        if fa_cache != fa_want or (mid["decode_attention"]
                                   != before["decode_attention"]):
            fail(f"the cache-mode forward launched flash_attention "
                 f"{fa_cache} times (want {fa_want}: the prefill's encoder "
                 f"and every call's cross attention) and decode_attention "
                 f"{mid['decode_attention'] - before['decode_attention']} "
                 f"times (want 0)")
        gen = torch.stack(toks, 1)                             # [B, N + 1]
        full = forward(params, cfg, None, {
            "tokens": torch.cat([batch["tokens"], gen[:, :N]], 1),
            "frames": batch["frames"]}, use_kernels=True)["logits"]
        torch.cuda.synchronize()
    fa = _counts()["flash_attention"] - mid["flash_attention"]
    if fa != _fa_per_forward(cfg):
        fail(f"the cache-free forward launched flash_attention {fa} times, "
             f"want {_fa_per_forward(cfg)}")
    ref = full[:, P - 1:].float()                              # [B, N + 1, V]
    got = torch.stack(rows, 1)
    logit_rel = float((got - ref).norm() / ref.norm())
    if not logit_rel <= TEACHER_HIDDEN_BOUND:
        fail(f"cache-mode logits vs the cache-free forward's: rel L2 "
             f"{logit_rel} > {TEACHER_HIDDEN_BOUND}")
    splits = []
    for b, i in torch.nonzero(torch.argmax(ref, -1) != gen).tolist():
        top = torch.topk(ref[b, i], 2).values
        margin, ulp = float(top[0] - top[1]), _ulp(float(top[0]))
        if margin > MARGIN_ULPS * ulp:
            fail(f"cache-mode token {i} of row {b} differs from the "
                 f"cache-free forward's argmax at a top-2 margin of "
                 f"{margin / ulp:.2f} bf16 ulps (limit {MARGIN_ULPS})")
        splits.append(f"row {b} token {i} ({margin / ulp:.2f} ulps)")
    try:
        Engine.from_artifact(cfg, plan, exported,
                             ServeConfig(max_slots=2, max_len=256),
                             device=DEVICE)
    except NotImplementedError as e:
        if "'encdec'" not in str(e):
            fail(f"the engine refused encdec with another message: {e}")
        refusal = str(e).split(":")[0]
    else:
        fail("the engine built an enc-dec serving path")
    del params, cache, full, got
    return (f"cache-mode forward (batch {B}, {ENCDEC_FRAMES} frames, a "
            f"{P}-token prompt, prefill + {N} greedy decode steps, "
            f"{t_cache:.2f} s, flash_attention {fa_cache}: the prefill's "
            f"encoder and every call's cross attention): logits rel L2 "
            f"{logit_rel:.3e} from the cache-free forward's (bound "
            f"{TEACHER_HIDDEN_BOUND:.0e}), {B * (N + 1) - len(splits)} of "
            f"{B * (N + 1)} tokens the cache-free forward's argmax"
            + (f", the others near-ties: {', '.join(splits)}" if splits
               else "") + f"; tokens {gen.tolist()}; the engine: "
            f"NotImplementedError '{refusal}'")


# ---------------------------------------------------------------------------
# phase 7: the pipeline at full width, run twice on one workdir
# ---------------------------------------------------------------------------

def _pipeline_run(pcfg, adapter, tag: str, keep: bool = False) -> dict:
    """run_pipeline with every kernel count at 0 just before it; the
    launches and the seconds of each stage are read at its log line.
    ``keep`` returns the PipelineResult too."""
    import torch
    from repro_torch.pipeline import run_pipeline
    per_stage: dict = {}
    mark = [_counts()]

    def log(msg: str) -> None:
        torch.cuda.synchronize()
        say(f"[pipeline] {tag}: {msg}")
        if msg.startswith("stage "):
            now = _counts()
            per_stage[msg.split()[1]] = {k: now[k] - mark[0][k] for k in now}
            per_stage[msg.split()[1]]["s"] = float(msg.split()[-1][:-1])
            mark[0] = now

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    mark[0] = _counts()
    t0 = time.perf_counter()
    result = run_pipeline(pcfg, log=log, adapter=adapter)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = {"wall": wall, "peak": _gib(), "per_stage": per_stage,
           "counts": _counts(), "run": result.stages_run,
           "skipped": result.stages_skipped, "history": result.history,
           "metrics": result.metrics}
    if keep:
        out["result"] = result
    for stage, c in per_stage.items():
        say(f"[pipeline] {tag}: {stage} launches " + ", ".join(
            f"{k}={v}" for k, v in c.items() if v and k != "s"))
    return out


def _record_student_routes(adapter) -> dict:
    """Wrap ``adapter.degradation``: after evaluate's metrics (the student's
    attention on ``_sdpa``, the route it trained on), once, the same metrics
    with the student's attention on K4 too, for the record.  That extra
    pass's launches are taken back off the counts."""
    import torch
    from repro_torch.kernels.flash_attention import attention_prefill
    from repro_torch.models import attention as attn
    degradation, sdpa, record = adapter.degradation, attn._sdpa, {}

    def student_on_k4(q, k, v, causal, q_offset, kv_len=None):
        if (causal and q_offset == 0 and kv_len is None and q.is_cuda
                and not torch.is_grad_enabled()):
            return attention_prefill(q, k, v, causal=True)
        return sdpa(q, k, v, causal, q_offset, kv_len)

    def both(student, teacher):
        record["sdpa"] = degradation(student, teacher)
        counts = _counts()
        attn._sdpa = student_on_k4
        try:
            record["k4"] = degradation(student, teacher)
        finally:
            attn._sdpa = sdpa
        _set_counts(counts)
        return record["sdpa"]

    adapter.degradation = both
    return record


def pipeline_path(cfg) -> dict:
    """python -m repro_torch quantize's path (run_pipeline) at full width,
    depth cut to PIPELINE_LAYERS, in a temporary workdir; then again on the
    same workdir, which must skip the student stages and reproduce evaluate.
    Returns the first run's launch counts."""
    import tempfile
    from repro_torch.pipeline import STAGES, PipelineConfig
    from repro_torch.pipeline.adapters import TransformerAdapter
    from repro_torch.train.checkpoint import CheckpointManager
    cfg_cut = dataclasses.replace(cfg, n_layers=PIPELINE_LAYERS)
    saves: list = []
    save = CheckpointManager.save

    def timed_save(self, step, *a, **k):     # host clock around each write
        t0 = time.perf_counter()
        save(self, step, *a, **k)
        self.wait()
        saves.append(f"{self.dir.name}/{step} "
                     f"{time.perf_counter() - t0:.1f} s")

    CheckpointManager.save = timed_save
    with tempfile.TemporaryDirectory(prefix="qft_pipeline_") as workdir:
        pcfg = PipelineConfig(arch=cfg.name, smoke=False, workdir=workdir,
                              device=DEVICE, log_every=1, **PIPELINE)
        say(f"[pipeline] {cfg.name} full width, {PIPELINE_LAYERS} of "
            f"{cfg.n_layers} layers, mode {pcfg.mode}: {PIPELINE}")
        adapters = [TransformerAdapter(pcfg, cfg_cut, pcfg.quant_config())
                    for _ in range(2)]
        routes = _record_student_routes(adapters[1])
        runs = [_pipeline_run(pcfg, ad, tag)
                for ad, tag in zip(adapters, ("run 1", "run 2"))]
        disk = sum(f.stat().st_size for f in Path(workdir).rglob("*")
                   if f.is_file())
    CheckpointManager.save = save
    first, second = runs
    ev1, ev2 = first["metrics"]["evaluate"], second["metrics"]["evaluate"]
    losses = [h["loss"] for h in first["history"]]
    say(f"[pipeline] run 1: {first['wall']:.1f} s, peak {first['peak']:.2f} "
        f"GiB; checkpoint writes ({disk / 2**30:.2f} GiB on disk): "
        f"{', '.join(saves)}; finetune loss (each step's batch, before "
        f"its update) {', '.join(f'{x:.6f}' for x in losses)}")
    say(f"[pipeline] run 1 evaluate: distill_loss {ev1['distill_loss']:.6f} "
        f"top1_agree {ev1['top1_agree']:.6f} export_parity_max_err "
        f"{ev1['export_parity_max_err']:.3e} artifact_bytes "
        f"{ev1['artifact_bytes']} kernel_route {ev1.get('kernel_route')} "
        f"serve {ev1.get('serve')}")
    say(f"[pipeline] run 2 (resume): {second['wall']:.1f} s, peak "
        f"{second['peak']:.2f} GiB, skipped {second['skipped']}; "
        f"distill_loss {ev2['distill_loss']:.6f} top1_agree "
        f"{ev2['top1_agree']:.6f} export_parity_max_err "
        f"{ev2['export_parity_max_err']:.3e}")
    dl_sdpa, dl_k4 = (routes[r]["distill_loss"] for r in ("sdpa", "k4"))
    say(f"[pipeline] run 2 evaluate, the student's attention on each route "
        f"(the teacher on K4): distill_loss _sdpa (evaluate's) "
        f"{dl_sdpa:.6f}, K4 {dl_k4:.6f} (rel "
        f"{abs(dl_k4 - dl_sdpa) / dl_sdpa:.3e}); top1_agree "
        f"{routes['sdpa']['top1_agree']:.6f} / "
        f"{routes['k4']['top1_agree']:.6f}")
    if first["run"] != list(STAGES) or first["skipped"]:
        fail(f"pipeline run 1 ran {first['run']}, skipped {first['skipped']}")
    if len(losses) != PIPELINE["steps"] or not all(map(math.isfinite,
                                                       losses)):
        fail(f"pipeline finetune losses {losses}")
    for stage in ("calibrate", "finetune", "evaluate"):
        if first["per_stage"][stage]["flash_attention"] < 1:
            fail(f"flash_attention did not launch in {stage}")
        _teacher_on_tensor_cores(first["per_stage"][stage],
                                 f"pipeline {stage}")
    # evaluate runs the teacher through K4 once a layer per eval batch; the
    # student keeps _sdpa, the route it trained on
    fa_eval = PIPELINE["eval_batches"] * PIPELINE_LAYERS
    if first["per_stage"]["evaluate"]["flash_attention"] != fa_eval:
        fail(f"evaluate launched flash_attention "
             f"{first['per_stage']['evaluate']['flash_attention']} times, "
             f"want {fa_eval} (the teacher only)")
    ev_counts = first["per_stage"]["evaluate"]
    if ev_counts["quant_matmul"] < 1 or ev_counts["decode_attention"] < 1:
        fail(f"evaluate's route check and serve smoke did not launch "
             f"quant_matmul and decode_attention: {ev_counts}")
    if not (ev1.get("kernel_route") or {}).get("kernel"):
        fail(f"kernel_route_check did not run quant_matmul: "
             f"{ev1.get('kernel_route')}")
    if ev1.get("serve", {}).get("tokens") != 12:
        fail(f"serve smoke: {ev1.get('serve')}")
    if not ev1["export_parity_max_err"] < 1e-4:
        fail(f"export parity {ev1['export_parity_max_err']} >= 1e-4")
    if second["skipped"] != ["calibrate", "init", "finetune"] \
            or second["run"] != ["export", "evaluate"]:
        fail(f"pipeline run 2 ran {second['run']}, skipped "
             f"{second['skipped']}")
    for key in ("distill_loss", "top1_agree", "export_parity_max_err"):
        a, b = ev1[key], ev2[key]
        if abs(a - b) > 1e-6 * max(abs(a), 1e-30):
            fail(f"resumed evaluate {key} {b} != first run's {a}")
    if ev1["artifact_bytes"] != ev2["artifact_bytes"]:
        fail("resumed artifact differs in size")
    return first["counts"]


# ---------------------------------------------------------------------------
# phase 8: the paper CNN's pipeline at full width
# ---------------------------------------------------------------------------

def _fq_counts(counts: dict) -> tuple[int, int]:
    return counts["fake_quant_fwd"], counts["fake_quant_bwd"]


def cnn_path(ccfg) -> dict:
    """python -m repro_torch quantize --config paper_cnn with the paper
    example's knobs (CNN_PIPELINE) at the config's full width, in a
    temporary workdir; again on the same workdir (calibrate, init and
    finetune skipped, the same evaluate metrics); then w4chw and w4a8 with
    no finetune (the pre-QFT accuracy).  fake_quant launches counted per
    stage: one forward and one backward per conv and finetune step (the
    loss reads the pre-pool features, so the fc is not run, as XLA drops it
    from the JAX step).  One step's loss and gradients through fake_quant
    and through the plain route, on one batch.  Returns the first run's
    launch counts."""
    import tempfile
    import torch
    from repro_torch.pipeline import STAGES, PipelineConfig
    from repro_torch.tree import tree_items
    n_w = len(ccfg.channels)          # K3 calls a finetune pass: the convs
    steps = CNN_PIPELINE["steps"]
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # the rerun's teacher
    try:
        with tempfile.TemporaryDirectory(prefix="qft_cnn_") as workdir:
            pcfg = PipelineConfig(arch=ccfg.name, workdir=workdir,
                                  device=DEVICE, log_every=steps // 6,
                                  **CNN_PIPELINE)
            say(f"[cnn] {ccfg.name} full width (channels {ccfg.channels}, "
                f"{ccfg.img_hw}x{ccfg.img_hw}x{ccfg.in_ch} images, "
                f"{ccfg.n_classes} classes): {CNN_PIPELINE}")
            first = _pipeline_run(pcfg, None, "cnn run 1", keep=True)
            second = _pipeline_run(pcfg, None, "cnn run 2 (resume)")
        chw = _pipeline_run(dataclasses.replace(
            pcfg, mode="w4chw", steps=0, cle=False, workdir=None), None,
            "cnn w4chw, no finetune")
        pre = _pipeline_run(dataclasses.replace(pcfg, steps=0, workdir=None),
                            None, "cnn w4a8, no finetune (pre-QFT)")
    finally:
        torch.backends.cudnn.deterministic = deterministic
    ev1, ev2 = first["metrics"]["evaluate"], second["metrics"]["evaluate"]
    if first["run"] != list(STAGES) or first["skipped"]:
        fail(f"cnn run 1 ran {first['run']}, skipped {first['skipped']}")
    ft = first["per_stage"]["finetune"]
    if _fq_counts(ft) != (n_w * steps, n_w * steps):
        fail(f"cnn finetune launched fake_quant {_fq_counts(ft)} (forward, "
             f"backward) over {steps} steps, want {n_w} each per step (the "
             f"convs)")
    for stage in ("calibrate", "init", "export"):
        if any(_fq_counts(first["per_stage"][stage])):
            fail(f"cnn {stage} launched fake_quant "
                 f"{_fq_counts(first['per_stage'][stage])}")
    if not ev1["export_parity_max_err"] < 1e-4:
        fail(f"cnn export parity {ev1['export_parity_max_err']} >= 1e-4")
    kr = ev1.get("kernel_route") or {}
    if kr.get("path") != "fc" or kr.get("kernel") is not False \
            or not kr.get("max_err", 1.0) <= 1e-4:
        fail(f"cnn kernel_route {kr}: want the int8 fc off the int4 kernel "
             f"within 1e-4")
    ev_counts = first["per_stage"]["evaluate"]
    if ev_counts["quant_matmul_int8"] < 1 or ev_counts["quant_matmul"]:
        fail(f"cnn evaluate: the route check on the int8 fc launched the "
             f"int8 entry {ev_counts['quant_matmul_int8']} times and the "
             f"int4 kernel {ev_counts['quant_matmul']}")
    if second["skipped"] != ["calibrate", "init", "finetune"]:
        fail(f"cnn run 2 skipped {second['skipped']}")
    if ev2 != ev1:
        fail(f"cnn resumed evaluate {ev2} != first run's {ev1}")
    losses = [h["loss"] for h in first["history"]]
    if not all(map(math.isfinite, losses)):
        fail(f"cnn finetune losses {losses}")
    for run in (chw, pre):
        if not run["metrics"]["evaluate"]["export_parity_max_err"] < 1e-4:
            fail(f"cnn export parity {run['metrics']['evaluate']}")

    # --- one step, fake_quant vs the plain route, on one batch
    from repro_torch.pipeline.adapters import get_adapter
    result = first.pop("result")
    ad = get_adapter(pcfg)
    x = ad.x_calib[:64]
    grads = {}
    for use in (True, False):
        before = _counts()
        ad.pcfg = dataclasses.replace(pcfg, use_kernels=use)
        grads[use] = ad.loss_and_grads(dict(result.student), result.teacher,
                                       x)
        torch.cuda.synchronize()
        delta = [a - b for a, b in zip(_fq_counts(_counts()),
                                       _fq_counts(before))]
        if delta != ([n_w, n_w] if use else [0, 0]):
            fail(f"cnn step (use_kernels={use}) launched fake_quant {delta}")
    (lk, gk), (lp, gp) = grads[True], grads[False]
    loss_rel = abs(float(lk) - float(lp)) / abs(float(lp))
    plain = dict(tree_items(gp))
    worst, worst_at = 0.0, None
    for path, gr in tree_items(gk):
        ref = plain[path]
        if gr is None or ref is None:   # the fc: not in the loss
            if (gr is None) != (ref is None):
                fail(f"cnn gradient of {path}: one route has none")
            continue
        rel = float((gr - ref).norm()) / max(float(ref.norm()), 1e-30)
        if rel > worst:
            worst, worst_at = rel, ".".join(map(str, path))
    n_params = sum(t.numel() for _, t in tree_items(result.student))

    # --- a trace of 10 finetune steps as the stage runs them (batch 64,
    # the paper's Adam recipe), on a copy of the trained student
    from repro_torch.optim.adam import paper_recipe
    from repro_torch.tree import tree_map
    ad.pcfg = pcfg
    copy = tree_map(lambda t: t.detach().clone(), result.student)
    opt = paper_recipe(steps_per_epoch=max(steps // 3, 1),
                       base_lr=pcfg.base_lr)
    state = [opt.init(copy)]

    def finetune_steps():
        for _ in range(10):
            _, g = ad.loss_and_grads(copy, result.teacher, x)
            state[0] = opt.update(g, state[0], copy)[1]
    _profile(finetune_steps, "paper-cnn finetune steps (batch 64, Adam)", 10,
             watch=("fq_", "conv", "elementwise"))

    def secs(run):
        per = {k: v["s"] for k, v in run["per_stage"].items()}
        return (f"{run['wall']:.1f} s ({', '.join(f'{k} {v:.1f}' for k, v in per.items())}; "
                f"teacher + student init {run['wall'] - sum(per.values()):.1f})")
    say(f"[cnn] run 1: {secs(first)}; peak {first['peak']:.3f} GiB; "
        f"{n_params} student parameters; finetune loss "
        f"{', '.join(f'{h['step']}:{h['loss']:.6f}' for h in first['history'])}")
    say(f"[cnn] run 1 fake_quant launches (forward, backward): finetune "
        f"{_fq_counts(ft)} = {n_w} x {steps} steps each; evaluate "
        f"{_fq_counts(first['per_stage']['evaluate'])}; quant_matmul's int8 "
        f"entry (the route check on the fc) "
        f"{first['per_stage']['evaluate']['quant_matmul_int8']}")
    for tag, run in (("run 1 (QFT)", first), ("run 2 (resume)", second),
                     ("w4chw, no finetune", chw),
                     ("w4a8, no finetune (pre-QFT)", pre)):
        ev = run["metrics"]["evaluate"]
        say(f"[cnn] {tag}: acc teacher {ev['acc_teacher']:.4f} student "
            f"{ev['acc_student']:.4f} deployed {ev['acc_deployed']:.4f}; "
            f"export_parity_max_err {ev['export_parity_max_err']:.3e}; "
            f"artifact_bytes {ev['artifact_bytes']}; skipped "
            f"{run['skipped']}; {secs(run)}")
    say(f"[cnn] one step on 64 images, fake_quant vs the plain route: loss "
        f"{float(lk):.8f} vs {float(lp):.8f} (rel {loss_rel:.2e}); worst "
        f"gradient leaf {worst_at} rel L2 {worst:.2e}")
    if loss_rel > 1e-6:
        fail(f"cnn step loss fake_quant {float(lk)} vs plain {float(lp)}")
    if worst > 1e-4:
        fail(f"cnn gradient of {worst_at}: rel L2 {worst} > 1e-4")
    return first["counts"]


# ---------------------------------------------------------------------------
# phase 24: the serving launcher and the analyzer
# ---------------------------------------------------------------------------

def _launch(argv: list[str], engines: list) -> tuple[str, float]:
    """``python -m repro_torch.launch.serve`` in this process, its stdout
    captured and each engine it builds kept in ``engines`` (the launcher
    itself keeps none)."""
    import io
    from repro_torch.launch import serve
    from repro_torch.serve.engine import Engine
    orig = Engine.from_artifact.__func__

    def capture(cls, *args, **kwargs):
        engines.append(orig(cls, *args, **kwargs))
        return engines[-1]

    buf = io.StringIO()
    t0 = time.perf_counter()
    Engine.from_artifact = classmethod(capture)
    try:
        with contextlib.redirect_stdout(buf):
            rc = serve.main(argv)
    finally:
        Engine.from_artifact = classmethod(orig)
    wall = time.perf_counter() - t0
    out = buf.getvalue()
    if rc != 0:
        fail(f"launch.serve {' '.join(argv)} exited {rc}:\n{out[-2000:]}")
    return out, wall


def _req_tokens(out: str) -> list[list[int]]:
    import re
    return [[int(t) for t in m.group(1).split(",") if t.strip()]
            for m in re.finditer(r"^req\d+: \[([\d, ]*)\]$", out, re.M)]


def launch_path(cfg, smoke_cfg, full: bool = True) -> dict:
    """Phase 24: ``python -m repro_torch.launch.serve --arch qwen3-8b
    --full --use-kernels --show-plan`` at full width and depth (the
    pipeline's calibrate → init → export on the card, then the engine):
    every count at 0 just before it, quant_matmul launched by the route
    check, decode_attention's paged entry layers x decode steps; its
    tokens against the same artifact on the plain route under phase 5's
    near-tie rule.  Then a SMOKE ``--ckpt-dir`` restore from a SMOKE
    pipeline workdir (a few MB written), and ``python -m repro_torch check
    --config qwen3-8b`` with the card present, its kernel-route
    prediction (decode_attention nodes a decode step) held against the
    launches of one real SMOKE decode step at the analyzer's serving
    geometry.  Returns the full-size run's launch counts."""
    import tempfile
    import torch
    from repro_torch.analysis.graph_checks import ANALYZER_SCFG
    from repro_torch.pipeline import PipelineConfig, run_pipeline
    from repro_torch.serve.engine import (Engine, Request, ServeConfig,
                                          _attn_layer_count)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    engines: list = []
    _zero_counts()
    out, wall = _launch(["--arch", cfg.name, "--use-kernels", "--show-plan",
                         "--device", DEVICE] + (["--full"] if full else []),
                        engines)
    torch.cuda.synchronize()
    counts = _counts()
    engine = engines[-1]
    steps = engine.decode_steps
    layers = _attn_layer_count(engine.cfg)
    toks = _req_tokens(out)
    route = next((ln for ln in out.splitlines()
                  if ln.startswith("kernel route:")), "")
    if "'kernel': True" not in route:
        fail(f"launch.serve --use-kernels: the route check did not run "
             f"quant_matmul: {route}")
    if counts["quant_matmul"] < 1:
        fail(f"launch.serve: quant_matmul launched {counts['quant_matmul']}"
             f" times")
    if steps == 0 or counts["decode_attention_paged"] != layers * steps \
            or counts["decode_attention"] != layers * steps:
        fail(f"launch.serve: decode_attention launched "
             f"{counts['decode_attention']} times (paged "
             f"{counts['decode_attention_paged']}) over {steps} decode "
             f"steps of {layers} layers")
    if "# " not in out or "layers.mlp.down" not in out:
        fail("launch.serve --show-plan printed no plan table")
    if len(toks) != 2 or not all(len(t) == 8 and all(
            0 <= x < cfg.vocab for x in t) for t in toks):
        fail(f"launch.serve: bad tokens {toks}")
    peak = _gib()
    say(f"[launch] launch.serve --arch {cfg.name}"
        f"{' --full' if full else ''} --use-kernels --show-plan: "
        f"{wall:.1f} s, peak {peak:.2f} GiB; {route}; "
        f"tokens {toks}; {steps} decode steps; launches quant_matmul="
        f"{counts['quant_matmul']} decode_attention="
        f"{counts['decode_attention']} (paged "
        f"{counts['decode_attention_paged']} = {layers} x {steps})")

    # --- the same artifact on the plain route, under phase 5's rule
    plain = _engine_as(engine, engine.cfg, use_kernels=False)
    before = _counts()
    ptoks = plain.generate([Request(prompt=[1, 2, 3], max_new_tokens=8),
                            Request(prompt=[4, 5], max_new_tokens=8)])
    if _counts()["decode_attention"] != before["decode_attention"]:
        fail("the plain route launched decode_attention")
    for p, a, b in zip(([1, 2, 3], [4, 5]), toks, ptoks):
        if a != b:
            where = _first_split(engine.cfg, p,
                                 ("plain", plain, False, b),
                                 ("kernel", plain, True, a))
            say(f"[launch]   {a} vs {b}: the routes first split at {where}")
    same = sum(a == b for a, b in zip(toks, ptoks))
    say(f"[launch] plain route: {same}/2 requests token-identical")
    del plain, engine, engines[:]
    gc.collect()
    torch.cuda.empty_cache()

    # --- a SMOKE --ckpt-dir restore from a SMOKE pipeline workdir
    with tempfile.TemporaryDirectory(prefix="qft_launch_") as wd:
        run_pipeline(PipelineConfig(
            arch=smoke_cfg.name, smoke=True, steps=2, calib_samples=64,
            calib_seq_len=16, calib_batch_size=8, calib_batches=2,
            eval_batches=1, stop_after="finetune", workdir=wd,
            device=DEVICE))
        mb = sum(f.stat().st_size for f in Path(wd).rglob("*")
                 if f.is_file()) / 2**20
        sout, swall = _launch(["--arch", smoke_cfg.name, "--ckpt-dir", wd,
                               "--use-kernels", "--device", DEVICE], engines)
    if "restored trained student from" not in sout:
        fail(f"launch.serve --ckpt-dir restored nothing:\n{sout[-1500:]}")
    stoks = _req_tokens(sout)
    if len(stoks) != 2 or not all(len(t) == 8 for t in stoks):
        fail(f"launch.serve --ckpt-dir: bad tokens {stoks}")
    say(f"[launch] SMOKE --ckpt-dir restore ({mb:.2f} MB written): "
        f"{swall:.1f} s, tokens {stoks}")
    del engines[:]

    # --- the analyzer with the card present, against a real decode step
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="qft_check_") as td:
        rep_path = Path(td) / "report.json"
        chk = subprocess.run(
            [sys.executable, "-m", "repro_torch", "check", "--config",
             smoke_cfg.name, "--json", str(rep_path)], cwd=ROOT,
            env=dict(os.environ, PYTHONPATH=str(SRC)),
            capture_output=True, text=True, timeout=600)
        if chk.returncode != 0:
            fail(f"python -m repro_torch check exited {chk.returncode}:\n"
                 f"{chk.stdout[-2000:]}{chk.stderr[-2000:]}")
        report = json.loads(rep_path.read_text())
    check_s = time.perf_counter() - t0
    route_diag = next(d for d in report["diagnostics"]
                      if d["check"] == "trace.kernel-route")
    predicted = route_diag["value"]["decode_attention_nodes"]
    from repro_torch.models import init_model
    from repro_torch.core.qconfig import QuantConfig
    from repro_torch.serve.deploy import export_for_layers, make_deploy_plan
    qcfg = QuantConfig()
    params = init_model(0, smoke_cfg, qcfg, device=DEVICE)
    plan = make_deploy_plan(qcfg, arch=smoke_cfg.name,
                            family=smoke_cfg.family, params=params,
                            model_cfg=smoke_cfg)
    with torch.no_grad():
        ex = export_for_layers(params, plan, device=DEVICE)
    eng = Engine.from_artifact(smoke_cfg, plan, ex,
                               ServeConfig(**ANALYZER_SCFG), device=DEVICE)
    _zero_counts()
    eng.generate([Request(prompt=[1, 2, 3], max_new_tokens=4)])
    torch.cuda.synchronize()
    real = _counts()["decode_attention"] / max(eng.decode_steps, 1)
    if real != predicted or predicted != _attn_layer_count(smoke_cfg):
        fail(f"check predicts {predicted} decode_attention node(s) a decode "
             f"step; one real SMOKE step launched {real}")
    s = report["summary"]
    say(f"[launch] python -m repro_torch check --config {smoke_cfg.name} "
        f"(card present): exit 0 in {check_s:.1f} s, {s['errors']} errors, "
        f"{s['infos']} infos, {s['skips']} skips; kernel-route predicts "
        f"{predicted} decode_attention node(s) a decode step, a real SMOKE "
        f"decode step launched {real:g} ({eng.decode_steps} steps)")
    return {"quant_matmul": counts["quant_matmul"],
            "decode_attention": counts["decode_attention"],
            "decode_attention_paged": counts["decode_attention_paged"],
            "decode_steps": steps, "wall_s": wall, "peak_gib": peak,
            "check_s": check_s, "check_predicted": predicted,
            "check_real": real}


# ---------------------------------------------------------------------------
# phase 22: remat on the card
# ---------------------------------------------------------------------------

def _rel_l2(a, b) -> float:
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).norm()) / max(float(b.norm()), 1e-30)


def _grads_agree(ga, gb, what: str) -> tuple[float, str, bool]:
    """(worst leaf relative L2, its path, all leaves bit-equal) of two
    gradient (or parameter) trees, ``ga``'s leaves tensors or DTensors;
    fails where one has a leaf the other lacks."""
    from repro_torch.tree import tree_items
    other = dict(tree_items(gb))
    worst, at, equal = 0.0, "-", True
    for path, g in tree_items(ga):
        ref = other[path]
        if g is None or ref is None:
            if (g is None) != (ref is None):
                fail(f"{what}: gradient of {path}: one side has none")
            continue
        if hasattr(g, "full_tensor"):      # a DTensor: one leaf at a time
            g = g.full_tensor()
        ref = ref.to(g.device)
        equal = equal and torch_equal(g, ref)
        r = _rel_l2(g, ref)
        if r > worst:
            worst, at = r, ".".join(path)
    return worst, at, equal


def torch_equal(a, b) -> bool:
    import torch
    return bool(torch.equal(a, b))


def remat_routes(cfg) -> dict:
    """One microbatch's loss and gradients (a 4-row slice of phase 6's
    batch) of a full-width qwen3-8b student on ``TRAIN_LAYERS`` layers
    under the three remat policies: ``full`` and ``save_dots`` held to
    ``none`` (loss 1e-6 relative, each leaf 1e-5 relative L2); fake_quant's
    forward launches, ms and peak of each."""
    import torch
    from repro_torch.core.qconfig import QuantConfig
    from repro_torch.models import init_model
    from repro_torch.train.steps import make_value_and_grad
    from repro_torch.tree import tree_map
    c = dataclasses.replace(cfg, n_layers=TRAIN_LAYERS)
    qcfg = QuantConfig()
    torch.cuda.empty_cache()
    teacher = init_model(torch.Generator(device=DEVICE).manual_seed(0), c,
                         None, device=DEVICE)
    student = init_model(torch.Generator(device=DEVICE).manual_seed(1), c,
                         qcfg, device=DEVICE)
    rows = TRAIN_DATA["batch_size"] // TRAIN_MICROBATCHES
    tokens = torch.randint(0, c.vocab, (rows, TRAIN_DATA["seq_len"]),
                           generator=torch.Generator(device=DEVICE)
                           .manual_seed(2), device=DEVICE)
    batch = {"tokens": tokens}
    make_value_and_grad(c, qcfg)(student, teacher, batch)      # warm-up
    out, ref = {}, None
    for pol in ("none", "full", "save_dots"):
        vg = make_value_and_grad(dataclasses.replace(c, remat_policy=pol),
                                 qcfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = _counts()
        t0 = time.perf_counter()
        loss, grads = vg(student, teacher, batch)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        fq = _counts()["fake_quant_fwd"] - before["fake_quant_fwd"]
        rec = {"loss": float(loss), "ms": ms, "peak_gib": _gib(),
               "fake_quant_fwd": fq}
        if ref is None:             # kept on the host: the later peaks
            ref = (loss, tree_map(    # are the policies' own
                lambda g: None if g is None else g.cpu(), grads))
        else:
            loss_rel = abs(float(loss) - float(ref[0])) / abs(float(ref[0]))
            worst, at, equal = _grads_agree(grads, ref[1], f"remat {pol}")
            rec.update(loss_rel=loss_rel, worst_rel_l2=worst, worst_at=at,
                       bit_equal=equal and torch_equal(loss, ref[0]))
            if loss_rel > 1e-6 or worst > 1e-5:
                fail(f"remat {pol} vs none: loss rel {loss_rel}, gradient "
                     f"{at} rel L2 {worst}")
        del grads
        out[pol] = rec
        say(f"[remat] {c.name} full width, {c.n_layers} layers, one "
            f"microbatch of {rows} x {TRAIN_DATA['seq_len']}: policy {pol}: "
            f"loss {float(loss):.8f}, {ms:.1f} ms forward+backward, peak "
            f"{rec['peak_gib']:.2f} GiB, fake_quant forward launches {fq}"
            + ("" if pol == "none" else
               f"; vs none: loss rel {rec['loss_rel']:.2e}, worst leaf "
               f"{rec['worst_at']} rel L2 {rec['worst_rel_l2']:.2e}, "
               f"bit-equal {rec['bit_equal']}"))
    per_fwd = _fq_per_forward(c)
    if out["none"]["fake_quant_fwd"] != per_fwd or any(
            out[p]["fake_quant_fwd"] != 2 * per_fwd - 1
            for p in ("full", "save_dots")):
        fail(f"remat fake_quant forward launches "
             f"{[out[p]['fake_quant_fwd'] for p in out]}, want {per_fwd} "
             f"without remat and {2 * per_fwd - 1} with (each layer's "
             f"weights again, the embedding once)")
    del teacher, student
    torch.cuda.empty_cache()
    return out


def _train_at(cfg, layers: int, steps: int = 2) -> dict:
    """``steps`` QFT steps of phase 6's batch (16 x 512, 4 microbatches,
    the paper's Adam) on a full-width student of ``layers`` layers built
    from a seed (no calibration: the memory is the train step's)."""
    import torch
    from repro_torch.core.qconfig import QuantConfig
    from repro_torch.models import init_model
    from repro_torch.optim.adam import paper_recipe
    from repro_torch.train.steps import make_train_step
    c = dataclasses.replace(cfg, n_layers=layers)
    qcfg = QuantConfig()
    teacher = init_model(torch.Generator(device=DEVICE).manual_seed(0), c,
                         None, device=DEVICE)
    student = init_model(torch.Generator(device=DEVICE).manual_seed(1), c,
                         qcfg, device=DEVICE)
    opt = paper_recipe(16)
    opt_state = opt.init(student)
    step = make_train_step(c, qcfg, opt, microbatches=TRAIN_MICROBATCHES)
    g = torch.Generator(device=DEVICE).manual_seed(3)
    ms, losses = [], []
    for _ in range(steps):
        batch = {"tokens": torch.randint(
            0, c.vocab, (TRAIN_DATA["batch_size"], TRAIN_DATA["seq_len"]),
            generator=g, device=DEVICE)}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        student, opt_state, m = step(student, opt_state, teacher, batch)
        losses.append(float(m["loss"]))
        ms.append(1e3 * (time.perf_counter() - t0))
    return {"layers": layers, "ms": ms, "losses": losses, "peak_gib": _gib()}


def remat_depth(cfg, depths=REMAT_DEPTHS) -> dict:
    """The deepest full-width qwen3-8b student that trains on the card
    under remat ``full``: each depth of ``depths`` (deepest first) is tried
    with two steps until one fits; a depth that runs out of memory is
    reported and the next tried."""
    import torch
    tried = []
    for L in depths:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        try:
            rec = _train_at(cfg, L)
        except torch.cuda.OutOfMemoryError:
            tried.append(L)
            say(f"[remat] {cfg.name} full width, {L} of {cfg.n_layers} "
                f"layers, remat {cfg.remat_policy}: out of memory in the "
                f"first steps (peak {_gib():.2f} GiB when it ran out)")
            rec = None
        gc.collect()
        torch.cuda.empty_cache()
        if rec is None:
            continue
        if not all(map(math.isfinite, rec["losses"])):
            fail(f"remat depth {L}: losses {rec['losses']}")
        say(f"[remat] {cfg.name} full width, {L} of {cfg.n_layers} layers "
            f"fit with remat {cfg.remat_policy} (batch "
            f"{TRAIN_DATA['batch_size']} x {TRAIN_DATA['seq_len']} in "
            f"{TRAIN_MICROBATCHES} microbatches): peak "
            f"{rec['peak_gib']:.2f} GiB, ms/step "
            f"{', '.join(f'{x:.1f}' for x in rec['ms'])}, loss "
            f"{', '.join(f'{x:.6f}' for x in rec['losses'])}; deeper "
            f"tried: {tried or 'none'}")
        return dict(rec, out_of_memory_at=tried)
    fail(f"no depth of {depths} trains on the card")


# ---------------------------------------------------------------------------
# phase 23: the sharded path at world size 1
# ---------------------------------------------------------------------------

def _free_port() -> int:
    import socket
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _rel(a, b) -> float:
    """|a - b| / |b| of two scalars (floats or 0-dim tensors)."""
    a, b = float(a), float(b)
    return abs(a - b) / max(abs(b), 1e-30)


def _host_copy(tree):
    """A host copy of a tree's tensors."""
    from repro_torch.tree import tree_from_items, tree_items
    return tree_from_items((p, t.detach().to("cpu", copy=True))
                           for p, t in tree_items(tree))


def sharded_path(cfg, moe_cfg, smoke_cfg) -> dict:
    """One NCCL rank on a localhost store, ``make_elastic_mesh(1, 1)``:
    the launcher's ``build_step`` on a full-width qwen3-8b student of 2
    layers against the QFTTrainer's step (loss 1e-6 relative, the
    gradient's norm 1e-5, updated parameters 1e-5 relative L2), a step
    with the int8 error-feedback compressor against the unsharded step
    with the same hook (the same bounds, and its residual's norm 1e-5),
    ``make_ep_moe`` at tp 1 on a
    2-layer qwen2-moe against the in-graph MoE, and the elastic runner
    with an injected failure restoring a real checkpoint (SMOKE width, so
    its writes stay small) against the run without the failure."""
    import tempfile
    import torch
    import torch.distributed as dist
    from repro_torch.core.qconfig import QuantConfig
    from repro_torch.data.calib import CalibConfig, CalibDataset
    from repro_torch.launch import train as lt
    from repro_torch.launch.mesh import make_elastic_mesh
    from repro_torch.models import init_model
    from repro_torch.models.transformer import set_runtime
    from repro_torch.pipeline.adapters import resolve_quant_plan
    from repro_torch.sharding.ep import make_ep_moe
    from repro_torch.sharding.partition import ShardingPolicy
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.compression import error_feedback_hook
    from repro_torch.train.elastic import ElasticConfig, ElasticRunner
    from repro_torch.train.qft_trainer import QFTConfig, QFTTrainer
    from repro_torch.train.steps import make_train_step, make_value_and_grad
    from repro_torch.tree import tree_from_items, tree_items
    dist.init_process_group("nccl" if DEVICE == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0)
    out = {}
    try:
        mesh = make_elastic_mesh(1, 1, DEVICE)
        pol = ShardingPolicy()
        qcfg = QuantConfig()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

        # the references first, each step's updated student kept on the
        # host: the QFTTrainer's step, then the unsharded step with the
        # int8 error-feedback hook; then the sharded path from the same
        # student on the same two batches (one path on the card at a time)
        c = dataclasses.replace(cfg, n_layers=SHARDED_LAYERS)
        teacher = init_model(torch.Generator(device=DEVICE).manual_seed(0),
                             c, None, device=DEVICE)
        tokens = CalibDataset(CalibConfig(vocab=c.vocab, **TRAIN_DATA))
        qplan = resolve_quant_plan(c, qcfg)
        trainer = QFTTrainer(c, qcfg, teacher, QFTConfig(),
                             steps_per_epoch=tokens.steps_per_epoch,
                             microbatches=TRAIN_MICROBATCHES, plan=qplan)
        student = trainer.prepare_student(1, [next(tokens)])
        batch, batch2 = next(tokens), next(tokens)
        start = _host_copy(student)

        def on_card(b):
            return {"tokens": torch.as_tensor(b["tokens"]).to(DEVICE)}
        opt_state = trainer.opt.init(student)
        student, opt_state, tm = trainer.train_step(student, opt_state,
                                                    teacher, on_card(batch))
        ref1 = _host_copy(student)
        p_hook = error_feedback_hook(student)
        p_step = make_train_step(c, qcfg, trainer.opt, grad_compress=p_hook,
                                 microbatches=TRAIN_MICROBATCHES, plan=qplan)
        student, opt_state, pm = p_step(student, opt_state, teacher,
                                        on_card(batch2))
        ref2 = _host_copy(student)
        p_ef = float(sum(float(e.float().norm()) ** 2
                         for _, e in tree_items(p_hook.state["ef"]))) ** 0.5
        del student, opt_state, p_hook, p_step
        torch.cuda.empty_cache()

        # --- build_step vs the QFTTrainer's step
        state = lt.init_sharded_state(
            tree_from_items((p, t.to(DEVICE)) for p, t in tree_items(start)),
            trainer.opt, c, mesh, pol)
        del start
        step = lt.build_step(mesh, c, qcfg, trainer.opt, teacher, pol,
                             plan=qplan, microbatches=TRAIN_MICROBATCHES)
        _zero_counts()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        s_ms = 1e3 * (time.perf_counter() - t0)
        counts = _counts()
        placed = {str(t.placements) for _, t in tree_items(state[0])}
        if counts["fake_quant_fwd"] == 0 or counts["flash_attention"] == 0:
            fail(f"the sharded step launched no fake_quant or "
                 f"flash_attention: {counts}")
        loss_rel = abs(float(m["loss"]) - float(tm["loss"])) / float(
            tm["loss"])
        # Adam's update hardly moves under a uniform scaling of the
        # gradient; the gradient's norm shows one
        gn_rel = _rel(m["grad_norm"], tm["grad_norm"])
        worst, at, equal = _grads_agree(state[0], ref1,
                                        "sharded step vs trainer")
        out["step"] = {"loss": float(m["loss"]),
                       "trainer_loss": float(tm["loss"]),
                       "loss_rel": loss_rel, "ms": s_ms,
                       "grad_norm_rel": gn_rel,
                       "params_worst_rel_l2": worst,
                       "params_bit_equal": equal,
                       "fake_quant_fwd": counts["fake_quant_fwd"],
                       "flash_attention": counts["flash_attention"]}
        say(f"[sharded] {c.name} full width, {c.n_layers} layers, mesh "
            f"(data 1, model 1), placements {sorted(placed)}: build_step "
            f"loss {float(m['loss']):.8f} vs the QFTTrainer step "
            f"{float(tm['loss']):.8f} (rel {loss_rel:.2e}); grad_norm rel "
            f"{gn_rel:.2e}; updated parameters: worst {at} rel L2 "
            f"{worst:.2e}, bit-equal {equal}; "
            f"{s_ms:.1f} ms (its first step, after the references'); "
            f"launches fake_quant {counts['fake_quant_fwd']} + "
            f"{counts['fake_quant_bwd']}, flash_attention "
            f"{counts['flash_attention']}")
        if loss_rel > 1e-6 or gn_rel > 1e-5 or worst > 1e-5:
            fail(f"sharded step vs trainer: loss {float(m['loss'])} vs "
                 f"{float(tm['loss'])}, grad_norm rel {gn_rel}, updated "
                 f"{at} rel L2 {worst}")
        # --- one more step with the int8 error-feedback compressor, held
        # against the unsharded step with the same hook
        hook = error_feedback_hook(state[0])
        step = lt.build_step(mesh, c, qcfg, trainer.opt, teacher, pol,
                             plan=qplan, microbatches=TRAIN_MICROBATCHES,
                             grad_compress=hook)
        state, m = step(state, batch2)
        ef = float(sum(float(e.full_tensor().float().norm()) ** 2
                       for _, e in tree_items(hook.state["ef"]))) ** 0.5
        loss_rel = abs(float(m["loss"]) - float(pm["loss"])) / float(
            pm["loss"])
        gn_rel = _rel(m["grad_norm"], pm["grad_norm"])
        ef_rel = _rel(ef, p_ef)
        worst, at, equal = _grads_agree(state[0], ref2,
                                        "compressed sharded vs unsharded")
        say(f"[sharded] a step with grad_compress (int8, error feedback): "
            f"loss {float(m['loss']):.8f} vs the unsharded step with the "
            f"same hook {float(pm['loss']):.8f} (rel {loss_rel:.2e}); "
            f"grad_norm rel {gn_rel:.2e}, residual norm rel {ef_rel:.2e}; "
            f"updated parameters: worst {at} rel L2 {worst:.2e}, bit-equal "
            f"{equal}; grad_norm {float(m['grad_norm']):.6f}, the residual "
            f"buffer's norm {ef:.3e} (unsharded {p_ef:.3e}); peak "
            f"{_gib():.2f} GiB")
        if not (math.isfinite(float(m["loss"])) and ef > 0):
            fail(f"compressed step: loss {float(m['loss'])}, residual {ef}")
        if loss_rel > 1e-6 or max(gn_rel, ef_rel, worst) > 1e-5:
            fail(f"compressed sharded step vs unsharded: loss rel "
                 f"{loss_rel}, grad_norm rel {gn_rel}, residual norm rel "
                 f"{ef_rel}, updated {at} rel L2 {worst}")
        out["compressed"] = {"loss": float(m["loss"]),
                             "unsharded_loss": float(pm["loss"]),
                             "loss_rel": loss_rel, "grad_norm_rel": gn_rel,
                             "ef_norm_rel": ef_rel,
                             "params_worst_rel_l2": worst,
                             "params_bit_equal": equal, "ef_norm": ef,
                             "unsharded_ef_norm": p_ef}
        del state, step, trainer, teacher, hook, ref1, ref2
        torch.cuda.empty_cache()

        # --- make_ep_moe at tp 1 vs the in-graph MoE
        mc = dataclasses.replace(moe_cfg, n_layers=SHARDED_LAYERS)
        teacher = init_model(torch.Generator(device=DEVICE).manual_seed(0),
                             mc, None, device=DEVICE)
        student = init_model(torch.Generator(device=DEVICE).manual_seed(1),
                             mc, qcfg, device=DEVICE)
        mplan = resolve_quant_plan(mc, qcfg)
        rows = TRAIN_DATA["batch_size"] // TRAIN_MICROBATCHES
        mb = {"tokens": torch.randint(
            0, mc.vocab, (rows, TRAIN_DATA["seq_len"]),
            generator=torch.Generator(device=DEVICE).manual_seed(4),
            device=DEVICE)}
        vg = make_value_and_grad(mc, qcfg, plan=mplan)
        base = vg(student, teacher, mb)
        set_runtime(moe_fn=make_ep_moe(mesh, mc, qcfg, plan=mplan))
        try:
            ep = vg(student, teacher, mb)
        finally:
            set_runtime(moe_fn=None)
        loss_rel = abs(float(ep[0]) - float(base[0])) / float(base[0])
        worst, at, equal = _grads_agree(ep[1], base[1], "EP vs in-graph")
        out["ep"] = {"loss_rel": loss_rel, "worst_rel_l2": worst,
                     "bit_equal": equal and torch_equal(ep[0], base[0])}
        say(f"[sharded] make_ep_moe at tp 1, {mc.name} full width, "
            f"{mc.n_layers} layers, one microbatch: loss {float(ep[0]):.8f} "
            f"vs the in-graph MoE {float(base[0]):.8f} (rel "
            f"{loss_rel:.2e}); gradients worst {at} rel L2 {worst:.2e}; "
            f"bit-equal {out['ep']['bit_equal']}")
        if loss_rel > 1e-6 or worst > 1e-5:
            fail(f"EP at tp 1 vs the in-graph MoE: loss rel {loss_rel}, "
                 f"{at} rel L2 {worst}")
        del teacher, student, base, ep, vg
        torch.cuda.empty_cache()

        # --- the elastic runner: a failure at step 3 restores step 2
        out["elastic"] = _elastic_on_card(smoke_cfg, mesh, pol)
    finally:
        dist.destroy_process_group()
    return out


def _elastic_on_card(cfg, mesh, pol) -> dict:
    import tempfile
    import torch
    from repro_torch.core.qconfig import QuantConfig
    from repro_torch.data.calib import CalibConfig, CalibDataset
    from repro_torch.launch import train as lt
    from repro_torch.models import init_model
    from repro_torch.pipeline.adapters import resolve_quant_plan
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.elastic import ElasticConfig, ElasticRunner
    from repro_torch.train.qft_trainer import QFTConfig, QFTTrainer
    from repro_torch.tree import tree_items
    qcfg = QuantConfig()
    written = [0]
    write = CheckpointManager._write

    def counted(self, step, host_state):
        write(self, step, host_state)
        written[0] += sum(f.stat().st_size for f in
                          (self.dir / f"step_{step:010d}").rglob("*"))

    def run(workdir, inject):
        teacher = init_model(0, cfg, None, device=DEVICE)
        data = CalibDataset(CalibConfig(n_samples=64, seq_len=64,
                                        batch_size=8, vocab=cfg.vocab))
        plan = resolve_quant_plan(cfg, qcfg)
        tr = QFTTrainer(cfg, qcfg, teacher, QFTConfig(), steps_per_epoch=8,
                        plan=plan)
        student = tr.prepare_student(1, [next(data)])
        data.skip_to(0)
        state = lt.init_sharded_state(student, tr.opt, cfg, mesh, pol)
        runner = ElasticRunner(
            lambda m: lt.build_step(m, cfg, qcfg, tr.opt, teacher, pol,
                                    plan=plan, microbatches=2),
            CheckpointManager(workdir, keep=3),
            ElasticConfig(checkpoint_every=ELASTIC_CKPT_EVERY,
                          model_parallel=1), device_type=DEVICE)
        state, s = runner.run(state, data, steps=ELASTIC_STEPS,
                              inject_failure_at=inject)
        if s != ELASTIC_STEPS or runner.restarts != (inject is not None):
            fail(f"elastic run: {s} steps, {runner.restarts} restarts, "
                 f"events {runner.events}")
        return state, runner

    CheckpointManager._write = counted
    try:
        with tempfile.TemporaryDirectory(prefix="qft_elastic_") as d:
            a, _ = run(f"{d}/a", None)
            b, runner = run(f"{d}/b", ELASTIC_FAIL_AT)
    finally:
        CheckpointManager._write = write
    full = [(p, t.full_tensor() if hasattr(t, "full_tensor") else t)
            for p, t in tree_items(a)]
    other = dict((p, t.full_tensor() if hasattr(t, "full_tensor") else t)
                 for p, t in tree_items(b))
    worst = max(_rel_l2(t, other[p]) for p, t in full
                if t.is_floating_point())
    equal = all(torch.equal(t, other[p]) for p, t in full)
    say(f"[elastic] {cfg.name} (SMOKE width), {ELASTIC_STEPS} steps, a "
        f"checkpoint every {ELASTIC_CKPT_EVERY}: {runner.restarts} restart "
        f"({runner.events}), the checkpoint of step "
        f"{ELASTIC_FAIL_AT - ELASTIC_FAIL_AT % ELASTIC_CKPT_EVERY} restored "
        f"and the data skipped to it; the final state against the run "
        f"without the failure: worst leaf rel L2 {worst:.2e}, bit-equal "
        f"{equal}; checkpoint bytes written {written[0]} (both runs)")
    if worst > 1e-5:
        fail(f"elastic restore: final state rel L2 {worst} from the run "
             f"without the failure")
    return {"restarts": runner.restarts, "worst_rel_l2": worst,
            "bit_equal": equal, "bytes_written": written[0]}


def _threaded_ranks(world: int, fn, timeout_s: float = 600.0) -> list:
    """``fn(rank)`` on ``world`` threads of this process, each a rank of
    torch's threaded process group (NCCL refuses two ranks on one card,
    and gloo has no all-gather or reduce-scatter for CUDA tensors).  Each
    thread runs its backward itself (``set_multithreading_enabled(False)``):
    on the autograd engine's one device thread one rank's all-reduce in a
    backward would wait for a rank queued behind it.  Returns the ranks'
    results; a rank that raises wakes the others and fails the phase."""
    import threading
    import torch
    import torch.distributed as dist
    from torch.testing._internal.distributed import multi_threaded_pg
    from torch.testing._internal.distributed.multi_threaded_pg import (
        ProcessLocalGroup, _install_threaded_pg)
    if not hasattr(multi_threaded_pg.ThreadLocalWorld, "comms"):
        # torch 2.11's c10d keeps a world's communicators in ``comms``; its
        # thread-local world has none
        def comms(self):
            world = self._get_world()
            if not hasattr(world, "comms"):
                world.comms = []
            return world.comms
        multi_threaded_pg.ThreadLocalWorld.comms = property(comms)
    torch._C._distributed_c10d._set_thread_isolation_mode(True)
    _install_threaded_pg()
    ProcessLocalGroup.reset()
    out, errors = [None] * world, []
    store = dist.HashStore()

    def run(rank):
        try:
            dist.init_process_group("threaded", rank=rank, world_size=world,
                                    store=store)
            try:
                with torch.autograd.set_multithreading_enabled(False):
                    out[rank] = fn(rank)
            finally:
                dist.destroy_process_group()
        except BaseException as e:      # noqa: BLE001 — reported below
            errors.append((rank, e))
            ProcessLocalGroup.exception_handle(e)

    threads = [threading.Thread(target=run, args=(r,), daemon=True)
               for r in range(world)]
    for t in threads:
        t.start()
    deadline = time.perf_counter() + timeout_s
    for t in threads:
        t.join(max(deadline - time.perf_counter(), 0.0))
    if any(t.is_alive() for t in threads):
        fail(f"{world} threaded ranks did not finish in {timeout_s:.0f} s")
    if errors:
        rank, e = errors[0]
        fail(f"threaded rank {rank} of {world}: {type(e).__name__}: {e}")
    return out


@contextlib.contextmanager
def _per_rank_launches(record: dict):
    """Record each rank's fake_quant forward and flash_attention calls
    (the kernels' wrappers, called as the model code calls them: K3's
    factored entry by its weight's 2-D view, the broadcast entry for the
    embedding) with their shapes: ``record[rank] = {"fake_quant": [...],
    "flash_attention": [...]}``.  The wrappers count as they always do."""
    import torch.distributed as dist
    from repro_torch.core import dof
    from repro_torch.models import attention as attn_mod
    fq, ff, fa = (dof.fake_quant_kernel, dof.fake_quant_factored,
                  attn_mod.attention_prefill)

    def mine():
        return record.setdefault(dist.get_rank(), {"fake_quant": [],
                                                   "flash_attention": []})

    def fq_rec(x, s, bits, rule="kernel"):
        mine()["fake_quant"].append(tuple(x.shape))
        return fq(x, s, bits, rule=rule)

    def ff_rec(w, s_wl, s_wr, bits=4, out_dtype=None):
        mine()["fake_quant"].append((w.numel() // w.shape[-1],
                                     w.shape[-1]))
        return ff(w, s_wl, s_wr, bits, out_dtype)

    def fa_rec(q, k, v, causal=True):
        mine()["flash_attention"].append((tuple(q.shape), tuple(k.shape)))
        return fa(q, k, v, causal=causal)

    dof.fake_quant_kernel, dof.fake_quant_factored = fq_rec, ff_rec
    attn_mod.attention_prefill = fa_rec
    try:
        yield record
    finally:
        dof.fake_quant_kernel, dof.fake_quant_factored = fq, ff
        attn_mod.attention_prefill = fa


def _grad_distances(got: dict, f32: dict, bf16: dict) -> tuple:
    """(worst ratio, its leaf, {leaf: (|got - f32|, |bf16 - f32|)}) over
    the gradient leaves of three host trees ``{path: tensor or None}``:
    the ratio of a leaf is its distance from the f32 gradient over the
    unsharded bf16 gradient's."""
    import torch
    worst, at, dist_ = 0.0, "-", {}
    for k, ref in f32.items():
        if ref is None:
            if got[k] is not None:
                fail(f"tp: {k} has a gradient the unsharded step has not")
            continue
        d_tp = float((got[k] - ref).norm())
        d_16 = float((bf16[k] - ref).norm())
        dist_[k] = (d_tp, d_16)
        ratio = d_tp / d_16 if d_16 > 0 else (0.0 if d_tp == 0
                                             else math.inf)
        if not torch.isfinite(got[k]).all():
            fail(f"tp: {k}'s gradient is not finite")
        if ratio > worst:
            worst, at = ratio, k
    return worst, at, dist_


def tp_path(cfg) -> dict:
    """Tensor parallelism over ``model`` (``sharding.tp``) at tp 2 and 4
    on the one card, the ranks threads of this process on a (data 1,
    model tp) mesh: the launcher's ``build_step`` on a full-width
    qwen3-8b student of ``TP_LAYERS`` layers, phase 6's batch in 4
    microbatches, its loss and every gradient leaf (captured on their way
    to the update) against the unsharded step the QFTTrainer runs
    (``make_value_and_grad`` with its arguments) in bf16 and in f32: the
    step's distance from the f32 step at most twice the bf16 step's, for
    the loss and each leaf.  Each rank must launch fake_quant and
    flash_attention on its own shards (printed with their shapes).  Threads
    share the GIL: no time here is a tensor-parallel speed."""
    import torch
    from repro_torch.core.qconfig import QuantConfig
    from repro_torch.data.calib import CalibConfig, CalibDataset
    from repro_torch.launch import train as lt
    from repro_torch.launch.mesh import make_elastic_mesh
    from repro_torch.models import init_model
    from repro_torch.pipeline.adapters import resolve_quant_plan
    from repro_torch.sharding.partition import ShardingPolicy
    from repro_torch.train.qft_trainer import QFTConfig, QFTTrainer
    from repro_torch.train.steps import make_value_and_grad
    from repro_torch.tree import tree_from_items, tree_items
    qcfg = QuantConfig()
    pol = ShardingPolicy()
    c = dataclasses.replace(cfg, n_layers=TP_LAYERS)
    teacher = init_model(torch.Generator(device=DEVICE).manual_seed(0), c,
                         None, device=DEVICE)
    tokens = CalibDataset(CalibConfig(vocab=c.vocab, **TRAIN_DATA))
    qplan = resolve_quant_plan(c, qcfg)
    trainer = QFTTrainer(c, qcfg, teacher, QFTConfig(),
                         steps_per_epoch=tokens.steps_per_epoch,
                         microbatches=TRAIN_MICROBATCHES, plan=qplan)
    student = _host_copy(trainer.prepare_student(1, [next(tokens)]))
    batch = {"tokens": torch.as_tensor(next(tokens)["tokens"]).to(DEVICE)}
    torch.cuda.empty_cache()

    def host_grads(grads) -> dict:
        return {".".join(p): None if g is None
                else g.detach().float().to("cpu", copy=True)
                for p, g in tree_items(grads)}

    # the unsharded references, the QFTTrainer's step's arguments
    ref = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        s = tree_from_items((p, t.to(DEVICE)) for p, t in tree_items(
            student))
        vg = make_value_and_grad(c, qcfg, microbatches=TRAIN_MICROBATCHES,
                                 plan=qplan, compute_dtype=dtype)
        loss, grads = vg(s, teacher, batch)
        ref[name] = {"loss": float(loss), "grads": host_grads(grads)}
        del s, grads, vg
        torch.cuda.empty_cache()
    opt = trainer.opt
    del trainer
    out = {}
    for tp in TP_SIZES:
        shared = {"student": tree_from_items(
            (p, t.to(DEVICE)) for p, t in tree_items(student))}
        shared["opt"] = opt.init(shared["student"])
        record: dict = {}
        import threading
        placed = threading.Barrier(tp)

        def rank_fn(rank):
            mesh = make_elastic_mesh(tp, tp, DEVICE)
            state = lt.place_state((shared["student"], shared["opt"]), c,
                                   mesh, pol)
            seen = {}

            def capture(g, opt_state):
                host = {}
                for p, t in tree_items(g):     # full_tensor: every rank
                    full = None if t is None else t.full_tensor()
                    if rank == 0:
                        host[".".join(p)] = None if full is None else \
                            full.detach().float().to("cpu", copy=True)
                    del full
                seen["grads"] = host
                return g, opt_state

            step = lt.build_step(mesh, c, qcfg, opt, teacher, pol,
                                 plan=qplan, microbatches=TRAIN_MICROBATCHES,
                                 grad_compress=capture)
            if placed.wait() == 0:              # the whole copies go
                shared.clear()
            placed.wait()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            return {"loss": float(m["loss"]), "ms": 1e3 * (
                time.perf_counter() - t0),
                "grads": seen["grads"] if rank == 0 else None,
                "gnorm": float(m["grad_norm"])}

        _zero_counts()
        torch.cuda.reset_peak_memory_stats()
        with _per_rank_launches(record):
            res = _threaded_ranks(tp, rank_fn)
        counts = _counts()
        torch.cuda.empty_cache()
        got = res[0]
        losses = {r["loss"] for r in res}
        if len(losses) != 1:
            fail(f"tp {tp}: the ranks' losses differ: {losses}")
        d_tp = abs(got["loss"] - ref["f32"]["loss"])
        d_16 = abs(ref["bf16"]["loss"] - ref["f32"]["loss"])
        worst, at, _ = _grad_distances(got["grads"], ref["f32"]["grads"],
                                       ref["bf16"]["grads"])
        per_rank = {r: {k: len(v) for k, v in rec.items()}
                    for r, rec in sorted(record.items())}
        say(f"[tp] {c.name} full width, {c.n_layers} layers, mesh (data 1, "
            f"model {tp}), ranks as threads: build_step loss "
            f"{got['loss']:.8f}; the unsharded step f32 "
            f"{ref['f32']['loss']:.8f}, bf16 {ref['bf16']['loss']:.8f}; "
            f"|tp - f32| {d_tp:.3e} against |bf16 - f32| {d_16:.3e} "
            f"({d_tp / max(d_16, 1e-30):.2f}x); gradients: worst leaf {at} "
            f"at {worst:.2f}x the bf16 step's distance; peak "
            f"{_gib():.2f} GiB; rank 0's step {got['ms']:.1f} ms (threads "
            f"share the GIL: not a speed)")
        for r, rec in sorted(record.items()):
            say(f"[tp]   rank {r}: fake_quant {len(rec['fake_quant'])} "
                f"launches at {sorted(set(rec['fake_quant']))}; "
                f"flash_attention {len(rec['flash_attention'])} at "
                f"{sorted(set(rec['flash_attention']))}")
        if set(record) != set(range(tp)) or not all(
                v["fake_quant"] and v["flash_attention"]
                for v in per_rank.values()):
            fail(f"tp {tp}: a rank launched no fake_quant or "
                 f"flash_attention: {per_rank}")
        want_fq = sum(v["fake_quant"] for v in per_rank.values())
        want_fa = sum(v["flash_attention"] for v in per_rank.values())
        if (counts["fake_quant_fwd"], counts["flash_attention"]) != (
                want_fq, want_fa):
            fail(f"tp {tp}: the wrappers counted fake_quant "
                 f"{counts['fake_quant_fwd']}, flash_attention "
                 f"{counts['flash_attention']}; the ranks called them "
                 f"{want_fq}, {want_fa}")
        if d_tp > 2 * d_16 or worst > 2.0:
            fail(f"tp {tp}: loss |tp - f32| {d_tp} > 2 x {d_16}, or "
                 f"{at}'s gradient {worst:.2f}x the bf16 step's distance")
        out[f"tp{tp}"] = {
            "loss": got["loss"], "f32_loss": ref["f32"]["loss"],
            "bf16_loss": ref["bf16"]["loss"],
            "loss_distance_ratio": d_tp / max(d_16, 1e-30),
            "worst_grad_ratio": worst, "worst_leaf": at,
            "launches_per_rank": per_rank,
            "shapes_rank0": {k: sorted(set(v)) for k, v in
                             record[0].items()},
            "peak_gib": _gib()}
        del res, got, record
        torch.cuda.empty_cache()
    return out


def _k2_rank_row(rows: int, Hkv: int, G: int, hd: int, T: int,
                 lengths) -> dict:
    """K2's slot-view entry at a tensor-parallel rank's shard of the cache
    (``rows`` x ``T``, its ``Hkv`` KV heads, bf16) against its plain
    version: error, events and profiler time, the plain version's, SDPA's
    and the bound (each K/V row up to its length read once)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.ref import decode_attention_ref
    g = torch.Generator(device=DEVICE).manual_seed(26)
    q = torch.randn((rows, Hkv, G, hd), generator=g,
                    device=DEVICE).bfloat16()
    k = torch.randn((rows, T, Hkv, hd), generator=g,
                    device=DEVICE).bfloat16()
    v = torch.randn((rows, T, Hkv, hd), generator=g,
                    device=DEVICE).bfloat16()
    lens = torch.as_tensor(lengths, dtype=torch.int32, device=DEVICE)
    out = decode_attention(q, k, v, lens)
    ref = decode_attention_ref(q, k, v, lens)
    err = float((out.float() - ref.float()).abs().max())
    tol = 1e-2 * float(ref.float().abs().max())
    if not math.isfinite(err) or err > tol:
        fail(f"decode_attention tp shard Hkv {Hkv}: max_abs_err {err} > "
             f"{tol}")
    mask = (torch.arange(T, device=DEVICE)[None, :]
            < lens[:, None])[:, None, None, :]
    qh = q.reshape(rows, Hkv * G, 1, hd)
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    ms = time_ms(lambda: decode_attention(q, k, v, lens))
    dev_ms = device_ms(lambda: decode_attention(q, k, v, lens),
                       ("fd_split", "fd_combine"))
    plain_ms = time_ms(lambda: decode_attention_ref(q, k, v, lens), iters=5)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qh, kt, vt, attn_mask=mask, enable_gqa=G > 1))
    live = int(lens.clamp(max=T).sum())
    b_ms, b_by = bound(2 * live * Hkv * hd * 2 + 2 * q.numel() * 2
                       + rows * 4, 4 * live * Hkv * G * hd, "bf16")
    dev_txt = "not measured" if dev_ms is None else f"{dev_ms:.4f}"
    say(f"[kernel] decode_attention tp shard S={rows} Hkv={Hkv} G={G} "
        f"hd={hd} T={T} max_abs_err={err:.3e} (tol {tol:.3e}) "
        f"ms={ms:.4f} device_ms={dev_txt} plain_ms={plain_ms:.4f} "
        f"library_ms={lib_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) [{CARD}]")
    return {"max_abs_err": err, "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms,
            "bound_by": b_by}


@contextlib.contextmanager
def _per_rank_decode(record: dict):
    """Record each rank's decode_attention calls (the model code's, on
    the slot view) with the shapes of its q and its cache shard:
    ``record[rank] = [(q shape, k shape), ...]``.  The wrapper counts as
    it always does."""
    import torch.distributed as dist
    from repro_torch.models import attention as attn_mod
    fd = attn_mod.decode_attention

    def rec(q, k, v, lengths, *a):
        record.setdefault(dist.get_rank(), []).append(
            (tuple(q.shape), tuple(k.shape)))
        return fd(q, k, v, lengths, *a)

    attn_mod.decode_attention = rec
    try:
        yield record
    finally:
        attn_mod.decode_attention = fd


@contextlib.contextmanager
def _routing_by_rank(replay: list, free: list):
    """Within the block, each thread's MoE routing calls
    (``models.moe.top_k``) take the recorded expert indices ``replay`` in
    order, each rank (thread) its own pass over them; rank 0 appends to
    ``free`` how many of the call's tokens would have chosen another
    expert set from this run's probabilities."""
    import torch
    import torch.distributed as dist
    from repro_torch.models import moe
    top_k = moe.top_k
    passes: dict = {}

    def routed(probs, k):
        rank = dist.get_rank()
        i = next(passes.setdefault(rank, iter(replay)))
        if rank == 0:
            mine = top_k(probs, k)[1]
            free.append(int((torch.sort(mine, -1).values
                             != torch.sort(i, -1).values).any(-1).sum()))
        return probs.gather(-1, i), i
    moe.top_k = routed
    try:
        yield
    finally:
        moe.top_k = top_k


def _tp_serve(c, layouts, seed: int, tag: str) -> dict:
    """The forward with a cache on the rank's shards (``sharding.tp``'s
    deployed views, ``models.attention``'s split caches, ``models.moe``'s
    partial combine), the ranks threads of this process on (data 1, model
    tp) meshes as in phase 25.  A 2-layer full-width ``c`` student's
    exported artifact is stored as ``params_shardings`` places it;
    ``TP_SERVE``'s rows are prefilled at scalar pos
    (``make_prefill_step``), then decoded at per-slot pos through
    ``forward`` on the kernel route, fed the tokens the f32 unsharded
    steps choose greedily.  The unsharded f32 and bf16 steps take the
    plain route on the artifact itself, each layer dequantized in its
    body.  For each ``(tp, kv, absorb)`` of ``layouts`` the monolithic
    bf16 cache is placed as ``cache_shardings`` places it, with ``model``
    dropped where ``kv`` is None, and ``c.mla_absorb`` is ``absorb``; a
    MoE model's sharded steps replay the unsharded bf16 step's expert
    choices.  The logits, gathered over the vocabulary for the check
    only, must lie within twice the bf16 unsharded steps' distance from
    the f32 ones; every rank of a KV-head split must launch
    decode_attention on its own shard in every layer of every decode
    step, and no other layout may launch it.  Threads share the GIL: no
    time here is a tensor-parallel speed."""
    import threading
    import torch
    import torch.distributed as dist
    from repro_torch.core.plan import PLAN_KEY
    from repro_torch.core.qconfig import QuantConfig
    from repro_torch.launch.mesh import make_elastic_mesh
    from repro_torch.launch.train import place
    from repro_torch.models import forward, init_cache, init_model
    from repro_torch.pipeline.adapters import resolve_quant_plan
    from repro_torch.serve.deploy import export_for_layers, make_deploy_plan
    from repro_torch.sharding import tp as tp_lib
    from repro_torch.sharding.partition import (ShardingPolicy,
                                                cache_shardings,
                                                params_shardings)
    from repro_torch.train.steps import make_prefill_step
    from repro_torch.tree import tree_items
    c = dataclasses.replace(c, n_layers=TP_LAYERS)
    R, P, T, N = (TP_SERVE[k] for k in ("rows", "prompt", "depth", "steps"))
    qcfg = QuantConfig()
    pol = ShardingPolicy()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        student = init_model(torch.Generator(device=DEVICE).manual_seed(seed),
                             c, qcfg, device=DEVICE)
        plan = make_deploy_plan(qcfg, arch=c.name, family=c.family,
                                quant_plan=resolve_quant_plan(c, qcfg))
        art = export_for_layers(student, plan, device=DEVICE)
    n_params = sum(t.numel() for _, t in tree_items(student))
    del student
    art.pop(PLAN_KEY)
    torch.cuda.empty_cache()
    export_gib = _gib()
    g = torch.Generator(device=DEVICE).manual_seed(seed + 1)
    prompt = torch.randint(0, c.vocab, (R, P), generator=g, device=DEVICE)
    pos0 = torch.tensor(TP_SERVE_POS, dtype=torch.int32, device=DEVICE)
    leaf = "ckv" if c.mla is not None else "k"

    def unsharded(cfg, dtype, tokens=None, record=None):
        """The plain route on the artifact: the logits of the prefill and
        of each decode step (host f32) and the greedy tokens (``tokens``
        fed instead where given); ``record`` takes the expert choices."""
        cache = init_cache(cfg, R, T, dtype=dtype, device=DEVICE)
        out, fed = [], []
        with torch.no_grad(), _routing(record=record):
            o = forward(art, cfg, None, {"tokens": prompt}, cache=cache,
                        compute_dtype=dtype)
            cache["pos"] = pos0.clone()
            out.append(o["logits"][:, -1].float().cpu())
            for i in range(N):
                t = (out[-1].argmax(-1) if tokens is None
                     else tokens[i]).to(DEVICE)[:, None]
                fed.append(t[:, 0].cpu())
                o = forward(art, cfg, None, {"tokens": t}, cache=cache,
                            compute_dtype=dtype)
                out.append(o["logits"][:, -1].float().cpu())
        del cache
        torch.cuda.empty_cache()
        return torch.stack(out), fed

    refs: dict = {}
    res_all: dict = {"parameters": n_params, "export_peak_gib": export_gib}
    for tp, kv, absorb in layouts:
        cfg = dataclasses.replace(c, mla_absorb=absorb)
        if absorb not in refs:
            torch.cuda.reset_peak_memory_stats()
            f32, tokens = unsharded(cfg, torch.float32)
            routes: list = []
            b16, _ = unsharded(cfg, torch.bfloat16, tokens, record=routes)
            refs[absorb] = (f32, tokens, b16, routes, _gib())
        f32, tokens, b16, routes, ref_gib = refs[absorb]
        d_16 = float((b16 - f32).norm())
        shared = {"art": art}
        placed = threading.Barrier(tp)
        t0 = time.perf_counter()

        def rank_fn(rank):
            mesh = make_elastic_mesh(tp, tp, DEVICE)
            ex = place(shared["art"], params_shardings(shared["art"], cfg,
                                                       mesh, pol), mesh)
            whole = init_cache(cfg, R, T, device=DEVICE)
            specs = cache_shardings(whole, cfg, mesh, pol)
            if kv is None:            # the cache whole over model
                specs = {k: v if k == "pos" else tuple(
                    None if e == "model" else e for e in v)
                    for k, v in specs.items()}
            cache = place(whole, specs, mesh)
            del whole
            placed.wait()
            got_kv = tp_lib.cache_view(cache)[1]
            shard = tuple(cache[leaf].to_local().shape)
            logits = []

            def keep(local):           # over the vocabulary, for the check
                parts = [torch.empty_like(local) for _ in range(tp)]
                dist.all_gather(parts, local.contiguous())
                if rank == 0:
                    logits.append(torch.cat(parts, -1).float().cpu())
            with torch.no_grad():
                lg, cache = make_prefill_step(cfg, None)(
                    ex, cache, {"tokens": prompt})
                keep(lg)
                cache["pos"] = pos0.clone()
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                for i in range(N):
                    o = forward(ex, cfg, None,
                                {"tokens": tokens[i].to(DEVICE)[:, None]},
                                cache=cache, use_kernels=True)
                    cache = o["cache"]
                    keep(o["logits"][:, -1])
                torch.cuda.synchronize()
            return {"kv": got_kv, "shard": shard, "logits": logits,
                    "ms": 1e3 * (time.perf_counter() - t1) / N}

        record: dict = {}
        free: list = []
        _zero_counts()
        torch.cuda.reset_peak_memory_stats()
        with _per_rank_decode(record), _routing_by_rank(routes, free):
            res = _threaded_ranks(tp, rank_fn)
        counts = _counts()
        secs = time.perf_counter() - t0
        del shared
        torch.cuda.empty_cache()
        got = torch.stack(res[0]["logits"])
        d_tp = float((got - f32).norm())
        worst = max(float((got[i] - f32[i]).norm())
                    / max(float((b16[i] - f32[i]).norm()), 1e-30)
                    for i in range(N + 1))
        greedy = got[1:].argmax(-1).T.tolist()
        same = sum(int(a == b) for row, ref in zip(greedy, torch.stack(
            tokens[1:] + [f32[-1].argmax(-1)]).T.tolist())
                   for a, b in zip(row, ref))
        kvs = {r["kv"] for r in res}
        per_rank = {r: len(v) for r, v in sorted(record.items())}
        shapes = {r: sorted(set(v)) for r, v in sorted(record.items())}
        form = " absorbed" if absorb else ""
        routing = ""
        if c.moe is not None:
            routing = (f"; the unsharded bf16 step's expert choices "
                       f"replayed, rank 0's free choice differing in "
                       f"{sum(free)} of {sum(int(i.shape[0]) for i in routes)}"
                       f" token-layer expert sets")
        say(f"[{tag}] {c.name}{form} full width, {c.n_layers} layers "
            f"({n_params / 1e9:.2f} B parameters), mesh (data 1, model "
            f"{tp}), ranks as threads: cache split {kv}, rank 0's {leaf} "
            f"shard {res[0]['shard']}; {R} rows x {P}-token prefill at "
            f"scalar pos, {N} decode steps at per-slot pos "
            f"{list(TP_SERVE_POS)}: logits |tp - f32| {d_tp:.4e} against "
            f"|bf16 - f32| {d_16:.4e} ({d_tp / max(d_16, 1e-30):.3f}x; "
            f"worst step {worst:.3f}x); greedy tokens equal to the f32 "
            f"steps' {same}/{R * N}{routing}; decode_attention launches "
            f"{counts['decode_attention']}; peak {_gib():.2f} GiB (the "
            f"unsharded steps' {ref_gib:.2f}, export {export_gib:.2f}); "
            f"rank 0's decode step {res[0]['ms']:.1f} ms (threads share "
            f"the GIL: not a speed); {secs:.1f} s [{CARD}]")
        say(f"[{tag}]   greedy tokens, row by row: {greedy}")
        for r in sorted(record):
            say(f"[{tag}]   rank {r}: decode_attention {per_rank[r]} "
                f"launches at (q, k) {shapes[r]}")
        what = f"{tag} {c.name}{form} tp {tp}"
        if kvs != {kv}:
            fail(f"{what}: the cache was split {kvs}, not {kv}")
        if len(free) != len(routes):
            fail(f"{what}: rank 0 routed {len(free)} times, the unsharded "
                 f"step {len(routes)}")
        if not d_tp <= 2 * d_16:
            fail(f"{what}: logits |tp - f32| {d_tp} > 2 x {d_16}")
        if kv == "heads":
            want = {r: c.n_layers * N for r in range(tp)}
            k_shape = (R, T, c.n_kv_heads_padded // tp, c.head_dim)
            if per_rank != want or any(
                    {k for _, k in v} != {k_shape} for v in shapes.values()):
                fail(f"{what}: decode_attention per rank {per_rank} at "
                     f"{shapes}; want {want} at k {k_shape}")
            if counts["decode_attention"] != sum(want.values()):
                fail(f"{what}: the wrapper counted "
                     f"{counts['decode_attention']} launches, the ranks "
                     f"called it {sum(want.values())} times")
        elif counts["decode_attention"] or record:
            fail(f"{what}: decode_attention launched on a cache split "
                 f"{kv}: {per_rank}")
        res_all[f"tp{tp}_{kv or 'whole'}{'_absorbed' if absorb else ''}"] = {
            "kv": kv, "shard_rank0": list(res[0]["shard"]),
            "launches": counts["decode_attention"],
            "launches_per_rank": per_rank,
            "shapes_rank0": [list(map(list, s))
                             for s in shapes.get(0, [])],
            "logits_distance_ratio": d_tp / max(d_16, 1e-30),
            "worst_step_ratio": worst, "greedy_equal": same,
            "free_sets_differ": sum(free), "peak_gib": _gib(),
            "reference_peak_gib": ref_gib, "seconds": secs}
        del res, got
        torch.cuda.empty_cache()
    del art
    torch.cuda.empty_cache()
    return res_all


def tp_serve_path(cfg) -> dict:
    """Phase 26: the dense forward with a cache on the rank's shards
    (:func:`_tp_serve`): the KV heads split at ``TP_SIZES``, the sequence
    at ``TP_SEQ``; then decode_attention at a rank's shard of the cache
    against its plain version."""
    out = _tp_serve(cfg, tuple((tp, "heads", False) for tp in TP_SIZES)
                    + ((TP_SEQ, "seq", False),), 26, "tp-serve")
    out["rank_rows"] = _k2_rank_rows(cfg, TP_SIZES)
    return out


def _k2_rank_rows(cfg, sizes) -> dict:
    """:func:`_k2_rank_row` at each KV-head split of ``sizes``: a rank's
    ``[rows, depth, Hkv/tp, hd]`` shard, the lengths of ``TP_SERVE``'s
    per-slot decode."""
    lengths = [p + TP_SERVE["steps"] for p in TP_SERVE_POS]
    return {f"Hkv{hkv}": _k2_rank_row(
                TP_SERVE["rows"], hkv,
                cfg.n_heads_padded // cfg.n_kv_heads_padded, cfg.head_dim,
                TP_SERVE["depth"], lengths)
            for hkv in sorted({cfg.n_kv_heads_padded // tp for tp in sizes},
                              reverse=True)}


def tp_serve_moe_path(moe_cfg, mla_cfg) -> dict:
    """Phase 27: the MoE experts and MLA in the forward with a cache on
    the rank's shards (``sharding.tp``'s ``_moe_view``/``_mla_view``;
    :func:`_tp_serve`): qwen2-moe at ``TP_MOE_LAYOUTS``, deepseek-v2 at
    ``TP_MLA_LAYOUTS``.  No kernel source is new: K2 runs on each
    qwen2-moe rank's KV heads, and is held against its plain version at
    those shards; MLA and the experts' products run none, in either
    package."""
    moe = _tp_serve(moe_cfg, TP_MOE_LAYOUTS, 28, "tp-serve-moe")
    moe["rank_rows"] = _k2_rank_rows(
        moe_cfg, tuple(tp for tp, kv, _ in TP_MOE_LAYOUTS if kv == "heads"))
    return {"qwen2_moe": moe,
            "deepseek_v2": _tp_serve(mla_cfg, TP_MLA_LAYOUTS, 30,
                                     "tp-serve-moe")}


def main() -> int:
    if not (SRC / "repro_torch" / "csrc").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             f"a checkout of the repository")
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    sys.path.insert(0, str(SRC))
    from repro_torch.configs.command_r_plus_104b import CONFIG as CMDR
    from repro_torch.configs.deepseek_v2_236b import CONFIG as DEEPSEEK
    from repro_torch.configs.mamba2_1_3b import CONFIG as MAMBA2
    from repro_torch.configs.paper_cnn import CONFIG as CNN
    from repro_torch.configs.phi4_mini_3_8b import CONFIG as PHI4
    from repro_torch.configs.qwen2_moe_a2_7b import CONFIG as QWEN2_MOE
    from repro_torch.configs.qwen2_vl_7b import CONFIG as QWEN2_VL
    from repro_torch.configs.qwen3_32b import CONFIG as QWEN3_32B
    from repro_torch.configs.qwen3_8b import CONFIG
    from repro_torch.configs.qwen3_8b import SMOKE
    from repro_torch.configs.seamless_m4t_medium import CONFIG as SEAMLESS
    from repro_torch.configs.zamba2_7b import CONFIG as ZAMBA2
    from repro_torch.serve.engine import ServeConfig
    from repro_torch.serve.kv_cache import resolve_kv_spec
    MOE = dataclasses.replace(QWEN2_MOE, moe=dataclasses.replace(
        QWEN2_MOE.moe, capacity_factor=MOE_CAPACITY_FACTOR))
    DS = dataclasses.replace(DEEPSEEK, moe=dataclasses.replace(
        DEEPSEEK.moe, capacity_factor=DS_CAPACITY_FACTOR))
    DS_TRAIN = dataclasses.replace(DEEPSEEK, moe=dataclasses.replace(
        DEEPSEEK.moe, n_experts=DS_TRAIN_EXPERTS,
        n_experts_padded=DS_TRAIN_EXPERTS,
        capacity_factor=DS_TRAIN_CAPACITY_FACTOR))
    t_start = time.perf_counter()
    probe()
    build()
    fd = check_decode_attention(
        resolve_kv_spec(CONFIG, ServeConfig(**MAIN_SERVE)))
    fd_phi4 = check_decode_attention(
        resolve_kv_spec(PHI4, ServeConfig(**MAIN_SERVE)),
        G=PHI4.n_heads // PHI4.n_kv_heads, tag=" phi4-mini")
    fd_moe = check_decode_attention(
        resolve_kv_spec(MOE, ServeConfig(**MAIN_SERVE)),
        G=MOE.n_heads // MOE.n_kv_heads, tag=" qwen2-moe",
        Hkv=MOE.n_kv_heads)
    # zamba2 serves a monolithic cache; the paged row takes the engine's
    # page geometry at the same max_len
    fd_zamba = check_decode_attention(
        resolve_kv_spec(CONFIG, ServeConfig(**MAIN_SERVE)),
        G=ZAMBA2.n_heads // ZAMBA2.n_kv_heads, tag=" zamba2",
        Hkv=ZAMBA2.n_kv_heads, hd=ZAMBA2.head_dim)
    fd_vl = check_decode_attention(
        resolve_kv_spec(QWEN2_VL, ServeConfig(**MAIN_SERVE)),
        G=QWEN2_VL.n_heads // QWEN2_VL.n_kv_heads, tag=" qwen2-vl",
        Hkv=QWEN2_VL.n_kv_heads)
    # command-r-plus-104b's 8 kv heads x a group of 12, and a group of 16:
    # two query chunks of 8 (12 = 8 + 4) re-reading the K/V rows
    fd_g12 = check_decode_attention(
        resolve_kv_spec(CMDR, ServeConfig(**MAIN_SERVE)),
        G=CMDR.n_heads // CMDR.n_kv_heads, tag=" command-r-plus",
        Hkv=CMDR.n_kv_heads)
    fd_g16 = check_decode_attention(
        resolve_kv_spec(CMDR, ServeConfig(**MAIN_SERVE)), G=16,
        tag=" G16", Hkv=CMDR.n_kv_heads)
    qmm, qmm_dequant = check_quant_matmul(CONFIG)
    qmm_i8 = check_quant_matmul_int8(DEEPSEEK, CNN)
    dispatch = op_dispatch_overhead(
        resolve_kv_spec(CONFIG, ServeConfig(**MAIN_SERVE)))
    fq, fq_layers = check_fake_quant(CONFIG)
    fq_cnn = check_fake_quant_cnn(CNN)
    fq_moe = check_fake_quant_moe(MOE)
    fq_mla = check_fake_quant_mla(DS)
    fq_ssm = check_fake_quant_ssm(MAMBA2, ZAMBA2)
    fa = check_flash_attention(CONFIG)
    fa_zamba = check_flash_attention_fma(ZAMBA2)
    fq_vl_ed = check_fake_quant_vlm_encdec(QWEN2_VL, SEAMLESS)
    fq_tp = check_fake_quant_tp(CONFIG)
    fq_factored = check_fake_quant_factored(CONFIG, MOE, DS, SEAMLESS)
    c16 = CONFIG.with_padding(tp=TP_SHARDS)
    fa_tp = check_flash_attention_at(
        f"qwen3-8b tp{TP_SHARDS} shard", 16, 512, 512,
        c16.n_heads_padded // TP_SHARDS,
        max(c16.n_kv_heads_padded // TP_SHARDS, 1), c16.head_dim, True,
        "wgmma", seed=24)
    S_ENC, S_DEC = ENCDEC_FRAMES, ENCDEC_TRAIN_DATA["seq_len"]
    fa_vl = check_flash_attention_at(
        "qwen2-vl", 16, 512, 512, QWEN2_VL.n_heads, QWEN2_VL.n_kv_heads,
        QWEN2_VL.head_dim, True, "wgmma", seed=21)
    fa_ed = {"self": check_flash_attention_at(
        "seamless self", 16, S_ENC, S_ENC, SEAMLESS.n_heads,
        SEAMLESS.n_kv_heads, SEAMLESS.head_dim, True, "wgmma", seed=22),
        "cross": check_flash_attention_at(
        "seamless cross", 16, S_DEC, S_ENC, SEAMLESS.n_heads,
        SEAMLESS.n_kv_heads, SEAMLESS.head_dim, False, "wgmma", seed=23)}
    check_reference()
    launches = main_path(CONFIG)
    train = train_path(CONFIG, chain_ab=True)
    pipeline = pipeline_path(CONFIG)
    cnn = cnn_path(CNN)
    t9 = time.perf_counter()
    phi4 = main_path(PHI4)
    say(f"[main] phase 9 ({PHI4.name}) {time.perf_counter() - t9:.1f} s")
    t10 = time.perf_counter()
    moe = main_path(MOE)
    say(f"[main] phase 10 ({MOE.name}) {time.perf_counter() - t10:.1f} s")
    t11 = time.perf_counter()
    moe_train = train_path(MOE, layers=MOE_TRAIN_LAYERS,
                           steps=MOE_TRAIN_STEPS)
    say(f"[main] phase 11 ({MOE.name} QFT) "
        f"{time.perf_counter() - t11:.1f} s")
    t12 = time.perf_counter()
    ds = main_path(DS, layers=DS_LAYERS)
    say(f"[main] phase 12 ({DS.name}) {time.perf_counter() - t12:.1f} s")
    t13 = time.perf_counter()
    ds_train = train_path(DS_TRAIN, layers=DS_TRAIN_LAYERS,
                          steps=DS_TRAIN_STEPS)
    say(f"[main] phase 13 ({DS.name} QFT, {DS_TRAIN_EXPERTS} experts) "
        f"{time.perf_counter() - t13:.1f} s")
    t14 = time.perf_counter()
    mamba = main_path(MAMBA2)
    say(f"[main] phase 14 ({MAMBA2.name}) {time.perf_counter() - t14:.1f} s")
    t15 = time.perf_counter()
    mamba_train = train_path(MAMBA2, layers=MAMBA_TRAIN_LAYERS,
                             steps=SSM_TRAIN_STEPS,
                             microbatches=MAMBA_TRAIN_MICROBATCHES)
    say(f"[main] phase 15 ({MAMBA2.name} QFT, {MAMBA_TRAIN_LAYERS} layers) "
        f"{time.perf_counter() - t15:.1f} s")
    t16 = time.perf_counter()
    zamba = main_path(ZAMBA2)
    say(f"[main] phase 16 ({ZAMBA2.name}) {time.perf_counter() - t16:.1f} s")
    t17 = time.perf_counter()
    zamba_train = train_path(ZAMBA2, layers=ZAMBA_TRAIN_LAYERS,
                             steps=SSM_TRAIN_STEPS)
    say(f"[main] phase 17 ({ZAMBA2.name} QFT, {ZAMBA_TRAIN_LAYERS} layers) "
        f"{time.perf_counter() - t17:.1f} s")
    t18 = time.perf_counter()
    vl = main_path(QWEN2_VL)
    say(f"[main] phase 18 ({QWEN2_VL.name}) {time.perf_counter() - t18:.1f} s")
    t19 = time.perf_counter()
    vl_train = train_path(
        QWEN2_VL, data_cfg=VLM_TRAIN_DATA, augment=vlm_augment(QWEN2_VL),
        shape=f"{VLM_TRAIN_DATA['batch_size']} x "
              f"({VLM_TRAIN_DATA['seq_len']} tokens + {VLM_PATCHES} patches)")
    say(f"[main] phase 19 ({QWEN2_VL.name} QFT, {TRAIN_LAYERS} layers) "
        f"{time.perf_counter() - t19:.1f} s")
    t20 = time.perf_counter()
    ed_train = train_path(
        SEAMLESS, layers=SEAMLESS.n_layers, steps=ENCDEC_TRAIN_STEPS,
        data_cfg=ENCDEC_TRAIN_DATA, augment=encdec_augment(SEAMLESS),
        shape=f"{ENCDEC_TRAIN_DATA['batch_size']} x ({ENCDEC_FRAMES} frames "
              f"-> {ENCDEC_TRAIN_DATA['seq_len']} tokens)")
    say(f"[main] phase 20 ({SEAMLESS.name} QFT, {SEAMLESS.enc_layers} + "
        f"{SEAMLESS.n_layers} layers) {time.perf_counter() - t20:.1f} s")
    t21 = time.perf_counter()
    cmdr = main_path(CMDR, layers=CMDR_LAYERS)
    say(f"[main] phase 21 ({CMDR.name}, {CMDR_LAYERS} layers) "
        f"{time.perf_counter() - t21:.1f} s")
    t21b = time.perf_counter()
    q32 = main_path(QWEN3_32B, layers=QWEN32_LAYERS)
    say(f"[main] phase 21 ({QWEN3_32B.name}, {QWEN32_LAYERS} layers) "
        f"{time.perf_counter() - t21b:.1f} s")
    t22 = time.perf_counter()
    _zero_counts()
    remat = remat_routes(CONFIG)
    depth = remat_depth(CONFIG)
    remat_counts = _counts()
    say(f"[main] phase 22 (remat) {time.perf_counter() - t22:.1f} s")
    t23 = time.perf_counter()
    sharded = sharded_path(CONFIG, MOE, SMOKE)
    say(f"[main] phase 23 (the sharded path, world size 1) "
        f"{time.perf_counter() - t23:.1f} s")
    t24 = time.perf_counter()
    launch = launch_path(CONFIG, SMOKE)
    say(f"[main] phase 24 (launch.serve, check) "
        f"{time.perf_counter() - t24:.1f} s")
    t25 = time.perf_counter()
    tp = tp_path(CONFIG)
    say(f"[main] phase 25 (tensor parallelism, ranks as threads) "
        f"{time.perf_counter() - t25:.1f} s")
    t26 = time.perf_counter()
    tp_serve = tp_serve_path(CONFIG)
    say(f"[main] phase 26 (tensor parallelism with a cache, ranks as "
        f"threads) {time.perf_counter() - t26:.1f} s")
    t27 = time.perf_counter()
    tp_moe = tp_serve_moe_path(MOE, DS)
    say(f"[main] phase 27 (the MoE experts and MLA with a cache on shards, "
        f"ranks as threads) {time.perf_counter() - t27:.1f} s")
    kernels = [
        {"name": "decode_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/decode_attention.cu",
         "replaces": "src/repro/kernels/decode_attention.py:60",
         "launches": launches["decode_attention"],
         "launches_paged": launches["decode_attention_paged"], **fd,
         "phi4_mini": dict(fd_phi4,
                           launches=phi4["decode_attention"],
                           launches_paged=phi4["decode_attention_paged"]),
         "qwen2_moe": dict(fd_moe,
                           launches=moe["decode_attention"],
                           launches_paged=moe["decode_attention_paged"]),
         "deepseek_v2": {"launches": ds["decode_attention"]
                         + ds_train["decode_attention"]},
         "mamba2": {"launches": mamba["decode_attention"]
                    + mamba_train["decode_attention"]},
         "zamba2": dict(fd_zamba, launches=zamba["decode_attention"],
                        launches_paged=zamba["decode_attention_paged"],
                        launches_train=zamba_train["decode_attention"]),
         "qwen2_vl": dict(fd_vl, launches=vl["decode_attention"],
                          launches_paged=vl["decode_attention_paged"],
                          launches_train=vl_train["decode_attention"]),
         "seamless_m4t": {"launches": ed_train["decode_attention"]},
         "command_r_plus": dict(fd_g12,
                                launches=cmdr["decode_attention"],
                                launches_paged=cmdr[
                                    "decode_attention_paged"]),
         "g16": fd_g16,
         "qwen3_32b": {"launches": q32["decode_attention"],
                       "launches_paged": q32["decode_attention_paged"]},
         "launch_serve": {"launches": launch["decode_attention"],
                          "launches_paged": launch["decode_attention_paged"],
                          "decode_steps": launch["decode_steps"],
                          "check_predicted_per_step":
                              launch["check_predicted"],
                          "real_per_step": launch["check_real"]},
         "operator_layer": dispatch, "tp": tp_serve,
         "tp_moe_mla": tp_moe},
        {"name": "quant_matmul", "route": "cuda",
         "source": "src/repro_torch/csrc/quant_matmul.cu",
         "replaces": "src/repro/kernels/quant_matmul.py:67",
         "launches": launches["quant_matmul"],
         **launches["quant_matmul_bodies"], **qmm,
         "launches_phi4_mini": phi4["quant_matmul"],
         "launches_qwen2_moe": moe["quant_matmul"],
         "launches_deepseek_v2": ds["quant_matmul"],
         "launches_mamba2": mamba["quant_matmul"],
         "launches_zamba2": zamba["quant_matmul"],
         "launches_qwen2_vl": vl["quant_matmul"],
         "launches_seamless_m4t": ed_train["quant_matmul"],
         "launches_command_r_plus": cmdr["quant_matmul"],
         "launches_qwen3_32b": q32["quant_matmul"],
         "launches_launch_serve": launch["quant_matmul"]},
        {"name": "quant_matmul_int8", "route": "cuda",
         "source": "src/repro_torch/csrc/quant_matmul.cu",
         "replaces": "src/repro/kernels/ops.py:58",
         "launches": cnn["quant_matmul_int8"], **qmm_i8},
        {"name": "fake_quant", "route": "cuda",
         "source": "src/repro_torch/csrc/fake_quant.cu",
         "replaces": "src/repro/kernels/fake_quant.py:24",
         "launches": train["fake_quant_fwd"] + train["fake_quant_bwd"],
         "launches_fwd": train["fake_quant_fwd"],
         "launches_bwd": train["fake_quant_bwd"], **fq,
         "launches_factored_fwd": train["fake_quant_factored_fwd"],
         "launches_factored_bwd": train["fake_quant_factored_bwd"],
         "factored": fq_factored,
         "chain": train.get("fake_quant_chain", {}),
         "qwen3_8b_layers": fq_layers,
         "remat": {"launches_fwd": remat_counts["fake_quant_fwd"],
                   "launches_bwd": remat_counts["fake_quant_bwd"],
                   "routes": remat, "depth": depth},
         "sharded": sharded,
         "tp": {"views": fq_tp, **{k: {
             "launches_per_rank": {r: v["fake_quant"] for r, v in
                                   rec["launches_per_rank"].items()},
             "shapes_rank0": rec["shapes_rank0"]["fake_quant"],
             "loss_distance_ratio": rec["loss_distance_ratio"],
             "worst_grad_ratio": rec["worst_grad_ratio"]}
             for k, rec in tp.items()}},
         "paper_cnn": {"launches_fwd": cnn["fake_quant_fwd"],
                       "launches_bwd": cnn["fake_quant_bwd"],
                       "views": fq_cnn},
         "qwen2_moe": {"launches_fwd": moe_train["fake_quant_fwd"],
                       "launches_bwd": moe_train["fake_quant_bwd"],
                       "views": fq_moe},
         "deepseek_v2": {"launches_fwd": ds_train["fake_quant_fwd"],
                         "launches_bwd": ds_train["fake_quant_bwd"],
                         "views": fq_mla},
         "mamba2": {"launches_fwd": mamba_train["fake_quant_fwd"],
                    "launches_bwd": mamba_train["fake_quant_bwd"],
                    "views": {k: v for k, v in fq_ssm.items()
                              if k.startswith(MAMBA2.name)}},
         "zamba2": {"launches_fwd": zamba_train["fake_quant_fwd"],
                    "launches_bwd": zamba_train["fake_quant_bwd"],
                    "views": {k: v for k, v in fq_ssm.items()
                              if k.startswith(ZAMBA2.name)}},
         "qwen2_vl": {"launches_fwd": vl_train["fake_quant_fwd"],
                      "launches_bwd": vl_train["fake_quant_bwd"],
                      "views": {k: v for k, v in fq_vl_ed.items()
                                if k.startswith(QWEN2_VL.name)}},
         "seamless_m4t": {"launches_fwd": ed_train["fake_quant_fwd"],
                          "launches_bwd": ed_train["fake_quant_bwd"],
                          "views": {k: v for k, v in fq_vl_ed.items()
                                    if k.startswith(SEAMLESS.name)}}},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:24",
         "launches": pipeline["flash_attention"],
         "launches_wgmma": pipeline["flash_attention_wgmma"],
         "launches_fma": pipeline["flash_attention_fma"], **fa,
         "launches_qwen2_moe": moe_train["flash_attention"],
         "deepseek_v2": {"launches": ds["flash_attention"]
                         + ds_train["flash_attention"]},
         "mamba2": {"launches": mamba["flash_attention"]
                    + mamba_train["flash_attention"]},
         "zamba2": dict(fa_zamba, launches=zamba_train["flash_attention"],
                        launches_fma=zamba_train["flash_attention_fma"]),
         "qwen2_vl": dict(fa_vl, launches=vl_train["flash_attention"],
                          launches_wgmma=vl_train["flash_attention_wgmma"],
                          launches_serve=vl["flash_attention"]),
         "seamless_m4t": dict(fa_ed, launches=ed_train["flash_attention"],
                              launches_wgmma=ed_train[
                                  "flash_attention_wgmma"]),
         "tp": dict(fa_tp, **{k: {
             "launches_per_rank": {r: v["flash_attention"] for r, v in
                                   rec["launches_per_rank"].items()},
             "shapes_rank0": rec["shapes_rank0"]["flash_attention"]}
             for k, rec in tp.items()})},
        {"name": "quant_matmul_dequant", "route": "cuda",
         "source": "src/repro_torch/csrc/quant_matmul.cu",
         "replaces": "src/repro/kernels/quant_matmul.py:115",
         **qmm_dequant},
    ]
    say(f"[done] {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
