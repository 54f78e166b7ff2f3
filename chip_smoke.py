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
   cin·cout] with one scale row, the fc [64, 10]) and at qwen2-moe's
   (each expert stack [E, in, out] as one [E·in, out] view with its full
   scale, the 8-bit router, the shared experts);
   flash_attention at the teacher's prefill, B 16 x S 512, and a ragged
   B 1 x S 300, 32/8 heads, f32 through its FMA body and bf16 through its
   tensor-core body, causal and not), with the error,
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
   fake-quant forward and backward through fake_quant and the teacher's
   attention through flash_attention's tensor-core body, launches counted
   per body; then export, the
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

The last line is {"ok": true, "device": {...}}; the line before it holds
the per-kernel JSON record.  Exits non-zero, printing no result, without a
CUDA device or without the repository beside this file.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

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
MAIN_PROMPTS = (17, 130, 300, 1000)
NEW_TOKENS = 16
MAIN_SERVE = dict(max_slots=8, max_len=2048, prefill_chunk=128)
MARGIN_ULPS = 4
DEVICE = "cuda"


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
    say(smi.stdout.strip().splitlines()[0])
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
                           Hkv: int = 8) -> dict:
    """K2's rows at ``Hkv`` kv heads and a GQA group of ``G`` query heads
    per kv head (qwen3-8b 8 x 4, phi4-mini 8 x 3, qwen2-moe 16 x 1): bf16
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
                                                      split_rows, tile_rows)
    from repro_torch.kernels.ref import (decode_attention_paged_ref,
                                         decode_attention_ref)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    S, hd, T = 8, 128, kv.view_len
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
        nbytes = (2 * live * Hkv * hd * elt + 2 * q[:n].numel() * 2
                  + n * 4 + extra_bytes)
        b_ms, b_by = bound(nbytes, 4 * live * Hkv * G * hd,
                           "int8" if elt == 1 else "bf16")
        dev_txt = "not measured" if dev_ms is None else f"{dev_ms:.4f}"
        say(f"[kernel] decode_attention{tag} {kind} S={n} Hkv={Hkv} G={G} "
            f"hd={hd} T={t} split={split_rows(t, n * Hkv, tile)} rows "
            f"max_abs_err={err:.3e} (tol {tol:.3e}) ms={ms:.4f} "
            f"device_ms={dev_txt} plain_ms={plain_ms:.4f} library_ms="
            f"{'null' if lib_ms is None else f'{lib_ms:.4f}'} "
            f"bound_ms={b_ms:.4f} ({b_by})")
        return {"max_abs_err": err, "ms": ms, "device_ms": dev_ms,
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": lib_ms}

    k = torch.randn((S, T, Hkv, hd), generator=g, device=dev).bfloat16()
    v = torch.randn((S, T, Hkv, hd), generator=g, device=dev).bfloat16()
    bf16 = row("bf16", decode_attention, decode_attention_ref,
               (q, k, v, lengths), lengths, T, 2, 0, lib=sdpa(q, k, v,
                                                             lengths))
    ks, vs = scales(S), scales(S)
    k8, v8 = int8((S, T, Hkv, hd)), int8((S, T, Hkv, hd))
    row("int8", decode_attention, decode_attention_ref,
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


def check_fake_quant(cfg) -> dict:
    """fake_quant at the shapes the train path gives it (qwen3-8b's four
    layer-linear shapes with a full doubly-channelwise scale, the
    embedding with a per-row scale, the lm_head).  Returns the
    embedding's record, the largest K3 call of the train path."""
    import torch
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(6)
    d, hq, hkv, ff, V = (cfg.d_model, cfg.n_heads * cfg.head_dim,
                         cfg.n_kv_heads * cfg.head_dim, cfg.d_ff, cfg.vocab)
    # (name, R, C, scale: "full" = s_wl ⊗ s_wr or "row" = per row, bits)
    cases = [("wq/wo", d, hq, "full", 4), ("wk/wv", d, hkv, "full", 4),
             ("gate/up", d, ff, "full", 4), ("down", ff, d, "full", 4),
             ("embed", V, d, "row", 8), ("lm_head", d, V, "full", 8)]
    record = None
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
        del x, s
        torch.cuda.empty_cache()
    return record


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
             ranges: tuple = ()) -> None:
    """Run ``run()`` (``steps`` steps of work) under torch.profiler: the
    device's busy share of the window, the kernels by device time, the
    share of each ``watch`` name (kernels whose name holds it) and the
    device span of each ``ranges`` name (a ``record_function`` range: from
    its first kernel's start to its last's end, gaps included)."""
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
        return
    rows.sort(reverse=True)
    say(f"[profile] {steps} {what}: wall {wall_us / steps / 1e3:.3f} ms/step,"
        f" device busy {busy / steps / 1e3:.3f} ms/step "
        f"({100 * busy / wall_us:.1f}% of the window), "
        f"{sum(r[1] for r in rows) // steps} kernel launches/step")
    for dev_us, count, key in rows[:8]:
        say(f"[profile]   {100 * dev_us / busy:5.1f}% {dev_us / steps:9.1f} "
            f"us/step x{count // steps:<4d} {key[:90]}")
    for name in watch:
        us = sum(r[0] for r in rows if name in r[2])
        n = sum(r[1] for r in rows if name in r[2])
        say(f"[profile]   {name}: {100 * us / busy:.2f}% of device time, "
            f"{us / steps:.1f} us/step over {n // steps} launches/step")
    for name in ranges:
        us, n = spans.get(name, (0, 0))
        say(f"[profile]   range {name}: " + (
            f"its device span {us / steps:.1f} us/step over {n // steps} "
            f"calls/step, {100 * us / busy:.2f}% of the kernels' device "
            f"time" if us else "device time not measured"))


def profile_decode(engine, cfg, steps: int = 4) -> None:
    """Trace a few steady decode steps (8 live slots)."""
    import torch
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
    from repro_torch.models import moe
    ffn = moe._expert_ffn

    def ranged_ffn(*a, **k):
        with torch.profiler.record_function("expert_ffn"):
            return ffn(*a, **k)
    moe._expert_ffn = ranged_ffn
    try:
        _profile(run, "decode steps, 8 live slots", steps,
                 watch=("fd_split", "fd_combine", "index", "gather"),
                 ranges=("expert_ffn",) if cfg.moe is not None else ())
    finally:
        moe._expert_ffn = ffn


def main_path(cfg) -> dict:
    import torch
    from repro_torch.core.qconfig import QuantConfig
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.quant_matmul import quant_matmul
    from repro_torch.models import init_model
    from repro_torch.serve.deploy import (export_for_layers,
                                          kernel_route_check,
                                          make_deploy_plan)
    from repro_torch.serve.engine import Engine, Request, ServeConfig
    qcfg = QuantConfig()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_model(gen, cfg, qcfg, device="cuda")
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
    say(f"[main] {cfg.name} full width: {cfg.n_layers} layers d={cfg.d_model} "
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
    decode_attention.launches = 0
    decode_attention.launches_paged = 0
    quant_matmul.launches = 0
    for body in ("mma", "mma_wide", "fma"):
        setattr(quant_matmul, f"launches_{body}", 0)
    check = kernel_route_check(exported, plan)
    engine = Engine.from_artifact(cfg, plan, exported, scfg)
    timing: dict = {}
    t0 = time.perf_counter()
    toks = _serve(engine, reqs, timing)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"decode_attention": decode_attention.launches,
                "decode_attention_paged": decode_attention.launches_paged,
                "quant_matmul": quant_matmul.launches,
                "quant_matmul_bodies": {
                    f"launches_{b}": getattr(quant_matmul, f"launches_{b}")
                    for b in ("mma", "mma_wide", "fma")}}
    # ---
    stats = engine.stats()
    steps = engine.decode_steps
    if not (check and check["kernel"]):
        fail(f"kernel_route_check did not run quant_matmul: {check}")
    if not check["max_err"] <= 1e-4:
        fail(f"kernel_route_check max_err {check['max_err']} > 1e-4")
    if stats["decode_attn_kernel_layers"] != cfg.n_layers:
        fail(f"decode_attn_kernel_layers {stats['decode_attn_kernel_layers']}"
             f" != {cfg.n_layers}")
    if launches["decode_attention"] != cfg.n_layers * steps or steps == 0:
        fail(f"decode_attention launched {launches['decode_attention']} "
             f"times over {steps} decode steps of {cfg.n_layers} layers")
    if launches["decode_attention_paged"] != cfg.n_layers * steps:
        fail(f"decode_attention's paged entry launched "
             f"{launches['decode_attention_paged']} times over {steps} "
             f"decode steps of {cfg.n_layers} layers")
    if launches["quant_matmul"] < 1:
        fail("quant_matmul never launched on the main path")
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
        f"(= {cfg.n_layers} x {steps}; paged entry "
        f"{launches['decode_attention_paged']}) quant_matmul="
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
    before = decode_attention.launches
    plain = Engine.from_artifact(
        cfg, dataclasses.replace(plan, use_kernels=False), exported, scfg)
    ptiming: dict = {}
    ptoks = _serve(plain, reqs, ptiming)
    if decode_attention.launches != before:
        fail("the plain route launched decode_attention")
    same = sum(a == b for a, b in zip(toks, ptoks))
    say(f"[main] plain route: {same}/{len(reqs)} requests token-identical to "
        f"the kernel route (greedy); decode "
        f"{ptiming['decode_s'] * 1e3 / plain.decode_steps:.3f} ms/step")
    for p, a, b in zip(prompts, toks, ptoks):
        if a != b:
            where = _first_split(plain, cfg, p, a, b)
            say(f"[main]   {a} vs {b}: the routes first split at {where} "
                f"(limit {MARGIN_ULPS})")
    return launches


def _serve_recorded(engine, prompt: list[int], n: int, use_kernels: bool
                    ) -> tuple[list[int], list]:
    """Serve ``prompt`` alone (slot 0) through ``engine`` with the decode
    step of the kernel or the plain route, recording in call order each
    router call's f32 logits (``("r", ·)``; MoE only), each prefill
    chunk's logits (``("p", ·)``) and each decode step's (``("z", ·)``)."""
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
        if "pt" in (k.get("cache") or {}):        # the paged decode step
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


def _first_split(engine, cfg, prompt: list[int], kernel_toks: list[int],
                 plain_toks: list[int]) -> str:
    """Where a request's kernel-route and plain-route tokens differ: serve
    it alone through both decode routes (recording every router call and
    every emitted token's logits), walk the two runs' decisions in call
    order — each real token's top-k experts in every layer (MoE), then
    each emitted token — and fail unless, at the first decision that
    differs, the plain route's own margin is within MARGIN_ULPS bf16 ulps
    of the row's largest logit in magnitude (the top logit, for a token):
    the k-th minus the (k+1)-th router logit, or the top-2 logit margin.
    Returns a description of that decision."""
    import torch
    n = len(kernel_toks)
    got = {}
    for use in (True, False):
        got[use] = _serve_recorded(engine, prompt, n, use)
        want = kernel_toks if use else plain_toks
        if got[use][0] != want:
            fail(f"{cfg.name}: the {'kernel' if use else 'plain'} route "
                 f"served alone gave {got[use][0]}, in the batch {want}")
    if [k for k, _ in got[False][1]] != [k for k, _ in got[True][1]]:
        fail(f"{cfg.name}: the two routes made different calls")
    K = cfg.moe.top_k if cfg.moe is not None else 0
    chunk = engine.scfg.prefill_chunk
    lens = [min(chunk, len(prompt) - o)
            for o in range(0, len(prompt), chunk)]
    f, tok = 0, 0                   # forward calls ended, tokens emitted
    for (kind, a), (_, b) in zip(got[False][1], got[True][1]):
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
                where = (f"routing, {at} row {r}: plain experts "
                         f"{sorted(pa)}, kernel {sorted(pb)}; the plain "
                         f"k-th/(k+1)-th logit gap {gap:.6g} = "
                         f"{gap / ulp:.2f} bf16 ulps")
                if gap > MARGIN_ULPS * ulp:
                    fail(f"{cfg.name}: the routes split at {where} (limit "
                         f"{MARGIN_ULPS})")
                return where
            continue
        f += 1
        if kind == "p" and f < len(lens):
            continue                  # an inner chunk: nothing emitted
        if int(torch.argmax(a[0])) != int(torch.argmax(b[0])):
            top = torch.topk(a[0], 2).values
            margin, ulp = float(top[0] - top[1]), _ulp(float(top[0]))
            where = (f"token {tok}: the plain top-2 margin {margin:.6g} = "
                     f"{margin / ulp:.2f} bf16 ulps")
            if margin > MARGIN_ULPS * ulp:
                fail(f"{cfg.name}: the routes split at {where} (limit "
                     f"{MARGIN_ULPS})")
            return where
        tok += 1
    fail(f"{cfg.name}: kernel tokens {kernel_toks} != plain tokens "
         f"{plain_toks}, but the requests served alone split nowhere")


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
            "quant_matmul": (quant_matmul, "launches"),
            "quant_matmul_dequant": (quant_matmul, "launches_dequant"),
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


def _teacher_on_tensor_cores(counts: dict, where: str) -> None:
    """Every flash_attention launch in ``counts`` went through the
    tensor-core body (the teacher's bf16 attention at hd 128)."""
    if counts["flash_attention_wgmma"] != counts["flash_attention"]:
        fail(f"{where}: {counts['flash_attention_fma']} of "
             f"{counts['flash_attention']} flash_attention launches took the "
             f"FMA body")


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
    and the MLP's three (dense), or the router, the three expert stacks
    (one K3 launch each) and the three shared experts' (MoE)."""
    if cfg.moe is None:
        return 7
    return 4 + 1 + 3 + (3 if cfg.moe.n_shared else 0)


def train_path(cfg, layers: int = TRAIN_LAYERS,
               steps: int = TRAIN_STEPS) -> dict:
    """QFT at full width, ``layers`` deep: prepare, ``steps`` steps, export
    and serve, the plain-route comparison.  Returns the kernels' launch
    counts."""
    import torch
    from repro_torch.core import dof
    from repro_torch.core.qconfig import QuantConfig
    from repro_torch.data.calib import CalibConfig, CalibDataset
    from repro_torch.models import forward, init_model
    from repro_torch.models.transformer import layer_slice
    from repro_torch.pipeline.adapters import resolve_quant_plan
    from repro_torch.serve.deploy import (export_for_layers,
                                          kernel_route_check,
                                          make_deploy_plan)
    from repro_torch.serve.engine import Engine, Request, ServeConfig
    from repro_torch.train.qft_trainer import QFTConfig, QFTTrainer
    from repro_torch.train.steps import make_value_and_grad
    from repro_torch.tree import tree_items
    full_depth = cfg.n_layers
    cfg = dataclasses.replace(cfg, n_layers=layers)
    L = cfg.n_layers
    qcfg = QuantConfig()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    teacher = init_model(torch.Generator(device=DEVICE).manual_seed(0), cfg,
                         None, device=DEVICE)
    n_params = sum(t.numel() for _, t in tree_items(teacher))
    data = CalibDataset(CalibConfig(vocab=cfg.vocab, **TRAIN_DATA))
    calib = CalibDataset(CalibConfig(vocab=cfg.vocab, **TRAIN_DATA))
    # the plan resolved once from the student's shapes: the trainer's grid
    # and the export's (at 2 layers qwen2-moe's 1 % rule keeps attn.wk at
    # 8 bits)
    qplan = resolve_quant_plan(cfg, qcfg)
    trainer = QFTTrainer(cfg, qcfg, teacher, QFTConfig(),
                         steps_per_epoch=data.steps_per_epoch,
                         microbatches=TRAIN_MICROBATCHES, plan=qplan)

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
    if prep_fa != 2 * L:          # the teacher over 2 calibration batches
        fail(f"calibration launched flash_attention {prep_fa} times, want "
             f"{2 * L}")
    _teacher_on_tensor_cores(_counts(), "calibration")
    torch.cuda.reset_peak_memory_stats()
    student, hist = trainer.run(student, data, steps=steps, log_every=1)
    torch.cuda.synchronize()
    peak_run = _gib()
    losses = [h["loss"] for h in hist]
    ts = [h["t"] for h in hist]
    step_ms = [1e3 * (b - a) for a, b in zip([0.0] + ts[:-1], ts)]
    n_lin = _linears_per_layer(cfg)
    per_fwd = 1 + n_lin * L       # embed + the layers' linears; no lm_head
    want = steps * TRAIN_MICROBATCHES * per_fwd
    run_counts = _counts()
    say(f"[train] {steps} steps, batch {TRAIN_DATA['batch_size']} x "
        f"{TRAIN_DATA['seq_len']} in {TRAIN_MICROBATCHES} microbatches: "
        f"loss {', '.join(f'{x:.6f}' for x in losses)}; ms/step "
        f"{', '.join(f'{x:.1f}' for x in step_ms)} (steps 2-{steps} "
        f"mean {sum(step_ms[1:]) / (len(step_ms) - 1):.1f}); peak "
        f"{peak_run:.2f} GiB")
    fa_want = steps * TRAIN_MICROBATCHES * L
    say(f"[train] fake_quant launches forward {run_counts['fake_quant_fwd']} "
        f"backward {run_counts['fake_quant_bwd']} (= {steps} steps x "
        f"{TRAIN_MICROBATCHES} microbatches x (1 embed + {n_lin} x {L} "
        f"linears); "
        f"lm_head is not run: the backbone-L2 loss never reads it); "
        f"flash_attention (the teacher) {prep_fa} in calibration + "
        f"{run_counts['flash_attention'] - prep_fa} in the steps (= "
        f"{steps} x {TRAIN_MICROBATCHES} x {L} layers)")
    if run_counts["flash_attention"] - prep_fa != fa_want:
        fail(f"the steps launched flash_attention "
             f"{run_counts['flash_attention'] - prep_fa} times, want "
             f"{fa_want}")
    _teacher_on_tensor_cores(run_counts, "the train steps")
    if len(losses) != steps or not all(map(math.isfinite, losses)):
        fail(f"train losses {losses}")
    if (run_counts["fake_quant_fwd"], run_counts["fake_quant_bwd"]) != (
            want, want):
        fail(f"fake_quant launched {run_counts['fake_quant_fwd']} forward / "
             f"{run_counts['fake_quant_bwd']} backward, want {want} each")

    # --- export the trained student and serve it
    plan = make_deploy_plan(qcfg, arch=cfg.name, family=cfg.family,
                            params=student, model_cfg=cfg)
    if dict(plan.quant_plan) != dict(qplan):
        fail("the export plan, resolved from the trained student, is not "
             "the plan it trained on")
    with torch.no_grad():
        exported = export_for_layers(student, plan, device=DEVICE)
        lp0 = layer_slice(student["layers"], 0)
        # layer 0's wq, and a MoE's up expert stack (its s_wl shared by
        # the experts)
        for mod, lin in (("attn", "wq"),) + (
                (("mlp", "up"),) if cfg.moe is not None else ()):
            w_eff = dof.effective_weight(lp0[mod][lin], qcfg,
                                         lp0[mod]["in_stream"]["log_sa"],
                                         compute_dtype=torch.float32)
            w_dq = dof.dequantize_export(
                layer_slice(exported["layers"][mod][lin], 0), torch.float32)
            parity = float((w_eff - w_dq).abs().max())
            if parity > 1e-6 * float(w_eff.abs().max()):
                fail(f"export parity: layer 0 {lin} dequantized export vs "
                     f"the trained effective weight, max err {parity}")
            del w_eff, w_dq
    check = kernel_route_check(exported, plan)
    scfg = ServeConfig(max_slots=2, max_len=256, prefill_chunk=128)
    rng = torch.Generator().manual_seed(8)
    reqs = [Request(prompt=torch.randint(0, cfg.vocab, (n,),
                                         generator=rng).tolist(),
                    max_new_tokens=NEW_TOKENS) for n in (40, 100)]
    engine = Engine.from_artifact(cfg, plan, exported, scfg, device=DEVICE)
    toks = engine.generate(reqs)
    torch.cuda.synchronize()
    counts = _counts()
    # ---
    if not (check and check["kernel"] and check["max_err"] <= 1e-4):
        fail(f"kernel_route_check on the trained artifact: {check}")
    for t in toks:
        if len(t) != NEW_TOKENS or not all(0 <= x < cfg.vocab for x in t):
            fail(f"bad output from the trained artifact: {t}")
    if counts["decode_attention"] != L * engine.decode_steps \
            or engine.decode_steps == 0:
        fail(f"decode_attention launched {counts['decode_attention']} times "
             f"over {engine.decode_steps} decode steps of {L} layers")
    say(f"[train] export parity (layer 0 {lin}) {parity:.3e}; "
        f"kernel_route_check {check['path']}: quant_matmul ran, max_err "
        f"{check['max_err']:.3e}; served {len(reqs)} greedy requests from "
        f"the trained artifact: {toks}; launches quant_matmul="
        f"{counts['quant_matmul']} decode_attention="
        f"{counts['decode_attention']} (= {L} x {engine.decode_steps}); "
        f"peak {_gib():.2f} GiB")
    del engine, exported
    torch.cuda.empty_cache()

    # --- one more step's loss and gradients: kernel route (profiled) vs
    # plain route, from the trained state.  The teacher's hidden states are
    # compared route against route first; then both student routes take
    # the kernel route's targets, so their gap is fake_quant's alone.
    batch = {k: torch.as_tensor(v).to(DEVICE) for k, v in next(data).items()}
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
                          replay=routes[True, None] if pin else None):
                hidden[use, pin] = forward(teacher, cfg, None, batch,
                                           use_kernels=use, logits=False)
            now = _counts()
            delta = {k: now[k] - before[k] for k in now}
            if delta["flash_attention"] != (L if use else 0):
                fail(f"teacher forward (use_kernels={use}) launched "
                     f"flash_attention {delta['flash_attention']} times over "
                     f"{L} layers")
            _teacher_on_tensor_cores(delta, "the teacher forward")

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
    say(f"[train] teacher hidden states, flash_attention vs the plain route "
        f"(bf16 compute, batch {TRAIN_DATA['batch_size']} x "
        f"{TRAIN_DATA['seq_len']}): rel L2 {hid_rel:.3e} (bound "
        f"{TEACHER_HIDDEN_BOUND:.0e}; both round P to bf16 before P.V, the "
        f"kernel unnormalised, the plain route normalised){pinned}")
    if not hid_rel <= TEACHER_HIDDEN_BOUND:
        fail(f"teacher hidden states: kernel vs plain route rel L2 {hid_rel}")
    targets = hidden[True, None]
    del hidden
    vg = make_value_and_grad(cfg, qcfg, microbatches=TRAIN_MICROBATCHES,
                             plan=qplan)
    _profile(lambda: vg(student, teacher, batch), "train-step forward+"
             "backward (kernel route, teacher included, 4 microbatches, no "
             "optimizer)", 1, watch=("fa_wgmma_kernel", "fq_"))
    grads = {}
    for use in (True, False):
        before = _counts()
        vg = make_value_and_grad(cfg, qcfg, microbatches=TRAIN_MICROBATCHES,
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
    return counts


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
        fail(f"cnn kernel_route {kr}: want the int8 fc on the reference "
             f"branch within 1e-4")
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
        f"{_fq_counts(first['per_stage']['evaluate'])}")
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


def main() -> int:
    if not (SRC / "repro_torch" / "csrc").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             f"a checkout of the repository")
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    sys.path.insert(0, str(SRC))
    from repro_torch.configs.paper_cnn import CONFIG as CNN
    from repro_torch.configs.phi4_mini_3_8b import CONFIG as PHI4
    from repro_torch.configs.qwen2_moe_a2_7b import CONFIG as QWEN2_MOE
    from repro_torch.configs.qwen3_8b import CONFIG
    from repro_torch.serve.engine import ServeConfig
    from repro_torch.serve.kv_cache import resolve_kv_spec
    MOE = dataclasses.replace(QWEN2_MOE, moe=dataclasses.replace(
        QWEN2_MOE.moe, capacity_factor=MOE_CAPACITY_FACTOR))
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
    qmm, qmm_dequant = check_quant_matmul(CONFIG)
    fq = check_fake_quant(CONFIG)
    fq_cnn = check_fake_quant_cnn(CNN)
    fq_moe = check_fake_quant_moe(MOE)
    fa = check_flash_attention(CONFIG)
    check_reference()
    launches = main_path(CONFIG)
    train = train_path(CONFIG)
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
                           launches_paged=moe["decode_attention_paged"])},
        {"name": "quant_matmul", "route": "cuda",
         "source": "src/repro_torch/csrc/quant_matmul.cu",
         "replaces": "src/repro/kernels/quant_matmul.py:67",
         "launches": launches["quant_matmul"],
         **launches["quant_matmul_bodies"], **qmm,
         "launches_phi4_mini": phi4["quant_matmul"],
         "launches_qwen2_moe": moe["quant_matmul"]},
        {"name": "fake_quant", "route": "cuda",
         "source": "src/repro_torch/csrc/fake_quant.cu",
         "replaces": "src/repro/kernels/fake_quant.py:24",
         "launches": train["fake_quant_fwd"] + train["fake_quant_bwd"],
         "launches_fwd": train["fake_quant_fwd"],
         "launches_bwd": train["fake_quant_bwd"], **fq,
         "paper_cnn": {"launches_fwd": cnn["fake_quant_fwd"],
                       "launches_bwd": cnn["fake_quant_bwd"],
                       "views": fq_cnn},
         "qwen2_moe": {"launches_fwd": moe_train["fake_quant_fwd"],
                       "launches_bwd": moe_train["fake_quant_bwd"],
                       "views": fq_moe}},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:24",
         "launches": pipeline["flash_attention"],
         "launches_wgmma": pipeline["flash_attention_wgmma"],
         "launches_fma": pipeline["flash_attention_fma"], **fa,
         "launches_qwen2_moe": moe_train["flash_attention"]},
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
