#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. probe — the card's name and power limit, torch/CUDA/nvcc versions;
   TF32 off for matmuls and cuDNN.
2. build — every CUDA source in src/repro_torch/csrc, one nvcc each, all
   started together.
3. kernels — each kernel against its plain PyTorch version at the shapes
   the main paths give it (decode_attention at the engine's slot pool and
   paged view, bf16 and int8; both bodies of quant_matmul — int8dot and
   the dequant baseline — at qwen3-8b's seven linear shapes, decode and
   prefill M, channel and group:128, then the variant benchmark, the
   dequant body's only path; fake_quant forward and both backward rules at
   qwen3-8b's four layer-linear shapes with a full doubly-channelwise
   scale, the embedding with a per-row scale and the lm_head;
   flash_attention at the teacher's prefill, B 16 x S 512, and a ragged
   B 1 x S 300, 32/8 heads, f32 and bf16, causal and not), with the error,
   the kernel's, the plain version's and a library call's time (CUDA
   events, after warm-up) and the least time the card could take.
4. reference — a SMOKE-size model served on the card through the kernels
   and on the CPU through the plain route must emit the same greedy tokens
   (a token may differ only where the CPU's top-2 logit margin is within a
   few bf16 ulps).
5. main path — qwen3-8b at full width (36 layers, random W4 weights from a
   seed): init on the card, export, the evaluate stage's kernel-route check
   (quant_matmul), then 4 greedy requests through the continuous-batching
   engine with paged int8 KV (decode_attention every layer of every decode
   step), counting each kernel's launches; the same requests again through
   the plain route, tokens compared.
6. train path — QFT on qwen3-8b at full width, depth cut to 4 of 36
   layers (the f32 training state of 36 layers does not fit one card):
   f32 teacher from a seed → student → activation calibration → APQ/MMSE
   scale init → 6 steps of joint finetuning (batch 16 x 512 tokens, 4
   microbatches, the paper's Adam recipe), every quantized weight's
   fake-quant forward and backward through fake_quant and the teacher's
   attention through flash_attention, launches counted; then export, the
   route check and 2 greedy requests served from the trained artifact
   (quant_matmul, decode_attention); then the teacher's hidden states
   through flash_attention and through the plain route, compared, and one
   more step's loss and gradients through both student routes on those
   same teacher targets, compared.
7. pipeline — run_pipeline, the path of `python -m repro_torch quantize`,
   at full width with the depth cut to 4 layers (calibrate, APQ/MMSE init,
   4 finetune steps of batch 16 x 512, export, evaluate with the serve
   smoke) in a temporary workdir, launches counted per stage; then again
   on the same workdir, which skips calibrate, init and finetune and must
   give the same evaluate metrics.

The last line is {"ok": true, "device": {...}}; the line before it holds
the per-kernel JSON record.  Exits non-zero, printing no result, without a
CUDA device or without the repository beside this file.
"""
from __future__ import annotations

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
#: 4 layers): relative L2.  The plain route rounds the probabilities to bf16
#: before P.V and the kernel does not; tests/test_torch_flash_attention.py
#: emulates the gap on the CPU (the kernel's plain version on the route).
TEACHER_HIDDEN_BOUND = 3e-2
#: phase 7: the pipeline's own knobs (PipelineConfig), on qwen3-8b at full
#: width with the depth cut to TRAIN_LAYERS
PIPELINE = dict(calib_seq_len=512, calib_batch_size=16, calib_batches=2,
                eval_batches=2, steps=4, serve_smoke=True)

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

def check_decode_attention(view_len: int) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.ref import decode_attention_ref
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    S, Hkv, G, hd, T = 8, 8, 4, 128, view_len
    # the main path's four requests mid-decode, a fresh slot (length 1), a
    # full slot (T) and two block edges
    lengths = torch.tensor([1, 25, 138, 308, 1008, 33, T - 1, T],
                           dtype=torch.int32, device=dev)
    live = int(torch.clamp(lengths, max=T).sum())
    q = torch.randn((S, Hkv, G, hd), generator=g, device=dev).bfloat16()
    record = None
    for kind in ("bf16", "int8"):
        if kind == "bf16":
            k = torch.randn((S, T, Hkv, hd), generator=g, device=dev).bfloat16()
            v = torch.randn((S, T, Hkv, hd), generator=g, device=dev).bfloat16()
            args = (q, k, v, lengths)
        else:
            k = torch.randint(-127, 128, (S, T, Hkv, hd), generator=g,
                              device=dev, dtype=torch.int8)
            v = torch.randint(-127, 128, (S, T, Hkv, hd), generator=g,
                              device=dev, dtype=torch.int8)
            ks = torch.rand((S, Hkv), generator=g, device=dev) * 0.02 + 0.005
            vs = torch.rand((S, Hkv), generator=g, device=dev) * 0.02 + 0.005
            args = (q, k, v, lengths, ks, vs)
        out = decode_attention(*args)
        ref = decode_attention_ref(*args)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        scale = float(ref.float().abs().max())
        tol = 1e-2 * scale          # both round one f32 result to bf16
        if not math.isfinite(err) or err > tol:
            fail(f"decode_attention {kind}: max_abs_err {err} > {tol}")
        ms = time_ms(lambda: decode_attention(*args))
        plain_ms = time_ms(lambda: decode_attention_ref(*args))
        lib_ms = None
        if kind == "bf16":
            qh = q.reshape(S, Hkv * G, 1, hd)
            mask = (torch.arange(T, device=dev)[None, :]
                    < lengths[:, None])[:, None, None, :]
            kt, vt = k.transpose(1, 2), v.transpose(1, 2)
            lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
                qh, kt, vt, attn_mask=mask, enable_gqa=True))
        elt = k.element_size()
        nbytes = (2 * live * Hkv * hd * elt + 2 * q.numel() * 2
                  + lengths.numel() * 4 + (2 * S * Hkv * 4 if kind == "int8"
                                           else 0))
        ops = 4 * live * Hkv * G * hd
        b_ms, b_by = bound(nbytes, ops, kind)
        say(f"[kernel] decode_attention {kind} S={S} Hkv={Hkv} G={G} hd={hd} "
            f"T={T} max_abs_err={err:.3e} (tol {tol:.3e}) ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms="
            f"{'null' if lib_ms is None else f'{lib_ms:.4f}'} "
            f"bound_ms={b_ms:.4f} ({b_by})")
        if kind == "int8":          # the main path's paged int8 view
            record = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}
    return record


def check_quant_matmul(cfg) -> tuple[dict, dict]:
    """Both bodies of quant_matmul against the plain version at qwen3-8b's
    seven linear shapes, then the variant benchmark — the dequant body's
    only caller (the JAX package's benchmarks/run.py:70-76), its launches
    counted from 0 over that run.  Returns (int8dot, dequant) records."""
    import torch
    from repro_torch.core.fakequant import pack_int4
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
    inputs = []
    for name, M, dt, layout in cases:
        K, N = shapes[name]
        x = torch.randn((M, K), generator=g, device=dev).to(dt)
        q4 = torch.randint(-8, 8, (K, N), generator=g, device=dev,
                           dtype=torch.int8)
        qw = pack_int4(q4, axis=0).contiguous()
        s_wl = torch.rand((K,), generator=g, device=dev) + 0.5
        swr_shape = (N,) if layout == "channel" else (K // 128, N)
        s_wr = (torch.rand(swr_shape, generator=g, device=dev) + 0.5) * 0.01
        inputs.append((x, qw, s_wl, s_wr))
    errs = {}
    for (name, M, dt, layout), args in zip(cases, inputs):
        ref = quant_matmul_ref(*args)
        scale = float(ref.float().abs().max())
        for variant in ("int8dot", "dequant"):
            y = quant_matmul(*args, variant=variant)
            torch.cuda.synchronize()
            err = float((y.float() - ref.float()).abs().max())
            # f32: summation order only; bf16: one rounding of the f32
            # result (the reference sweep's 2e-5 / 2e-2, of the output's
            # largest magnitude)
            tol = (2e-5 if dt == torch.float32 else 2e-2) * scale
            if not math.isfinite(err) or err > tol:
                fail(f"quant_matmul {variant} {name} M={M} {layout}: "
                     f"max_abs_err {err} > {tol}")
            errs[(name, M, dt, layout, variant)] = (err, tol)

    # --- the variant benchmark, with the dequant body's count at 0
    quant_matmul.launches_dequant = 0
    records = {}
    for (name, M, dt, layout), args in zip(cases, inputs):
        x, qw, s_wl, s_wr = args
        K, N = shapes[name]
        ms = {v: time_ms(lambda v=v: quant_matmul(*args, variant=v))
              for v in ("int8dot", "dequant")}
        plain_ms = time_ms(lambda: quant_matmul_ref(*args))
        nbytes = (x.numel() * x.element_size() + qw.numel() + 4 * K
                  + 4 * s_wr.numel() + M * N * x.element_size())
        b_ms, b_by = bound(nbytes, 2.0 * M * K * N,
                           "f32" if dt == torch.float32 else "bf16")
        for v in ("int8dot", "dequant"):
            err, tol = errs[(name, M, dt, layout, v)]
            say(f"[kernel] quant_matmul {v} {name} M={M} K={K} N={N} "
                f"{layout} {str(dt).split('.')[-1]} max_abs_err={err:.3e} "
                f"(tol {tol:.3e}) ms={ms[v]:.4f} plain_ms={plain_ms:.4f} "
                f"library_ms=null bound_ms={b_ms:.4f} ({b_by})")
            if dt == torch.float32:   # what the main path's route check runs
                records[v] = {"max_abs_err": err, "ms": ms[v],
                              "plain_ms": plain_ms, "bound_ms": b_ms,
                              "bound_by": b_by, "library_ms": None}
    records["dequant"]["launches"] = quant_matmul.launches_dequant
    # ---
    say(f"[kernel] quant_matmul variant benchmark: dequant launched "
        f"{quant_matmul.launches_dequant} times")
    return records["int8dot"], records["dequant"]


def check_flash_attention(cfg) -> dict:
    """flash_attention (through ops.attention_prefill, GQA read in the
    kernel) against its plain version at qwen3-8b's heads: the teacher's
    prefill (B 16 x S 512) and a ragged S (B 1 x S 300), f32 and bf16,
    causal and not, within the reference's own tolerances (f32 rtol 2e-4
    atol 2e-5; bf16 3e-2); then two runs' bits compared.  Returns the
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
    for (B, S) in ((16, 512), (1, 300)):
        base = [torch.randn((B, S, h, hd), generator=g, device=dev)
                for h in (H, Hkv, Hkv)]
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = (t.to(dt) for t in base)
            rtol, atol = (2e-4, 2e-5) if dt == torch.float32 else (3e-2, 3e-2)
            for causal in (True, False):
                out = attention_prefill(q, k, v, causal=causal)
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
                kind = "f32" if dt == torch.float32 else "bf16"
                ms = time_ms(lambda: attention_prefill(q, k, v,
                                                       causal=causal), iters=10)
                plain_ms = time_ms(lambda: attention_prefill_ref(
                    q, k, v, causal=causal), iters=5)
                qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
                lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, enable_gqa=True), iters=10)
                elt = q.element_size()
                nbytes = elt * hd * B * S * (2 * H + 2 * Hkv)
                pairs = S * (S + 1) // 2 if causal else S * S
                b_ms, b_by = bound(nbytes, 4.0 * B * H * pairs * hd, kind)
                say(f"[kernel] flash_attention B={B} S={S} H={H} Hkv={Hkv} "
                    f"hd={hd} {kind} causal={causal} max_abs_err={err:.3e} "
                    f"(rtol {rtol} atol {atol}) ms={ms:.4f} plain_ms="
                    f"{plain_ms:.4f} library_ms={lib_ms:.4f} "
                    f"bound_ms={b_ms:.4f} ({b_by})")
                if (B, S, kind, causal) == (16, 512, "bf16", True):
                    record = {"max_abs_err": err, "ms": ms,
                              "plain_ms": plain_ms, "bound_ms": b_ms,
                              "bound_by": b_by, "library_ms": lib_ms}
                del out, ref, diff
        del base, q, k, v
    # the reference's own [BH, S, hd] signature, on one small f32 case
    q3, k3, v3 = (torch.randn((4, 200, 64), generator=g, device=dev)
                  for _ in range(3))
    ref3 = flash_attention_ref(q3, k3, v3)
    excess = float(((flash_attention(q3, k3, v3) - ref3).abs()
                    - 2e-4 * ref3.abs()).max())
    if not excess <= 2e-5:
        fail(f"flash_attention [BH, S, hd]: beyond rtol 2e-4 + atol 2e-5 by "
             f"{excess - 2e-5}")
    torch.cuda.empty_cache()
    return record


def check_fake_quant(cfg) -> dict:
    """fake_quant forward (bit-equal) and both backward rules (gx bit-equal,
    gs bit-equal when elementwise, else within 1e-5 x max|ref|) against the
    plain versions, at the shapes the train path gives it."""
    import torch
    from repro_torch.kernels.fake_quant import (fake_quant_bwd,
                                                fake_quant_fwd)
    from repro_torch.kernels.ref import fake_quant_grad_ref, fake_quant_ref
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
        gy = torch.randn((R, C), generator=g, device=dev)
        y = fake_quant_fwd(x, s, bits)
        torch.cuda.synchronize()
        if not torch.equal(y, fake_quant_ref(x, s, bits)):
            fail(f"fake_quant {name}: forward differs from the plain version")
        err = 0.0
        for rule in ("kernel", "ste"):
            gx, gs = fake_quant_bwd(gy, x, s, bits, rule)
            rx, rs = fake_quant_grad_ref(gy, x, s, bits, rule)
            torch.cuda.synchronize()
            if not torch.equal(gx, rx):
                fail(f"fake_quant {name} {rule}: gx differs from the plain "
                     f"version")
            e = float((gs - rs).abs().max())
            tol = 0.0 if kind == "full" else 1e-5 * float(rs.abs().max())
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
        # forward: x read, y written, the scale read; backward: g and x
        # read, gx written, the scale read and gs written
        f_ms, f_by = bound(8 * n + 4 * ns, 4 * n, "f32")
        b_ms, b_by = bound(12 * n + 8 * ns, 8 * n, "f32")
        lib_ms = None
        if kind == "row":             # one PyTorch call: the per-channel
            xl = x.clone().requires_grad_()       # learnable fake-quant
            sl = s[:, 0].clone().requires_grad_()
            zl = torch.zeros_like(sl)

            def lib():
                out = torch._fake_quantize_learnable_per_channel_affine(
                    xl, sl, zl, 0, -qmax, qmax, 1.0)
                torch.autograd.grad(out, (xl, sl), gy)
            lib_ms = time_ms(lib, iters=10)
            del xl, sl, zl
        say(f"[kernel] fake_quant {name} R={R} C={C} {kind} scale {bits}b "
            f"max_abs_err={err:.3e} fwd ms={fwd_ms:.4f} plain_ms="
            f"{pfwd_ms:.4f} bound_ms={f_ms:.4f} ({f_by}); bwd(ste) ms="
            f"{bwd_ms:.4f} plain_ms={pbwd_ms:.4f} bound_ms={b_ms:.4f} "
            f"({b_by}); library_ms(fwd+bwd)="
            f"{'null' if lib_ms is None else f'{lib_ms:.4f}'}")
        if kind == "row":             # the largest K3 call of the train path
            record = {"max_abs_err": err, "ms": fwd_ms + bwd_ms,
                      "plain_ms": pfwd_ms + pbwd_ms, "bound_ms": f_ms + b_ms,
                      "bound_by": "bytes" if "bytes" in (f_by, b_by)
                      else "operations", "library_ms": lib_ms}
        del x, s, gy, y
        torch.cuda.empty_cache()
    return record


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


def _profile(run, what: str, steps: int, watch: tuple = ()) -> None:
    """Run ``run()`` (``steps`` steps of work) under torch.profiler: the
    device's busy share of the window, the kernels by device time, and the
    share of each ``watch`` name (kernels whose name holds it)."""
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
    rows = []                             # device-side events only
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
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
    _profile(run, "decode steps, 8 live slots", steps)


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
    say(f"[main] {cfg.name} full width: {cfg.n_layers} layers d={cfg.d_model} "
        f"heads={cfg.n_heads}/{cfg.n_kv_heads} ff={cfg.d_ff} vocab={cfg.vocab};"
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
    quant_matmul.launches = 0
    check = kernel_route_check(exported, plan)
    engine = Engine.from_artifact(cfg, plan, exported, scfg)
    timing: dict = {}
    t0 = time.perf_counter()
    toks = _serve(engine, reqs, timing)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"decode_attention": decode_attention.launches,
                "quant_matmul": quant_matmul.launches}
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
        f"(= {cfg.n_layers} x {steps}) quant_matmul="
        f"{launches['quant_matmul']}")
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
    for a, b in zip(toks, ptoks):
        if a != b:
            i = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
            say(f"[main]   first difference at token {i}: {a} vs {b}")
    return launches


# ---------------------------------------------------------------------------
# phase 6: the train path at full width
# ---------------------------------------------------------------------------

def _counts() -> dict:
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.fake_quant import fake_quant_kernel
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.quant_matmul import quant_matmul
    return {"fake_quant_fwd": fake_quant_kernel.launches_fwd,
            "fake_quant_bwd": fake_quant_kernel.launches_bwd,
            "quant_matmul": quant_matmul.launches,
            "quant_matmul_dequant": quant_matmul.launches_dequant,
            "decode_attention": decode_attention.launches,
            "flash_attention": flash_attention.launches}


def _zero_counts() -> None:
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.fake_quant import fake_quant_kernel
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.quant_matmul import quant_matmul
    fake_quant_kernel.launches_fwd = fake_quant_kernel.launches_bwd = 0
    quant_matmul.launches = quant_matmul.launches_dequant = 0
    decode_attention.launches = flash_attention.launches = 0


def _gib() -> float:
    import torch
    return torch.cuda.max_memory_allocated() / 2**30


def train_path(cfg) -> dict:
    """QFT at full width, 4 layers: prepare, 6 steps, the plain-route
    comparison, export and serve.  Returns the kernels' launch counts."""
    import torch
    from repro_torch.core import dof
    from repro_torch.core.qconfig import QuantConfig
    from repro_torch.data.calib import CalibConfig, CalibDataset
    from repro_torch.models import forward, init_model
    from repro_torch.models.transformer import layer_slice
    from repro_torch.serve.deploy import (export_for_layers,
                                          kernel_route_check,
                                          make_deploy_plan)
    from repro_torch.serve.engine import Engine, Request, ServeConfig
    from repro_torch.train.qft_trainer import QFTConfig, QFTTrainer
    from repro_torch.train.steps import make_value_and_grad
    from repro_torch.tree import tree_items
    cfg = dataclasses.replace(cfg, n_layers=TRAIN_LAYERS)
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
    trainer = QFTTrainer(cfg, qcfg, teacher, QFTConfig(),
                         steps_per_epoch=data.steps_per_epoch,
                         microbatches=TRAIN_MICROBATCHES)

    # --- the path, with every kernel count at 0 just before it
    _zero_counts()
    student = trainer.prepare_student(1, [next(calib) for _ in range(2)])
    torch.cuda.synchronize()
    t_prep = time.perf_counter() - t0
    peak_prep = _gib()
    say(f"[train] {cfg.name} full width, {L} of 36 layers ({n_params / 1e9:.3f}"
        f" B parameters): teacher + prepare_student (calibration on 2 "
        f"batches, APQ/MMSE init) {t_prep:.1f} s, peak {peak_prep:.2f} GiB")
    if _counts()["fake_quant_fwd"]:
        fail("prepare_student launched fake_quant: the teacher is FP")
    prep_fa = _counts()["flash_attention"]
    if prep_fa != 2 * L:          # the teacher over 2 calibration batches
        fail(f"calibration launched flash_attention {prep_fa} times, want "
             f"{2 * L}")
    torch.cuda.reset_peak_memory_stats()
    student, hist = trainer.run(student, data, steps=TRAIN_STEPS, log_every=1)
    torch.cuda.synchronize()
    peak_run = _gib()
    losses = [h["loss"] for h in hist]
    ts = [h["t"] for h in hist]
    step_ms = [1e3 * (b - a) for a, b in zip([0.0] + ts[:-1], ts)]
    per_fwd = 1 + 7 * L           # embed + 7 linears a layer; no lm_head
    want = TRAIN_STEPS * TRAIN_MICROBATCHES * per_fwd
    run_counts = _counts()
    say(f"[train] {TRAIN_STEPS} steps, batch {TRAIN_DATA['batch_size']} x "
        f"{TRAIN_DATA['seq_len']} in {TRAIN_MICROBATCHES} microbatches: "
        f"loss {', '.join(f'{x:.6f}' for x in losses)}; ms/step "
        f"{', '.join(f'{x:.1f}' for x in step_ms)} (steps 2-{TRAIN_STEPS} "
        f"mean {sum(step_ms[1:]) / (len(step_ms) - 1):.1f}); peak "
        f"{peak_run:.2f} GiB")
    fa_want = TRAIN_STEPS * TRAIN_MICROBATCHES * L
    say(f"[train] fake_quant launches forward {run_counts['fake_quant_fwd']} "
        f"backward {run_counts['fake_quant_bwd']} (= {TRAIN_STEPS} steps x "
        f"{TRAIN_MICROBATCHES} microbatches x (1 embed + 7 x {L} linears); "
        f"lm_head is not run: the backbone-L2 loss never reads it); "
        f"flash_attention (the teacher) {prep_fa} in calibration + "
        f"{run_counts['flash_attention'] - prep_fa} in the steps (= "
        f"{TRAIN_STEPS} x {TRAIN_MICROBATCHES} x {L} layers)")
    if run_counts["flash_attention"] - prep_fa != fa_want:
        fail(f"the steps launched flash_attention "
             f"{run_counts['flash_attention'] - prep_fa} times, want "
             f"{fa_want}")
    if len(losses) != TRAIN_STEPS or not all(map(math.isfinite, losses)):
        fail(f"train losses {losses}")
    if (run_counts["fake_quant_fwd"], run_counts["fake_quant_bwd"]) != (
            want, want):
        fail(f"fake_quant launched {run_counts['fake_quant_fwd']} forward / "
             f"{run_counts['fake_quant_bwd']} backward, want {want} each")

    # --- export the trained student and serve it
    plan = make_deploy_plan(qcfg, arch=cfg.name, family=cfg.family,
                            params=student, model_cfg=cfg)
    exempt = sorted(plan._plan().exempt_names)
    if exempt:                    # trained on the role ladder's grid
        fail(f"the export plan exempts {exempt}: not the trained grid")
    with torch.no_grad():
        exported = export_for_layers(student, plan, device=DEVICE)
        lp0 = layer_slice(student["layers"], 0)
        w_eff = dof.effective_weight(lp0["attn"]["wq"], qcfg,
                                     lp0["attn"]["in_stream"]["log_sa"],
                                     compute_dtype=torch.float32)
        w_dq = dof.dequantize_export(
            layer_slice(exported["layers"]["attn"]["wq"], 0), torch.float32)
        parity = float((w_eff - w_dq).abs().max())
        w_max = float(w_eff.abs().max())
    del w_eff, w_dq
    if parity > 1e-6 * w_max:
        fail(f"export parity: layer 0 wq dequantized export vs the trained "
             f"effective weight, max err {parity}")
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
    say(f"[train] export parity (layer 0 wq) {parity:.3e}; "
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
    hidden = {}
    with torch.no_grad():
        for use in (True, False):
            before = _counts()["flash_attention"]
            hidden[use] = forward(teacher, cfg, None, batch, use_kernels=use,
                                  logits=False)
            if _counts()["flash_attention"] - before != (L if use else 0):
                fail(f"teacher forward (use_kernels={use}) launched "
                     f"flash_attention {_counts()['flash_attention'] - before}"
                     f" times over {L} layers")
    hk, hp = hidden[True]["hidden"].float(), hidden[False]["hidden"].float()
    hid_rel = float((hk - hp).norm() / hp.norm())
    del hk, hp
    say(f"[train] teacher hidden states, flash_attention vs the plain route "
        f"(bf16 compute, batch {TRAIN_DATA['batch_size']} x "
        f"{TRAIN_DATA['seq_len']}): rel L2 {hid_rel:.3e} (bound "
        f"{TEACHER_HIDDEN_BOUND:.0e}: the plain route rounds the "
        f"probabilities to bf16 before P.V, the kernel keeps them f32)")
    if not hid_rel <= TEACHER_HIDDEN_BOUND:
        fail(f"teacher hidden states: kernel vs plain route rel L2 {hid_rel}")
    targets = hidden[True]
    del hidden
    vg = make_value_and_grad(cfg, qcfg, microbatches=TRAIN_MICROBATCHES)
    _profile(lambda: vg(student, teacher, batch), "train-step forward+"
             "backward (kernel route, teacher included, 4 microbatches, no "
             "optimizer)", 1, watch=("fa_kernel", "fq_"))
    grads = {}
    for use in (True, False):
        before = _counts()
        vg = make_value_and_grad(cfg, qcfg, microbatches=TRAIN_MICROBATCHES,
                                 use_kernels=use)
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
    say(f"[train] step {TRAIN_STEPS + 1}, kernel vs plain route: loss "
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

def _pipeline_run(pcfg, adapter, tag: str) -> dict:
    """run_pipeline with every kernel count at 0 just before it; the
    launches of each stage are read off the counts at its log line."""
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
    for stage, c in per_stage.items():
        say(f"[pipeline] {tag}: {stage} launches " + ", ".join(
            f"{k}={v}" for k, v in c.items() if v))
    return out


def pipeline_path(cfg) -> dict:
    """python -m repro_torch quantize's path (run_pipeline) at full width,
    depth cut to 4 layers, in a temporary workdir; then again on the same
    workdir, which must skip the student stages and reproduce evaluate.
    Returns the first run's launch counts."""
    import tempfile
    from repro_torch.pipeline import STAGES, PipelineConfig
    from repro_torch.pipeline.adapters import TransformerAdapter
    from repro_torch.train.checkpoint import CheckpointManager
    cfg4 = dataclasses.replace(cfg, n_layers=TRAIN_LAYERS)
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
        say(f"[pipeline] {cfg.name} full width, {TRAIN_LAYERS} of "
            f"{cfg.n_layers} layers, mode {pcfg.mode}: {PIPELINE}")
        runs = [_pipeline_run(pcfg, TransformerAdapter(
            pcfg, cfg4, pcfg.quant_config()), tag) for tag in ("run 1",
                                                                "run 2")]
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
    if first["run"] != list(STAGES) or first["skipped"]:
        fail(f"pipeline run 1 ran {first['run']}, skipped {first['skipped']}")
    if len(losses) != PIPELINE["steps"] or not all(map(math.isfinite,
                                                       losses)):
        fail(f"pipeline finetune losses {losses}")
    for stage in ("calibrate", "finetune", "evaluate"):
        if first["per_stage"][stage]["flash_attention"] < 1:
            fail(f"flash_attention did not launch in {stage}")
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


def main() -> int:
    if not (SRC / "repro_torch" / "csrc").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             f"a checkout of the repository")
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    sys.path.insert(0, str(SRC))
    from repro_torch.configs.qwen3_8b import CONFIG
    from repro_torch.serve.engine import ServeConfig
    from repro_torch.serve.kv_cache import resolve_kv_spec
    t_start = time.perf_counter()
    probe()
    build()
    fd = check_decode_attention(
        resolve_kv_spec(CONFIG, ServeConfig(**MAIN_SERVE)).view_len)
    qmm, qmm_dequant = check_quant_matmul(CONFIG)
    fq = check_fake_quant(CONFIG)
    fa = check_flash_attention(CONFIG)
    check_reference()
    launches = main_path(CONFIG)
    train = train_path(CONFIG)
    pipeline = pipeline_path(CONFIG)
    kernels = [
        {"name": "decode_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/decode_attention.cu",
         "replaces": "src/repro/kernels/decode_attention.py:60",
         "launches": launches["decode_attention"], **fd},
        {"name": "quant_matmul", "route": "cuda",
         "source": "src/repro_torch/csrc/quant_matmul.cu",
         "replaces": "src/repro/kernels/quant_matmul.py:67",
         "launches": launches["quant_matmul"], **qmm},
        {"name": "fake_quant", "route": "cuda",
         "source": "src/repro_torch/csrc/fake_quant.cu",
         "replaces": "src/repro/kernels/fake_quant.py:24",
         "launches": train["fake_quant_fwd"] + train["fake_quant_bwd"],
         "launches_fwd": train["fake_quant_fwd"],
         "launches_bwd": train["fake_quant_bwd"], **fq},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:24",
         "launches": pipeline["flash_attention"], **fa},
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
