#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. probe — the card's name and power limit, torch/CUDA/nvcc versions;
   TF32 off for matmuls and cuDNN.
2. build — every CUDA source in src/repro_torch/csrc, one nvcc each, all
   started together.
3. kernels — each kernel against its plain PyTorch version at the shapes
   the main path gives it (decode_attention at the engine's slot pool and
   paged view, bf16 and int8; quant_matmul at qwen3-8b's seven linear
   shapes, decode and prefill M, channel and group:128), with the error,
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

MAIN_PROMPTS = (17, 130, 300, 1000)
NEW_TOKENS = 16
MAIN_SERVE = dict(max_slots=8, max_len=2048, prefill_chunk=128)
MARGIN_ULPS = 4


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


def check_quant_matmul(cfg) -> dict:
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
    record = None
    for name, M, dt, layout in cases:
        K, N = shapes[name]
        x = torch.randn((M, K), generator=g, device=dev).to(dt)
        q4 = torch.randint(-8, 8, (K, N), generator=g, device=dev,
                           dtype=torch.int8)
        qw = pack_int4(q4, axis=0).contiguous()
        s_wl = torch.rand((K,), generator=g, device=dev) + 0.5
        swr_shape = (N,) if layout == "channel" else (K // 128, N)
        s_wr = (torch.rand(swr_shape, generator=g, device=dev) + 0.5) * 0.01
        args = (x, qw, s_wl, s_wr)
        y = quant_matmul(*args)
        ref = quant_matmul_ref(*args)
        torch.cuda.synchronize()
        err = float((y.float() - ref.float()).abs().max())
        scale = float(ref.float().abs().max())
        # f32: summation order only; bf16: one rounding of the f32 result
        tol = (5e-5 if dt == torch.float32 else 1e-2) * scale
        if not math.isfinite(err) or err > tol:
            fail(f"quant_matmul {name} M={M} {layout}: max_abs_err {err} > "
                 f"{tol}")
        ms = time_ms(lambda: quant_matmul(*args))
        plain_ms = time_ms(lambda: quant_matmul_ref(*args))
        nbytes = (x.numel() * x.element_size() + qw.numel() + 4 * K
                  + 4 * s_wr.numel() + M * N * x.element_size())
        b_ms, b_by = bound(nbytes, 2.0 * M * K * N,
                           "f32" if dt == torch.float32 else "bf16")
        say(f"[kernel] quant_matmul {name} M={M} K={K} N={N} {layout} "
            f"{str(dt).split('.')[-1]} max_abs_err={err:.3e} (tol {tol:.3e}) "
            f"ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms=null "
            f"bound_ms={b_ms:.4f} ({b_by})")
        if dt == torch.float32:     # what the main path's route check runs
            record = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
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


def profile_decode(engine, cfg, steps: int = 4) -> None:
    """Trace a few steady decode steps (8 live slots) with torch.profiler:
    the device's busy share of the window and the kernels by device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve.engine import Request
    engine.reset()
    rng = torch.Generator().manual_seed(5)
    for _ in range(engine.scfg.max_slots):
        engine.submit(Request(prompt=torch.randint(
            0, cfg.vocab, (64,), generator=rng).tolist(),
            max_new_tokens=steps + 4))
    engine.step()                         # admit, prefill, install, decode
    engine.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.step()
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
    say(f"[profile] {steps} decode steps, 8 live slots: wall "
        f"{wall_us / steps / 1e3:.3f} ms/step, device busy "
        f"{busy / steps / 1e3:.3f} ms/step ({100 * busy / wall_us:.1f}% of "
        f"the window), {sum(r[1] for r in rows) // steps} kernel launches/step")
    for dev_us, count, key in rows[:8]:
        say(f"[profile]   {100 * dev_us / busy:5.1f}% {dev_us / steps:9.1f} "
            f"us/step x{count // steps:<4d} {key[:90]}")


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
    qmm = check_quant_matmul(CONFIG)
    check_reference()
    launches = main_path(CONFIG)
    kernels = [
        {"name": "decode_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/decode_attention.cu",
         "replaces": "src/repro/kernels/decode_attention.py:60",
         "launches": launches["decode_attention"], **fd},
        {"name": "quant_matmul", "route": "cuda",
         "source": "src/repro_torch/csrc/quant_matmul.cu",
         "replaces": "src/repro/kernels/quant_matmul.py:67",
         "launches": launches["quant_matmul"], **qmm},
    ]
    say(f"[done] {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
