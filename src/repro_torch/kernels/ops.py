"""The deployed linear over an exported (nibble-packed) artifact leaf, the
fused fake-quant and the cache-free prefill attention: the layout shims
between the model code and the kernels."""
from __future__ import annotations

import torch

from . import ref
from ._library import on_card
from .fake_quant import fake_quant_kernel
from .flash_attention import attention_prefill
from .quant_matmul import (quant_matmul, quant_matmul_int8,
                           tiles_ok as kernel_tiles_ok)

__all__ = ["attention_prefill", "fused_fake_quant", "kernel_tiles_ok",
           "qlinear_deployed"]


def qlinear_deployed(x: torch.Tensor, export: dict, use_kernels: bool = True,
                     plan=None) -> torch.Tensor:
    """``y = x @ dequant(export) (+b)``; x ``[..., K]``, export from
    ``core.dof.export_qlinear``.

    ``plan`` (a ``serve.deploy.DeployPlan``) overrides ``use_kernels``.  A
    packed int4 leaf whose shape passes :func:`kernel_tiles_ok` goes through
    ``quant_matmul`` (the CUDA kernel for CUDA tensors).  On the card
    another shape goes through K1's int8 entry, which reads the packed
    nibbles in place: the JAX package's Pallas blocks, clamped to each
    dim, take shapes whose N is under or off 64 (N 32 at SMOKE width) where
    this kernel's 64-column tiles do not, and there its route keeps the
    integer weight as the operand.  CPU tensors, and the plain route, take
    the plain version.  An int8 (exempt, unpacked) leaf goes through
    ``quant_matmul_int8``: the integer weight is the kernel's operand, with
    per-group partial sums and the scales hoisted, as the JAX package's
    integer ``dot_general`` (for CPU tensors, and on the plain route, the
    plain version, which widens the weight).
    """
    if plan is not None:
        use_kernels = plan.use_kernels
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    q = export["q"]
    s_wl = export.get("s_wl")
    if s_wl is None:
        s_wl = torch.ones((x.shape[-1],), dtype=torch.float32,
                          device=x.device)
    s_wr = export["s_wr"]
    if s_wr.ndim == 0:
        s_wr = torch.broadcast_to(s_wr, (q.shape[-1],)).contiguous()
    n_groups = s_wr.shape[0] if s_wr.ndim == 2 else None
    if q.dtype == torch.uint8:
        if use_kernels and kernel_tiles_ok(x2.shape[0], q.shape[-1],
                                           x2.shape[-1], n_groups):
            y = quant_matmul(x2, q, s_wl, s_wr)
        elif use_kernels and on_card(x2):
            y = quant_matmul_int8(x2, q, s_wl, s_wr)
        else:
            y = ref.quant_matmul_ref(x2, q, s_wl, s_wr)
    elif use_kernels:
        y = quant_matmul_int8(x2, q, s_wl, s_wr)
    else:
        y = ref.quant_matmul_int8_ref(x2, q, s_wl, s_wr)
    if "b" in export:
        y = y + export["b"].to(y.dtype)
    return y.reshape(*lead, -1)


def fused_fake_quant(x: torch.Tensor, scale: torch.Tensor, bits: int = 4,
                     use_kernels: bool = False) -> torch.Tensor:
    """``clip(round(x/s), ±qmax)·s``: a 2-D ``x`` with ``use_kernels`` goes
    through ``fake_quant_kernel`` (the CUDA kernel for CUDA tensors) with
    the reference kernel's gradient rule; otherwise the plain version."""
    if use_kernels and x.ndim == 2:
        return fake_quant_kernel(x, scale, bits, rule="kernel")
    return ref.fake_quant_ref(x, scale, bits)
