"""Device-side stochastic decoding for the serving engine.

``sample_tokens`` maps ``(logits [S, V], seeds [S], counters [S],
temperature [S], top_k [S], top_p [S]) -> tokens [S]`` on the logits' device,
so the draw adds no host transfer to the decode step.  The knobs mean what
they mean in the JAX package: ``temperature == 0`` is exact greedy argmax;
``top_k`` keeps the k highest logits, ties at the k-th included; ``top_p``
keeps the smallest probability-sorted prefix whose mass reaches p, ties with
the boundary probability included.

Randomness.  The JAX package draws with threefry keys, which PyTorch does not
reproduce.  The port uses a per-slot counter-based chain instead: the
uniforms of a draw are a 32-bit integer hash of ``(seed, counter, token
index)``, turned into Gumbel noise for a Gumbel-argmax draw (the form of
``jax.random.categorical``).  The counter is the request's emission count,
so a request's k-th token depends only on its own ``(seed, k)`` and never on
what shares the batch.  Masks and greedy tokens agree with the JAX package;
sampled tokens agree only within the port.
"""
from __future__ import annotations

import torch

#: temperature floor for the scaled-logits path; greedy is selected by
#: ``temperature > 0``, so this only keeps the unused branch finite
_TEMP_FLOOR = 1e-6

_M32 = 0xFFFFFFFF


def top_k_mask(logits: torch.Tensor, k) -> torch.Tensor:
    """Logits below the k-th largest (per row) set to ``-inf``; ``k <= 0``
    or ``k >= vocab`` disables the mask.  ``k`` broadcasts over the leading
    dims."""
    v = logits.shape[-1]
    k = torch.as_tensor(k, dtype=torch.int64, device=logits.device)
    k = torch.broadcast_to(k, logits.shape[:-1])
    desc = torch.sort(logits, dim=-1, descending=True).values
    kth = torch.gather(desc, -1, torch.clamp(k - 1, 0, v - 1)[..., None])
    active = ((k > 0) & (k < v))[..., None]
    return torch.where(~active | (logits >= kth), logits,
                       torch.full_like(logits, float("-inf")))


def top_p_mask(logits: torch.Tensor, p) -> torch.Tensor:
    """Logits outside the top-p (nucleus) support set to ``-inf``; ``p >= 1``
    disables it, ``p <= 0`` keeps the single most probable token."""
    p = torch.as_tensor(p, dtype=logits.dtype, device=logits.device)
    p = torch.broadcast_to(p, logits.shape[:-1])[..., None]
    probs = torch.softmax(logits, dim=-1)
    sorted_p = torch.sort(probs, dim=-1, descending=True).values
    cum = torch.cumsum(sorted_p, dim=-1)
    prefix = (cum - sorted_p) < torch.clamp(p, min=_TEMP_FLOOR)
    p_min = torch.amin(torch.where(prefix, sorted_p,
                                   torch.full_like(sorted_p, float("inf"))),
                       dim=-1, keepdim=True)
    return torch.where((p >= 1.0) | (probs >= p_min), logits,
                       torch.full_like(logits, float("-inf")))


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A bijective 32-bit integer hash on int64 tensors holding values in
    [0, 2^32).  The multipliers stay below 2^31 so no product overflows."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x2C1B3C6D) & _M32
    return x ^ (x >> 16)


def gumbel_noise(seeds: torch.Tensor, counters: torch.Tensor,
                 n: int) -> torch.Tensor:
    """Gumbel(0, 1) noise ``[S, n]`` as a pure function of each row's
    ``(seed, counter)``."""
    base = _mix32(_mix32(seeds.to(torch.int64) & _M32)
                  ^ (counters.to(torch.int64) & _M32))
    idx = torch.arange(n, dtype=torch.int64, device=seeds.device)
    h = _mix32(base[:, None] ^ idx[None, :])
    u = ((h >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))   # (0, 1)
    return -torch.log(-torch.log(u))


def sample_tokens(logits: torch.Tensor, seeds: torch.Tensor,
                  counters: torch.Tensor, temperature: torch.Tensor,
                  top_k: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """One draw per row of ``logits [S, V]`` → int32 tokens ``[S]``."""
    temperature = temperature.to(torch.float32)
    greedy = torch.argmax(logits, dim=-1)
    scaled = (logits.to(torch.float32)
              / torch.clamp(temperature, min=_TEMP_FLOOR)[:, None])
    masked = top_p_mask(top_k_mask(scaled, top_k), top_p)
    drawn = torch.argmax(masked + gumbel_noise(seeds, counters,
                                               logits.shape[-1]), dim=-1)
    return torch.where(temperature > 0.0, drawn, greedy).to(torch.int32)
