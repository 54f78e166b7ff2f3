"""Paged int8 KV cache: page geometry, host page allocator, prefill buckets.

The serve engine stores decode KV in fixed-size **pages** drawn from one
shared per-layer pool instead of a monolithic ``[max_slots, max_len]``
preallocation.  Geometry:

- pools  ``k``/``v``: int8 ``[L, n_pages + 1, page, Hkv, hd]`` — one extra
  **trash page** (index ``n_pages``) at the end.  Unused page-table entries
  point at it, so the decode step's unconditional scatter write (every slot
  writes its current token, dead or alive) lands somewhere harmless without
  a branch on the host.
- page table ``pt``: int32 ``[max_slots, max_pages_per_slot]``, threaded
  through the forward like ``pos`` (shared across layers, excluded from the
  layer scan).
- scales ``k_scale``/``v_scale``: f32 ``[L, max_slots, Hkv]`` — per-layer,
  per-slot, per-kv-head.  Fitted by MMSE (PPQ) over the slot's prefill at
  install time, then frozen for the slot's lifetime; they ride the decode
  step as plain cache leaves, so the one-transfer invariant is untouched.

Pages are allocated **up front at admission** for the request's worst case
(``ceil((len(prompt) + max_new_tokens) / page)``): admission is the only
host decision point, so the decode step never needs to grow a slot, and
the one-transfer-per-step invariant holds trivially.

The same module owns the **prefill bucket menu** (powers of two up to the
configured chunk): every prompt piece is padded to one of a fixed set of
shapes.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..core.fakequant import quantize
from ..core.plan import KV_CACHE_FAMILIES as PAGED_KV_FAMILIES

@dataclasses.dataclass(frozen=True)
class KVSpec:
    """Resolved paged-KV geometry for one engine instance."""
    page_size: int            # tokens per page
    n_pages: int              # pool pages (excluding the trash page)
    max_pages_per_slot: int   # page-table width = ceil(max_len / page_size)
    kv_bits: int = 8          # only int8 is implemented

    @property
    def trash_page(self) -> int:
        """Write-sink page id: scatters through unused pt entries land here."""
        return self.n_pages

    @property
    def view_len(self) -> int:
        """Per-slot gathered KV length (``max_pages_per_slot * page_size``)."""
        return self.max_pages_per_slot * self.page_size

    def pages_for(self, n_tokens: int) -> int:
        return max(1, math.ceil(n_tokens / self.page_size))


def resolve_kv_spec(cfg, scfg, kv_bits: int = 8) -> KVSpec | None:
    """KVSpec for (model config, serve config), or None → monolithic cache.

    ``scfg.kv_pages == 0`` auto-sizes the pool to the capacity-equivalent
    default ``max_slots * ceil(max_len / page)`` — same worst-case token
    capacity as the monolithic layout, so paging alone never loses
    admission capacity; the win comes from int8 (2x vs bf16) and from
    requests that reserve fewer than ``max_pages_per_slot`` pages.
    """
    if scfg.kv_mode == "monolithic" or cfg.family not in PAGED_KV_FAMILIES:
        return None
    if scfg.kv_mode != "paged":
        raise ValueError(f"kv_mode must be 'paged' or 'monolithic', "
                         f"got {scfg.kv_mode!r}")
    if kv_bits == 0:
        return None
    if kv_bits != 8:
        raise ValueError(f"paged KV supports kv_bits=8 only, got {kv_bits}")
    page = int(scfg.kv_page_size)
    if page < 1:
        raise ValueError(f"kv_page_size must be >= 1, got {page}")
    per_slot = max(1, math.ceil(scfg.max_len / page))
    n_pages = int(scfg.kv_pages) or scfg.max_slots * per_slot
    return KVSpec(page_size=page, n_pages=n_pages,
                  max_pages_per_slot=per_slot, kv_bits=kv_bits)


def quantize_kv(x, scale):
    """Symmetric int8 encode of ``x`` by per-kv-head ``scale``.

    x: ``[..., Hkv, hd]`` float; scale: ``[..., Hkv]`` (broadcast over hd).
    Same grid as every other tensor class (core.fakequant, paper Eq. 1).
    """
    return quantize(x, scale[..., None], 8).to(torch.int8)


class PageAllocator:
    """Deterministic host-side free-list over the page pool.

    Mirrors the slot Scheduler's discipline: the free list is kept sorted
    descending so ``pop()`` hands out the lowest page id first — allocation
    order is a pure function of the admission sequence, which keeps the
    conformance tier's bit-identical batch-composition checks meaningful.
    """

    def __init__(self, n_pages: int):
        self.n_pages = int(n_pages)
        self.free = sorted(range(self.n_pages), reverse=True)

    def can_alloc(self, n: int) -> bool:
        return n <= len(self.free)

    def alloc(self, n: int) -> list[int]:
        if not self.can_alloc(n):
            raise RuntimeError(f"page pool exhausted: want {n}, "
                               f"have {len(self.free)}")
        return [self.free.pop() for _ in range(n)]

    def release(self, pages: list[int]) -> None:
        free = set(self.free)
        for p in pages:
            if not 0 <= p < self.n_pages:
                raise ValueError(f"page id {p} outside pool of "
                                 f"{self.n_pages}")
            if p in free:               # already free, or twice in `pages`
                raise ValueError(f"double free of page {p}")
            free.add(p)
        self.free.extend(pages)
        self.free.sort(reverse=True)

    @property
    def n_free(self) -> int:
        return len(self.free)


def prefill_buckets(chunk: int) -> tuple[int, ...]:
    """The fixed menu of prefill chunk lengths, ascending.

    Powers of two up to ``chunk`` plus ``chunk`` itself.  Every prompt
    piece is padded up to the smallest bucket that holds it, so the number
    of distinct prefill shapes is ``len(prefill_buckets(chunk))`` no matter
    what prompt lengths arrive.
    """
    chunk = max(1, int(chunk))
    menu = []
    b = 1
    while b < chunk:
        menu.append(b)
        b *= 2
    menu.append(chunk)
    return tuple(menu)


def bucket_for(n: int, chunk: int) -> int:
    """Smallest menu bucket holding ``n`` tokens (n must be ≤ chunk)."""
    for b in prefill_buckets(chunk):
        if n <= b:
            return b
    raise ValueError(f"chunk length {n} exceeds prefill_chunk {chunk}")
