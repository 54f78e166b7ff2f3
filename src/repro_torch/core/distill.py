"""Knowledge-distillation losses for the QFT regime (paper §3.1, Fig. 6).

Default: normalized L2 on the backbone output (the last hidden states).
Cross-entropy on logits is a mix-in for the Fig. 6 ablation only.  The
teacher's tensors are detached: no gradient reaches the teacher.
"""
from __future__ import annotations

import torch


def backbone_l2(h_student: torch.Tensor, h_teacher: torch.Tensor,
                mask: torch.Tensor | None = None) -> torch.Tensor:
    """||h_S − h_T||² / ||h_T||²  (normalized; per-token, masked mean)."""
    h_s = h_student.to(torch.float32)
    h_t = h_teacher.detach().to(torch.float32)
    err = torch.sum((h_s - h_t) ** 2, dim=-1)
    ref = torch.sum(h_t ** 2, dim=-1) + 1e-6
    per_tok = err / ref
    if mask is not None:
        per_tok = per_tok * mask
        return torch.sum(per_tok) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(per_tok)


def logits_ce(logits_student: torch.Tensor, logits_teacher: torch.Tensor,
              mask: torch.Tensor | None = None,
              temperature: float = 1.0) -> torch.Tensor:
    """Classic KD: cross-entropy of student logits vs teacher soft targets."""
    zs = logits_student.to(torch.float32) / temperature
    zt = logits_teacher.detach().to(torch.float32) / temperature
    pt = torch.softmax(zt, dim=-1)
    ce = -torch.sum(pt * torch.log_softmax(zs, dim=-1), dim=-1)
    if mask is not None:
        ce = ce * mask
        return torch.sum(ce) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(ce)


def qft_loss(h_student: torch.Tensor, h_teacher: torch.Tensor,
             logits_student: torch.Tensor | None = None,
             logits_teacher: torch.Tensor | None = None,
             ce_proportion: float = 0.0,
             mask: torch.Tensor | None = None) -> torch.Tensor:
    """Paper default: pure backbone L2 (``ce_proportion = 0``); Fig. 6 mixes
    CE in."""
    loss = backbone_l2(h_student, h_teacher, mask)
    if ce_proportion > 0.0:
        if logits_student is None or logits_teacher is None:
            raise ValueError("ce_proportion > 0 needs both logits")
        ce = logits_ce(logits_student, logits_teacher, mask)
        loss = (1.0 - ce_proportion) * loss + ce_proportion * ce
    return loss
