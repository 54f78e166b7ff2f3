"""Empirical bias correction (paper [29], used in Table 2 baselines).

Zeroes the 1st moment of the per-channel quantization error at each linear's
output by shifting the bias:  b ← b + E[x@W − x̂@Ŵ]  over a calibration batch.

Implemented generically: the caller's forwards expose per-linear output
taps; teacher and student run on the same batch and the mean difference is
folded into the student's bias DoF.
"""
from __future__ import annotations

import copy
from typing import Callable

import torch


def bias_correct(taps_fp: dict[str, torch.Tensor],
                 taps_q: dict[str, torch.Tensor], params: dict,
                 path_map: dict[str, tuple]) -> dict:
    """Fold E[fp_out − q_out] (over all leading axes) into each linear's bias.

    ``path_map``: tap name → key path of the qlinear's params dict inside
    ``params`` (a missing ``b`` is created).  Returns updated params: the
    nodes on each path are copied, the input tree is left as it was.
    """
    new = copy.copy(params)

    def set_in(tree, path, fn):
        node = tree
        for k in path[:-1]:
            node[k] = copy.copy(node[k])
            node = node[k]
        node[path[-1]] = copy.copy(node[path[-1]])
        node[path[-1]]["b"] = fn(node[path[-1]].get("b"))
        return tree

    for name, path in path_map.items():
        if name not in taps_fp:
            continue
        diff = (taps_fp[name].to(torch.float32)
                - taps_q[name].to(torch.float32))
        corr = torch.mean(diff.reshape(-1, diff.shape[-1]), dim=0)
        new = set_in(new, path,
                     lambda b, c=corr: c if b is None else b + c)
    return new


def empirical_bias_correction(forward_fp: Callable, forward_q: Callable,
                              params_fp, params_q, batch,
                              path_map: dict[str, tuple]) -> dict:
    """Convenience wrapper: run both nets with taps and correct the biases."""
    _, taps_fp = forward_fp(params_fp, batch)
    _, taps_q = forward_q(params_q, batch)
    return bias_correct(taps_fp, taps_q, params_q, path_map)
