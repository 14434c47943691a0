"""The comparison that decides ``correct``: what the timed path produced
against the plain reference, each number against its limit.

Every answer the window produced, a page's logits over its valid boxes:
``logit_rel``, the largest relative gap of a page's logits,
the norm of the difference over the reference's norm; ``logit_err``, the
largest absolute gap of a valid box's logit against the largest reference
logit magnitude of its batch.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def serve_numbers(answers: List[Tuple[int, np.ndarray]],
                  ref: List[np.ndarray], valid: List[List[int]]) -> dict:
    """``answers``: (pool batch, logits [B, P, C]) of every request;
    ``ref``: the reference's logits of each pool batch; ``valid``: each
    pool batch's valid box counts. Returns ``logit_rel`` and
    ``logit_err``, and each answer's (``rels``, ``errs``)."""
    scale = []
    for j, r in enumerate(ref):
        scale.append(max(float(np.abs(r[i, :n]).max())
                         for i, n in enumerate(valid[j])))
    errs, rels = [], []
    for j, logits in answers:
        r = ref[j]
        worst = rel = 0.0
        for i, n in enumerate(valid[j]):
            if logits.shape != r.shape:
                worst = rel = float("inf")
                break
            d = logits[i, :n].astype(np.float64) - r[i, :n]
            worst = max(worst, float(np.abs(d).max()))
            rel = max(rel, float(np.linalg.norm(d) / max(
                np.linalg.norm(r[i, :n].astype(np.float64)), 1e-30)))
        errs.append(worst / scale[j])
        rels.append(rel)
    inf = float("inf")
    return {"logit_rel": max(rels) if rels else inf,
            "logit_err": max(errs) if errs else inf,
            "rels": rels, "errs": errs}


def judge(numbers: dict, limits: dict) -> Tuple[bool, Dict[str, dict]]:
    """Each limited number beside its limit, and whether all are within
    (a number that is not finite is not)."""
    checks = {}
    ok = True
    for name, limit in limits.items():
        value = float(numbers[name])
        checks[name] = {"value": value, "limit": limit}
        if not (np.isfinite(value) and value <= limit):
            ok = False
    return ok, checks
