"""The comparison that decides ``correct``: what the served prefill
produced against the plain reference at the same position, over a sample
of the window's answered requests.

``logit_gap``: how far the served token's reference logit lies below the
reference's best, in units of the reference logits' standard deviation at
that position (0 when the program served the reference's own argmax),
widest over the sample. ``logit_err``: the largest distance of any of the
served logits from the reference's, in the same units, widest over the
sample. A cell compares those its file (``bench/workloads/<cell>.json``)
gives a limit, beside any exact counts its driver checks (limit 0)."""
from __future__ import annotations

import importlib
import time
from typing import Callable, Dict, List, Optional

import torch


def gap(ref: torch.Tensor, token: Optional[int]) -> float:
    """(max(ref) - ref[token]) / std(ref); inf for no token or one outside
    the vocabulary."""
    if token is None or not 0 <= int(token) < ref.numel():
        return float("inf")
    return float((ref.max() - ref[int(token)]) / ref.std())


def err(ref: torch.Tensor, logits: Optional[torch.Tensor]) -> float:
    """max |logits - ref| / std(ref); inf without logits."""
    if logits is None or logits.shape != ref.shape:
        return float("inf")
    return float((logits.float() - ref).abs().max() / ref.std())


def reference_gaps(ctx, sample, make_weights: Callable, control: bool = False) -> Dict:
    """Run the configuration's reference over each sampled request's prompt,
    a model instance at a time, and return the served tokens' gaps and the
    served logits' errors (``gaps``, ``errs``) and, with ``control``, the
    same of the fp8 control at the same positions (``control_gaps``: of
    the token it puts first; ``control_errs``)."""
    from reference.plain import tf32_off

    tf32_off()
    ref = importlib.import_module(f"reference.{ctx.conf['reference']}")
    out: Dict[str, List[float]] = {"gaps": [], "errs": [], "control_gaps": [],
                                   "control_errs": []}
    t0 = time.monotonic()
    by_instance: Dict[int, list] = {}
    for r in sample:
        by_instance.setdefault(r.instance, []).append(r)
    with torch.no_grad():
        for inst, reqs in sorted(by_instance.items()):
            tree = make_weights(inst)
            for r in reqs:
                toks = torch.as_tensor(r.tokens, dtype=torch.long, device=ctx.device)
                logits = ref.last_logits(tree, toks, ctx.sizes)
                out["gaps"].append(gap(logits, r.served))
                out["errs"].append(err(logits, r.logits))
                if control:
                    low = ref.last_logits(tree, toks, ctx.sizes, fp8_control=True)
                    out["control_gaps"].append(gap(logits, int(low.argmax())))
                    out["control_errs"].append(err(logits, low))
            del tree
    out["seconds"] = time.monotonic() - t0
    return out


def verdict(numbers: Dict[str, float], limits: Dict[str, Optional[float]]) -> bool:
    """Every number at or under its limit (a number without a limit, or a
    limit without a number, is not correct)."""
    if set(numbers) != set(limits):
        return False
    return all(limits[k] is not None and numbers[k] <= limits[k] for k in numbers)
