"""The numbers that decide ``correct``: what the timed path produced against
the plain reference (``perfbench/reference/decoder.py``) on the same inputs
and the same weights, drawn again from the seed after the program is gone.

* Prefill: each position's logits, as the relative distance
  ||program - reference|| / ||reference|| over the vocabulary, over every
  position of the calls checked: the mean (``logit_err_mean``: the
  precision the output was computed in, or rows or calls gone wrong), the
  median, the 99.9th percentile (``logit_err_p999``: a few positions gone
  wrong) and the largest (``logit_err_max``: one position gone wrong).
  With experts, the reference follows the program's routing, and the
  routing is judged apart: the share of the program's choices that are not
  among the reference's own k best (``route_flip_share``), and the
  assignments kept or dropped against the capacity rule
  (``drop_mismatch``).

``control=True`` puts the reference computed in float8 (e4m3, per-row
scales) in the program's place: the lower precision that would tempt a
later change, which these numbers must fail.
"""

from __future__ import annotations

import torch

from perfbench.reference import decoder as R
from perfbench.weights import Weights

BLOCK = 512


def prefill_numbers(cfg: dict, calls, seed: int, device,
                    control: bool = False, dtype=torch.bfloat16) -> dict:
    """``calls``: (tokens (B, S), the program's logits (B, S, V), its
    routing: one (experts, kept) per expert layer, or None without experts)
    of each checked call -> {"logit_err_mean", "logit_err_med",
    "logit_err_p999", "logit_err_max"}, and with experts
    {"route_flip_share", "drop_mismatch"}: the reference follows the
    routing it judges (a choice flipped at a near-tie under rounding would
    otherwise change a token's whole output), and ``reference.decoder.
    judge_routing`` holds that routing against its own. With ``control``
    the float8 reference, its own routing recorded, stands in for the
    program."""
    w = Weights(cfg, seed, device, dtype)
    head = w.top("lm_head")
    errs, judge = [], {}
    for tokens, out, routing in calls:
        hc = None
        if control:
            rec = [] if routing is not None else None
            hc = R.hidden(cfg, w, tokens, mm=R.fp8, record=rec).flatten(0, 1)
            routing = rec
        h = R.hidden(cfg, w, tokens, routing=routing,
                     judge=judge).flatten(0, 1)
        prog = None if control else out.flatten(0, 1)
        for s0 in range(0, h.shape[0], BLOCK):
            ref = R.logits(head, h[s0:s0 + BLOCK])
            got = R.logits(head, hc[s0:s0 + BLOCK], R.fp8) if control \
                else prog[s0:s0 + BLOCK].float()
            errs.append(torch.linalg.vector_norm(got - ref, dim=-1)
                        / torch.linalg.vector_norm(ref, dim=-1))
        del h, hc, prog
    e = torch.cat(errs)
    q = torch.quantile(e, torch.tensor([0.5, 0.999], device=e.device))
    out = {"logit_err_mean": float(e.mean()), "logit_err_med": float(q[0]),
           "logit_err_p999": float(q[1]), "logit_err_max": float(e.max())}
    if judge:
        out["route_flip_share"] = judge["route_flips"] / judge["route_choices"]
        out["drop_mismatch"] = judge["drop_mismatch"]
    return out

