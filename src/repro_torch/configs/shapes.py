"""Assigned input-shape set (LM transformer shapes, seq_len x global_batch).

decode_* / long_* lower ``serve_step`` (one new token against a KV/SSM cache
of seq_len), NOT ``train_step``. long_500k requires sub-quadratic attention
and is skipped for pure full-attention archs (recorded in DESIGN.md §4).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k":    ShapeCell("train_4k",    4_096,   256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  ShapeCell("decode_32k",  32_768,  128, "decode"),
    "long_500k":   ShapeCell("long_500k",   524_288, 1,   "decode"),
}


def applicable(arch_cfg, shape_name: str) -> tuple[bool, str]:
    """Assignment skip rules. Returns (runs, reason-if-skipped)."""
    cell = SHAPES[shape_name]
    if cell.name == "long_500k" and not arch_cfg.subquadratic:
        return False, ("long_500k requires sub-quadratic attention; "
                       f"{arch_cfg.name} is pure full-attention "
                       "(skip recorded in DESIGN.md §4)")
    return True, ""
