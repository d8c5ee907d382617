"""The SQ8 quantization rule, frozen, and the control's int4 rule.

A copy of the per-row rule of ``repro_torch.core.ivf.quantize_index``
(per-vector symmetric int8: ``scale = max |v| / 127``, ``v_int8 =
clamp(round(v / scale), -127, 127)``, ``score = (q . v_int8) * scale``),
applied to the rows as the generator makes them, so that the reference
works the int8 rows and scales out again.  The rule is elementwise along a
row, so applying it cluster by cluster gives the bits that the program's
chunks of clusters give.
"""

from __future__ import annotations

import torch


def quantize(rows: torch.Tensor, levels: int = 127):
    """``rows [..., D]`` -> ``(codes [..., D] f32 holding integers in
    [-levels, levels], scales [...] f32)``.  ``levels=127`` is SQ8;
    ``levels=7`` is the control's int4."""
    v32 = rows.float()
    s = torch.clamp(v32.abs().amax(-1), min=1e-12)
    # a tensor divisor: the card divides exactly (by a Python scalar it would
    # multiply by the reciprocal)
    s = s / torch.full_like(s, float(levels))
    codes = torch.clamp(torch.round(v32 / s[..., None]), -levels, levels)
    return codes, s
