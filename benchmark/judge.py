"""The comparison that decides ``correct``: the program's set-up products
and the timed window's outputs, against the plain reference.

Every number is a reading where 0 is a perfect match and larger is
worse; a run is correct where each number is at most its cell's limit
(``limits/<workload>.json``) and no number is missing. What each compares:

- ``weight_codes_off``: int8 weight codes of the program's quantized
  params that differ from the reference's (an exact comparison);
- ``scales_gap``: the widest relative gap of a weight scale or an
  activation scale (the calibration) from the reference's;
- ``head_gap``: the widest gap of the float32 head over a sampled batch,
  as a share of the reference head's largest magnitude in that batch;
- the task's own numbers (``tasks/<task>.py``), such as the detections'.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

INT8 = 127.0            # qmax of the int8 codes every configuration states


def weight_numbers(prog: Sequence[Dict], ref: Sequence[Dict],
                   prog_scales: Sequence[float],
                   ref_scales: Sequence[float]) -> Dict[str, float]:
    """Program params ({"wq", "s_w", "b"} per layer, on the host) and
    activation scales against the reference's."""
    off, gap = 0, 0.0
    for p, r in zip(prog, ref):
        if not r:
            continue
        if not p or tuple(p["wq"].shape) != tuple(r["wq"].shape):
            return {"weight_codes_off": float("inf"),
                    "scales_gap": float("inf")}
        off += int((p["wq"].cpu() != r["wq"].cpu()).sum())
        rs = r["s_w"].cpu().double()
        gap = max(gap, float(((p["s_w"].cpu().double() - rs).abs()
                              / rs).max()))
    if len(prog_scales) != len(ref_scales):
        return {"weight_codes_off": float(off), "scales_gap": float("inf")}
    for a, b in zip(prog_scales, ref_scales):
        gap = max(gap, abs(a - b) / b)
    return {"weight_codes_off": float(off), "scales_gap": gap}


def head_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    if tuple(prog.shape) != tuple(ref.shape):
        return float("inf")
    p, r = prog.to(ref.device, torch.float64), ref.to(torch.float64)
    if not torch.isfinite(p).all():
        return float("inf")
    return float((p - r).abs().max() / r.abs().max().clamp_min(1e-30))


def verdict(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, [(name, value, limit)]): each limit's number is present
    and at most the limit."""
    rows: List = []
    ok = True
    for name, limit in limits.items():
        value = numbers.get(name)
        rows.append((name, value, limit))
        if value is None or not value <= limit:
            ok = False
    return ok, rows
