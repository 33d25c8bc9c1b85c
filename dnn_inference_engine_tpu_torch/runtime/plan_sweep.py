"""Measured per-layer plan strategy: the greedy whole-net sweep.

Counterpart of ``dnn_inference_engine_tpu/runtime/plan_sweep.py``:

    python -m dnn_inference_engine_tpu_torch.cli plan-sweep \
        --model yolov2-tiny --mode w8a8 --batch 32 --out strategy.json

Starting from the all-xla plan, it coordinate-descends over the conv
layers: each layer tries every legal kind (``candidate_entries``), keeps
the whole-net fastest (min-of-reps loop-difference timing,
runtime/benchlib.py), and records every measurement. In the artifact a
candidate whose plan is illegal is ``null``, one whose head diverges from
the all-xla head is ``"PARITY..."`` (a fast wrong kernel never wins) and
one that raised is ``"CRASHED: ..."``. ``EngineConfig.strategy`` (a path
to the artifact) makes ``Engine.prepare`` use the result.

Both quantized plans are swept: w8a8 and the weight-only w8, whose
candidates leave out the int8 kernel kinds (rs, rs2, the stems and
fold_xla_s2). The weights come from ``weights`` (a file the engine
loads) or from seed 0, the w8a8 scales from ``calib`` (calibration
images) or, for random weights only, the engine's uniform-noise
calibration, as in the JAX sweep.
"""

from __future__ import annotations

import json
import sys
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from dnn_inference_engine_tpu_torch.models.layers import Conv, MaxPool
from dnn_inference_engine_tpu_torch.runtime.plan import (
    _referenced_layers, build_plan, plan_forward_w8, plan_forward_w8a8,
    plan_input_uint8_ok, prepare_plan_params,
)

StrategyEntry = Tuple  # (kind, fold) or (kind, fold, opts)
Strategy = Dict[int, StrategyEntry]


def load_strategy(path: str) -> Strategy:
    """Read a strategy mapping from a sweep artifact (or a bare
    ``{li: [kind, fold, opts?]}`` JSON object)."""
    with open(path) as f:
        d = json.load(f)
    raw = d.get("strategy", d)
    out: Strategy = {}
    for k, v in raw.items():
        kind, fold = v[0], int(v[1])
        opts = v[2] if len(v) > 2 else {}
        out[int(k)] = (kind, fold, opts) if opts else (kind, fold)
    return out


def _strategy_jsonable(strategy: Strategy) -> Dict[str, list]:
    return {str(k): list(v) for k, v in sorted(strategy.items())}


def _cand_name(c: StrategyEntry) -> str:
    kind, fold = c[0], c[1]
    opts = c[2] if len(c) > 2 else {}
    s = f"{kind}:{fold}"
    if opts:
        s += ":" + ",".join(f"{k}={v}" for k, v in sorted(opts.items()))
    return s


def candidate_entries(model, li: int, mode: str,
                      quick: bool = False) -> List[StrategyEntry]:
    """Legal strategy entries for conv layer ``li``, as ``build_plan``
    constrains them: folds need the following 2x2/s2 MaxPool and an
    unreferenced pre-pool output; the fused stems and the f=4 entry folds
    need the 3-channel network input; the int8 kernel kinds (rs, rs2, the
    stems, fold_xla_s2) are offered in w8a8 only."""
    layers = model.layers
    layer = layers[li]
    assert isinstance(layer, Conv), li
    cands: List[StrategyEntry] = [("xla", 1)]
    int8_ok = mode == "w8a8"
    plain = layer.ksize == 3 and layer.stride == 1 and layer.padding == "SAME"
    if not quick:
        cands.append(("gemm", 1))
    nxt = li + 1
    pooled = (nxt < len(layers) and isinstance(layers[nxt], MaxPool)
              and layers[nxt].stride == 2 and layers[nxt].size == 2)
    if pooled and li not in _referenced_layers(model) and plain:
        if li == 0 and model.in_ch == 3:
            # entry folds: f=4 absorbs the first pool at 1/4 resolution
            cands += [("fold_xla_k2", 4, {"cin_pad": 64}),
                      ("fold_xla", 4, {"cin_pad": 64})]
            if int8_ok:
                cands.append(("stem_rs", 4, {"cin_pad": 64}))
                cands.append(("stem_dg", 4))
            if not quick:
                cands.append(("fold_xla_k2", 4))
        else:
            cands += [("fold_xla", 2), ("fold_xla_k2", 2)]
            if int8_ok:
                # legal only when the NEXT conv runs fold_xla_k2 f=2:
                # found on a later pass once that layer has settled
                cands.append(("fold_xla_s2", 2))
            if int8_ok and not quick:
                cands += [("rs", 2), ("rs2", 2)]
    return cands


def _conv_indices(model) -> List[int]:
    return [li for li, lay in enumerate(model.layers)
            if isinstance(lay, Conv)]


class _SweepContext:
    """One quantized model and input batch, shared by every candidate plan
    (calibration runs once)."""

    def __init__(self, model_name: str, mode: str, batch: int,
                 input_size: Optional[int], seed: int = 0, device=None,
                 weights: Optional[str] = None,
                 calib: Optional[str] = None):
        from dnn_inference_engine_tpu_torch.config import EngineConfig
        from dnn_inference_engine_tpu_torch.runtime.engine import Engine
        # kernel="xla" builds no plan: the candidates are built here from
        # the same quantized params and scales
        kw = dict(model=model_name, mode=mode, kernel="xla", batch=batch,
                  weights=weights, calib=calib)
        if input_size:
            kw["input_size"] = input_size
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")       # noise calibration
            self.eng = Engine(EngineConfig(**kw), device=device).load_weights(
                seed=0).prepare()
        self.model = self.eng.model
        self.mode = mode
        s = self.eng.config.input_size
        rng = np.random.default_rng(seed)
        xf = rng.uniform(0, 1, (batch, s, s, 3)).astype(np.float32)
        dev = self.eng.device
        self.x_f32 = torch.as_tensor(xf, device=dev)
        self.x_u8 = torch.as_tensor(
            np.clip(np.round(xf * 255), 0, 255).astype(np.uint8), device=dev)
        self.ref_head = None        # all-xla plan output, parity anchor

    def build(self, strategy: Strategy):
        """(forward, params, input) for a candidate strategy, or None when
        the plan is illegal."""
        plan = build_plan(self.model, strategy)
        if plan is None:
            return None
        if self.mode == "w8" and any(st.kind in ("rs", "s0") for st in plan):
            return None
        pp = prepare_plan_params(self.model, self.eng.params, plan)
        scales = self.eng.act_scales

        def fwd(params, xx):
            if self.mode == "w8":
                return plan_forward_w8(self.model, plan, params, xx)
            return plan_forward_w8a8(self.model, plan, params, scales, xx)
        x = (self.x_u8 if self.mode == "w8a8" and plan_input_uint8_ok(plan)
             else self.x_f32)
        return fwd, pp, x

    @staticmethod
    def _flat(heads) -> np.ndarray:
        if isinstance(heads, (tuple, list)):
            return np.concatenate([h.cpu().numpy().ravel() for h in heads])
        return heads.cpu().numpy().ravel()

    def check_parity(self, heads, tol: float = 0.06) -> Optional[float]:
        """Relative RMS against the all-xla head; None beyond ``tol``.
        The uint8 entry stages quantize layer 0's input at another scale
        than the f32 reference, so a small RMS is expected."""
        got = self._flat(heads)
        if self.ref_head is None:
            return 0.0
        ref = self.ref_head
        rms = float(np.sqrt(np.mean((got - ref) ** 2))
                    / (np.sqrt(np.mean(ref ** 2)) + 1e-12))
        return rms if rms < tol else None

    def measure(self, strategy: Strategy,
                iters: Tuple[int, int] = (60, 10), reps: int = 3,
                ) -> Tuple[Optional[float], Optional[float], Optional[str]]:
        """(whole-net seconds per batch, parity RMS, error):

          (None, None, None)            plan illegal
          (None, None, "PARITY...")     ran but diverged: rejected
          (None, None, "CRASHED: ...")  raised while running
        """
        from dnn_inference_engine_tpu_torch.runtime.benchlib import (
            per_iter_time)
        built = self.build(strategy)
        if built is None:
            return None, None, None
        fwd, pp, x = built
        try:
            heads = fwd(pp, x)
            rms = self.check_parity(heads)
            if rms is None:                    # fast but wrong: reject
                return None, None, "PARITY: diverged from all-XLA head"
            t = per_iter_time(lambda xx: fwd(pp, xx), (x,),
                              iters_hi=iters[0], iters_lo=iters[1],
                              reps=reps, stat="min")
            return float(t), rms, None
        except Exception as e:                 # noqa: BLE001 — candidate
            return None, None, f"CRASHED: {repr(e)[:200]}"


def _iters_for(t_s: float, base: Tuple[int, int] = (60, 10),
               target_delta_s: float = 0.12,
               max_iters: int = 2000) -> Tuple[int, int]:
    """Loop counts that resolve about ``target_delta_s`` of work at
    ``t_s`` per call, never fewer than ``base``'s difference."""
    delta = int(min(max(base[0] - base[1],
                        target_delta_s / max(t_s, 1e-6)), max_iters))
    lo = max(delta // 10, base[1])
    return (lo + delta, lo)


def sweep(model_name: str = "yolov2-tiny", mode: str = "w8a8",
          batch: int = 32, input_size: Optional[int] = None,
          iters: Tuple[int, int] = (60, 10), reps: int = 3,
          quick: bool = False, verbose: bool = True,
          weights: Optional[str] = None,
          calib: Optional[str] = None,
          auto_iters: bool = True, device=None) -> Dict:
    """Greedy whole-net strategy sweep; returns the artifact dict.

    ``auto_iters`` scales each measurement's loop counts from the current
    best time (and re-measures a candidate that comes out much faster
    than the counts were scaled for), so every number resolves about
    120 ms of work; ``iters`` is the floor. ``device``: None is the card
    (as ``Engine``), "cpu" the plain PyTorch versions."""
    if mode not in ("w8", "w8a8"):
        raise ValueError(
            f"plan-sweep measures the fused quantized plans; mode={mode!r} "
            "has no plan (use --mode w8a8 or w8)")

    def log(*a):
        if verbose:
            print(*a, file=sys.stderr, flush=True)

    ctx = _SweepContext(model_name, mode, batch, input_size, device=device,
                        weights=weights, calib=calib)
    convs = _conv_indices(ctx.model)
    base: Strategy = {li: ("xla", 1) for li in convs}

    # parity anchor: the all-xla plan's head(s)
    fwd, pp, _ = ctx.build(base)
    ctx.ref_head = ctx._flat(fwd(pp, ctx.x_f32))

    measurements: Dict[str, Dict[str, object]] = {}
    crashed = 0
    best_t, _, err = ctx.measure(base, iters, reps)
    if best_t is None:
        raise RuntimeError(f"all-xla baseline plan failed to run: {err}")
    if auto_iters:
        t2, _, _ = ctx.measure(base, _iters_for(best_t, iters), reps)
        if t2 is not None:
            best_t = t2
    log(f"[sweep] {model_name} {mode} batch={batch}: all-xla baseline "
        f"{best_t*1e3:.3f} ms/batch")
    # coordinate descent until stable (at most 3 passes): fold_xla_s2 is
    # legal only once its consumer runs fold_xla_k2, so later passes find
    # it. rel_loss: candidate time over the best when it was measured;
    # later passes skip clear losers (> 15%); illegal and crashed
    # candidates have none and are tried again.
    passes = 0
    rel_loss: Dict[Tuple, float] = {}
    for pass_no in range(3):
        passes += 1
        changed = False
        for li in convs:
            row: Dict[str, object] = measurements.get(str(li), {})
            row[_cand_name(base[li])] = round(best_t * 1e3, 4)
            for cand in candidate_entries(ctx.model, li, mode, quick=quick):
                if cand == base[li]:
                    continue
                if pass_no > 0 and rel_loss.get((li, _cand_name(cand)),
                                                0.0) > 1.15:
                    continue
                trial = dict(base)
                trial[li] = cand
                it = _iters_for(best_t, iters) if auto_iters else iters
                t, rms, err = ctx.measure(trial, it, reps)
                if auto_iters and t is not None and t < best_t / 2:
                    t2, rms2, _ = ctx.measure(trial, _iters_for(t, iters),
                                              reps)
                    if t2 is not None:
                        t, rms = t2, rms2
                row[_cand_name(cand)] = (round(t * 1e3, 4)
                                         if t is not None else err)
                if t is not None:
                    rel_loss[(li, _cand_name(cand))] = t / min(best_t, t)
                if err is not None and err.startswith("CRASHED"):
                    crashed += 1
                    log(f"[sweep] WARNING L{li} {_cand_name(cand)}: {err}")
                if t is not None and t < best_t:
                    base, best_t = trial, t
                    changed = True
                log(f"[sweep] p{pass_no} L{li} {_cand_name(cand):24s} "
                    + ((err or "illegal") if t is None else
                       f"{t*1e3:.3f} ms (rms {rms:.4f})"))
            measurements[str(li)] = row
            log(f"[sweep] p{pass_no} L{li} -> {_cand_name(base[li])}  "
                f"(whole-net {best_t*1e3:.3f} ms)")
        if not changed:
            break
    if crashed:
        log(f"[sweep] WARNING: {crashed} candidate(s) CRASHED (recorded "
            "in measurements) — a production kernel may be broken")

    dev = ctx.eng.device
    return {
        "model": model_name, "mode": mode, "batch": batch,
        "input_size": ctx.eng.config.input_size,
        "backend": dev.type,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else str(dev)),
        "whole_net_ms": round(best_t * 1e3, 4),
        "images_per_s": round(batch / best_t, 1),
        "strategy": _strategy_jsonable(base),
        "measurements": measurements,
        "crashed_candidates": crashed,
        "passes": passes,
        "note": "greedy coordinate descent, whole-net min-of-reps "
                "loop-difference timing"
                + (" with auto-scaled loop counts (~120 ms resolved "
                   "work per measurement)" if auto_iters else "")
                + "; null = plan illegal/unbuildable; "
                "'CRASHED: ...' = raised while running; "
                "'PARITY...' = failed the parity check vs all-XLA",
    }
