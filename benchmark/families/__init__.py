"""Model families: everything the harness needs to know about a kind of
model, one module a family (``families/<family>.py``), named by the
configuration's optional ``"family"`` key (``layer_list`` where it has
none). Each module provides:

- ``weights(cfg, seed, device, calib)``: the float32 weights both sides
  get, made from the seed on ``device`` in the form the program's
  ``Engine.load_weights(params=...)`` takes (a tree of lists, tuples and
  dicts of tensors; ``calib`` the calibration images, for weights fitted
  to them);
- ``reference(cfg, params, qmax)``: the plain reference on those weights,
  quantized at ``qmax`` (127 the cells' int8, 7 the int4 control): an
  object with ``calibrate(images)``, ``forward(u8 batch) -> head``, its
  quantized weights ``qparams`` ({"wq", "s_w"} each, or {} where a layer
  has none) and its activation scales ``scales``;
- ``ops_per_image(cfg)``: the model's useful operations an image (2 a
  multiply-accumulate), which ``step_mfu_pct`` reads;
- ``program_codes(engine)``: the program's quantized weights
  ([{"wq", "s_w"}], on the host) and its activation scales, in the
  reference's order.
"""

from __future__ import annotations

import importlib
from pathlib import Path
from types import ModuleType
from typing import Dict

HERE = Path(__file__).resolve().parent
DEFAULT = "layer_list"


def name(cfg: Dict) -> str:
    return cfg.get("family", DEFAULT)


def of(cfg: Dict) -> ModuleType:
    """The family module of configuration ``cfg``."""
    family = name(cfg)
    module = f"{__name__}.{family}"
    try:
        return importlib.import_module(module)
    except ModuleNotFoundError as e:
        if e.name != module:
            raise
        raise ModuleNotFoundError(
            f"configuration {cfg.get('name')!r} names the family "
            f"{family!r}, which has no module {HERE / (family + '.py')}",
            name=module) from None
