"""Blocking scale uploads a batch in the traced window: the program's
upload counter (``f32_scalar.uploads`` in ``quant/quantize.py``, reset
with the launch counters at the window's start) over its batches. Each is
a pageable host-to-device copy that waits for the stream to drain."""

from dnn_inference_engine_tpu_torch.quant import quantize


def read(ctx):
    tr = ctx.get("trace")
    n = getattr(quantize.f32_scalar, "uploads", None)
    if not tr or not tr["batches"] or n is None:
        return None
    return n / tr["batches"]
