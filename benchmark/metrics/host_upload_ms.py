"""Host ms a batch inside the program's ``host.upload`` spans in the
traced window (``profiling.read_spans``, emptied at the window's start):
the host blocked in the blocking scale uploads, each waiting for the
stream to drain before its copy."""

from dnn_inference_engine_tpu_torch.runtime import profiling


def read(ctx):
    tr = ctx.get("trace")
    read_spans = getattr(profiling, "read_spans", None)
    if not tr or not tr["batches"] or read_spans is None:
        return None
    up = read_spans().get("host.upload")
    return (up.total_ns if up else 0) / 1e6 / tr["batches"]
