"""Host ms a batch inside the program's ``engine.forward`` and
``engine.postprocess`` spans in the traced window (``profiling.read_spans``,
emptied at the window's start), less the ``host.upload`` time: the host's
own work in the model step (Python, PyTorch's dispatch, the kernel
launches), with the blocked uploads taken out. Every upload of the window
lies inside those two spans: the harness's own code makes none."""

from dnn_inference_engine_tpu_torch.runtime import profiling


def read(ctx):
    tr = ctx.get("trace")
    read_spans = getattr(profiling, "read_spans", None)
    if not tr or not tr["batches"] or read_spans is None:
        return None
    spans = read_spans()
    if "engine.forward" not in spans:
        return None
    ns = sum(spans[k].total_ns for k in ("engine.forward",
                                         "engine.postprocess") if k in spans)
    up = spans.get("host.upload")
    return (ns - (up.total_ns if up else 0)) / 1e6 / tr["batches"]
