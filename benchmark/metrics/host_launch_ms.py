"""Host ms a batch inside the program's ``host.launch.<kernel>`` spans in
the traced window (``profiling.read_spans``, emptied at the window's
start), less the spans inside them: each port kernel wrapper's argument
checks, contiguity copies, tensor maps and ctypes call, without an upload
it makes and without counting a nested wrapper twice."""

from dnn_inference_engine_tpu_torch.runtime import profiling


def read(ctx):
    tr = ctx.get("trace")
    read_spans = getattr(profiling, "read_spans", None)
    if not tr or not tr["batches"] or read_spans is None:
        return None
    ns = sum(v.self_ns for k, v in read_spans().items()
             if k.startswith("host.launch."))
    return ns / 1e6 / tr["batches"]
