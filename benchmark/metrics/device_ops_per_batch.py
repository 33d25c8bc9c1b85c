"""Device operations (kernels, copies, sets) in the traced window, over
its batches: the launch and upload work the host does a batch."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr or not tr["events"] or not tr["batches"]:
        return None
    return len(tr["events"]) / tr["batches"]
