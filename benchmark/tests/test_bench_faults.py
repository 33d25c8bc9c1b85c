"""The comparison fails where it must: the int4 control in the program's
place, and runs whose timed path is broken underneath (on the CPU at 64
px, past the harness's look for a card). A one-chip inference cell's
timed path can fail three ways: a step that returns its state unchanged
(the outputs of the first batch, whatever comes in), half of the batch
left out (its second half computed from the first half's images), and an
answer altered where it is produced. A detection cell's decode can also
move every box by the same few pixels, which leaves the NMS's choices as
they were, or run in float16 (its own control)."""

import numpy as np
import pytest
import torch

from benchmark import cell, control, judge, spec

BENCH = spec.load()
CELLS = [w["name"] for w in BENCH["workloads"]]
SMALL = {"input_size": 64, "batch": 4, "pool_batches": 2,
         "sample_batches": 4, "trace_batches": 2}


@pytest.fixture(autouse=True)
def few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def unchanged(call):
    first = []

    def f(x):
        if not first:
            first.append(call(x))
        return first[0]
    return f


def half_left_out(call):
    def f(x):
        h = x.shape[0] // 2
        return call(torch.cat([x[:h], x[:h]]))
    return f


def answer_altered(call):
    """Image 0's answer altered: a detection of class 0 at the corner
    with score 0.9 put first, or its logits reversed."""
    def f(x):
        out, head = call(x)
        if isinstance(out, tuple):
            b, s, c = (np.array(v) for v in out)
            b[0, 0], s[0, 0], c[0, 0] = (0, 0, 9, 9), 0.9, 0
            return (b, s, c), head
        out = np.array(out)
        out[0] = out[0][::-1]
        return out, head
    return f


def boxes_shifted(call):
    """Every box moved 3 pixels right: the IoUs between candidates, and so
    the NMS's choices, stay as they were."""
    def f(x):
        (b, s, c), head = call(x)
        b = np.array(b)
        b[..., 0::2] += 3.0
        return (b, s, c), head
    return f


@pytest.mark.parametrize("fault", [unchanged, half_left_out,
                                   answer_altered], ids=lambda f: f.__name__)
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_timed_path_is_not_correct(workload, fault):
    c = spec.cell(BENCH, workload)
    # 2 s: enough batches for every kept slot (sample_batches + one a pool
    # batch) on a loaded CPU, as the cells' windows have
    r = cell.run(c, 99, 2.0, False, 0.0, device="cpu", sizes=SMALL,
                 fault=fault)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("workload", CELLS)
def test_the_int4_control_is_not_correct(workload):
    c = spec.cell(BENCH, workload)
    for seed in (1, 2):
        numbers = control.readings(c, seed, "cpu", sizes=SMALL)
        ok, rows = judge.verdict(numbers, c.limits)
        assert not ok, rows
        # it fails the outputs' numbers too, not only the weights'
        assert numbers["head_gap"] > c.limits["head_gap"]


DETECT = [w for w in CELLS
          if spec.cell(BENCH, w).config["task"] == "detect"]
# the cells' own 416 px, where boxes pass the serving threshold (at 64 px
# none does)
FULL_SIZE = {"batch": 2, "pool_batches": 1, "sample_batches": 1,
             "trace_batches": 1}


@pytest.mark.parametrize("workload", DETECT)
def test_shifted_boxes_are_not_correct(workload):
    c = spec.cell(BENCH, workload)
    r = cell.run(c, 99, 0.1, False, 0.0, device="cpu", sizes=FULL_SIZE,
                 fault=boxes_shifted)
    assert not r["correct"], r["checks"]
    checks = {k: v["value"] for k, v in r["checks"].items()}
    assert checks["box_gap"] > c.limits["box_gap"]


@pytest.mark.parametrize("workload", DETECT)
def test_a_float16_decode_is_not_correct(workload):
    c = spec.cell(BENCH, workload)
    for seed in (1, 2):
        numbers = control.readings(c, seed, "cpu", sizes=FULL_SIZE,
                                   side="decode16")
        ok, rows = judge.verdict(numbers, c.limits)
        assert not ok, rows
        # the forward is the reference's own: only the decode's numbers
        assert numbers["head_gap"] == 0 and numbers["weight_codes_off"] == 0
        assert (numbers["box_gap"] > c.limits["box_gap"]
                or numbers["score_gap"] > c.limits["score_gap"])
