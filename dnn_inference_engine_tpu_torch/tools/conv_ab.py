"""Time the conv_w8a8 kernel of two checkouts of this repository on one
card, in turns (base, this, this, base).

    python -m dnn_inference_engine_tpu_torch.tools.conv_ab --base DIR

DIR is another checkout (for example the parent commit, unpacked with
``git archive`` into a directory that ``.gitignore`` lists). Each turn
runs in a process of its own, from that checkout's root: its
``chip_smoke.conv_shapes`` at YOLOv2-tiny's b32 and b1 and YOLOv3-tiny's
b16 conv_w8a8 launches (inputs from one seed, every launch checked
against the plain version there), each checkout's kernels built into its
own ``build/kernels``. Prints each turn's ms a layer and the sums, then
each layer's mean a checkout, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

_TURN = """
import json, sys, torch
sys.path.insert(0, {root!r})
import chip_smoke as cs
dev = torch.device("cuda")
ops_peak, bw = cs.peaks(torch.cuda.get_device_name(0))
out = {{}}
for tag, table in (("v2-b32", cs.V2_B32_CONVS), ("v2-b1", cs.V2_B1_CONVS),
                   ("v3-b16", cs.V3_B16_CONVS)):
    g = torch.Generator(device=dev).manual_seed(11)
    rows = cs.conv_shapes(g, dev, table, ops_peak, bw, tag)
    out[tag] = {{r["layer"]: r["ms"] for r in rows}}
print("AB " + json.dumps(out))
"""


def turn(root: Path) -> dict:
    """One checkout's conv_w8a8 times, in a process of its own."""
    r = subprocess.run([sys.executable, "-c", _TURN.format(root=str(root))],
                       cwd=root, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"turn in {root} failed:\n{r.stdout[-3000:]}\n"
                           f"{r.stderr[-3000:]}")
    line = next(x for x in r.stdout.splitlines() if x.startswith("AB "))
    return json.loads(line[3:])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", required=True, type=Path,
                    help="root of the other checkout")
    args = ap.parse_args(argv)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    order = [("base", args.base.resolve()), ("this", ROOT),
             ("this", ROOT), ("base", args.base.resolve())]
    runs = {"base": [], "this": []}
    for name, root in order:
        t = turn(root)
        runs[name].append(t)
        print(f"{name}: " + "; ".join(
            f"{tag} " + " ".join(f"{k} {v:.4f}" for k, v in ms.items())
            + f" sum {sum(ms.values()):.4f}" for tag, ms in t.items()),
            flush=True)
    for tag in runs["this"][0]:
        for layer in runs["this"][0][tag]:
            means = {n: sum(r[tag][layer] for r in rs) / len(rs)
                     for n, rs in runs.items()}
            print(f"{tag} {layer}: base {means['base']:.4f} this "
                  f"{means['this']:.4f} ms ({means['this'] / means['base']:.3f}"
                  f" of base) [{card}]")
        sums = {n: sum(sum(r[tag].values()) for r in rs) / len(rs)
                for n, rs in runs.items()}
        print(f"{tag} sum: base {sums['base']:.4f} this {sums['this']:.4f} "
              f"ms ({sums['this'] / sums['base']:.3f} of base) [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
