"""A/B: borders genome-wide detect, fused multi-kernel vs per-kernel.

Times two in-process passes per mode (first compiles the programs,
second is steady state) and diffs the output tables.
"""

import os
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

GEN = os.environ.get(
    "CHROMOSIGHT_AB_GENOME",
    str(
        pathlib.Path(__file__).resolve().parents[1]
        / "build" / "chromosight_bench" / "genome_50000x3.cool"
    ),
)


def run(tag, fuse):
    from chromosight_tpu.cli.main import main

    os.environ["CHROMOSIGHT_TPU_FUSE_KERNELS"] = fuse
    out = str(pathlib.Path(GEN).parent / f"ab_{tag}")
    t0 = time.time()
    try:
        main(["detect", "--no-plotting", "--pattern", "borders", GEN, out])
    except SystemExit as exc:
        if exc.code not in (0, None):
            raise
    return time.time() - t0, out


walls = {}
outs = {}
order = [a for a in sys.argv[1:] if not a.startswith("/")] or [
    "fused",
    "unfused",
]
paths = [a for a in sys.argv[1:] if a.startswith("/")]
if paths:
    GEN = paths[0]
for tag in order:
    fuse = "1" if tag == "fused" else "0"
    w1, _ = run(tag + "_warm", fuse)
    w2, out = run(tag, fuse)
    walls[tag] = (round(w1, 1), round(w2, 1))
    outs[tag] = out
    print(f"{tag}: warm {w1:.1f}s steady {w2:.1f}s", flush=True)

print("WALLS", walls)
if len(outs) == 2:
    import pandas as pd

    try:
        f = pd.read_csv(outs["fused"] + ".tsv", sep="\t")
        u = pd.read_csv(outs["unfused"] + ".tsv", sep="\t")
        key = ["bin1", "bin2", "kernel_id", "iteration"]
        same = set(map(tuple, f[key].values)) == set(map(tuple, u[key].values))
        print(f"calls: fused {len(f)} unfused {len(u)} identical_coords={same}")
    except FileNotFoundError:
        print("no calls in one or both modes (timing still valid)")
