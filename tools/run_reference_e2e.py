"""Run the ACTUAL reference CLI end-to-end on an arbitrary cool file.

This is the genome-scale honesty check: the reference implementation
(/root/reference, koszullab/chromosight v1.6.3, its own cmd_detect at
``cli/chromosight.py:625-896``) executes unmodified — through the same
cooler/docopt shims tools/gen_reference_golden.py uses for the
example.cool goldens — on the synthetic genomes this package is
benchmarked on, and its WALL-CLOCK and pattern table are recorded so

1. tests/test_golden_genome_scale.py can assert exact call parity at
   150k+ bins (not just the 720-bin fixture), and
2. bench.py's vs_baseline can divide end-to-end wall by end-to-end wall
   (REFERENCE_E2E.json), instead of scaling the reference's engine-only
   slice throughput.

Usage:
    python tools/run_reference_e2e.py <cool> <outdir> \
        [--pattern loops] [--norm auto] [--min-dist X] [--max-dist X] \
        [--label NAME] [--json REFERENCE_E2E.json]

Writes <outdir>/reference_<label>.tsv plus a JSON record with the wall
seconds, pattern count, and the genome parameters (from the cool file)
needed to validate that a pinned wall still describes the same workload.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import tempfile
import time

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))

from gen_reference_golden import (  # noqa: E402
    BASE_ARGS,
    install_shims,
    make_patched_reference,
)


def run_reference_detect(cool, prefix, overrides):
    """Import the patched reference and run cmd_detect; returns wall s."""
    import pandas as pd

    pd.set_option("future.infer_string", False)
    install_shims()
    tmpdir = tempfile.mkdtemp(prefix="refsrc_")
    sys.path.insert(0, make_patched_reference(tmpdir))
    import chromosight.cli.chromosight as refcli

    import warnings

    warnings.simplefilter("error", pd.errors.ChainedAssignmentError)

    args = dict(BASE_ARGS)
    args.update({"detect": True, "<contact_map>": cool, "<prefix>": prefix})
    args.update(overrides)
    t0 = time.perf_counter()
    try:
        refcli.cmd_detect(args)
    except SystemExit as exc:
        if exc.code not in (None, 0):
            raise
    return time.perf_counter() - t0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("cool")
    ap.add_argument("outdir")
    ap.add_argument("--pattern", default="loops")
    ap.add_argument("--norm", default="auto")
    ap.add_argument("--min-dist", default=None)
    ap.add_argument("--max-dist", default=None)
    ap.add_argument("--inter", action="store_true")
    ap.add_argument("--tsvd", action="store_true")
    ap.add_argument("--iterations", default=None)
    ap.add_argument("--threads", default="1")
    ap.add_argument("--label", default=None)
    ap.add_argument(
        "--json",
        default=None,
        help="also append this run to a REFERENCE_E2E.json record",
    )
    ns = ap.parse_args()

    import os

    os.environ.setdefault("MPLBACKEND", "Agg")
    outdir = pathlib.Path(ns.outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    label = ns.label or ns.pattern

    overrides = {
        "--pattern": ns.pattern,
        "--norm": ns.norm,
        "--threads": ns.threads,
    }
    if ns.min_dist is not None:
        overrides["--min-dist"] = ns.min_dist
    if ns.max_dist is not None:
        overrides["--max-dist"] = ns.max_dist
    if ns.iterations is not None:
        overrides["--iterations"] = ns.iterations
    if ns.inter:
        overrides["--inter"] = True
    if ns.tsvd:
        overrides["--tsvd"] = True

    prefix = str(outdir / f"reference_{label}")
    wall = run_reference_detect(ns.cool, prefix, overrides)

    tsv = pathlib.Path(prefix + ".tsv")
    n_patterns = 0
    if tsv.exists():
        import pandas as pd

        n_patterns = len(pd.read_csv(tsv, sep="\t"))

    from chromosight_tpu.io.cool import CoolFile

    clr = CoolFile(ns.cool)
    record = {
        "label": label,
        "cool": str(ns.cool),
        "pattern": ns.pattern,
        "overrides": {
            k: v for k, v in overrides.items() if k != "--threads"
        },
        "wall_s": round(wall, 2),
        "n_patterns": n_patterns,
        "genome": {
            "n_bins": clr.n_bins,
            "n_chroms": len(clr.chromnames),
            "binsize": clr.binsize,
            "nnz": clr.nnz,
        },
        "host": "same 1-vCPU host as bench.py's timed passes",
        "reference": "koszullab/chromosight v1.6.3 cmd_detect "
        "(cli/chromosight.py:625-896) via cooler/docopt shims",
    }
    print(json.dumps(record, indent=2))
    if ns.json:
        p = pathlib.Path(ns.json)
        existing = json.loads(p.read_text()) if p.exists() else {}
        existing[label] = record
        p.write_text(json.dumps(existing, indent=2) + "\n")


if __name__ == "__main__":
    main()
