"""Run the five BASELINE.json benchmark configurations end-to-end, in
this process, and print a results table.

Configs (BASELINE.json "configs"):
1. loops detect on data_test/example.cool (raw norm)
2. quantify scoring of example.bed2 coordinates against example.cool
3. borders + hairpins genome-wide detect with --iterations refinement
4. genome-scale detect with --min-dist/--max-dist banding, norm=force
5. genome-scale detect with --tsvd separable conv (+ --inter on the small
   dataset; dense trans matrices at 49k-bin chromosome scale exceed HBM,
   as they do for the reference's sparse path in RAM)

Usage: python tools/run_baseline_configs.py [genome.cool] [genome_trans.cool]
where genome.cool is a large synthetic genome (see make_synthetic_cool)
and genome_trans.cool one generated with --trans-density for the
genome-scale --inter configuration.
"""

from __future__ import annotations

import pathlib
import shutil
import sys
import tempfile
import time

REPO = pathlib.Path(__file__).parents[1]


def run(args):
    from chromosight_tpu.cli.main import main

    t0 = time.time()
    try:
        main(args)
        status = "ok"
    except SystemExit as exc:
        status = f"exit {exc.code}"
    return time.time() - t0, status


def count_rows(prefix):
    import pandas as pd

    try:
        return len(pd.read_csv(prefix + ".tsv", sep="\t"))
    except Exception:
        return "-"


def main():
    example = str(REPO / "data_test" / "example.cool")
    bed2 = str(REPO / "data_test" / "example.bed2")
    genome = sys.argv[1] if len(sys.argv) > 1 else None
    genome_trans = sys.argv[2] if len(sys.argv) > 2 else None

    tmp = tempfile.mkdtemp(prefix="chromosight_baseline_")
    rows = []

    # 1: loops detect, raw norm
    p = f"{tmp}/c1"
    dt, st = run(["detect", "--no-plotting", "-n", "raw", example, p])
    rows.append(("1 loops detect example.cool (raw norm)", dt, st, count_rows(p)))

    # 2: quantify
    p = f"{tmp}/c2"
    dt, st = run(["quantify", "--no-plotting", bed2, example, p])
    rows.append(("2 quantify example.bed2", dt, st, count_rows(p)))

    # 3: borders + hairpins with iterations
    for pat in ("borders", "hairpins"):
        p = f"{tmp}/c3_{pat}"
        dt, st = run(
            ["detect", "--no-plotting", "-P", pat, "-i", "2", example, p]
        )
        rows.append((f"3 {pat} detect -i 2", dt, st, count_rows(p)))

    if genome:
        # 4: banding + norm=force (on a private copy: force overwrites
        # the weight column)
        gcopy = f"{tmp}/genome_force.cool"
        shutil.copy(genome, gcopy)
        p = f"{tmp}/c4"
        dt, st = run(
            [
                "detect", "--no-plotting", "-n", "force",
                "-m", "50000", "-M", "1000000", gcopy, p,
            ]
        )
        rows.append(
            ("4 genome detect min/max-dist banding, norm=force", dt, st,
             count_rows(p))
        )

        # 5: tsvd separable conv at genome scale
        p = f"{tmp}/c5"
        dt, st = run(["detect", "--no-plotting", "--tsvd", genome, p])
        rows.append(("5 genome detect --tsvd", dt, st, count_rows(p)))

    if genome_trans:
        # 5c: genome-scale --inter: trans maps stay sparse and run
        # through the tiled engine (a dense 50k x 50k trans pair would
        # be 20 GB; see ops/tiled.py)
        p = f"{tmp}/c5c"
        dt, st = run(["detect", "--no-plotting", "-I", genome_trans, p])
        rows.append(
            ("5c genome detect --inter (sparse trans maps)", dt, st,
             count_rows(p))
        )

    # 5b: --inter on the small dataset
    p = f"{tmp}/c5b"
    dt, st = run(["detect", "--no-plotting", "-I", example, p])
    rows.append(("5b detect --inter (example.cool)", dt, st, count_rows(p)))

    print("| config | wall (s) | status | patterns |\n|---|---|---|---|")
    for name, dt, st, n in rows:
        print(f"| {name} | {dt:.1f} | {st} | {n} |")


if __name__ == "__main__":
    main()
