"""Measure the genome-scale --inter config (BASELINE 5c) steady-state.

Runs detect twice in-process on the trans genome (warm pass loads
programs; the second pass is the steady measurement), printing wall,
stage counters, link bytes and the compute-accounting block per pass.

Usage: python tools/measure_inter.py [trans_genome.cool] [reps]
"""

import json
import os
import pathlib
import sys
import tempfile
import time

REPO = pathlib.Path(__file__).parents[1]
sys.path.insert(0, str(REPO))

from chromosight_tpu.config import init_compilation_cache

init_compilation_cache()


def main():
    cool = sys.argv[1] if len(sys.argv) > 1 else (
        str(
            pathlib.Path(__file__).resolve().parents[1]
            / "build" / "chromosight_bench" / "genome_trans_50000x3.cool"
        )
    )
    reps = int(sys.argv[2]) if len(sys.argv) > 2 else 2

    from chromosight_tpu import observability as obs
    from chromosight_tpu.cli.main import main as climain

    tmp = tempfile.mkdtemp(prefix="inter_measure_")
    for rep in range(reps):
        obs.reset()
        t0 = time.perf_counter()
        rc = climain(
            ["detect", "--no-plotting", "-I", cool, f"{tmp}/out{rep}"]
        )
        wall = time.perf_counter() - t0
        stages, counts, bytes_ = obs.snapshot()
        comp = obs.compute_snapshot()
        n_calls = (
            sum(1 for _ in open(f"{tmp}/out{rep}.tsv")) - 1
            if os.path.exists(f"{tmp}/out{rep}.tsv")
            else 0
        )
        print(
            json.dumps(
                {
                    "rep": rep,
                    "rc": rc,
                    "wall_s": round(wall, 2),
                    "calls": n_calls,
                    "stage_s": {
                        k: round(v, 2) for k, v in sorted(stages.items())
                    },
                    "bytes_MB": {
                        k: round(v / 1e6, 1) for k, v in bytes_.items()
                    },
                    "compute": {
                        k: {
                            "flops_T": round(v["flops"] / 1e12, 3),
                            "hbm_min_GB": round(
                                v["hbm_min_bytes"] / 1e9, 3
                            ),
                            "dispatches": v["dispatches"],
                        }
                        for k, v in sorted(comp.items())
                    },
                }
            ),
            flush=True,
        )


if __name__ == "__main__":
    main()
