"""Genome-scale call parity against the ACTUAL reference implementation.

The example.cool goldens pin parity at 720 bins; these pin it at 150,000
bins (3 x 50k-bin chromosomes at 5 kb, the BASELINE config-4/5 genome).
``tests/data/golden_genome_{loops,borders}.tsv`` were produced by running
the reference's own ``cmd_detect`` (reference ``cli/chromosight.py:
625-896``) end-to-end on the deterministic seed-0 synthetic genome via
``tools/run_reference_e2e.py`` — real reference code, not a
reimplementation.  The tests regenerate the genome if missing (cached
under build/chromosight_bench), fingerprint it against the goldens'
recorded identity, and assert exact (bin1, bin2, kernel_id, iteration)
equality plus fp32-tolerance scores.

Marked slow: a full run (genome generation + two genome-wide detects on
the CPU backend) takes minutes; set CHROMOSIGHT_TPU_SKIP_GENOME_TESTS=1
to skip.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest

from chromosight_tpu.ops.oracle import genome_fingerprint

REPO = pathlib.Path(__file__).parents[1]
DATA = pathlib.Path(__file__).parent / "data"
CACHE = pathlib.Path(
    os.environ.get("CHROMOSIGHT_BENCH_CACHE", REPO / "build" / "chromosight_bench")
)
GENOME = CACHE / "genome_50000x3.cool"

pytestmark = [
    pytest.mark.slow,
    pytest.mark.skipif(
        bool(os.environ.get("CHROMOSIGHT_TPU_SKIP_GENOME_TESTS")),
        reason="genome-scale tests disabled by env",
    ),
]


@pytest.fixture(scope="session")
def genome_cool():
    if not GENOME.exists():
        CACHE.mkdir(parents=True, exist_ok=True)
        env = dict(os.environ)
        env["PYTHONPATH"] = f"{REPO}:{env.get('PYTHONPATH', '')}"
        subprocess.run(
            [
                sys.executable,
                str(REPO / "tools" / "make_synthetic_cool.py"),
                str(GENOME),
                "--bins",
                "50000",
                "--chroms",
                "3",
            ],
            check=True,
            env=env,
        )
    meta_path = DATA / "golden_genome_meta.json"
    if not meta_path.exists():
        pytest.skip("golden_genome_meta.json not vendored yet")
    meta = json.loads(meta_path.read_text())
    got = genome_fingerprint(GENOME)
    if got != meta["fingerprint"]:
        pytest.skip(
            "cached genome does not match the goldens' fingerprint "
            f"({got} != {meta['fingerprint']}) — regenerate goldens with "
            "tools/run_reference_e2e.py"
        )
    return str(GENOME)


def _run_detect(genome_cool, tmp_path_factory, name, extra=()):
    from chromosight_tpu.cli.main import main

    prefix = str(tmp_path_factory.mktemp(f"genome_{name}") / "out")
    rc = main(
        ["detect", "--no-plotting", *extra, genome_cool, prefix]
    )
    assert rc in (0, None)
    return pd.read_csv(prefix + ".tsv", sep="\t")


@pytest.mark.parametrize(
    "name,extra",
    [
        ("loops", ()),
        ("borders", ("--pattern", "borders")),
    ],
)
def test_genome_scale_calls_match_reference(
    genome_cool, tmp_path_factory, name, extra
):
    golden_path = DATA / f"golden_genome_{name}.tsv"
    if not golden_path.exists():
        pytest.skip(f"{golden_path.name} not vendored yet")
    golden = pd.read_csv(golden_path, sep="\t")
    ours = _run_detect(genome_cool, tmp_path_factory, name, extra)

    key = ["bin1", "bin2", "kernel_id", "iteration"]
    g = golden.sort_values(key).reset_index(drop=True)
    o = ours.sort_values(key).reset_index(drop=True)
    assert len(o) == len(g), (
        f"{name}: {len(o)} calls vs reference's {len(g)}"
    )
    for col in key + ["chrom1", "start1", "chrom2", "start2"]:
        assert (g[col] == o[col]).all(), f"{name}: column {col} differs"
    assert np.abs(g.score - o.score).max() < 5e-5
    # p-values are extreme tails at genome scale; compare in log space
    with np.errstate(divide="ignore"):
        lg = np.log10(np.maximum(g.pvalue, 1e-300))
        lo = np.log10(np.maximum(o.pvalue, 1e-300))
    assert np.abs(lg - lo).max() < 1e-3
