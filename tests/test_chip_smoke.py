"""The GPU bring-up script's helpers, and its refusal to run without a GPU
(its phases themselves need the card: ``python chip_smoke.py`` on it)."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest

REPO = pathlib.Path(__file__).parents[1]
DATA = pathlib.Path(__file__).parent / "data"
sys.path.insert(0, str(REPO))
import chip_smoke as cs  # noqa: E402


def test_last_line_is_the_exact_contract():
    line = cs.last_line("gpu", "NVIDIA H100 80GB HBM3", 1)
    assert line == (
        '{"ok": true, "device": {"platform": "gpu", '
        '"kind": "NVIDIA H100 80GB HBM3", "count": 1}}'
    )
    assert json.loads(line) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1},
    }


def test_compare_calls_accepts_the_example_golden():
    g = pd.read_csv(DATA / "golden_detect_loops.tsv", sep="\t")
    shuffled = g.sample(frac=1.0, random_state=0)
    assert cs.compare_calls(shuffled, g, "detect") == (89, 0.0)


@pytest.mark.parametrize(
    "change",
    ["drop_row", "move_call", "other_kernel", "score_off", "extra_row"],
)
def test_compare_calls_rejects_any_difference(change):
    g = pd.read_csv(DATA / "golden_detect_loops.tsv", sep="\t")
    o = g.copy()
    if change == "drop_row":
        o = o.iloc[1:]
    elif change == "move_call":
        o.loc[0, "bin2"] += 1
    elif change == "other_kernel":
        o.loc[0, "kernel_id"] += 1
    elif change == "score_off":
        o.loc[0, "score"] += 1e-4
    else:
        o = pd.concat([o, o.iloc[:1]])
    with pytest.raises(AssertionError):
        cs.compare_calls(o, g, "detect")


def test_compare_quantify_checks_validation_outcomes():
    g = pd.read_csv(DATA / "golden_quantify_loops.tsv", sep="\t")
    n, d = cs.compare_quantify(g.copy(), g, "quantify")
    assert (n, d) == (53, 0.0)
    o = g.copy()
    kept = o.index[o.score.notna()][0]
    o.loc[kept, "score"] = np.nan
    with pytest.raises(AssertionError):
        cs.compare_quantify(o, g, "quantify")


def test_sweep_metrics_flips_and_ambiguity_band():
    corr64 = np.array([[0.5, 0.3 + 5e-4, 0.1, 0.0]])
    corr32 = np.array([[0.5 + 2e-5, 0.3 - 1e-5, 0.1, 0.0]])
    logp = np.array([[-3.0, -2.0, -1.0, 0.0]])
    m = cs.sweep_metrics(corr32, logp, corr64, logp, 0.3)
    assert m["flips"] == 1 and m["flips_outside_band"] == 0
    assert m["candidates"] == 2
    assert abs(m["max_dcorr"] - 5.1e-4) < 1e-12
    # a flip far from the threshold is outside the band
    corr32[0, 2] = 0.31
    m = cs.sweep_metrics(corr32, logp, corr64, logp, 0.3)
    assert m["flips"] == 2 and m["flips_outside_band"] == 1


def _run_script(cwd, extra_env=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **(extra_env or {}))
    return subprocess.run(
        [sys.executable, "chip_smoke.py"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300,
    )


def test_refuses_a_cpu_backend():
    r = _run_script(REPO)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "not a GPU" in r.stderr


def test_refuses_outside_a_checkout(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run_script(tmp_path)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "not a checkout" in r.stderr
