#!/usr/bin/env python3
"""Bring-up check of the detection pipeline on a GPU.

Drives the main path through the CLI, in this one process (a second JAX
process could not open the card), and checks what comes out against the
reference goldens and the float64 oracle:

  phase 0  environment: card, JAX, packages, native host library; fails
           unless JAX's backend is the GPU
  phase 1  example.cool goldens: detect (89 calls), quantify (53 rows),
           detect --inter on the dense and on the tiled sparse engine
  phase 2  genome-scale goldens: generate the seed-0 3 x 50,000-bin 5 kb
           genome, detect loops (159 calls) and borders (3,706 calls),
           cold and warm walls
  phase 3  the correlation sweeps on one chromosome of that genome, the
           loops one (``ops.band.band_normxcorr``) and the three-kernel
           borders one (``band_normxcorr_multi``), against the float64
           oracle (``ops.oracle``), with device times

``--four-cards`` runs only the multi-device phase instead: phase 2's
detects on the (dp, sp) mesh over four cards (GSPMD, shard_map, and the
multi-kernel borders program), each against the goldens.

Usage: python chip_smoke.py [--four-cards]

Each phase prints its findings; any failure exits non-zero.  The last
line of stdout is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.metadata
import json
import os
import pathlib
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent
DATA = REPO / "tests" / "data"
EXAMPLE_COOL = REPO / "data_test" / "example.cool"
EXAMPLE_BED2 = REPO / "data_test" / "example.bed2"
WORK = REPO / "build" / "chip_smoke"
GENOME_BINS, GENOME_CHROMS = 50_000, 3
SCORE_TOL = 5e-5
# Phase 3: rows of the oracle at each end of the chromosome (the float64
# correlate2d oracle takes about a minute for 2 x 8,000 rows).
ORACLE_ROWS = 8_000
# Scores within this distance of the threshold may fall on either side
# in float32 (test_fp32_boundaries.test_pearson_threshold_straddle).
AMBIGUITY = 1e-3


def say(phase, msg):
    print(f"[phase {phase}] {msg}", flush=True)


def last_line(platform, kind, count):
    """The run's final stdout line."""
    return json.dumps(
        {"ok": True, "device": {"platform": platform, "kind": kind, "count": count}}
    )


# --------------------------------------------------------------------- #
# Comparisons
# --------------------------------------------------------------------- #
KEY = ["bin1", "bin2", "kernel_id", "iteration"]


def compare_calls(ours, golden, what):
    """Exact call set on (bin1, bin2, kernel_id, iteration), scores
    within SCORE_TOL.  Returns (n_calls, max |d score|)."""
    o = ours.sort_values(KEY).reset_index(drop=True)
    g = golden.sort_values(KEY).reset_index(drop=True)
    if len(o) != len(g):
        raise AssertionError(f"{what}: {len(o)} calls, golden has {len(g)}")
    for col in KEY + ["chrom1", "start1", "chrom2", "start2"]:
        if not (o[col] == g[col]).all():
            raise AssertionError(f"{what}: column {col} differs from golden")
    dscore = float(np.abs(o.score - g.score).max()) if len(g) else 0.0
    if not dscore < SCORE_TOL:
        raise AssertionError(f"{what}: max |d score| {dscore} >= {SCORE_TOL}")
    return len(o), dscore


def compare_quantify(ours, golden, what):
    """Same coordinates, same validation outcome (NaN = rejected window)
    and scores within SCORE_TOL.  Returns (n_rows, max |d score|)."""
    m = golden.merge(ours, on=["bin1", "bin2"], suffixes=("_ref", "_ours"))
    if not len(ours) == len(golden) == len(m):
        raise AssertionError(
            f"{what}: {len(ours)} rows, golden has {len(golden)}, "
            f"{len(m)} shared"
        )
    if not (m.score_ref.isna() == m.score_ours.isna()).all():
        raise AssertionError(f"{what}: validation outcomes differ")
    ok = m.score_ref.notna()
    dscore = float(np.abs(m.score_ref[ok] - m.score_ours[ok]).max())
    if not dscore < SCORE_TOL:
        raise AssertionError(f"{what}: max |d score| {dscore} >= {SCORE_TOL}")
    return len(m), dscore


def sweep_metrics(corr32, logp32, corr64, logp64, pearson):
    """Engine (float32) against oracle (float64) on the same rows:
    max |d corr|, max |d log10 p| where both are finite and the oracle
    score is nonzero, candidate flips at ``pearson`` and how many of them
    lie outside the float32 ambiguity band."""
    c32 = np.asarray(corr32, np.float64)
    dcorr = float(np.abs(c32 - corr64).max())
    l32 = np.asarray(logp32, np.float64)
    both = np.isfinite(l32) & np.isfinite(logp64) & (corr64 != 0)
    dlogp = float(np.abs(l32[both] - logp64[both]).max()) if both.any() else 0.0
    cand32 = (c32 >= pearson) & (c32 != 0)
    cand64 = (corr64 >= pearson) & (corr64 != 0)
    flips = cand32 != cand64
    outside = flips & (np.abs(corr64 - pearson) > AMBIGUITY)
    return {
        "max_dcorr": dcorr,
        "max_dlog10p": dlogp,
        "flips": int(flips.sum()),
        "flips_outside_band": int(outside.sum()),
        "candidates": int(cand64.sum()),
    }


# --------------------------------------------------------------------- #
# Running the CLI in this process
# --------------------------------------------------------------------- #
@contextlib.contextmanager
def env(**values):
    old = {k: os.environ.get(k) for k in values}
    os.environ.update({k: str(v) for k, v in values.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def run_cli(*argv):
    """Run the CLI in-process (its stdout goes to stderr, keeping this
    script's stdout to findings); returns the wall in seconds."""
    from chromosight_tpu.cli.main import main

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        rc = main([str(a) for a in argv])
    if rc not in (0, None):
        raise RuntimeError(f"chromosight {' '.join(map(str, argv))}: rc={rc}")
    return time.perf_counter() - t0


def read_tsv(path):
    import pandas as pd

    return pd.read_csv(path, sep="\t")


def golden(name):
    return read_tsv(DATA / f"{name}.tsv")


# --------------------------------------------------------------------- #
# Phases
# --------------------------------------------------------------------- #
def phase0(n_cards):
    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        raise SystemExit(f"chip_smoke: JAX backend is {backend!r}, not a GPU")
    devices = jax.devices()
    if len(devices) < n_cards:
        raise SystemExit(f"chip_smoke: {n_cards} cards needed, {len(devices)} visible")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    for line in smi.splitlines():
        say(0, f"card: {line}")
    from chromosight_tpu import native
    from chromosight_tpu.config import init_compilation_cache

    init_compilation_cache()
    say(0, f"jax {jax.__version__}, devices {devices}")
    say(0, f"XLA_FLAGS={os.environ.get('XLA_FLAGS')!r}")
    say(0, f"compile cache: {jax.config.jax_compilation_cache_dir}")
    versions = []
    for pkg in ("numpy", "scipy", "pandas", "jsonschema", "h5py"):
        try:
            versions.append(f"{pkg} {importlib.metadata.version(pkg)}")
        except importlib.metadata.PackageNotFoundError:
            versions.append(f"{pkg} not installed")
    say(0, ", ".join(versions))
    if native.get_lib() is None:
        raise RuntimeError("native host library did not build or load")
    say(0, "native host library loaded")
    return devices[0].device_kind


def phase1():
    cool = WORK / "example.cool"
    shutil.copy(EXAMPLE_COOL, cool)
    out = WORK / "example"
    wall = run_cli("detect", "--no-plotting", cool, out)
    n, d = compare_calls(read_tsv(f"{out}.tsv"), golden("golden_detect_loops"), "detect")
    say(1, f"detect: {n} calls = golden, max |d score| {d:.3g}, {wall:.2f} s")
    wall = run_cli("quantify", "--no-plotting", EXAMPLE_BED2, cool, out)
    n, d = compare_quantify(
        read_tsv(f"{out}.tsv"), golden("golden_quantify_loops"), "quantify"
    )
    say(1, f"quantify: {n} rows = golden, max |d score| {d:.3g}, {wall:.2f} s")
    for engine, limit in (("dense", None), ("tiled", 50)):
        ctx = env(CHROMOSIGHT_TPU_DENSE_LIMIT=limit) if limit else contextlib.nullcontext()
        with ctx:
            wall = run_cli("detect", "--no-plotting", "--inter", cool, out)
        n, d = compare_calls(
            read_tsv(f"{out}.tsv"), golden("golden_detect_loops_inter"),
            f"detect --inter ({engine})",
        )
        say(1, f"detect --inter, {engine} engine: {n} calls = golden, "
               f"max |d score| {d:.3g}, {wall:.2f} s")


def make_genome():
    """Generate the seed-0 genome (in a subprocess that imports no JAX)
    and check it against the goldens' fingerprint."""
    path = WORK / f"genome_{GENOME_BINS}x{GENOME_CHROMS}.cool"
    t0 = time.perf_counter()
    subprocess.run(
        [
            sys.executable, REPO / "tools" / "make_synthetic_cool.py", path,
            "--bins", str(GENOME_BINS), "--chroms", str(GENOME_CHROMS),
        ],
        check=True, stdout=sys.stderr,
        env=dict(os.environ, PYTHONPATH=str(REPO)),
    )
    wall = time.perf_counter() - t0
    from chromosight_tpu.ops.oracle import genome_fingerprint

    got = genome_fingerprint(path)
    meta = json.loads((DATA / "golden_genome_meta.json").read_text())
    if got != meta["fingerprint"]:
        raise AssertionError(f"genome fingerprint {got} != {meta['fingerprint']}")
    return path, wall, got


def genome_detects(cool, phase, label=""):
    out = WORK / "genome"
    for pattern in ("loops", "borders"):
        gold = golden(f"golden_genome_{pattern}")
        walls = []
        for run in ("cold", "warm"):
            walls.append(run_cli("detect", "--no-plotting", "--pattern", pattern, cool, out))
            n, d = compare_calls(read_tsv(f"{out}.tsv"), gold, f"genome {pattern}{label} {run}")
        say(phase, f"genome {pattern}{label}: {n} calls = golden, max |d score| "
                   f"{d:.3g}; wall cold {walls[0]:.2f} s, warm {walls[1]:.2f} s")


def phase2():
    cool, wall, fp = make_genome()
    say(2, f"genome generated in {wall:.1f} s: {fp['nnz']} pixels, fingerprint = golden")
    genome_detects(cool, 2)
    return cool


def chromosome_band(cool, config):
    """chr1's preprocessed band as the CLI builds it: (band, missing, n,
    max_dist)."""
    from chromosight_tpu.detection import _pad_to_bucket
    from chromosight_tpu.runtime.genome import HicGenome

    genome = HicGenome(str(cool), kernel_config=config)
    genome.normalize(norm="auto", n_mads=5, threads=1)
    genome.compute_max_dist()
    genome.make_sub_matrices()
    cm = genome.sub_mats.iloc[0].contact_map
    cm.create_mat()
    band, miss, n, _width = _pad_to_bucket(cm)
    return band, miss, n, int(cm.max_dist)


def timed(fn, *args, reps=5):
    """(output, compile + first run seconds, median steady seconds) of a
    jitted call, each run fenced with block_until_ready."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return out, first, float(np.median(times))


def phase3(cool):
    """The loops sweep (``band_normxcorr``) and the three-kernel borders
    sweep (``band_normxcorr_multi``) on chr1, each against the float64
    oracle, with its matmul precisions and device time."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    import chromosight_tpu.kernels as ck
    from chromosight_tpu.ops.band import (
        band_normxcorr,
        band_normxcorr_multi,
        shear_kernel,
    )
    from chromosight_tpu.ops.oracle import band_oracle, matmul_precisions

    for pattern in ("loops", "borders"):
        config = dict(getattr(ck, pattern))
        kernels = [np.asarray(k, np.float32) for k in config["kernels"]]
        shape = kernels[0].shape
        band, miss, n, max_dist = chromosome_band(cool, config)
        tol = config["max_perc_undetected"] / 100
        pearson = float(config["pearson"])
        stacks = [
            np.stack([f(k) for k in kernels]).astype(np.float32)
            for f in (np.asarray, shear_kernel, lambda k: shear_kernel(k**2))
        ]
        if len(kernels) == 1:
            program, kargs = band_normxcorr, [jnp.asarray(x[0]) for x in stacks]
        else:
            program, kargs = band_normxcorr_multi, [jnp.asarray(x) for x in stacks]

        def sweep(b, m):
            return program(b, m, *kargs, shape, n, max_dist, tol, pearson)

        miss_d = jnp.asarray(miss)
        found = matmul_precisions(sweep, band, miss_d)
        if set(found) - {lax.Precision.HIGHEST}:
            raise AssertionError(f"{pattern} sweep: matmul precisions {found}")
        name = f"{pattern} sweep ({len(kernels)} x {shape} kernels)"
        (corr, logp, _cand), first, steady = timed(sweep, band, miss_d)
        cost = jax.jit(sweep).lower(band, miss_d).compile().cost_analysis()
        cost = cost[0] if isinstance(cost, (list, tuple)) else cost
        say(3, f"{name}: chr1 band {tuple(band.shape)} (n={n}, max_dist="
               f"{max_dist}), {len(found)} matmuls, none below HIGHEST; device time {steady * 1e3:.2f} ms "
               f"(compile + first run {first:.1f} s), "
               f"{cost.get('bytes accessed', 0) / 1e9:.3f} GB accessed by "
               "XLA's cost analysis of the compiled program")
        if len(kernels) == 1:
            corr, logp = corr[None], logp[None]

        rows = [(0, ORACLE_ROWS), (n - ORACLE_ROWS, n)] if n > 2 * ORACLE_ROWS else [(0, n)]
        t0 = time.perf_counter()
        for k, K in enumerate(kernels):
            oracle = [band_oracle(np.asarray(band), miss, K, n, max_dist, tol, rows=r)
                      for r in rows]
            worst = sweep_metrics(
                np.concatenate([corr[k, lo:hi] for lo, hi in rows]),
                np.concatenate([logp[k, lo:hi] for lo, hi in rows]),
                np.concatenate([o[0] for o in oracle]),
                np.concatenate([o[1] for o in oracle]),
                pearson,
            )
            say(3, f"{name}, kernel {k}, against the float64 oracle on rows "
                   f"{rows}: max |d corr| {worst['max_dcorr']:.3g}, max |d log10 p| "
                   f"{worst['max_dlog10p']:.3g}, flips {worst['flips']} "
                   f"({worst['flips_outside_band']} outside +-{AMBIGUITY}) of "
                   f"{worst['candidates']} candidates")
            if worst["max_dcorr"] > SCORE_TOL or worst["flips_outside_band"]:
                raise AssertionError(
                    f"{name}, kernel {k}: sweep disagrees with the oracle: {worst}"
                )
        say(3, f"{name}: oracle took {time.perf_counter() - t0:.1f} s on the host")


def phase_four_cards():
    cool, wall, fp = make_genome()
    say(4, f"genome generated in {wall:.1f} s: {fp['nnz']} pixels, fingerprint = golden")
    from chromosight_tpu.parallel import auto_mesh

    say(4, f"mesh {dict(auto_mesh(batch=GENOME_CHROMS).shape)}")
    genome_detects(cool, 4, " (GSPMD)")
    with env(CHROMOSIGHT_TPU_SHARD_MAP=1):
        out = WORK / "genome"
        t0 = time.perf_counter()
        run_cli("detect", "--no-plotting", "--pattern", "loops", cool, out)
        n, d = compare_calls(read_tsv(f"{out}.tsv"), golden("golden_genome_loops"),
                             "genome loops (shard_map)")
        say(4, f"genome loops (shard_map): {n} calls = golden, max |d score| "
               f"{d:.3g}, {time.perf_counter() - t0:.2f} s")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument(
        "--four-cards", action="store_true",
        help="run only the multi-device phase, on four cards",
    )
    opts = ap.parse_args(argv)
    if not (REPO / "chromosight_tpu").is_dir():
        raise SystemExit(f"chip_smoke: {REPO} is not a checkout of the repository")
    n_cards = 4 if opts.four_cards else 1
    kind = phase0(n_cards)
    if WORK.exists():
        shutil.rmtree(WORK)
    WORK.mkdir(parents=True)
    try:
        if opts.four_cards:
            phase_four_cards()
        else:
            phase1()
            phase3(phase2())
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    import jax

    print(last_line(jax.devices()[0].platform, kind, len(jax.devices())))


if __name__ == "__main__":
    main()
