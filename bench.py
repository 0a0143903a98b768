#!/usr/bin/env python3
"""Benchmark: cached-compile END-TO-END genome-scale loop detection.

Workload: the full `chromosight detect` pipeline (cool IO -> native
fetch/balance/scatter -> device upload -> fused band normxcorr2 ->
candidate extraction -> foci/validation -> tsv) on a synthetic
multi-chromosome 5 kb genome with planted loops (the BASELINE.json
"human 5kb genome-wide detect" shape).  The genome is generated once and
cached under ``build/``; the pipeline runs in-process, first to compile
(reported separately) and then timed.

The baseline is the REFERENCE'S OWN sparse engine
(``chromosight.utils.detection.normxcorr2`` full-mode with missing mask
and p-values, reference ``utils/detection.py:917-1131``) imported from
the reference tree and timed on a slice of the same data, scaled per
window (cooler/docopt are only its IO/CLI layers; the engine itself
needs just numpy/scipy/sklearn).  When the reference tree is absent a
same-math reimplementation is timed instead; the JSON output names
which baseline ran.

Prints ONE json line with the contract keys {metric, value, unit,
vs_baseline} plus: wall_s, recall, a stage breakdown, the measured
host<->device transfer rates and the device's published peaks.
"""

import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np

from chromosight_tpu.config import init_compilation_cache

init_compilation_cache()

# Headline workload: the BASELINE.json north-star shape — a human-scale
# 5 kb genome (624k bins = 13 chromosomes x 48k bins, ~331M pixels).
GENOME_BINS = int(os.environ.get("CHROMOSIGHT_BENCH_GENOME_BINS", 624_000))
GENOME_CHROMS = int(os.environ.get("CHROMOSIGHT_BENCH_GENOME_CHROMS", 13))
BASELINE_BINS = int(os.environ.get("CHROMOSIGHT_BENCH_BASELINE_BINS", 5000))
MAX_DIST = 400  # loops config: 2 Mb at 5 kb
CACHE_DIR = pathlib.Path(
    os.environ.get(
        "CHROMOSIGHT_BENCH_CACHE",
        pathlib.Path(__file__).parent / "build" / "chromosight_bench",
    )
)


def ensure_genome():
    """Generate (once) and cache the synthetic genome cool file."""
    CACHE_DIR.mkdir(parents=True, exist_ok=True)
    per_chrom = GENOME_BINS // GENOME_CHROMS
    path = CACHE_DIR / f"genome_{per_chrom}x{GENOME_CHROMS}.cool"
    if not path.exists():
        tool = pathlib.Path(__file__).parent / "tools" / "make_synthetic_cool.py"
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p
            for p in (
                str(pathlib.Path(__file__).parent),
                env.get("PYTHONPATH", ""),
            )
            if p
        )
        subprocess.run(
            [
                sys.executable,
                str(tool),
                str(path),
                "--bins",
                str(per_chrom),
                "--chroms",
                str(GENOME_CHROMS),
            ],
            check=True,
            env=env,
            # the generator's progress lines must not pollute stdout:
            # the bench contract is ONE json line
            stdout=sys.stderr,
        )
    return path


def measure_link():
    """Measured host<->device bandwidth and scalar roundtrip latency,
    each transfer fenced with a host readback."""
    import jax
    import jax.numpy as jnp

    _ = float(jnp.zeros(()))
    x = np.random.rand(2048, 2048).astype(np.float32)  # 16 MB
    t0 = time.perf_counter()
    d = jax.device_put(x)
    float(jnp.sum(d[:1, :1]))
    up = x.nbytes / (time.perf_counter() - t0)
    t0 = time.perf_counter()
    _ = np.asarray(d)
    down = x.nbytes / (time.perf_counter() - t0)
    t0 = time.perf_counter()
    for _i in range(5):
        float(jnp.sum(d[:1, :1]))
    rtt = (time.perf_counter() - t0) / 5
    return up, down, rtt


def run_detect(cool_path, prefix):
    from contextlib import redirect_stdout

    from chromosight_tpu.cli import main as climain

    argv_save = sys.argv
    sys.argv = [
        "chromosight",
        "detect",
        "--no-plotting",
        "--threads",
        "4",
        str(cool_path),
        str(prefix),
    ]
    try:
        # keep stdout clean: the bench contract is ONE json line
        with redirect_stdout(sys.stderr):
            climain.main()
    except SystemExit as exc:  # "no patterns" exits 0
        if exc.code not in (None, 0):
            raise
    finally:
        sys.argv = argv_save


def loop_recall(out_tsv, truth_bed2d, binsize=5000, tol_bins=3):
    """Fraction of planted loops recovered within tol_bins."""
    import pandas as pd

    calls = pd.read_csv(out_tsv, sep="\t")
    truth = pd.read_csv(
        truth_bed2d,
        sep="\t",
        header=None,
        names=["chrom1", "start1", "end1", "chrom2", "start2", "end2"],
    )
    got = 0
    by_chrom = {c: g for c, g in calls.groupby("chrom1")}
    for _, t in truth.iterrows():
        g = by_chrom.get(t["chrom1"])
        if g is None:
            continue
        d1 = (g["start1"] - t["start1"]).abs() // binsize
        d2 = (g["start2"] - t["start2"]).abs() // binsize
        if ((d1 <= tol_bins) & (d2 <= tol_bins)).any():
            got += 1
    return got / max(len(truth), 1)


def run_reference_engine(band, missing, K, max_dist, reference_dir=None):
    """Time the REFERENCE'S OWN sparse engine (normxcorr2 full-mode with
    missing mask + p-values — the per-chromosome hot path) on the same
    detrended band slice.  Returns seconds, or None when the reference
    tree is unavailable.  cooler/docopt are not installed, but the
    reference's detection/preprocessing modules only need
    numpy/scipy/sklearn, so the engine itself runs unmodified — this
    pins vs_baseline to real chromosight code, not a reimplementation.
    """
    import importlib
    import scipy.sparse as sp

    reference_dir = reference_dir or os.environ.get(
        "CHROMOSIGHT_REFERENCE_DIR", "/root/reference"
    )
    if not (pathlib.Path(reference_dir) / "chromosight").is_dir():
        return None
    sys.path.insert(0, str(reference_dir))
    try:
        refdet = importlib.import_module("chromosight.utils.detection")
        refpre = importlib.import_module("chromosight.utils.preprocessing")
    except Exception:
        sys.path.pop(0)
        return None
    try:
        n, width = band.shape
        i, d = np.nonzero(band)
        j = i + d
        ok = j < n
        signal = sp.coo_matrix(
            (band[i[ok], d[ok]], (i[ok], j[ok])), shape=(n, n)
        ).tocsr()
        valid = np.flatnonzero(~missing)
        t0 = time.perf_counter()
        mask = refpre.make_missing_mask(
            signal.shape,
            valid_rows=valid,
            valid_cols=valid,
            max_dist=max_dist,
            sym_upper=True,
        )
        corr, _pvals = refdet.normxcorr2(
            signal,
            np.asarray(K, np.float64),
            max_dist=max_dist,
            sym_upper=True,
            full=True,
            missing_mask=mask,
            missing_tol=0.5,
            pval=True,
        )
        dt = time.perf_counter() - t0
        _ = (corr >= 0.3).sum()  # touch the result
        return dt
    except Exception as exc:
        # Never lose the bench to a baseline failure: the timed genome
        # passes already ran, and main() falls back to the
        # reference-formulation reimplementation when this returns None.
        print(f"reference engine failed ({exc!r}); falling back", file=sys.stderr)
        return None
    finally:
        sys.path.pop(0)


# --------------------------------------------------------------------- #
# Reference-formulation CPU baseline (same Pearson math, scipy sparse)
# --------------------------------------------------------------------- #
def baseline_band(cool_path, nb, width):
    """First nb bins of chr1 as a (nb, width) detrended band (same
    preprocessing semantics as the pipeline, host numpy)."""
    from chromosight_tpu.io.cool import CoolFile

    clr = CoolFile(str(cool_path))
    s, e = clr.extent(clr.chromnames[0])
    e = min(e, s + nb)
    band = clr.band_upper((s, e), width, balance=True)
    band = np.nan_to_num(band, nan=0.0)
    missing = ~band.any(axis=1)
    with np.errstate(invalid="ignore", divide="ignore"):
        law = band.sum(0) / np.maximum((band > 0).sum(0), 1)
        band = np.where(band != 0, band / law[None, :], 0.0)
    band[band >= 10] = 1.0
    return band.astype(np.float64), missing


def run_baseline(band, missing, K, max_dist):
    """Reference-style engine: one banded-Toeplitz matmul per kernel row
    (reference detection.py:699-713) x 6 convolutions + the
    missing-corrected Pearson algebra."""
    import scipy.sparse as sp

    n, width = band.shape
    i, d = np.nonzero(band)
    j = i + d
    ok = j < n
    signal = sp.coo_matrix(
        (band[i[ok], d[ok]], (i[ok], j[ok])), shape=(n, n)
    ).tocsr()
    mk, nk = K.shape

    def frame(mat):
        m = sp.csr_matrix((mk - 1, mat.shape[1]))
        out = sp.vstack([m, mat, m], format="csr")
        m2 = sp.csr_matrix((out.shape[0], nk - 1))
        return sp.hstack([m2, out, m2], format="csr")

    t0 = time.perf_counter()
    framed = frame(signal)
    mi = np.flatnonzero(missing)
    shifts = np.arange(max_dist + 1)
    rr = np.concatenate(
        [(mi[:, None] - shifts[None, :]).ravel(), np.repeat(mi, max_dist + 1)]
    )
    cc = np.concatenate(
        [np.repeat(mi, max_dist + 1), (mi[:, None] + shifts[None, :]).ravel()]
    )
    okm = (rr >= 0) & (rr < n) & (cc >= 0) & (cc < n)
    mask = sp.coo_matrix(
        (np.ones(okm.sum()), (rr[okm], cc[okm])), shape=(n, n)
    ).tocsr()
    mask.data[:] = 1
    framed_mask = frame(mask)
    big_k = max(mk, nk)
    framed_mask = (
        framed_mask
        + sp.diags(
            np.ones(big_k),
            -np.arange(1, big_k + 1),
            shape=framed_mask.shape,
            format="csr",
        )
    ).tocsr()
    framed_mask.data[:] = 1

    def xcorr_sparse(mat, kern):
        sm, sn = mat.shape
        km, kn_ = kern.shape
        out = None
        for ki in range(km):
            sub = sp.diags(
                kern[ki, :],
                np.arange(kn_),
                shape=(sn - kn_ + 1, sn),
                format="csr",
            )
            term = mat[ki : sm - km + 1 + ki, :].dot(sub.T)
            out = term if out is None else out + term
        out.data[np.abs(out.data) < 1e-4] = 0
        out.eliminate_zeros()
        return out

    ksize = mk * nk
    kernel1 = np.ones(K.shape)
    ksum, k2sum = K.sum(), (K**2).sum()
    sig_mean = xcorr_sparse(framed, kernel1 / ksize)
    sig2 = framed.copy()
    sig2.data = sig2.data**2
    sig2_mean = xcorr_sparse(sig2, kernel1 / ksize)
    conv_k = xcorr_sparse(framed, K / ksize)
    n_miss = xcorr_sparse(framed_mask, kernel1)
    conv_mk = xcorr_sparse(framed_mask, K)
    conv_mk2 = xcorr_sparse(framed_mask, K**2)
    npres = ksize - n_miss.toarray()
    with np.errstate(divide="ignore", invalid="ignore"):
        kmean_eff = (ksum - conv_mk.toarray()) / npres
        k2mean_eff = (k2sum - conv_mk2.toarray()) / npres
        corr_f = ksize / npres
        sm_ = sig_mean.toarray() * corr_f
        s2m = sig2_mean.toarray() * corr_f
        denom = np.sqrt((s2m - sm_**2) * (k2mean_eff - kmean_eff**2))
        denom[npres < int(0.5 * ksize)] = 0
        num = (conv_k.toarray() - sm_ * kmean_eff / corr_f) * corr_f
        corr = np.where(np.abs(denom) < 1e-10, 0.0, num / denom)
    corr[~np.isfinite(corr)] = 0
    np.clip(corr, -1, 1, out=corr)
    cand = (corr >= 0.3).sum()
    return time.perf_counter() - t0, int(cand)


def main():
    from chromosight_tpu import observability as obs
    import chromosight_tpu.kernels as ck

    cool_path = ensure_genome()
    truth = pathlib.Path(str(cool_path) + ".truth.bed2d")
    up_bw, down_bw, rtt = measure_link()

    with tempfile.TemporaryDirectory() as tmp:
        # Warm pass: compiles and program loads.
        t0 = time.perf_counter()
        run_detect(cool_path, os.path.join(tmp, "warm"))
        warm_s = time.perf_counter() - t0

        # Timed passes: cached programs, fresh IO and device work.  The
        # wall is best-of-2 (both reported in `walls`); stage/byte
        # accounting comes from the best pass.
        walls, snaps, comps = [], [], []
        for rep in range(2):
            obs.reset()
            t0 = time.perf_counter()
            run_detect(cool_path, os.path.join(tmp, "out"))
            walls.append(time.perf_counter() - t0)
            snaps.append(obs.snapshot())
            comps.append(obs.compute_snapshot())
        if max(walls) > 1.5 * min(walls):
            # The two passes disagree badly; one more pass costs seconds.
            obs.reset()
            t0 = time.perf_counter()
            run_detect(cool_path, os.path.join(tmp, "out"))
            walls.append(time.perf_counter() - t0)
            snaps.append(obs.snapshot())
            comps.append(obs.compute_snapshot())
        best = int(np.argmin(walls))
        wall = walls[best]
        stages, _counts, byte_totals = snaps[best]
        compute = comps[best]
        recall = (
            loop_recall(os.path.join(tmp, "out.tsv"), truth)
            if truth.exists()
            else None
        )

    windows = GENOME_BINS * (MAX_DIST + 1)
    e2e_wps = windows / wall

    # ---- baseline: pinned END-TO-END reference wall when available --- #
    # REFERENCE_E2E.json (repo root) pins wall-clocks of the ACTUAL
    # reference CLI (tools/run_reference_e2e.py: its own cmd_detect,
    # cli/chromosight.py:625-896, via cooler/docopt shims) measured on
    # this host.  A record matching this genome gives a direct
    # end-to-end / end-to-end ratio; a record for a smaller genome
    # scales per window; the engine-only slice is the last resort.
    cpu_wps = None
    baseline_kind = None
    t_cpu = None
    ref_e2e_path = pathlib.Path(__file__).parent / "REFERENCE_E2E.json"
    clr = None
    if ref_e2e_path.exists():
        # Pinned records are matched by (n_bins, nnz); when the cool
        # cannot be read those can't be verified, so fall through to the
        # engine baseline instead of pinning blind.
        try:
            from chromosight_tpu.io.cool import CoolFile

            clr = CoolFile(str(cool_path))
        except Exception:
            clr = None
    if clr is not None:
        recs = json.loads(ref_e2e_path.read_text())
        loops_recs = [
            r for r in recs.values() if r.get("pattern") == "loops"
        ]
        exact = [
            r
            for r in loops_recs
            if r["genome"]["n_bins"] == clr.n_bins
            and r["genome"]["nnz"] == clr.nnz
        ]
        if exact:
            r = exact[0]
            t_cpu = r["wall_s"]
            cpu_wps = GENOME_BINS * (MAX_DIST + 1) / t_cpu
            baseline_kind = (
                "reference CLI end-to-end on THIS genome (pinned, "
                f"{t_cpu:.0f}s for {r['n_patterns']} patterns)"
            )
        elif loops_recs:
            r = max(loops_recs, key=lambda r: r["genome"]["n_bins"])
            t_cpu = r["wall_s"]
            cpu_wps = r["genome"]["n_bins"] * (MAX_DIST + 1) / t_cpu
            baseline_kind = (
                "reference CLI end-to-end, scaled per window from its "
                f"measured {t_cpu:.0f}s wall on a "
                f"{r['genome']['n_bins']}-bin genome (pinned)"
            )
    if cpu_wps is None:
        K = np.asarray(ck.loops["kernels"][0])
        width = 512
        nb = min(BASELINE_BINS, GENOME_BINS // GENOME_CHROMS)
        band_b, missing_b = baseline_band(cool_path, nb, width)
        # best of two reps: the shared host is contended and a single
        # timing of the CPU engine can swing the ratio 2x
        ref_times = [
            run_reference_engine(band_b, missing_b, K, MAX_DIST)
            for _ in range(2)
        ]
        ref_times = [t for t in ref_times if t is not None]
        if ref_times:
            t_cpu = min(ref_times)
            baseline_kind = (
                "reference chromosight sparse engine (own code), "
                "engine-only slice"
            )
        else:
            t_cpu = min(
                run_baseline(band_b, missing_b, K, MAX_DIST)[0]
                for _ in range(2)
            )
            baseline_kind = "reference-formulation reimplementation"
        cpu_wps = nb * (MAX_DIST + 1) / t_cpu

    up_bytes = byte_totals.get("upload", 0)
    down_bytes = byte_totals.get("download", 0)
    link_s = up_bytes / up_bw + down_bytes / down_bw

    # ---- MFU / roofline accounting ------------------------------------ #
    # Logical FLOPs and HBM-byte bounds per program family come from
    # observability.account_dispatch (the traced jaxpr, loop trip counts
    # included, cached per shape bucket).
    # mfu = logical FLOPs / (wall x fp32 peak): a lower bound on device
    # utilization, since the wall includes host time and the
    # precision=HIGHEST matmuls run in full float32.  hbm_util uses the
    # input+output byte floor (perfect fusion); the unfused upper bound
    # is reported alongside.
    peaks = obs.device_peaks()
    chip = peaks["kind"] if peaks else "cpu"
    sweep_names = [n for n in compute if n != "band_preprocess"]
    flops_total = sum(compute[n]["flops"] for n in compute)
    flops_sweep = sum(compute[n]["flops"] for n in sweep_names)
    hbm_min_sweep = sum(compute[n]["hbm_min_bytes"] for n in sweep_names)
    hbm_unf_sweep = sum(
        compute[n]["hbm_unfused_bytes"] for n in sweep_names
    )
    detect_s = stages.get("detect", wall)
    compute_block = {
        "chip": chip,
        "flops_total_T": round(flops_total / 1e12, 3),
        "detect_stage": {
            "flops_T": round(flops_sweep / 1e12, 3),
            "hbm_min_GB": round(hbm_min_sweep / 1e9, 3),
            "hbm_unfused_GB": round(hbm_unf_sweep / 1e9, 3),
            "tflops_per_s": round(flops_sweep / max(detect_s, 1e-9) / 1e12, 3),
        },
        "per_program": {
            n: {
                "flops_T": round(c["flops"] / 1e12, 3),
                "hbm_min_GB": round(c["hbm_min_bytes"] / 1e9, 3),
                "dispatches": c["dispatches"],
            }
            for n, c in sorted(compute.items())
        },
    }
    if peaks:
        peak_flops, peak_bw = peaks["fp32_flops"], peaks["hbm_bytes"]
        compute_block["peak"] = {
            "tflops_fp32": round(peak_flops / 1e12, 1),
            "hbm_GBps": round(peak_bw / 1e9, 1),
        }
        compute_block["mfu_detect_stage"] = round(
            flops_sweep / max(detect_s, 1e-9) / peak_flops, 5
        )
        compute_block["mfu_e2e"] = round(
            flops_total / max(wall, 1e-9) / peak_flops, 5
        )
        compute_block["hbm_util_detect_stage_min"] = round(
            hbm_min_sweep / max(detect_s, 1e-9) / peak_bw, 5
        )
    print(
        json.dumps(
            {
                "metric": (
                    "end-to-end genome detect (cool->tsv, cached compile, "
                    f"{GENOME_BINS} bins x {MAX_DIST + 1} diagonals)"
                ),
                "value": round(e2e_wps, 1),
                "unit": "windows/s",
                "vs_baseline": round(e2e_wps / cpu_wps, 2),
                "wall_s": round(wall, 2),
                "walls_s": [round(w, 2) for w in walls],
                "baseline": baseline_kind,
                "baseline_slice_s": round(t_cpu, 2),
                "warm_compile_load_s": round(warm_s, 2),
                "recall_planted_loops": recall,
                "stage_s": {
                    k: round(v, 2) for k, v in sorted(stages.items())
                },
                "link": {
                    "up_MBps": round(up_bw / 1e6, 1),
                    "down_MBps": round(down_bw / 1e6, 1),
                    "rtt_ms": round(rtt * 1e3, 1),
                    "upload_MB": round(up_bytes / 1e6, 1),
                    "download_MB": round(down_bytes / 1e6, 1),
                    "attributable_s": round(link_s, 2),
                },
                "compute": compute_block,
                "note": (
                    "vs_baseline compares per-window throughput against "
                    "the 'baseline' named above — end-to-end reference CLI "
                    "walls (REFERENCE_E2E.json, measured on a CPU host via "
                    "tools/run_reference_e2e.py) when pinned, engine-only "
                    "slice otherwise"
                ),
            }
        )
    )


if __name__ == "__main__":
    main()
