#!/usr/bin/env python3
"""Pattern exploration and detection.

Explore and detect patterns (loops, borders, centromeres, etc.) in Hi-C
contact maps with pattern matching, using a JAX/XLA compute core.

Usage:
    chromosight detect  [--kernel-config=FILE] [--pattern=loops]
                        [--pearson=auto] [--win-size=auto] [--iterations=auto]
                        [--win-fmt={json,npy}] [--norm={auto,raw,force}]
                        [--subsample=no] [--inter] [--tsvd] [--smooth-trend]
                        [--n-mads=5] [--min-dist=0] [--max-dist=auto]
                        [--no-plotting] [--min-separation=auto] [--dump=DIR]
                        [--threads=1] [--perc-zero=auto]
                        [--perc-undetected=auto] <contact_map> <prefix>
    chromosight generate-config [--preset loops] [--click contact_map]
                        [--norm={auto,raw,norm}] [--win-size=auto] [--n-mads=5]
                        [--chroms=CHROMS] [--inter] [--threads=1] <prefix>
    chromosight quantify [--inter] [--pattern=loops] [--subsample=no]
                         [--win-fmt=json] [--kernel-config=FILE] [--norm={auto,raw,norm}]
                         [--threads=1] [--n-mads=5] [--win-size=auto]
                         [--perc-undetected=auto] [--perc-zero=auto]
                         [--no-plotting] [--tsvd] <bed2d> <contact_map> <prefix>
    chromosight list-kernels [--long] [--mat] [--name=kernel_name]
    chromosight test

    detect:
        performs pattern detection on a Hi-C contact map via template
        matching
    quantify:
        Gives a pattern matching score for a list of 2D coordinates on an
        input Hi-C contact map
    generate-config:
        Generate pre-filled config files to use for detect and quantify.
        A config consists of a JSON file describing parameters for the
        analysis and path pointing to kernel matrices files. Those matrices
        files are tsv files with numeric values as kernel to use for
        convolution.
    list-kernels:
        Prints information about available kernels.
    test:
        Download example data and run the loop detection pipeline on it,
        comparing the detection log against the golden record.

Arguments for detect:
    <contact_map>               The Hi-C contact map to detect patterns on,
                                in .cool format.
    <prefix>                    Common path prefix used for all output files
                                (e.g. "out" creates out.tsv, out.json, ...).
                                May include a directory, which must exist.

    -k FILE, --kernel-config=FILE   Custom JSON kernel-config file to use
                                for pattern detection instead of a preset.
                                Mutually exclusive with --pattern.
    -P NAME, --pattern=NAME     Preset pattern configuration to use
                                [default: loops]. `list-kernels` shows all
                                presets.
    -p FLOAT, --pearson=FLOAT   Minimum Pearson correlation for a pixel to
                                seed a detection focus. "auto" reads it
                                from the kernel config. [default: auto]
    -W INT, --win-size=INT      Resize the kernel matrices to this size
                                (pixels, odd) before scanning. "auto" keeps
                                the preset size. [default: auto]
    -i INT, --iterations=INT    How many times to iterate the detection,
                                re-deriving the kernel from the pileup of
                                the previous pass. "auto" reads
                                max_iterations from the config.
                                [default: 1]
    -w FMT, --win-fmt=FMT       Output format for the windows around
                                detected patterns: "json" (dict of 2D
                                lists) or "npy" (stacked numpy array).
                                [default: json]
    -n NORM, --norm=NORM        "auto" reuses weights stored in the cool
                                file (balancing only if absent); "raw"
                                skips balancing; "force" recomputes ICE
                                weights and overwrites the file.
                                [default: auto]
    -s FLOAT, --subsample=FLOAT Use only this proportion of the contacts
                                (bootstrap subsampling), e.g. for
                                coverage-matched comparisons. [default: no]
    -I, --inter                 Also scan inter-chromosomal (trans)
                                matrices. Substantially increases RAM use.
    -V, --tsvd                  Factorise kernels by truncated SVD (keeping
                                99.9% information) to accelerate the
                                convolutions.
    -T, --smooth-trend          Smooth the distance law with isotonic
                                regression before detrending; useful on
                                sparse or noisy data.
    -N FLOAT, --n-mads=FLOAT    Bins whose log contact sum is more than
                                this many median absolute deviations below
                                the median are treated as undetectable.
                                [default: 5]
    -m INT, --min-dist=INT      Minimum genomic distance (bp) from the
                                diagonal at which to report patterns.
                                "auto" reads the config. [default: auto]
    -M INT, --max-dist=INT      Maximum genomic distance (bp) scanned; the
                                intra band representation is sized from it.
                                "auto" reads the config. [default: auto]
    -S INT, --min-separation=INT  Minimum genomic separation (bp) between
                                two reported patterns; closer pairs keep
                                only the best-scoring one. "auto" reads the
                                config. [default: auto]
    -u FLOAT, --perc-undetected=FLOAT  Reject windows with more than this
                                percentage of undetectable pixels (missing
                                bins). "auto" reads the config.
                                [default: auto]
    -z FLOAT, --perc-zero=FLOAT Reject windows with more than this
                                percentage of zero pixels. "auto" reads the
                                config. [default: auto]
    -d DIR, --dump=DIR          Save matrix snapshots after each processing
                                stage into DIR (debugging aid).
    -t INT, --threads=INT       Number of worker threads pipelining host
                                IO, device uploads and the per-chromosome
                                host tails (foci labeling, validation)
                                behind detection compute (the device
                                itself is shared). [default: 1]
    --no-plotting               Skip the pileup pdf output.

Arguments for quantify:
    <bed2d>                     Tab-separated file of coordinate pairs
                                (chrom1 start1 end1 chrom2 start2 end2,
                                with or without header) to score.
    <contact_map>, <prefix>     As for detect.
    Options shared with detect keep the same meaning; scanning distance is
    set automatically from the furthest input pair and min-dist is 0.

Arguments for generate-config:
    <prefix>                    Path prefix for the generated config
                                (prefix.json + prefix.N.txt kernels).
    -e NAME, --preset=NAME      Preset config to start from.
                                [default: loops]
    -c FILE, --click=FILE       Build the kernel interactively instead:
                                displays the contact map FILE and records
                                double-clicked windows, whose gaussian-
                                blurred pileup becomes the kernel.
    -C LIST, --chroms=LIST      Comma-separated chromosome subset to
                                display in --click mode.

Arguments for list-kernels:
    --long                      Also print each preset's parameters.
    --mat                       Render each kernel matrix as ASCII art.
    --name=NAME                 Restrict output to one kernel.
                                [default: all]
"""

from __future__ import annotations

import io
import itertools as it
import json
import os
import pathlib
import sys
import tempfile
from contextlib import contextmanager

import numpy as np
import pandas as pd

import chromosight_tpu.detection as cid
import chromosight_tpu.io as cio
import chromosight_tpu.kernels as ck
from chromosight_tpu.cli.args import CliError, parse_args
from chromosight_tpu.preprocessing import resize_kernel
from chromosight_tpu.runtime import HicGenome
from chromosight_tpu.stats import fdr_correction
from chromosight_tpu.version import __version__
from chromosight_tpu.config import init_compilation_cache

init_compilation_cache()

LOGO = np.loadtxt(pathlib.Path(__file__).parents[0] / "logo.txt")
URL_EXAMPLE_DATASET = (
    "https://raw.githubusercontent.com/koszullab/"
    "chromosight/master/data_test/example.cool"
)
# Offline fallback for the test subcommand: a re-encoded copy of the example
# dataset shipped with the repository (overridable via environment).
LOCAL_EXAMPLE_DATASET = os.environ.get(
    "CHROMOSIGHT_TPU_TEST_COOL",
    str(pathlib.Path(__file__).parents[2] / "data_test" / "example.cool"),
)

# Golden log of the self-test (identical to the reference's TEST_LOG,
# cli/chromosight.py:185-199: the detection results must match exactly).
TEST_LOG = f"""Fetching test dataset at {URL_EXAMPLE_DATASET}...
Running detection on test dataset...
pearson set to 0.3 based on config file.
max_dist set to 2000000 based on config file.
min_dist set to 20000 based on config file.
min_separation set to 5000 based on config file.
max_perc_undetected set to 50.0 based on config file.
max_perc_zero set to 10.0 based on config file.
Matrix already balanced, reusing weights
Preprocessing sub-matrices...
Detecting patterns...
89 patterns detected
Saving patterns in chromosight_test.tsv
Saving patterns in chromosight_test.json
"""

# Final output column order (reference tsv layout).
DETECT_COLUMNS = [
    "chrom1", "start1", "end1", "chrom2", "start2", "end2",
    "bin1", "bin2", "kernel_id", "iteration", "score", "pvalue", "qvalue",
]
QUANTIFY_COLUMNS = [
    "chrom1", "start1", "end1", "chrom2", "start2", "end2",
    "bin1", "bin2", "score", "pvalue", "qvalue",
]


# --------------------------------------------------------------------- #
# Option / config resolution
# --------------------------------------------------------------------- #
def _resolve_config_param(cfg, name, cli_value, cast):
    """Merge one CLI override into the kernel config.

    The CLI sentinel "auto" defers to the config file (announced on
    stderr, exactly as the reference does — the self-test log diff depends
    on these lines); any other value is cast and replaces the config's.
    """
    if cli_value == "auto":
        if name not in cfg:
            raise KeyError(
                f"{name} is not defined in the config. Please add it to "
                f"the JSON config file, or provide it as a command line option."
            )
        sys.stderr.write(f"{name} set to {cfg[name]} based on config file.\n")
        return
    try:
        cfg[name] = cast(cli_value)
    except ValueError:
        raise ValueError(f'Error: {name} must be a {cast} or "auto"')


def _load_scan_config(args, overrides):
    """Load the kernel config named by --pattern / --kernel-config and
    apply the given CLI overrides ({name: (value, cast)})."""
    custom_path = args["--kernel-config"]
    if custom_path is not None:
        cfg = cio.load_kernel_config(custom_path, True)
    else:
        cfg = cio.load_kernel_config(args["--pattern"], False)
    for name, (value, cast) in overrides.items():
        _resolve_config_param(cfg, name, value, cast)
    return cfg


def _resize_config_kernels(cfg, win_size):
    """Resize every kernel in the config to win_size x win_size pixels."""
    win_size = int(win_size)
    if not win_size % 2:
        raise ValueError("--win-size must be odd")
    cfg["kernels"] = [
        resize_kernel(k, factor=win_size / k.shape[0]) for k in cfg["kernels"]
    ]
    return win_size


def _check_win_fmt(win_fmt):
    if win_fmt not in ("npy", "json"):
        sys.stderr.write("Error: --win-fmt must be either json or npy.\n")
        sys.exit(1)


def _parse_subsample(value):
    return None if value == "no" else value


# --------------------------------------------------------------------- #
# Submatrix scanning
# --------------------------------------------------------------------- #
class _Prefetcher:
    """Overlaps ContactMap.create_mat (cool reads + device uploads, which
    release the GIL) of upcoming work items with detection on the current
    one.  ``threads`` is the total worker count: one consumer plus up to
    threads-1 prefetch slots running ahead."""

    def __init__(self, items, threads):
        self.items = items
        # Floor of two prefetch slots even at --threads 1 (the default):
        # create_mat is cool reads + native scatter + async uploads, all
        # GIL-released, and the consumer spends most of its wall blocked
        # on device readbacks — overlapping upcoming maps' IO under the
        # current map's device wait removes the strict IO->compute
        # serialization (without lookahead, detect and load+preprocess
        # walls add up; one slot hides most of the load, a second slot
        # covers maps whose fetch outlasts one device scan).
        # --threads keeps raising the lookahead;
        # CHROMOSIGHT_TPU_PREFETCH=0 restores the serial order.
        floor = int(os.environ.get("CHROMOSIGHT_TPU_PREFETCH", "2"))
        self.lookahead = max(
            0, min(max(int(threads) - 1, floor), len(items) - 1)
        )

    @staticmethod
    def _create(data):
        cm = data[0][1].contact_map
        if (
            cm.band_dev is None
            and cm.dense is None
            and cm.sparse is None
        ):
            cm.create_mat()

    def map(self, fn):
        # Worker pipelining: run up to ``depth`` detect workers
        # concurrently (ordered yield).  A single-device worker's wall is
        # mostly fence waits on the dispatch->extract->gather chain;
        # overlapping the next chromosome's chain under the current
        # one's fences hides those waits.  Per-map results are
        # independent (the mesh path already threads the same tails), so
        # outputs are unchanged.
        # CHROMOSIGHT_TPU_DETECT_PIPELINE=1 restores the serial worker.
        depth = max(
            1, int(os.environ.get("CHROMOSIGHT_TPU_DETECT_PIPELINE", "2"))
        )
        if not self.lookahead and depth == 1:
            for data in self.items:
                yield fn(data)
            return
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        from chromosight_tpu.observability import stage as _stage

        with ThreadPoolExecutor(
            max_workers=max(self.lookahead, 1)
        ) as pool, ThreadPoolExecutor(max_workers=depth) as wpool:
            pending = deque(
                pool.submit(self._create, item)
                for item in self.items[: self.lookahead]
            )
            wfuts = deque()
            for idx, data in enumerate(self.items):
                if pending:
                    # time the consumer actually blocks on prefetch IO
                    # (distinct from the worker-side fetch stages, which
                    # run concurrently with detection)
                    with _stage("io: prefetch wait"):
                        pending.popleft().result()
                nxt = idx + self.lookahead
                if nxt < len(self.items):
                    pending.append(pool.submit(self._create, self.items[nxt]))
                wfuts.append(wpool.submit(fn, data))
                if len(wfuts) >= depth:
                    yield wfuts.popleft().result()
            while wfuts:
                yield wfuts.popleft().result()


def _scan_submatrices(genome, worker, payload, threads):
    """Run ``worker`` over every submatrix of the genome with IO
    prefetching; ``payload(sub)`` supplies the per-submatrix extra args.
    Returns the list of worker result dicts, in submatrix order."""
    items = [
        (sub, *payload(sub)) for sub in genome.sub_mats.iterrows()
    ]
    results = []
    for done, res in enumerate(_Prefetcher(items, threads).map(worker)):
        cio.progress(done, len(items), f"{res['chr1']}-{res['chr2']}")
        results.append(res)
    return results


def _retain_maps(genome, n_passes):
    """Whether workers should keep contact maps device-resident across
    (kernel x iteration) passes instead of re-fetching and re-uploading
    the whole genome every pass.  Enabled when there are multiple passes
    and the estimated footprint fits the retain budget (HBM holds a
    human 5 kb genome's band tensors in ~1.3 GB).  Override with
    CHROMOSIGHT_TPU_RETAIN=0 / CHROMOSIGHT_TPU_RETAIN_BYTES."""
    if n_passes <= 1:
        return False
    if os.environ.get("CHROMOSIGHT_TPU_RETAIN", "auto") == "0":
        return False
    if genome.sample is not None:
        # the reference redraws the bootstrap subsample on every pass;
        # keep that behaviour rather than freezing the first draw
        return False
    from chromosight_tpu.runtime.contact_map import (
        COL_BUCKET,
        ROW_BUCKET,
        bucket_size,
    )

    from chromosight_tpu.detection import _dense_limit

    total = 0
    for _, sub in genome.sub_mats.iterrows():
        cm = sub.contact_map
        n1, n2 = cm.shape
        if cm.is_banded:
            width = bucket_size(cm.keep_distance + 1, COL_BUCKET)
            total += bucket_size(n1, ROW_BUCKET) * width * 4
        elif max(n1, n2) > _dense_limit():
            # sparse-resident (trans) map: lives in host RAM (O(nnz)),
            # occupies no device HBM — don't charge it against the
            # retain budget, or --inter genomes could never retain.
            pass
        else:
            total += n1 * n2 * 8
    budget = float(os.environ.get("CHROMOSIGHT_TPU_RETAIN_BYTES", 4e9))
    return total <= budget


def _destroy_all_maps(genome):
    for _, sub in genome.sub_mats.iterrows():
        sub.contact_map.destroy_mat()


def _detect_sub_mat(data):
    """Per-submatrix detection task (reference cli/chromosight.py:601-622)."""
    from chromosight_tpu.observability import stage

    sub, config, kernel, dump = data[0][1], data[1], data[2], data[3]
    destroy = data[4] if len(data) > 4 else True
    with stage("load+preprocess"):
        cm = sub.contact_map
        if cm.band_dev is None and cm.dense is None and cm.sparse is None:
            sub.contact_map.create_mat()
    with stage("detect"):
        patterns, windows = cid.pattern_detector(
            sub.contact_map,
            config,
            kernel,
            dump=dump,
            full=True,
            tsvd=config["tsvd"],
        )
    if destroy:
        sub.contact_map.destroy_mat()
    return {
        "coords": patterns,
        "windows": windows,
        "chr1": sub.chr1,
        "chr2": sub.chr2,
    }


def _detect_sub_mat_multi(data):
    """Per-submatrix detection with every kernel of a config fused into
    one band dispatch (single-device path; the mesh path fuses inside
    detect_on_mesh).  Returns per-kernel (coords, windows) pairs."""
    from chromosight_tpu.observability import stage

    sub, config, kernels, dump = data[0][1], data[1], data[2], data[3]
    destroy = data[4] if len(data) > 4 else True
    with stage("load+preprocess"):
        cm = sub.contact_map
        if cm.band_dev is None and cm.dense is None and cm.sparse is None:
            cm.create_mat()
    with stage("detect"):
        if cm.band_dev is not None:
            per_kernel = cid.detect_banded_multi(
                cm, config, kernels, dump=dump, tsvd=config["tsvd"]
            )
        else:
            per_kernel = [
                cid.pattern_detector(
                    cm, config, k, dump=dump, full=True, tsvd=config["tsvd"]
                )
                for k in kernels
            ]
    if destroy:
        cm.destroy_mat()
    return {
        "per_kernel": per_kernel,
        "chr1": sub.chr1,
        "chr2": sub.chr2,
    }


def _quantify_sub_mat(data):
    """Per-submatrix quantification task (reference cli:229-260)."""
    sub, config, kernel, positions = data[0][1], data[1], data[2], data[3]
    destroy = data[4] if len(data) > 4 else True
    patterns = windows = None
    if positions.shape[0]:
        cm = sub.contact_map
        if cm.band_dev is None and cm.dense is None and cm.sparse is None:
            sub.contact_map.create_mat()
        patterns, windows = cid.pattern_detector(
            sub.contact_map,
            config,
            kernel,
            coords=np.array(positions.loc[:, ["bin1", "bin2"]]),
            full=True,
            tsvd=config["tsvd"],
        )
        if destroy:
            sub.contact_map.destroy_mat()
    return {
        "coords": patterns,
        "windows": windows,
        "chr1": sub.chr1,
        "chr2": sub.chr2,
    }


# --------------------------------------------------------------------- #
# detect
# --------------------------------------------------------------------- #
def _quantify_sub_mat_multi(data):
    """Per-submatrix quantification with every kernel fused into one band
    dispatch (single-device path)."""
    sub, config, kernels, positions = (
        data[0][1],
        data[1],
        data[2],
        data[3],
    )
    destroy = data[4] if len(data) > 4 else True
    per_kernel = [(None, None)] * len(kernels)
    if positions.shape[0]:
        cm = sub.contact_map
        if cm.band_dev is None and cm.dense is None and cm.sparse is None:
            cm.create_mat()
        coords = np.array(positions.loc[:, ["bin1", "bin2"]])
        if cm.band_dev is not None:
            per_kernel = cid.detect_banded_multi(
                cm, config, kernels, coords=coords, tsvd=config["tsvd"]
            )
        else:
            per_kernel = [
                cid.pattern_detector(
                    cm,
                    config,
                    k,
                    coords=coords,
                    full=True,
                    tsvd=config["tsvd"],
                )
                for k in kernels
            ]
        if destroy:
            cm.destroy_mat()
    return {
        "per_kernel": per_kernel,
        "chr1": sub.chr1,
        "chr2": sub.chr2,
    }


def _detection_mesh(genome):
    """The device mesh for batched multi-chip detection, or None when a
    single device is visible / the mesh is disabled
    (CHROMOSIGHT_TPU_MESH=0)."""
    if os.environ.get("CHROMOSIGHT_TPU_MESH", "1") == "0":
        return None
    from chromosight_tpu.parallel import auto_mesh

    return auto_mesh(batch=genome.sub_mats.shape[0])


def _scan_submatrices_mesh(
    genome, cfg, kernel, dump, tsvd, mesh, destroy=True, coords_by_pos=None,
    threads=1,
):
    """Batched sharded scan of all submatrices (multi-chip path);
    ``coords_by_pos`` switches detect_on_mesh to quantify mode."""
    from chromosight_tpu.parallel import detect_on_mesh

    n_items = genome.sub_mats.shape[0]
    done = [0]

    def progress(res):
        cio.progress(done[0], n_items, f"{res['chr1']}-{res['chr2']}")
        done[0] += 1

    return detect_on_mesh(
        list(genome.sub_mats.iterrows()),
        cfg,
        kernel,
        dump,
        tsvd,
        mesh,
        progress=progress,
        destroy=destroy,
        coords_by_pos=coords_by_pos,
        threads=threads,
    )


def _split_per_kernel(multi, n_kernels):
    """Reshape per-submatrix multi-kernel worker results into one
    single-kernel-shaped result list per kernel (fused dispatch path)."""
    return [
        [
            {
                "coords": r["per_kernel"][k][0],
                "windows": r["per_kernel"][k][1],
                "chr1": r["chr1"],
                "chr2": r["chr2"],
            }
            for r in multi
        ]
        for k in range(n_kernels)
    ]


def _coords_by_pos(genome, pair_positions):
    """Per-submatrix (bin1, bin2) coordinate arrays keyed by the
    sub-matrix table position (detect_on_mesh quantify mode)."""
    return {
        pos: np.asarray(
            pair_positions[sub[1].name][1].loc[:, ["bin1", "bin2"]]
        )
        for pos, sub in enumerate(genome.sub_mats.iterrows())
    }


def _iterative_scan(genome, cfg, dump, threads):
    """Scan every (kernel x iteration) combination over all submatrices,
    refining each kernel from the pileup of its previous pass (reference
    cli:730-792).  Returns (coords DataFrame, window stack) or (None, None)
    when nothing was found anywhere.

    Multi-kernel configs (borders ships three kernels) run all their
    kernels in ONE fused band dispatch per pass — the iteration loop
    becomes the outer loop, each kernel still refining from its own
    pileup, and the output is reassembled in the reference's kernel-major
    order so the final table is unchanged."""
    total_runs = len(cfg["kernels"]) * cfg["max_iterations"]
    mesh = _detection_mesh(genome)
    retain = _retain_maps(genome, total_runs)
    from chromosight_tpu.observability import maybe_trace

    per_pass = {}  # (kernel_id, iteration) -> (coords DataFrame, windows)

    def collect(kernel_id, iteration, results):
        """Merge one pass's per-submatrix results into ``per_pass``;
        returns the refined kernel for the next iteration, or None when
        the pass found nothing (ending that kernel's iterations)."""
        found = [r for r in results if r["coords"] is not None]
        windows_found = [
            r["windows"] for r in results if r["windows"] is not None
        ]
        if not found or not windows_found:
            return None
        pass_coords = pd.concat(
            [
                genome.get_full_mat_pattern(r["chr1"], r["chr2"], r["coords"])
                for r in found
            ],
            axis=0,
        ).reset_index(drop=True)
        pass_coords["kernel_id"] = kernel_id
        pass_coords["iteration"] = iteration
        pass_windows = np.concatenate(windows_found, axis=0)
        per_pass[(kernel_id, iteration)] = (pass_coords, pass_windows)
        return cid.pileup_patterns(pass_windows)

    kernels0 = [np.asarray(k) for k in cfg["kernels"]]
    fused = cid.fuse_kernels_eligible(kernels0)
    run_id = 0
    kernel_id = iteration = 0
    with maybe_trace():
        if fused:
            current = dict(enumerate(kernels0))  # kernel_id -> current kernel
            for iteration in range(cfg["max_iterations"]):
                if not current:
                    break
                ids = sorted(current)
                for kernel_id in ids:
                    cio.progress(
                        run_id,
                        total_runs,
                        f"Kernel: {kernel_id}, Iteration: {iteration}\n",
                    )
                klist = [current[k] for k in ids]
                if mesh is not None:
                    per_kernel_results = _scan_submatrices_mesh(
                        genome, cfg, klist, dump, cfg["tsvd"], mesh,
                        destroy=not retain, threads=threads,
                    )
                else:
                    multi = _scan_submatrices(
                        genome,
                        _detect_sub_mat_multi,
                        lambda sub: (cfg, klist, dump, not retain),
                        threads,
                    )
                    per_kernel_results = _split_per_kernel(multi, len(ids))
                for k_idx, kid in enumerate(ids):
                    refined = collect(kid, iteration, per_kernel_results[k_idx])
                    if refined is None:
                        del current[kid]
                    else:
                        current[kid] = refined
                        run_id += 1
        else:
            for kernel_id, kernel in enumerate(cfg["kernels"]):
                for iteration in range(cfg["max_iterations"]):
                    cio.progress(
                        run_id,
                        total_runs,
                        f"Kernel: {kernel_id}, Iteration: {iteration}\n",
                    )
                    if mesh is not None:
                        results = _scan_submatrices_mesh(
                            genome, cfg, kernel, dump, cfg["tsvd"], mesh,
                            destroy=not retain, threads=threads,
                        )
                    else:
                        results = _scan_submatrices(
                            genome,
                            _detect_sub_mat,
                            lambda sub, k=kernel: (cfg, k, dump, not retain),
                            threads,
                        )
                    kernel = collect(kernel_id, iteration, results)
                    if kernel is None:
                        break  # nothing this pass: skip remaining iterations
                    run_id += 1
        cio.progress(
            run_id, total_runs, f"Kernel: {kernel_id}, Iteration: {iteration}\n"
        )
    if retain:
        _destroy_all_maps(genome)
    if not per_pass:
        return None, None
    # reference order: kernel-major, iterations inside (cli:730-792)
    ordered = [per_pass[key] for key in sorted(per_pass)]
    return (
        pd.concat([c for c, _ in ordered], axis=0).reset_index(drop=True),
        np.concatenate([w for _, w in ordered], axis=0),
    )


def _suppress_close_patterns(genome, cfg, coords, windows):
    """Keep only the best-scoring pattern within each min_separation
    neighbourhood (reference cli:805-814)."""
    separation_bins = max(
        1, int(cfg["min_separation"] // genome.clr.binsize)
    )
    print(f"Minimum pattern separation is : {separation_bins}")
    keep = cid.remove_neighbours(coords, win_size=separation_bins)
    return coords.loc[keep, :], windows[keep, :, :]


def _attach_genomic_coords(genome, coords):
    """Add chromN/startN/endN columns for both anchors (cli:821-833)."""
    parts = [coords.reset_index(drop=True)]
    for axis in (1, 2):
        cols = genome.bins_to_coords(coords[f"bin{axis}"]).reset_index(
            drop=True
        )
        cols.columns = [f"{c}{axis}" for c in cols.columns]
        parts.append(cols)
    return pd.concat(parts, axis=1)


def _finalize_detect_table(coords, windows, cfg):
    """Distance filter, p-value pruning and FDR correction
    (cli:835-867)."""
    too_close = (coords.chrom1 == coords.chrom2) & (
        np.abs(coords.start2 - coords.start1) < cfg["min_dist"]
    )
    coords, windows = coords.loc[~too_close, :], windows[~too_close, :, :]
    has_pval = ~coords.pvalue.isnull()
    coords, windows = coords.loc[has_pval, :], windows[has_pval, :, :]
    coords = coords.copy()
    coords["qvalue"] = fdr_correction(coords["pvalue"])
    return coords.loc[:, DETECT_COLUMNS], windows


def _plot_pileup(windows, cfg, prefix, title):
    from chromosight_tpu.plotting import pileup_plot

    pileup = cid.pileup_patterns(windows)
    if not cfg["max_dist"]:
        # diagonal patterns: windows live on the diagonal, mirror them
        pileup = np.nan_to_num(pileup)
        pileup += pileup.T - np.diag(np.diag(pileup))
    sys.stderr.write(f"Saving pileup plots in {prefix}.pdf\n")
    pileup_plot(pileup, prefix, name=title)


def cmd_detect(args):
    """Full detection pipeline (behaviour-parity with reference
    ``cli/chromosight.py:625-896``; structure is this package's own)."""
    prefix = args["<prefix>"]
    dump = args["--dump"]
    threads = int(args["--threads"])
    win_fmt = args["--win-fmt"]
    cio.check_prefix_dir(prefix)
    _check_win_fmt(win_fmt)

    cfg = _load_scan_config(
        args,
        {
            "max_iterations": (args["--iterations"], int),
            "pearson": (args["--pearson"], float),
            "max_dist": (args["--max-dist"], int),
            "min_dist": (args["--min-dist"], int),
            "min_separation": (args["--min-separation"], int),
            "max_perc_undetected": (args["--perc-undetected"], float),
            "max_perc_zero": (args["--perc-zero"], float),
        },
    )
    if args["--win-size"] != "auto":
        _resize_config_kernels(cfg, args["--win-size"])
    cfg["tsvd"] = 0.999 if args["--tsvd"] else None

    if args["--inter"]:
        sys.stderr.write(
            "WARNING: Detection on interchromosomal matrices is expensive in RAM\n"
        )
    genome = HicGenome(
        args["<contact_map>"],
        inter=args["--inter"],
        kernel_config=cfg,
        dump=dump,
        smooth=bool(args["--smooth-trend"]),
        sample=_parse_subsample(args["--subsample"]),
    )
    genome.kernel_config = cfg
    genome.normalize(
        norm=args["--norm"], n_mads=float(args["--n-mads"]), threads=threads
    )
    genome.compute_max_dist()
    genome.make_sub_matrices()
    # Start compiling/loading the per-bucket device programs while the
    # cool fetch streams pixels (shape buckets depend only on the
    # chromosome table + scan config).
    cid.warm_band_programs(
        genome,
        cfg,
        cfg["kernels"],
        cfg["tsvd"],
        cid.fuse_kernels_eligible([np.asarray(k) for k in cfg["kernels"]]),
    )

    sys.stderr.write("Detecting patterns...\n")
    coords, windows = _iterative_scan(genome, cfg, dump, threads)
    if coords is None:
        sys.stderr.write("No pattern detected ! Exiting.\n")
        sys.exit(0)

    coords, windows = _suppress_close_patterns(genome, cfg, coords, windows)
    coords = _attach_genomic_coords(genome, coords)
    coords, windows = _finalize_detect_table(coords, windows, cfg)

    sys.stderr.write(f"{coords.shape[0]} patterns detected\n")
    sys.stderr.write(f"Saving patterns in {prefix}.tsv\n")
    cio.write_patterns(coords, prefix)
    sys.stderr.write(f"Saving patterns in {prefix}.{win_fmt}\n")
    cio.save_windows(windows, prefix, fmt=win_fmt)
    if not args["--no-plotting"]:
        _plot_pileup(
            windows,
            cfg,
            prefix,
            f"Pileup of {windows.shape[0]} {cfg['name']}",
        )


# --------------------------------------------------------------------- #
# quantify
# --------------------------------------------------------------------- #
def _positions_for_pair(genome, positions, chr1, chr2):
    """Positions falling on one chromosome pair, as submatrix bins.

    Returns (original row indices, converted positions); entries outside
    the matrix are announced and dropped (reference cli:263-292).
    """
    pair = positions.loc[
        (positions.chrom1 == chr1) & (positions.chrom2 == chr2)
    ].copy()
    for axis in (1, 2):
        anchor = pair.loc[:, [f"chrom{axis}", f"pos{axis}"]].rename(
            columns={f"chrom{axis}": "chrom", f"pos{axis}": "pos"}
        )
        pair[f"bin{axis}"] = genome.coords_to_bins(anchor)
    outside = np.isnan(pair["bin1"]) | np.isnan(pair["bin2"])
    if np.any(outside):
        n_out = int(np.sum(outside))
        sys.stderr.write(
            f"\n{n_out} entr{'ies' if n_out > 1 else 'y'} outside "
            "genomic coordinates of the Hi-C matrix will be ignored.\n"
        )
        pair = pair.loc[~outside, :]
    return pair.index.values, genome.get_sub_mat_pattern(chr1, chr2, pair)


def _best_of_kernels(per_kernel_tables, per_kernel_windows):
    """Across kernels, keep the highest score per coordinate (NaN scores
    sort first and lose; reference cli:431-439 semantics incl. NaN-last
    tail)."""
    merged = pd.concat(per_kernel_tables, axis=0).reset_index(drop=True)
    windows = np.concatenate(per_kernel_windows, axis=0)
    merged = (
        merged.sort_values("score", ascending=True)
        .groupby(["chrom1", "start1", "chrom2", "start2"], sort=False)
        .tail(1)
    )
    windows = windows[merged.index, :, :]
    return merged.reset_index(drop=True), windows


def cmd_quantify(args):
    """Score user-supplied coordinates (behaviour-parity with reference
    ``cli:295-496``; structure is this package's own)."""
    prefix = args["<prefix>"]
    threads = int(args["--threads"])
    win_fmt = args["--win-fmt"]
    _check_win_fmt(win_fmt)
    cio.check_prefix_dir(prefix)

    bed2d = cio.load_bed2d(args["<bed2d>"])
    if (
        not args["--inter"]
        and len(bed2d.start1[bed2d.chrom1 != bed2d.chrom2]) > 0
    ):
        sys.stderr.write(
            "Warning: The bed2d file contains interchromosomal patterns. "
            "These patterns will not be scanned unless --inter is used.\n"
        )

    cfg = _load_scan_config(
        args,
        {
            "max_perc_zero": (args["--perc-zero"], float),
            "max_perc_undetected": (args["--perc-undetected"], float),
        },
    )
    genome = HicGenome(
        args["<contact_map>"],
        inter=args["--inter"],
        kernel_config=cfg,
        sample=_parse_subsample(args["--subsample"]),
    )
    # scan exactly as far as the furthest requested pair
    furthest = np.max(bed2d.start2 - bed2d.start1)
    cfg["max_dist"] = min(furthest, genome.clr.shape[0] * genome.clr.binsize)
    cfg["min_dist"] = 0
    cfg["tsvd"] = 0.999 if args["--tsvd"] else None
    genome.kernel_config = cfg
    genome.normalize(
        norm=args["--norm"], n_mads=float(args["--n-mads"]), threads=threads
    )

    km, kn = cfg["kernels"][0].shape
    if args["--win-size"] != "auto":
        km = kn = _resize_config_kernels(cfg, args["--win-size"])
        genome.kernel_config = cfg
    genome.compute_max_dist()
    genome.make_sub_matrices()

    bed2d["score"] = np.nan
    bed2d["pvalue"] = np.nan
    positions = bed2d.copy()
    positions["pos1"] = (positions.start1 + positions.end1) // 2
    positions["pos2"] = (positions.start2 + positions.end2) // 2

    tables, window_stacks = [], []
    retain = _retain_maps(genome, len(cfg["kernels"]))
    mesh = _detection_mesh(genome)
    pair_positions = {
        sub[1].name: _positions_for_pair(
            genome, positions, sub[1].chr1, sub[1].chr2
        )
        for sub in genome.sub_mats.iterrows()
    }
    cid.warm_band_programs(
        genome,
        cfg,
        cfg["kernels"],
        cfg["tsvd"],
        cid.fuse_kernels_eligible([np.asarray(k) for k in cfg["kernels"]]),
        run_mode="quantify",
        coord_counts={
            name: pos[1].shape[0] for name, pos in pair_positions.items()
        },
    )

    def merge_results(results):
        table = bed2d.copy()
        windows = np.full((positions.shape[0], km, kn), np.nan)
        for sub, res in zip(genome.sub_mats.iterrows(), results):
            if res["coords"] is None:
                continue
            row_idx = pair_positions[sub[1].name][0]
            try:
                table.loc[row_idx, "score"] = res["coords"].score.values
                table.loc[row_idx, "pvalue"] = res["coords"].pvalue.values
                windows[row_idx, :, :] = res["windows"]
            except AttributeError:
                pass  # submatrix smaller than kernel
        tables.append(table)
        window_stacks.append(windows)

    kernels0 = [np.asarray(k) for k in cfg["kernels"]]
    if cid.fuse_kernels_eligible(kernels0):
        # every kernel scores the same coordinates on the same maps: one
        # fused multi-kernel pass replaces the per-kernel loop
        for kernel_id in range(len(kernels0)):
            cio.progress(
                kernel_id, len(kernels0), f"Kernel: {kernel_id}\n"
            )
        if mesh is not None:
            per_kernel_results = _scan_submatrices_mesh(
                genome,
                cfg,
                kernels0,
                None,
                cfg["tsvd"],
                mesh,
                destroy=not retain,
                coords_by_pos=_coords_by_pos(genome, pair_positions),
                threads=threads,
            )
        else:
            multi = _scan_submatrices(
                genome,
                _quantify_sub_mat_multi,
                lambda sub: (
                    cfg,
                    kernels0,
                    pair_positions[sub[1].name][1],
                    not retain,
                ),
                threads,
            )
            per_kernel_results = _split_per_kernel(multi, len(kernels0))
        for results in per_kernel_results:
            merge_results(results)
    else:
        for kernel_id, kernel in enumerate(cfg["kernels"]):
            cio.progress(
                kernel_id, len(cfg["kernels"]), f"Kernel: {kernel_id}\n"
            )
            if mesh is not None:
                # Batched sharded scoring (the reference parallelises
                # quantify over submatrices exactly like detect,
                # cli:407-408).
                results = _scan_submatrices_mesh(
                    genome,
                    cfg,
                    kernel,
                    None,
                    cfg["tsvd"],
                    mesh,
                    destroy=not retain,
                    coords_by_pos=_coords_by_pos(genome, pair_positions),
                    threads=threads,
                )
            else:
                results = _scan_submatrices(
                    genome,
                    _quantify_sub_mat,
                    lambda sub, k=kernel: (
                        cfg,
                        k,
                        pair_positions[sub[1].name][1],
                        not retain,
                    ),
                    threads,
                )
            merge_results(results)

    if retain:
        _destroy_all_maps(genome)
    best, windows = _best_of_kernels(tables, window_stacks)
    for axis in (1, 2):
        anchor = best.loc[:, [f"chrom{axis}", f"start{axis}"]].rename(
            columns={f"chrom{axis}": "chrom", f"start{axis}": "pos"}
        )
        best[f"bin{axis}"] = genome.coords_to_bins(anchor)
    best["qvalue"] = fdr_correction(best["pvalue"])
    best = best.loc[:, QUANTIFY_COLUMNS]
    # coordinates whose windows failed validation keep NaN everywhere
    invalid = np.isnan(best.score)
    best.loc[invalid, "pvalue"] = np.nan
    best.loc[invalid, "qvalue"] = np.nan
    best = best.sort_values(["bin1", "bin2"], ascending=True).reset_index(
        drop=True
    )
    cio.write_patterns(best, prefix)
    cio.save_windows(windows, prefix, fmt=win_fmt)
    if not args["--no-plotting"]:
        _plot_pileup(
            windows,
            cfg,
            prefix,
            f"pileup_of_{windows.shape[0]}_{cfg['name']}",
        )


# --------------------------------------------------------------------- #
# generate-config / list-kernels / test
# --------------------------------------------------------------------- #
def _capture_click_windows(args, cfg, win_size):
    """Interactive kernel building: display the map(s), record
    double-clicked windows (reference cli:529-588)."""
    import scipy.ndimage as ndi

    from chromosight_tpu.plotting import click_finder

    genome = HicGenome(
        args["--click"], inter=args["--inter"], kernel_config=cfg
    )
    genome.normalize(
        norm=args["--norm"],
        n_mads=float(args["--n-mads"]),
        threads=int(args["--threads"]),
    )
    genome.max_dist = genome.clr.shape[0] * genome.clr.binsize
    genome.make_sub_matrices()
    half_w = int((win_size - 1) / 2)
    chroms = args["--chroms"]
    if chroms is None:
        for sub in genome.sub_mats.iterrows():
            sub[1].contact_map.create_mat()
        whole = genome.gather_sub_matrices().tocsr()
        windows = click_finder(whole, half_w=half_w)
    else:
        names = chroms.split(",")
        pairs = (
            it.combinations_with_replacement(names, 2)
            if args["--inter"]
            else [(ch, ch) for ch in names]
        )
        collected = []
        for c1, c2 in pairs:
            try:
                sub_mat = genome.sub_mats.query(
                    "(chr1 == @c1) & (chr2 == @c2)"
                )["contact_map"].values[0]
            except IndexError:
                c1, c2 = c2, c1
                sub_mat = genome.sub_mats.query(
                    "(chr1 == @c1) & (chr2 == @c2)"
                )["contact_map"].values[0]
            sub_mat.create_mat()
            collected.append(
                click_finder(
                    sub_mat.matrix.tocsr(), half_w=half_w, xlab=c2, ylab=c1
                )
            )
            sub_mat.destroy_mat()
        windows = np.concatenate(collected, axis=0)

    pileup = ndi.gaussian_filter(cid.pileup_patterns(windows), 1)
    from chromosight_tpu.plotting import _plt

    plt = _plt()
    hm = plt.imshow(
        np.log(pileup), vmax=np.percentile(pileup, 99), cmap="afmhot_r"
    )
    plt.colorbar(hm).set_label("Log10 Hi-C contacts")
    plt.title("Manually generated kernel")
    plt.show()
    return pileup


def cmd_generate_config(args):
    """Write a preset (or interactively captured) kernel config
    (reference ``cli:499-598``)."""
    prefix = args["<prefix>"]
    cfg = cio.load_kernel_config(args["--preset"], False)
    cio.check_prefix_dir(prefix)

    if args["--win-size"] != "auto":
        win_size = _resize_config_kernels(cfg, args["--win-size"])
    else:
        win_size = cfg["kernels"][0].shape[0]

    if args["--click"]:
        cfg["kernels"] = [_capture_click_windows(args, cfg, win_size).tolist()]

    # Kernel matrices go to separate text files referenced by the JSON
    # config, byte-compatible with the reference's generate-config output.
    for mat_id, mat in enumerate(cfg["kernels"]):
        mat_path = f"{prefix}.{mat_id + 1}.txt"
        np.savetxt(mat_path, mat)
        cfg["kernels"][mat_id] = mat_path
    with open(f"{prefix}.json", "w") as config_handle:
        json.dump(cfg, config_handle, indent=4, default=_json_default)


def _json_default(obj):
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    raise TypeError(f"not JSON serializable: {type(obj)}")


def cmd_list_kernels(args):
    """List available kernels (reference ``cli:899-925``)."""
    from chromosight_tpu.plotting import print_ascii_mat

    kernel_name = args["--name"]
    names = ck.kernel_names if kernel_name == "all" else [kernel_name]
    for k in names:
        try:
            kernel_infos = getattr(ck, k)
        except AttributeError:
            raise ValueError(f"Kernel {k} is not available")
        print(k)
        if args["--long"]:
            exclude_params = ["name", "resolution", "kernels"]
            for param, value in kernel_infos.items():
                if param not in exclude_params:
                    print(f"  {param}: {value}")
        if args["--mat"]:
            for mat in kernel_infos["kernels"]:
                print_ascii_mat(mat)


def cmd_test(args):
    """Self-test: run detection on the example dataset
    (reference ``cli:928-940``), falling back to the bundled copy when the
    network is unavailable."""
    sys.stderr.write(f"Fetching test dataset at {URL_EXAMPLE_DATASET}...\n")
    tmp_cool = tempfile.NamedTemporaryFile(delete=False)
    tmp_cool.close()
    try:
        cio.download_file(URL_EXAMPLE_DATASET, tmp_cool.name)
        cool_path = tmp_cool.name
    except Exception:
        cool_path = LOCAL_EXAMPLE_DATASET
    sys.stderr.write("Running detection on test dataset...\n")
    args["<contact_map>"] = cool_path
    args["<prefix>"] = "chromosight_test"
    args["--no-plotting"] = True
    cmd_detect(args)
    os.unlink(tmp_cool.name)


@contextmanager
def capture_output(stderr_to=None):
    """Capture stderr during the self-test run."""
    try:
        stderr = sys.stderr
        sys.stderr = c2 = stderr_to or io.StringIO()
        yield c2
    finally:
        sys.stderr = stderr
        try:
            c2.flush()
            c2.seek(0)
        except (ValueError, IOError):
            pass


def logo_version(logo, ver):
    from chromosight_tpu.plotting import print_ascii_mat

    small_logo = resize_kernel(logo, factor=0.33, quiet=True)
    ascii_logo = print_ascii_mat(small_logo, colored=False, print_str=False)
    return f"{ascii_logo} chromosight-tpu version {ver}"


def _run_self_test(args):
    """Run `test` and diff the captured log against the golden record."""
    with capture_output() as stderr:
        cmd_test(args)
    obs_log = stderr.read()
    sys.stderr.write(obs_log)
    obs_log_lines = {
        u.strip("\x1b[K") for u in set(obs_log.split("\n")) if "\r" not in u
    }
    exp_log_lines = set(TEST_LOG.split("\n"))
    if len(exp_log_lines ^ obs_log_lines):
        sys.stderr.write(
            "\nWarning, the test log differed from the "
            "expected one. This means the program changed its output from"
            "previous versions. You may ignore this if you are not a "
            "developer.\n\n"
            f"Here is the expected log:\n\n{TEST_LOG}\n"
        )


def main(argv=None):
    if argv is None:
        argv = sys.argv[1:]
    try:
        args = parse_args(
            argv, __doc__, version=logo_version(LOGO, __version__)
        )
    except CliError as exc:
        return exc.code
    if args["test"]:
        _run_self_test(args)
    elif args["detect"]:
        cmd_detect(args)
    elif args["generate-config"]:
        cmd_generate_config(args)
    elif args["list-kernels"]:
        cmd_list_kernels(args)
    elif args["quantify"]:
        cmd_quantify(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
