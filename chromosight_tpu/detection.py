"""Detection engine: convolution dispatch, foci picking, pattern validation.

Public surface mirrors the reference ``chromosight/utils/detection.py``.
The heavy numerics (normxcorr2 / xcorr2) run on device through
``chromosight_tpu.ops``; the small combinatorial tail (connected-component
labeling over candidate pixels, window validation, neighbour suppression)
runs vectorised on host, which matches the compute split of the workload:
for a genome-scale scan the candidate set is ~1e3-1e5 pixels while the
correlation map has ~1e8-1e10.

Sparse/dense compatibility: `xcorr2` and `normxcorr2` accept scipy.sparse
matrices or numpy arrays like the reference and return the same container
type, so user code written against the reference API runs unchanged.
Small sparse inputs are densified for the fused device engines; inputs
larger than CHROMOSIGHT_TPU_DENSE_LIMIT (default 8192) bins per side are
scanned by the bounded-memory halo-tiled engine (`ops.tiled`) and never
densified, matching the reference's sparse-native guarantee.
"""

from __future__ import annotations

import os
import pathlib
import sys
from functools import partial

import numpy as np
import pandas as pd
import scipy.sparse as sp

import chromosight_tpu.observability as observability
import chromosight_tpu.preprocessing as preproc
from chromosight_tpu.ops import pow2
from chromosight_tpu.ops.convolve import xcorr2 as _xcorr2_device
from chromosight_tpu.ops.normxcorr import normxcorr2_dense


# --------------------------------------------------------------------- #
# Convolution API (sparse/dense compatible wrappers over device ops)
# --------------------------------------------------------------------- #
def _dense_limit():
    """Largest dimension a sparse input may have before the public API
    routes it through the halo-tiled engine instead of densifying."""
    return int(os.environ.get("CHROMOSIGHT_TPU_DENSE_LIMIT", 8192))


def xcorr2(signal, kernel, threshold=1e-4, tsvd=None):
    """Cross-correlate a dense or sparse 2D signal with a dense kernel.

    Reference: ``detection.py:595-624``.  Computation happens on device as
    a dense XLA convolution; small sparse inputs are densified, large ones
    go through the bounded-memory tiled engine (``ops.tiled``), and the
    result is returned in the input's container type.
    """
    if tsvd is not None:
        kernel = preproc.factorise_kernel(kernel, prop_info=tsvd)
    is_sparse = sp.issparse(signal)
    if is_sparse and max(signal.shape) > _dense_limit():
        from chromosight_tpu.ops.tiled import xcorr2_sparse_tiled

        return xcorr2_sparse_tiled(signal, kernel, threshold=threshold)
    dense = np.asarray(signal.todense()) if is_sparse else np.asarray(signal)
    out = np.asarray(_xcorr2_device(dense, kernel, threshold=threshold))
    if is_sparse:
        return sp.csr_matrix(out)
    return out


def normxcorr2(
    signal,
    kernel,
    max_dist=None,
    sym_upper=False,
    full=False,
    missing_mask=None,
    missing_tol=0.75,
    tsvd=None,
    pval=False,
):
    """Normalized cross-correlation (sliding Pearson) of signal and kernel.

    Reference: ``detection.py:807-914``.  Accepts scipy sparse or numpy
    arrays; the fused device kernel (``ops.normxcorr``) does the work.
    Returns (corr, log10-pvals or None) in the input container type.
    """
    is_sparse = sp.issparse(signal)
    if sp.issparse(kernel):
        raise ValueError("cannot handle kernel in sparse format")
    kernel = np.asarray(kernel)
    if not (kernel.std() > 0):
        raise ValueError("Cannot have flat kernel.")
    if missing_mask is not None:
        if is_sparse and not sp.issparse(missing_mask):
            raise ValueError("Missing mask must be a sparse matrix.")
        if signal.shape != missing_mask.shape:
            raise ValueError(
                "Signal and missing mask do not have the same shape"
            )
        mask_dtype = missing_mask.dtype
        if mask_dtype != bool:
            raise ValueError(
                f"Missing mask dtype is {mask_dtype}. Should be bool."
            )
        if min(kernel.shape) >= max(signal.shape):
            raise ValueError("cannot have kernel bigger than signal")
        preproc.check_missing_mask(signal, missing_mask)
    if is_sparse and max(signal.shape) > _dense_limit():
        # Bounded-memory path: the signal (and mask) stay sparse end to
        # end; the tiled engine scans halo-extended dense blocks of
        # constant shape. Reference sparse engine: detection.py:917-1131.
        from chromosight_tpu.ops.tiled import normxcorr2_sparse_tiled

        return normxcorr2_sparse_tiled(
            signal,
            kernel,
            max_dist=max_dist,
            sym_upper=sym_upper,
            full=full,
            missing_mask=missing_mask,
            missing_tol=missing_tol,
            tsvd=tsvd,
            pval=pval,
        )
    if missing_mask is not None:
        mask_dense = (
            np.asarray(missing_mask.todense())
            if sp.issparse(missing_mask)
            else np.asarray(missing_mask)
        )
    else:
        mask_dense = None
    dense = np.asarray(signal.todense()) if is_sparse else np.asarray(signal)
    corr, pvals = normxcorr2_dense(
        dense,
        kernel,
        max_dist=max_dist,
        sym_upper=sym_upper,
        full=full,
        missing_mask=mask_dense,
        missing_tol=missing_tol,
        tsvd=tsvd,
        pval=pval,
    )
    corr = np.asarray(corr)
    pvals = np.asarray(pvals) if pvals is not None else None
    if is_sparse:
        corr = sp.csr_matrix(corr)
        if pvals is not None:
            # Match the sparse reference: p-values are only defined where a
            # correlation coefficient exists.
            pvals = sp.csr_matrix(np.where(corr.toarray() != 0, pvals, 0))
    return corr, pvals


# --------------------------------------------------------------------- #
# Foci labeling (host tail)
# --------------------------------------------------------------------- #
def _connected_labels(rows, cols, n_cols):
    """4-way connected-component labels for a row-major sorted pixel list.

    Returns an array of component labels where each label is the rank of
    the component's first (row-major) pixel - the same ordering that the
    reference obtains from scipy's connected_components over its
    neighbour-adjacency graph (``detection.py:459-554``).
    """
    n = len(rows)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    from chromosight_tpu import native

    native_labels = native.cc_label(rows, cols, n_cols)
    if native_labels is not None:
        return native_labels
    flat = rows.astype(np.int64) * np.int64(n_cols) + cols.astype(np.int64)
    # Right-neighbour edges: consecutive list entries on the same row with
    # adjacent columns.
    dflat = np.diff(flat)
    drow = np.diff(rows)
    right = np.flatnonzero((dflat == 1) & (drow == 0))
    edges_a = [right]
    edges_b = [right + 1]
    # Down-neighbour edges: pixel directly below exists in the list.
    below = flat + n_cols
    pos = np.searchsorted(flat, below)
    ok = pos < n
    ok[ok] = flat[pos[ok]] == below[ok]
    edges_a.append(np.flatnonzero(ok))
    edges_b.append(pos[ok])
    ea = np.concatenate(edges_a)
    eb = np.concatenate(edges_b)

    lab = np.arange(n, dtype=np.int64)
    # Min-label propagation with pointer jumping until fixpoint; foci have
    # tiny diameters so this converges in a handful of rounds.
    while True:
        nxt = lab.copy()
        np.minimum.at(nxt, eb, lab[ea])
        np.minimum.at(nxt, ea, lab[eb])
        nxt = nxt[nxt]
        nxt = nxt[nxt]
        if np.array_equal(nxt, lab):
            break
        lab = nxt
    return lab


def label_foci(matrix):
    """Label 4-way connected foci of nonzero pixels in a sparse matrix.

    Reference: ``detection.py:459-554``.  Labels are 1-based and ordered by
    each focus' first row-major pixel.
    """
    coo = sp.coo_matrix(sp.csr_matrix(matrix))
    order = np.lexsort((coo.col, coo.row))
    rows, cols = coo.row[order], coo.col[order]
    lab = _connected_labels(rows, cols, matrix.shape[1])
    # Renumber roots as 1..num_foci in first-pixel order
    uniq, inv = np.unique(lab, return_inverse=True)
    num_foci = len(uniq)
    foci_mat = sp.coo_matrix(
        (inv + 1, (rows, cols)), shape=matrix.shape
    )
    return num_foci, foci_mat


def filter_foci(foci_mat, min_size=2):
    """Drop foci smaller than ``min_size`` pixels.

    Reference: ``detection.py:557-592``.  Label values of surviving foci
    are preserved.
    """
    data = foci_mat.data.copy()
    ids, sizes = np.unique(data, return_counts=True)
    small = set(ids[sizes < min_size].tolist())
    if small:
        drop = np.isin(data, list(small))
        data[drop] = 0
    filtered = sp.coo_matrix(
        (data, (foci_mat.row, foci_mat.col)), shape=foci_mat.shape
    )
    filtered.eliminate_zeros()
    num_filtered = int(np.sum(sizes >= min_size))
    return num_filtered, filtered


def pick_foci(mat_conv, pearson, min_size=2):
    """Find local maxima of contiguous high-correlation foci.

    Reference: ``detection.py:387-456``.  Thresholds the correlation map
    at ``pearson``, labels 4-way connected foci, drops foci smaller than
    ``min_size`` and returns the argmax pixel of each focus (row-major
    first occurrence breaks score ties, like the reference's np.argmax).

    Accepts a scipy sparse matrix or a dense numpy array.
    """
    if sp.issparse(mat_conv):
        coo = mat_conv.tocoo()
        cand = coo.data >= pearson
        cand &= coo.data != 0
        rows, cols, scores = coo.row[cand], coo.col[cand], coo.data[cand]
        order = np.lexsort((cols, rows))
        rows, cols, scores = rows[order], cols[order], scores[order]
        n_cols_total = mat_conv.shape[1]
    else:
        dense = np.asarray(mat_conv)
        cand = (dense >= pearson) & (dense != 0)
        rows, cols = np.nonzero(cand)  # row-major order
        scores = dense[rows, cols]
        n_cols_total = dense.shape[1]
    if len(rows) == 0:
        return None, None
    lab = _connected_labels(rows, cols, n_cols_total)
    uniq, inv, counts = np.unique(lab, return_inverse=True, return_counts=True)
    keep_focus = counts >= min_size
    if not np.any(keep_focus):
        return None, None
    # Build the labelled matrix (surviving foci only, 1-based labels in
    # first-pixel order like label_foci + filter_foci).
    keep_px = keep_focus[inv]
    labelled_mat = sp.coo_matrix(
        (inv[keep_px] + 1, (rows[keep_px], cols[keep_px])),
        shape=mat_conv.shape,
    )
    # Best pixel per surviving focus: max score, row-major tie-break.
    flat = rows.astype(np.int64) * np.int64(n_cols_total) + cols
    order = np.lexsort((flat, -scores, inv))
    first = np.searchsorted(inv[order], np.arange(len(uniq)))
    best = order[first]
    best = best[keep_focus]
    foci_coords = np.stack([rows[best], cols[best]], axis=1).astype(int)
    return foci_coords, labelled_mat


# --------------------------------------------------------------------- #
# Window validation
# --------------------------------------------------------------------- #
def validate_patterns(
    coords,
    matrix,
    conv_mat,
    detectable_bins,
    kernel_matrix,
    drop=True,
    zero_tol=0.3,
    missing_tol=0.75,
):
    """Filter detected patterns by window quality and extract their windows.

    Reference: ``detection.py:18-155``.  Vectorised host implementation:
    all candidate windows are gathered in one fancy-indexing pass, missing
    rows/columns are NaN-ed, and zero/missing proportions decide validity.

    ``matrix`` and ``conv_mat`` may be dense numpy arrays or scipy sparse
    matrices (densified internally).
    """
    mat = (
        np.asarray(matrix.todense(), dtype=np.float64)
        if sp.issparse(matrix)
        else np.asarray(matrix, dtype=np.float64)
    )
    conv = (
        np.asarray(conv_mat.todense(), dtype=np.float64)
        if sp.issparse(conv_mat)
        else np.asarray(conv_mat, dtype=np.float64)
    )
    coords = np.asarray(coords, dtype=np.int64)
    n_pat = coords.shape[0]
    win_h, win_w = kernel_matrix.shape
    half_h, half_w = win_h // 2 + 1, win_w // 2 + 1
    miss_rows = preproc.missing_flags(detectable_bins[0], mat.shape[0])
    miss_cols = preproc.missing_flags(detectable_bins[1], mat.shape[1])

    validated_coords = pd.DataFrame(
        {
            "bin1": coords[:, 0],
            "bin2": coords[:, 1],
            "score": np.full(n_pat, np.nan),
        }
    )
    pattern_windows = np.full((n_pat, win_h, win_w), np.nan)
    if n_pat:
        p1, p2 = coords[:, 0], coords[:, 1]
        high = p1 - half_h + 1
        low = p1 + half_h
        left = p2 - half_w + 1
        right = p2 + half_w
        inbound = (
            (high >= 0)
            & (low < mat.shape[0])
            & (left >= 0)
            & (right < mat.shape[1])
        )
        # Gather all windows at once (clip indices for out-of-bound coords;
        # their contents are discarded).
        u = np.arange(win_h)
        v = np.arange(win_w)
        ridx = np.clip(high[:, None] + u[None, :], 0, mat.shape[0] - 1)
        cidx = np.clip(left[:, None] + v[None, :], 0, mat.shape[1] - 1)
        wins = mat[ridx[:, :, None], cidx[:, None, :]]
        # NaN out missing rows/columns within each window
        row_missing = miss_rows[ridx]  # (n, win_h)
        col_missing = miss_cols[cidx]  # (n, win_w)
        wins = np.where(row_missing[:, :, None], np.nan, wins)
        wins = np.where(col_missing[:, None, :], np.nan, wins)

        tot = win_h * win_w
        n_missing = np.sum(~np.isfinite(wins), axis=(1, 2))
        n_zero = np.sum(wins == 0, axis=(1, 2))
        with np.errstate(invalid="ignore", divide="ignore"):
            prop_undetected = n_missing / tot
            prop_zero = n_zero / (tot - n_missing)
        valid = (
            inbound
            & (prop_undetected < missing_tol)
            & (prop_zero < zero_tol)
        )
        scores = conv[np.clip(p1, 0, conv.shape[0] - 1),
                      np.clip(p2, 0, conv.shape[1] - 1)]
        validated_coords.loc[valid, "score"] = scores[valid]
        pattern_windows[valid] = wins[valid]
    else:
        valid = np.zeros(0, dtype=bool)

    if drop:
        filtered_coords = validated_coords.loc[valid, :]
        filtered_windows = pattern_windows[valid, :, :]
    else:
        filtered_coords = validated_coords
        filtered_windows = pattern_windows
    return filtered_coords, filtered_windows


def pileup_patterns(pattern_windows):
    """NaN-mean stack of pattern windows (reference ``detection.py:158-174``)."""
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", category=RuntimeWarning)
        return np.nanmean(pattern_windows, axis=0)


# --------------------------------------------------------------------- #
# Neighbour suppression
# --------------------------------------------------------------------- #
def remove_neighbours(patterns, win_size=8):
    """Greedy suppression of patterns whose windows overlap, keeping the
    highest scores (ties break to the earlier row, deterministically).

    Reference: ``detection.py:348-384``.  Returns a boolean whitelist in
    the original row order.  At genome scale the raw candidate list is
    tens of thousands of rows, so the grid-hashed native tier does the
    sweep; the numpy fallback is the same greedy O(n^2).
    """
    # Row-positional semantics regardless of the caller's index: the
    # reference indexes its whitelist with *labels* (detection.py:382-383),
    # which only works for the RangeIndex its CLI always passes; a
    # non-default index would crash or corrupt the mask there.  Both our
    # paths treat rows positionally.
    patterns = patterns.reset_index(drop=True)
    b1 = patterns["bin1"].to_numpy(dtype=np.int64)
    b2 = patterns["bin2"].to_numpy(dtype=np.int64)
    sc = patterns["score"].to_numpy(dtype=np.float64)
    from chromosight_tpu import native

    keep = native.remove_neighbours(b1, b2, sc, win_size)
    if keep is not None:
        return keep
    return _remove_neighbours_numpy(b1, b2, sc, win_size)


def _remove_neighbours_numpy(b1, b2, sc, win_size):
    """Grid-hashed greedy sweep, the numpy twin of the native tier: same
    ordering (score desc, NaN last, ties to the earlier row) and the same
    win_size-edged 3x3 cell neighbourhood, so the no-toolchain path stays
    ~O(n) on genome-scale candidate lists instead of the quadratic
    all-pairs scan."""
    n = len(b1)
    keep = np.ones(n, dtype=bool)
    if n == 0 or win_size <= 0:
        # strict |d| < win_size never holds for win_size <= 0
        return keep
    # score desc with NaN last, stable on ties -> earlier row wins
    order = np.lexsort((np.arange(n), -sc))
    nan_mask = np.isnan(sc[order])
    order = np.concatenate([order[~nan_mask], order[nan_mask]])
    w = int(win_size)
    cells = {}
    c1 = b1 // w
    c2 = b2 // w
    for i in range(n):
        cells.setdefault((c1[i], c2[i]), []).append(i)
    killed = np.zeros(n, dtype=bool)
    for i in order:
        if killed[i]:
            continue
        for d1 in (-1, 0, 1):
            for d2 in (-1, 0, 1):
                for j in cells.get((c1[i] + d1, c2[i] + d2), ()):
                    if j != i and abs(b1[j] - b1[i]) < w and abs(b2[j] - b2[i]) < w:
                        killed[j] = True
    keep[killed] = False
    return keep


# --------------------------------------------------------------------- #
# Band-mode detection (large intra maps)
# --------------------------------------------------------------------- #
def _validate_patterns_band(
    coords,
    band_shape,
    raw_windows,
    miss_flags,
    score_vec,
    kernel_matrix,
    big_k,
    drop=True,
    zero_tol=0.3,
    missing_tol=0.75,
):
    """Band-space equivalent of ``validate_patterns`` in full mode.

    ``raw_windows`` holds the window values already gathered on device
    (zeros outside the band); the kh/kw zero-padding, the NaN-ed missing
    rows/columns, and the NaN lower diagonals of the reference full-mode
    validation (``detection.py:18-155`` plus the padding/shifts of
    ``pattern_detector``, reference ``291-315``) are applied analytically.
    Coordinates are in original matrix space.
    """
    n, width = band_shape
    win_h, win_w = kernel_matrix.shape
    kh, kw = (win_h - 1) // 2, (win_w - 1) // 2
    half_h, half_w = win_h // 2 + 1, win_w // 2 + 1
    coords = np.asarray(coords, dtype=np.int64)
    n_pat = coords.shape[0]

    validated_coords = pd.DataFrame(
        {
            "bin1": coords[:, 0] if n_pat else np.zeros(0, np.int64),
            "bin2": coords[:, 1] if n_pat else np.zeros(0, np.int64),
            "score": np.full(n_pat, np.nan),
        }
    )
    pattern_windows = np.full((n_pat, win_h, win_w), np.nan)
    if n_pat == 0:
        valid = np.zeros(0, dtype=bool)
    else:
        p1, p2 = coords[:, 0], coords[:, 1]
        # Padded coordinates (reference pads matrix by kh/kw in full mode)
        P1, P2 = p1 + kh, p2 + kw
        high = P1 - half_h + 1
        low = P1 + half_h
        left = P2 - half_w + 1
        right = P2 + half_w
        inbound = (
            (high >= 0)
            & (low < n + 2 * kh)
            & (left >= 0)
            & (right < n + 2 * kw)
        )
        a = np.arange(win_h)
        b = np.arange(win_w)
        # original-space row/col of every window cell
        r = (high[:, None] - kh) + a[None, :]  # (n_pat, win_h)
        c = (left[:, None] - kw) + b[None, :]  # (n_pat, win_w)
        rr = r[:, :, None]
        cc = c[:, None, :]
        wins = np.array(raw_windows, dtype=np.float64, copy=True)
        # NaN lower diagonals of the padded matrix: 1 <= (i'-j') <= big_k
        dd = (rr + kh) - (cc + kw)
        wins = np.where((dd >= 1) & (dd <= big_k), np.nan, wins)
        # NaN missing rows/cols: out-of-matrix padding rows/cols are
        # missing too (they are absent from the shifted detectable-bin
        # list the reference builds over the padded matrix).
        row_missing = (
            (r < 0) | (r >= n) | miss_flags[np.clip(r, 0, n - 1)]
        )
        col_missing = (
            (c < 0) | (c >= n) | miss_flags[np.clip(c, 0, n - 1)]
        )
        wins = np.where(row_missing[:, :, None], np.nan, wins)
        wins = np.where(col_missing[:, None, :], np.nan, wins)

        tot = win_h * win_w
        n_missing = np.sum(~np.isfinite(wins), axis=(1, 2))
        n_zero = np.sum(wins == 0, axis=(1, 2))
        with np.errstate(invalid="ignore", divide="ignore"):
            prop_undetected = n_missing / tot
            prop_zero = n_zero / (tot - n_missing)
        valid = (
            inbound
            & (prop_undetected < missing_tol)
            & (prop_zero < zero_tol)
        )
        validated_coords.loc[valid, "score"] = np.asarray(score_vec)[valid]
        pattern_windows[valid] = wins[valid]

    if drop:
        return (
            validated_coords.loc[valid, :],
            pattern_windows[valid, :, :],
            valid,
        )
    return validated_coords, pattern_windows, valid


def jax_default_backend_is_cpu():
    import jax

    return jax.default_backend() == "cpu"


def _band_guards(contact_map, kernel_matrix):
    """Skip/raise checks shared by the single-map and batched band paths.

    Returns True when the map must be skipped (smaller than the kernel).
    For kernels taller than wide, mirrors the reference sparse engine's
    raise: the framed below-diagonal missing margin overlaps the upper
    triangle there (frame_missing_mask draws it in framed coordinates,
    offset by nk - mk), so any nonzero signal on diagonals [0, km-kn)
    trips check_missing_mask (ref detection.py:1022 /
    preprocessing.py:501-532).
    """
    km, kn = kernel_matrix.shape
    if min(contact_map.shape) <= max(kernel_matrix.shape):
        return True
    if km > kn:
        n_bad = int(
            np.count_nonzero(np.asarray(contact_map.band_dev[:, : km - kn]))
        )
        if n_bad:
            raise ValueError(
                f"There are {n_bad} non-zero elements reported as missing."
            )
    return False


def warm_band_programs(
    genome, kernel_config, kernels, tsvd, fused, run_mode="detect",
    coord_counts=None,
):
    """Start compiling/loading the per-bucket device programs on zero
    inputs, in a daemon thread, BEFORE the cool fetch touches pixel data.

    A cold compile is otherwise serialized behind the first
    chromosome's fetch+upload; the shape buckets are fully determined by
    the chromosome table and the scan config, so the compiles can ride
    concurrently with host IO (cool reads and the native scatter release
    the GIL).  Every program family compiles in its OWN thread:
    preprocessing, correlation, the count-upload finalize the first
    upload blocks on, candidate extraction at its floor capacity, and
    the score/window gathers.  Never raises: a warmup failure must not
    break the pipeline.  Returns the thread (already started), or None
    when warming is disabled or pointless.
    """
    import threading

    warm_env = os.environ.get("CHROMOSIGHT_TPU_WARM", "1")
    if warm_env == "0":
        return None
    if jax_default_backend_is_cpu() and warm_env != "force":
        return None  # CPU compiles are cheap; don't burn a core
    import jax

    if len(jax.devices()) > 1 and warm_env != "force":
        # multi-chip runs dispatch the sharded programs instead; warming
        # the single-map ones would load executables nothing uses
        return None
    kernels = [np.asarray(k) for k in kernels]
    km, kn = kernels[0].shape
    buckets = {}
    coord_pads = {}
    for row_idx, sub in genome.sub_mats.iterrows():
        cm = sub.contact_map
        try:
            if not cm.is_banded or min(cm.shape) <= max(km, kn):
                continue
            from chromosight_tpu.runtime.contact_map import (
                COL_BUCKET,
                ROW_BUCKET,
                bucket_size,
            )

            n = cm.shape[0]
            kd = int(cm.keep_distance)
            key = (
                bucket_size(n, ROW_BUCKET),
                bucket_size(kd + 1, COL_BUCKET),
            )
            buckets.setdefault(key, (n, kd, int(cm.max_dist), cm.use_norm))
            if coord_counts:
                # keys are sub_mats row labels (cli builds pair_positions
                # keyed on sub[1].name, the Series index label)
                cnt = int(coord_counts.get(row_idx, 0))
                if cnt:
                    coord_pads.setdefault(key, set()).add(pow2(cnt, 64))
        except Exception:
            continue
    if not buckets:
        return None

    missing_tol = kernel_config["max_perc_undetected"] / 100
    pearson_min = float(kernel_config["pearson"])
    have_weights = getattr(genome.clr, "weights", None) is not None

    def _warm_correlate(n_pad, width, n, kd, md, use_norm):
        import jax.numpy as jnp

        from chromosight_tpu.ops.band import (
            band_normxcorr,
            band_normxcorr_multi,
            band_preprocess,
            shear_kernel,
        )

        dtype = np.float32
        band0 = jnp.zeros((n_pad, width), dtype)
        miss0 = jnp.zeros((n_pad,), bool)
        if fused and len(kernels) > 1:
            shs, sh2s = [], []
            for k in kernels:
                ck_, ck2 = _band_conv_kernels(k, tsvd)
                shs.append(shear_kernel(ck_))
                sh2s.append(shear_kernel(ck2))
            out = band_normxcorr_multi(
                band0,
                miss0,
                jnp.asarray(np.stack(kernels), dtype),
                jnp.asarray(np.stack(shs), dtype),
                jnp.asarray(np.stack(sh2s), dtype),
                (km, kn),
                n,
                md,
                missing_tol,
                pearson_min,
            )
            float(out[0][0, 0, 0])
        else:
            # mirror _band_correlate's kernel-argument selection so the
            # warmed program family matches the dispatched one (the
            # tsvd factor pair is a different pytree structure).
            sheared, sheared_sq = _band_sheared_args(
                np.asarray(kernels[0]), tsvd, dtype
            )
            out = band_normxcorr(
                band0,
                miss0,
                jnp.asarray(kernels[0], dtype),
                sheared,
                sheared_sq,
                (km, kn),
                n,
                md,
                missing_tol,
                pearson_min,
            )
            float(out[0][0, 0])

    def _warm_preprocess(n_pad, width, n, kd, use_norm):
        import jax.numpy as jnp

        from chromosight_tpu.ops.band import band_preprocess

        band0 = jnp.zeros((n_pad, width), np.float32)
        miss0 = jnp.zeros((n_pad,), bool)
        pre = band_preprocess(
            band0,
            miss0,  # "detect" flags: all False is a valid input
            10 if use_norm else None,
            kd,
            min(kd + 1, n),
            zero_nan=use_norm,
        )
        float(pre[0, 0])

    def _warm_finalize(n_pad, width, kd, use_norm):
        # Mirror ContactMap.create_mat's upload gates to predict which
        # finalize program the first chromosome upload will block on.
        # Best-effort: the count mode (u4 vs u8 vs u16) depends on the
        # data; u4 is warmed when allowed (the genome-scale common case)
        # — a miss just means that variant compiles on demand as before.
        import jax.numpy as jnp

        from chromosight_tpu.ops import pow2
        from chromosight_tpu.ops.band import (
            band_counts_finalize_u4,
            band_counts_finalize_u8,
            band_weighted_finalize_u4,
            band_weighted_finalize_u8,
        )
        from chromosight_tpu.runtime.contact_map import (
            _big_map,
            _upload_shape,
        )

        if os.environ.get("CHROMOSIGHT_TPU_COUNT_UPLOAD", "1") == "0":
            return
        if not _big_map(n_pad) or (use_norm and not have_weights):
            return
        w_up, _ = _upload_shape(kd + 1, width, n_pad)
        cap = pow2(1, 512)
        exc_idx = jnp.full((cap,), n_pad * w_up, jnp.int32)
        exc_val = jnp.zeros((cap,), jnp.float32)
        allow_u8 = os.environ.get("CHROMOSIGHT_TPU_COUNT_U8", "1") != "0"
        allow_u4 = os.environ.get("CHROMOSIGHT_TPU_COUNT_U4", "1") != "0"
        d0 = int(os.environ.get("CHROMOSIGHT_TPU_U4_HEAD", "64"))
        if allow_u8 and allow_u4 and 0 < d0 <= width // 2:
            head = jnp.zeros((n_pad, d0), jnp.uint8)
            tail = jnp.zeros((n_pad, (w_up - d0 + 1) // 2), jnp.uint8)
            if use_norm:
                w = jnp.zeros((n_pad,), jnp.float32)
                out = band_weighted_finalize_u4(
                    head, tail, exc_idx, exc_val, w, width, w_up
                )
            else:
                out = band_counts_finalize_u4(
                    head, tail, exc_idx, exc_val, width, w_up
                )
        elif allow_u8:
            counts = jnp.zeros((n_pad, w_up), jnp.uint8)
            if use_norm:
                w = jnp.zeros((n_pad,), jnp.float32)
                out = band_weighted_finalize_u8(
                    counts, exc_idx, exc_val, w, width
                )
            else:
                out = band_counts_finalize_u8(counts, exc_idx, exc_val, width)
        else:
            return
        float(out[0, 0])

    def _warm_extract(n_pad, width):
        import jax.numpy as jnp

        from chromosight_tpu.ops.band import (
            extract_candidates_packed,
            extract_candidates_topk_packed,
        )

        corr0 = jnp.zeros((n_pad, width), np.float32)
        cand0 = jnp.zeros((n_pad, width), bool)
        row_k = int(os.environ.get("CHROMOSIGHT_TPU_EXTRACT_ROW_K", 32))
        from chromosight_tpu.ops import pow2 as _pow2

        cap0 = _pow2(
            int(os.environ.get("CHROMOSIGHT_TPU_EXTRACT_CAP0", 1 << 12)), 256
        )
        if row_k > 0 and cap0 <= n_pad * row_k:
            out = extract_candidates_topk_packed(corr0, cand0, cap0, row_k)
        else:
            out = extract_candidates_packed(corr0, cand0, cap0)
        float(out[0, 0])

    def _warm_gathers(n_pad, width):
        import jax.numpy as jnp

        from chromosight_tpu.ops.band import gather_tail_packed

        corr0 = jnp.zeros((n_pad, width), np.float32)
        p = jnp.zeros((64,), jnp.int32)
        out = gather_tail_packed(corr0, corr0, corr0, p, p, km, kn)
        float(out[0, 0])

    def _warm_at(n_pad, width, n, md, pad_len):
        # The fused quantify patch program (scores + log-p + windows in
        # one dispatch) at the exact coordinate-pad bucket it will use.
        import jax.numpy as jnp

        from chromosight_tpu.ops.band import (
            band_normxcorr_at_packed,
            shear_kernel,
        )

        shs, sh2s = [], []
        for k in kernels:
            ck_, ck2 = _band_conv_kernels(k, tsvd)
            shs.append(shear_kernel(ck_))
            sh2s.append(shear_kernel(ck2))
        band0 = jnp.zeros((n_pad, width), np.float32)
        miss0 = jnp.zeros((n_pad,), bool)
        z = jnp.zeros((pad_len,), jnp.int32)
        out = band_normxcorr_at_packed(
            band0,
            miss0,
            z,
            z,
            jnp.asarray(np.stack(kernels), np.float32),
            jnp.asarray(np.stack(shs), np.float32),
            jnp.asarray(np.stack(sh2s), np.float32),
            (km, kn),
            n,
            md,
            missing_tol,
        )
        float(out[0, 0])

    quantify_at = (
        run_mode == "quantify"
        and os.environ.get("CHROMOSIGHT_TPU_QUANTIFY_AT", "1") != "0"
    )
    thunks = []
    for (n_pad, width), (n, kd, md, use_norm) in buckets.items():
        if quantify_at:
            for pad_len in sorted(coord_pads.get((n_pad, width), {64})):
                thunks.append(partial(_warm_at, n_pad, width, n, md, pad_len))
        else:
            thunks.append(partial(_warm_correlate, n_pad, width, n, kd, md, use_norm))
            thunks.append(partial(_warm_gathers, n_pad, width))
        thunks.append(partial(_warm_preprocess, n_pad, width, n, kd, use_norm))
        thunks.append(partial(_warm_finalize, n_pad, width, kd, use_norm))
        if run_mode == "detect":
            thunks.append(partial(_warm_extract, n_pad, width))

    def _warm():
        from concurrent.futures import ThreadPoolExecutor

        try:
            with ThreadPoolExecutor(
                max_workers=min(8, len(thunks)), thread_name_prefix="warmup"
            ) as pool:
                for exc in pool.map(_warm_one, thunks):
                    if exc is not None:
                        sys.stderr.write(f"program warmup skipped: {exc!r}\n")
        except Exception as exc:  # warmup is best-effort by contract
            sys.stderr.write(f"program warmup skipped: {exc!r}\n")

    t = threading.Thread(target=_warm, name="program-warmup", daemon=True)
    t.start()
    return t


def _warm_one(thunk):
    """Run one warmup thunk, trapping its failure (best-effort)."""
    try:
        thunk()
        return None
    except Exception as exc:
        return exc


def _band_conv_kernels(kernel_matrix, tsvd):
    """The kernel (and kernel**2) actually convolved: when tSVD is
    requested, the rank-truncated reconstructions — numerically what the
    reference's factorised 1D convolutions compute (detection.py:648-665).
    """
    if tsvd is None:
        return kernel_matrix, kernel_matrix**2
    lk, rk = preproc.factorise_kernel(kernel_matrix, prop_info=tsvd)
    lk2, rk2 = preproc.factorise_kernel(kernel_matrix**2, prop_info=tsvd)
    return lk @ rk, lk2 @ rk2


def _band_sheared_args(kernel_matrix, tsvd, dtype=np.float32):
    """(sheared, sheared_sq) for the fused band program — plain sheared
    arrays normally, ``(lk, rk)`` factor pairs when tSVD is requested and
    the truncation actually saves work (rank < mk): the separable band
    conv (``ops.band._band_conv_valid_sep``) then runs rank Toeplitz
    blocks instead of mk, realising the speedup of the reference's
    ``--tsvd`` (detection.py:648-665) on the hot band path.  Full-rank
    factorisations fall back to the reconstructed sheared kernel (same
    numbers, no savings to claim)."""
    import jax.numpy as jnp

    from chromosight_tpu.ops.band import shear_kernel

    if tsvd is not None:
        mk = kernel_matrix.shape[0]
        lk, rk = preproc.factorise_kernel(kernel_matrix, prop_info=tsvd)
        lk2, rk2 = preproc.factorise_kernel(
            kernel_matrix**2, prop_info=tsvd
        )
        if max(lk.shape[1], lk2.shape[1]) < mk:
            return (
                (jnp.asarray(lk, dtype), jnp.asarray(rk, dtype)),
                (jnp.asarray(lk2, dtype), jnp.asarray(rk2, dtype)),
            )
        ck, ck2 = lk @ rk, lk2 @ rk2
    else:
        ck, ck2 = kernel_matrix, kernel_matrix**2
    return (
        jnp.asarray(shear_kernel(ck), dtype),
        jnp.asarray(shear_kernel(ck2), dtype),
    )


def _pad_to_bucket(contact_map):
    """(band_p, miss_p, n, width): the device band row-padded to its shape
    bucket (bounds recompiles) and the padded missing flags.  ``n`` is the
    logical row count; ContactMap already pads the band at creation, so
    the pad here is a no-op unless the band was set by hand."""
    import jax.numpy as jnp

    from chromosight_tpu.runtime.contact_map import ROW_BUCKET, bucket_size

    band_dev = contact_map.band_dev
    n = contact_map.shape[0]
    rows, width = band_dev.shape
    n_pad = bucket_size(n, ROW_BUCKET)
    band_p = jnp.pad(
        band_dev.astype(np.float32), ((0, n_pad - rows), (0, 0))
    )
    miss_p = np.zeros(n_pad, dtype=bool)
    miss_p[:n] = preproc.missing_flags(contact_map.detectable_bins[0], n)
    return band_p, miss_p, n, width


def _band_correlate(contact_map, kernel_config, kernel_matrix, tsvd):
    """Fused correlation maps for one chromosome (single-device path).

    Returns (corr, log10-pvals, candidate mask), all device-resident: only
    sparse candidates and gathered values ever cross to the host.
    """
    import jax.numpy as jnp

    from chromosight_tpu.ops.band import band_normxcorr

    km, kn = kernel_matrix.shape
    band_p, miss_p, n, width = _pad_to_bucket(contact_map)
    max_dist = contact_map.max_dist
    dtype = np.float32

    sheared, sheared_sq = _band_sheared_args(kernel_matrix, tsvd, dtype)
    args = (
        band_p,
        jnp.asarray(miss_p),
        jnp.asarray(kernel_matrix, dtype),
        sheared,
        sheared_sq,
        (km, kn),
        n,
        int(max_dist),
        kernel_config["max_perc_undetected"] / 100,
        float(kernel_config["pearson"]),
    )
    observability.account_dispatch("band_normxcorr", band_normxcorr, *args)
    return band_normxcorr(*args)


def _band_tail(
    contact_map,
    kernel_config,
    kernel_matrix,
    coords,
    dump,
    corr_b,
    logp_b,
    cand_b,
):
    """Host tail of band detection: candidate extraction, foci labeling,
    score/window gathers and validation, from precomputed (possibly
    mesh-sharded) correlation maps."""
    import jax.numpy as jnp

    from chromosight_tpu.ops.band import (
        extract_candidates_packed,
        extract_candidates_topk_packed,
    )

    km, kn = kernel_matrix.shape
    band_dev = contact_map.band_dev
    n = contact_map.shape[0]  # logical rows; band_dev is bucket-padded
    width = band_dev.shape[1]
    miss_flags = preproc.missing_flags(contact_map.detectable_bins[0], n)

    if dump:
        # The band engine fuses diagonal trimming into the correlation
        # kernel, so the 03 and 04 snapshots hold the same (trimmed) map.
        corr_band_full = np.asarray(corr_b, dtype=np.float64)[:n]
        i, d = np.nonzero(corr_band_full)
        snapshot = sp.coo_matrix(
            (corr_band_full[i, d], (i, i + d)), shape=(n, n)
        ).tocsr()
        for stage in ("03_normxcorr2", "04_diag_trim"):
            sp.save_npz(
                pathlib.Path(dump) / f"{contact_map.name}_{stage}", snapshot
            )

    from chromosight_tpu.observability import add_bytes, stage as _stage

    run_mode = "detect" if coords is None else "quantify"
    if run_mode == "detect":
        # Optimistic single dispatch: extract at the floor cap and read
        # the exact candidate count from the packed payload (row 3).
        # Genome chromosomes rarely exceed the floor, so the common case
        # pays ONE dispatch+download instead of a count readback
        # chained before the extract; overflow re-extracts at the exact
        # pow2 cap (same bounded program family, so recompiles stay
        # bounded too).
        row_k = int(os.environ.get("CHROMOSIGHT_TPU_EXTRACT_ROW_K", 32))

        def _extract(cap, exact=False):
            # Two-stage top_k extraction (ops/band.py
            # extract_candidates_topk_packed).  A negative payload means
            # some row held more than row_k candidates and the per-row
            # stage may have truncated - fall back to the exact nonzero
            # path.
            if not exact and 0 < row_k and cap <= corr_b.shape[0] * row_k:
                p = np.asarray(
                    extract_candidates_topk_packed(corr_b, cand_b, cap, row_k)
                )
                payload = float(p[3, 0])
                if payload >= 0:
                    return p, int(payload)
                add_bytes("download", p.nbytes)
            p = np.asarray(extract_candidates_packed(corr_b, cand_b, cap))
            return p, int(p[3, 0])

        # Optimistic first shot at a small cap: the payload carries the
        # exact candidate count, so overflow costs one more dispatch at
        # the exact pow2 cap while the common case downloads a few tens
        # of kB instead of the 1 MB a 64k-cap packed array weighs.
        cap = pow2(
            int(os.environ.get("CHROMOSIGHT_TPU_EXTRACT_CAP0", 1 << 12)), 256
        )
        with _stage("device wait: extract"):
            packed, count = _extract(cap)
            # The count rides a float32 payload slot, exact only up to
            # 2^24; above that add one ulp of slack so the pow2 cap can
            # never land below the true count, and re-verify each
            # re-extraction's count against its cap (loop, not one shot).
            while count > cap:
                add_bytes("download", packed.nbytes)
                safe = count + (count >> 23) + 1 if count > (1 << 24) else count
                cap = pow2(safe, cap << 1)
                packed, count = _extract(cap)
        add_bytes("download", packed.nbytes)
        ci = packed[0, :count].astype(np.int64)
        cd = packed[1, :count].astype(np.int64)
        cv = packed[2, :count].astype(np.float64)
        keep_c = (ci >= 0) & (ci < n) & ((ci + cd) < n)
        ci, cd, cv = ci[keep_c], cd[keep_c], cv[keep_c]
        cj = ci + cd
        if len(ci) == 0:
            return None, None
        order = np.lexsort((cj, ci))
        ci, cj, cv = ci[order], cj[order], cv[order]
        lab = _connected_labels(ci, cj, n)
        uniq, inv, counts = np.unique(
            lab, return_inverse=True, return_counts=True
        )
        keep_focus = counts >= 2
        if not np.any(keep_focus):
            return None, None
        flat = ci.astype(np.int64) * np.int64(n) + cj
        order2 = np.lexsort((flat, -cv, inv))
        first = np.searchsorted(inv[order2], np.arange(len(uniq)))
        best = order2[first][keep_focus]
        coords = np.stack([ci[best], cj[best]], axis=1).astype(np.int64)
        if dump:
            keep_px = keep_focus[inv]
            sp.save_npz(
                pathlib.Path(dump) / f"{contact_map.name}_05_foci",
                sp.coo_matrix(
                    (inv[keep_px] + 1, (ci[keep_px], cj[keep_px])),
                    shape=(n, n),
                ).tocsr(),
            )
    coords = np.array(coords, dtype=np.int64, copy=True)
    if kernel_config["max_dist"] == 0:
        coords[:, 0] = coords[:, 1]

    # Gather scores and log-p values at the final coordinates on device
    # (padded to a bucket to bound recompiles).
    n_pat = coords.shape[0]
    pad_len = pow2(n_pat, 64)
    p1 = np.zeros(pad_len, np.int32)
    dsc = np.zeros(pad_len, np.int32)
    p1[:n_pat] = coords[:, 0]
    dsc[:n_pat] = coords[:, 1] - coords[:, 0]
    # Fused gather: scores + log-p + raw windows in one dispatch and one
    # download (host gets only n_pat * (2 + wh*ww) floats).
    from chromosight_tpu.ops.band import gather_tail_packed

    with _stage("device wait: gathers"):
        tail = np.asarray(
            gather_tail_packed(
                corr_b,
                logp_b,
                band_dev,
                jnp.asarray(p1),
                jnp.asarray(dsc),
                km,
                kn,
            ),
            dtype=np.float64,
        )
    add_bytes("download", tail.nbytes)
    score_vec = tail[:n_pat, 0]
    logp_vec = tail[:n_pat, 1]
    raw_windows = tail[:n_pat, 2:].reshape(n_pat, km, kn)
    in_band = (
        (coords[:, 0] >= 0)
        & (coords[:, 0] < n)
        & ((coords[:, 1] - coords[:, 0]) >= 0)
        & ((coords[:, 1] - coords[:, 0]) < width)
    )
    score_vec = np.where(in_band, score_vec, 0.0)
    logp_vec = np.where(in_band, logp_vec, np.nan)

    filtered_coords, filtered_windows, valid_mask = _validate_patterns_band(
        coords,
        (n, width),
        raw_windows,
        miss_flags,
        score_vec,
        kernel_matrix,
        big_k=max(km, kn),
        drop=run_mode == "detect",
        zero_tol=kernel_config["max_perc_zero"] / 100,
        missing_tol=kernel_config["max_perc_undetected"] / 100,
    )
    if run_mode == "detect":
        logp_out = logp_vec[valid_mask]
    else:
        logp_out = logp_vec
    filtered_coords["pvalue"] = 10 ** logp_out
    return filtered_coords, filtered_windows


def _pattern_detector_band(
    contact_map, kernel_config, kernel_matrix, coords, dump, tsvd
):
    """Band-engine detection path for large intra maps (full mode)."""
    if _band_guards(contact_map, kernel_matrix):
        return None, None
    if (
        coords is not None
        and dump is None
        and os.environ.get("CHROMOSIGHT_TPU_QUANTIFY_AT", "1") != "0"
    ):
        return quantify_banded(
            contact_map, kernel_config, [kernel_matrix], coords, tsvd
        )[0]
    corr_b, logp_b, cand_b = _band_correlate(
        contact_map, kernel_config, kernel_matrix, tsvd
    )
    return _band_tail(
        contact_map,
        kernel_config,
        kernel_matrix,
        coords,
        dump,
        corr_b,
        logp_b,
        cand_b,
    )


def fuse_kernels_eligible(kernels):
    """Whether a config's kernels can run as one fused multi-kernel band
    dispatch: more than one kernel, all the same shape."""
    if len(kernels) < 2:
        return False
    if os.environ.get("CHROMOSIGHT_TPU_FUSE_KERNELS", "1") == "0":
        return False
    shapes = {np.asarray(k).shape for k in kernels}
    return len(shapes) == 1


def _band_correlate_multi(contact_map, kernel_config, kernels, tsvd):
    """Fused correlation maps for K same-shape kernels on one chromosome:
    one device dispatch computes what K ``_band_correlate`` calls would
    (the reference loops kernels over every submatrix,
    cli/chromosight.py:730-792 — here the kernel loop rides one program).

    Returns (corr, logp, cand), each (K, n_pad, W).
    """
    import jax.numpy as jnp

    from chromosight_tpu.ops.band import band_normxcorr_multi, shear_kernel

    km, kn = np.asarray(kernels[0]).shape
    band_p, miss_p, n, width = _pad_to_bucket(contact_map)
    dtype = np.float32
    shs, sh2s = [], []
    for k in kernels:
        conv_k, conv_k2 = _band_conv_kernels(np.asarray(k), tsvd)
        shs.append(shear_kernel(conv_k))
        sh2s.append(shear_kernel(conv_k2))
    args = (
        band_p,
        jnp.asarray(miss_p),
        jnp.asarray(np.stack([np.asarray(k) for k in kernels]), dtype),
        jnp.asarray(np.stack(shs), dtype),
        jnp.asarray(np.stack(sh2s), dtype),
        (km, kn),
        n,
        int(contact_map.max_dist),
        kernel_config["max_perc_undetected"] / 100,
        float(kernel_config["pearson"]),
    )
    observability.account_dispatch(
        "band_normxcorr_multi", band_normxcorr_multi, *args
    )
    return band_normxcorr_multi(*args)


def detect_banded_multi(
    contact_map, kernel_config, kernels, coords=None, dump=None, tsvd=None
):
    """Detect (or quantify) with every kernel of a config on one banded
    map in a single fused device dispatch.

    Returns a list of (coords, windows) pairs, one per kernel, each
    identical to ``pattern_detector`` run with that kernel alone.
    """
    if _band_guards(contact_map, np.asarray(kernels[0])):
        return [(None, None)] * len(kernels)
    if (
        coords is not None
        and dump is None
        and os.environ.get("CHROMOSIGHT_TPU_QUANTIFY_AT", "1") != "0"
    ):
        return quantify_banded(contact_map, kernel_config, kernels, coords, tsvd)
    corr, logp, cand = _band_correlate_multi(
        contact_map, kernel_config, kernels, tsvd
    )
    return [
        _band_tail(
            contact_map,
            kernel_config,
            np.asarray(kernels[k]),
            coords,
            dump,
            corr[k],
            logp[k],
            cand[k],
        )
        for k in range(len(kernels))
    ]


def quantify_banded(contact_map, kernel_config, kernels, coords, tsvd):
    """Score user coordinates on a banded map without the full-width
    correlation sweep: one patch-gather + stencil-matmul dispatch
    (``ops.band.band_normxcorr_at``) computes all K kernels' Pearson and
    log-p values at the requested pixels only.

    Quantify widens the band to the furthest requested pair (reference
    ``cli/chromosight.py:352-358``), so the sweep the detect path
    amortizes over every band pixel is mostly wasted here.  Output
    matches ``detect_banded_multi(..., coords=...)``'s per-kernel
    (coords DataFrame, window stack) list to ~1e-6 on f32 scores (the
    stencil matmul sums in a different order than the sweep convs).
    """
    import jax.numpy as jnp

    from chromosight_tpu.observability import add_bytes, stage as _stage
    from chromosight_tpu.ops.band import (
        band_normxcorr_at_packed,
        shear_kernel,
    )

    kernels = [np.asarray(k) for k in kernels]
    km, kn = kernels[0].shape
    band_p, miss_p, n, width = _pad_to_bucket(contact_map)
    coords = np.array(coords, dtype=np.int64, copy=True)
    if kernel_config["max_dist"] == 0:
        coords[:, 0] = coords[:, 1]
    n_pat = coords.shape[0]
    pad_len = pow2(n_pat, 64)
    p1 = np.zeros(pad_len, np.int32)
    dsc = np.zeros(pad_len, np.int32)
    p1[:n_pat] = coords[:, 0]
    dsc[:n_pat] = coords[:, 1] - coords[:, 0]
    shs, sh2s = [], []
    for k in kernels:
        ck, ck2 = _band_conv_kernels(k, tsvd)
        shs.append(shear_kernel(ck))
        sh2s.append(shear_kernel(ck2))
    dtype = np.float32
    at_args = (
        band_p,
        jnp.asarray(miss_p),
        jnp.asarray(p1),
        jnp.asarray(dsc),
        jnp.asarray(np.stack(kernels), dtype),
        jnp.asarray(np.stack(shs), dtype),
        jnp.asarray(np.stack(sh2s), dtype),
        (km, kn),
        n,
        int(contact_map.max_dist),
        kernel_config["max_perc_undetected"] / 100,
    )
    observability.account_dispatch(
        "band_normxcorr_at", band_normxcorr_at_packed, *at_args
    )
    n_k = len(kernels)
    # One dispatch, one download: per-kernel scores + log-p and the
    # kernel-independent raw windows packed as (pad_len, 2K + km*kn).
    with _stage("device wait: quantify-at"):
        packed = np.asarray(band_normxcorr_at_packed(*at_args), np.float64)
    add_bytes("download", packed.nbytes)
    raw_windows = packed[:n_pat, 2 * n_k :].reshape(n_pat, km, kn)

    in_band = (
        (coords[:, 0] >= 0)
        & (coords[:, 0] < n)
        & ((coords[:, 1] - coords[:, 0]) >= 0)
        & ((coords[:, 1] - coords[:, 0]) < width)
    )
    miss_flags = preproc.missing_flags(contact_map.detectable_bins[0], n)

    results = []
    for k in range(len(kernels)):
        score_vec = np.where(in_band, packed[:n_pat, k], 0.0)
        logp_vec = np.where(in_band, packed[:n_pat, n_k + k], np.nan)
        filtered_coords, filtered_windows, _ = _validate_patterns_band(
            coords,
            (n, width),
            raw_windows,
            miss_flags,
            score_vec,
            kernels[k],
            big_k=max(km, kn),
            drop=False,
            zero_tol=kernel_config["max_perc_zero"] / 100,
            missing_tol=kernel_config["max_perc_undetected"] / 100,
        )
        filtered_coords["pvalue"] = 10**logp_vec
        results.append((filtered_coords, filtered_windows))
    return results


# --------------------------------------------------------------------- #
# Orchestrator
# --------------------------------------------------------------------- #
def pattern_detector(
    contact_map,
    kernel_config,
    kernel_matrix,
    coords=None,
    dump=None,
    full=False,
    tsvd=None,
):
    """Detect (or quantify at given coords) patterns on one contact map.

    Reference: ``detection.py:177-345``.  ``contact_map`` is a
    ``chromosight_tpu.runtime.ContactMap`` (dense matrix resident on
    device/host) exposing ``matrix``, ``detectable_bins``, ``max_dist``,
    ``inter`` and ``name``.

    Returns (patterns DataFrame with bin1/bin2/score/pvalue, window stack).
    """
    km, kn = kernel_matrix.shape
    kh, kw = (km - 1) // 2, (kn - 1) // 2

    run_mode = "detect" if coords is None else "quantify"

    banded = getattr(contact_map, "band_dev", None) is not None
    if full and banded:
        return _pattern_detector_band(
            contact_map, kernel_config, kernel_matrix, coords, dump, tsvd
        )
    if getattr(contact_map, "sparse", None) is not None or (banded and not full):
        # full=False on a banded map: expanding the band to dense would be
        # O(n^2) memory at genome scale, so route through the sparse path
        # (O(nnz) host view + the bounded-memory tiled engine when large).
        return _pattern_detector_sparse(
            contact_map, kernel_config, kernel_matrix, coords, dump, full,
            tsvd,
        )

    mat_dense = contact_map.dense  # float ndarray, NaNs already zeroed
    if min(mat_dense.shape) <= max(kernel_matrix.shape):
        return None, None

    def save_dump(base, arr):
        sp.save_npz(
            pathlib.Path(dump) / f"{contact_map.name}_{base}",
            sp.csr_matrix(np.asarray(arr)),
        )

    from chromosight_tpu.ops.normxcorr import make_missing_mask_dense
    from chromosight_tpu.ops.preprocess import diag_trim_dense

    if full:
        miss_r = preproc.missing_flags(
            contact_map.detectable_bins[0], mat_dense.shape[0]
        )
        miss_c = preproc.missing_flags(
            contact_map.detectable_bins[1], mat_dense.shape[1]
        )
        missing_mask = np.asarray(
            make_missing_mask_dense(
                mat_dense.shape,
                miss_r,
                miss_c,
                max_dist=contact_map.max_dist,
                sym_upper=not contact_map.inter,
            )
        )
    else:
        missing_mask = None

    corr_dev, logp_dev = normxcorr2_dense(
        mat_dense,
        kernel_matrix,
        max_dist=contact_map.max_dist,
        sym_upper=not contact_map.inter,
        full=full,
        missing_mask=missing_mask,
        tsvd=tsvd,
        pval=True,
        missing_tol=kernel_config["max_perc_undetected"] / 100,
    )
    if dump:
        save_dump("03_normxcorr2", corr_dev)
    if not contact_map.inter:
        corr_dev = diag_trim_dense(corr_dev, contact_map.max_dist)
        if dump:
            save_dump("04_diag_trim", corr_dev)
    mat_conv = np.asarray(corr_dev, dtype=np.float64)
    mat_conv[np.isnan(mat_conv)] = 0
    mat_log10_pvals = np.asarray(logp_dev, dtype=np.float64)

    if run_mode == "detect":
        coords, foci_mat = pick_foci(mat_conv, kernel_config["pearson"])
        if coords is None:
            return None, None
        if dump:
            save_dump("05_foci", foci_mat.todense())
    coords = np.array(coords, dtype=np.int64, copy=True)

    mat = np.array(mat_dense, dtype=np.float64, copy=True)
    det = [np.array(d, copy=True) for d in contact_map.detectable_bins]
    if full:
        mat = np.pad(mat, ((kh, kh), (kw, kw)))
        mat_conv = np.pad(mat_conv, ((kh, kh), (kw, kw)))
        det[0] = det[0] + kh
        det[1] = det[1] + kw
        coords[:, 0] += kh
        coords[:, 1] += kw

    if not contact_map.inter:
        # NaN the lower diagonals so pileups ignore them
        big_k = max(km, kn)
        n0, n1 = mat.shape
        i, j = np.indices((n0, n1), sparse=True)
        band = ((i - j) >= 1) & ((i - j) <= big_k)
        mat = np.where(band, np.nan, mat)
        if kernel_config["max_dist"] == 0:
            coords[:, 0] = coords[:, 1]

    filtered_coords, filtered_windows = validate_patterns(
        coords,
        mat,
        mat_conv,
        det,
        kernel_matrix,
        zero_tol=kernel_config["max_perc_zero"] / 100,
        missing_tol=kernel_config["max_perc_undetected"] / 100,
        drop=True if run_mode == "detect" else False,
    )

    if full:
        filtered_coords.bin1 -= kh
        filtered_coords.bin2 -= kw

    b1 = filtered_coords.bin1.to_numpy(dtype=np.int64)
    b2 = filtered_coords.bin2.to_numpy(dtype=np.int64)
    inb = (
        (b1 >= 0)
        & (b1 < mat_log10_pvals.shape[0])
        & (b2 >= 0)
        & (b2 < mat_log10_pvals.shape[1])
    )
    logp = np.full(len(b1), np.nan)
    logp[inb] = mat_log10_pvals[b1[inb], b2[inb]]
    filtered_coords["pvalue"] = 10 ** logp
    return filtered_coords, filtered_windows


# --------------------------------------------------------------------- #
# Sparse-mode detection (genome-scale inter maps)
# --------------------------------------------------------------------- #
# Above this many stored nonzeros the bulk point query switches from one
# flat-key searchsorted (O(nnz) int64 transients) to per-row segments.
_POINT_QUERY_FLAT_NNZ = 1 << 22


def _csr_point_values(csr, qr, qc):
    """Bulk point query csr[qr[k], qc[k]] -> values (0 where absent).

    Small matrices take one searchsorted over row-major flat keys (every
    query served at once); big ones group queries by row and searchsorted
    each row's index segment, so the transient footprint stays O(queries)
    instead of O(nnz) int64 keys (a genome-scale trans CSR would
    otherwise allocate ~16 B/nonzero per call).
    """
    if csr.nnz == 0 or len(qr) == 0:
        return np.zeros(len(qr), dtype=np.float64)
    csr = csr.tocsr()
    csr.sum_duplicates()
    qr = np.asarray(qr, dtype=np.int64)
    qc = np.asarray(qc, dtype=np.int64)
    valid = (qr >= 0) & (qr < csr.shape[0]) & (qc >= 0) & (qc < csr.shape[1])
    if not valid.all():
        # out-of-range queries read 0 (a row-major flat key would alias
        # qc >= ncols into the next row's pixels)
        out = np.zeros(len(qr), dtype=np.float64)
        out[valid] = _csr_point_values(csr, qr[valid], qc[valid])
        return out
    if csr.nnz <= _POINT_QUERY_FLAT_NNZ:
        ncols = np.int64(csr.shape[1])
        flat = (
            np.repeat(
                np.arange(csr.shape[0], dtype=np.int64), np.diff(csr.indptr)
            )
            * ncols
            + csr.indices
        )
        q = qr * ncols + qc
        pos = np.searchsorted(flat, q)
        pos = np.minimum(pos, len(flat) - 1)
        hit = flat[pos] == q
        return np.where(hit, csr.data[pos], 0.0).astype(np.float64)
    out = np.zeros(len(qr), dtype=np.float64)
    order = np.lexsort((qc, qr))
    qr_s, qc_s = qr[order], qc[order]
    starts = np.flatnonzero(np.r_[True, qr_s[1:] != qr_s[:-1]])
    bounds = np.r_[starts, len(qr_s)]
    indptr, indices, data = csr.indptr, csr.indices, csr.data
    for k in range(len(starts)):
        s, e = bounds[k], bounds[k + 1]
        lo, hi = indptr[qr_s[s]], indptr[qr_s[s] + 1]
        if lo == hi:
            continue
        seg = indices[lo:hi]
        p = np.searchsorted(seg, qc_s[s:e])
        p = np.minimum(p, hi - lo - 1)
        hit = seg[p] == qc_s[s:e]
        out[order[s:e]] = np.where(hit, data[lo + p], 0.0)
    return out


def _validate_patterns_sparse(
    coords,
    matrix,
    conv_mat,
    detectable_bins,
    kernel_matrix,
    drop=True,
    zero_tol=0.3,
    missing_tol=0.75,
    nan_band=0,
    pad=None,
):
    """``validate_patterns`` semantics with sparse window gathers: every
    candidate's (win_h, win_w) window is read through one bulk CSR point
    query, so the matrix is never densified and the host tail stays
    vectorised at genome scale (a per-pattern CSR slicing loop dominates
    detect-mode runs with many candidates).  ``nan_band`` > 0 NaNs window
    pixels on diagonals 1..nan_band below the main one (the dense path's
    pileup masking for symmetric matrices).

    ``pad=(kh, kw)`` runs the full-mode semantics WITHOUT materialising
    zero-padded copies of the matrices: coords/detectable_bins arrive in
    padded coordinates (top-left offset (kh, kw), logical shape grown by
    2*(kh, kw)) while ``matrix``/``conv_mat`` stay unpadded — reads
    subtract the offset and out-of-range pixels evaluate to the pad's
    zeros.  At genome scale each ``zero_pad_sparse`` is a full O(nnz)
    CSR rebuild, four of them per trans map in the --inter host tail."""
    matrix = matrix.tocsr()
    conv = conv_mat.tocsr()
    coords = np.asarray(coords, dtype=np.int64)
    n_pat = coords.shape[0]
    win_h, win_w = kernel_matrix.shape
    half_h, half_w = win_h // 2 + 1, win_w // 2 + 1
    kh, kw = pad if pad is not None else (0, 0)
    shape = (matrix.shape[0] + 2 * kh, matrix.shape[1] + 2 * kw)
    miss_rows = preproc.missing_flags(detectable_bins[0], shape[0])
    miss_cols = preproc.missing_flags(detectable_bins[1], shape[1])

    validated_coords = pd.DataFrame(
        {
            "bin1": coords[:, 0],
            "bin2": coords[:, 1],
            "score": np.full(n_pat, np.nan),
        }
    )
    pattern_windows = np.full((n_pat, win_h, win_w), np.nan)
    if n_pat == 0:
        valid = np.zeros(0, dtype=bool)
    else:
        p1, p2 = coords[:, 0], coords[:, 1]
        high = p1 - half_h + 1
        low = p1 + half_h
        left = p2 - half_w + 1
        right = p2 + half_w
        # strict bounds, matching the dense path (and the reference's
        # last-row/column drop quirk)
        inbound = (
            (high >= 0)
            & (low < shape[0])
            & (left >= 0)
            & (right < shape[1])
        )
        # ---- phase 1: candidate pre-filter without value reads ---- #
        # Detect-mode candidate sets can be 100x the final call count
        # (sparse trans windows fail the zero-fraction rule almost
        # everywhere), and each window costs win_h*win_w point queries
        # plus several full-array masking sweeps.  Two exact-or-
        # necessary conditions cut the exact (value-reading) phase to
        # the survivors:
        #  * prop_undetected: for inbound windows the analytic missing
        #    count (mr missing rows, mc missing cols ->
        #    wh*ww - (wh-mr)*(ww-mc)) EXACTLY equals the mask the
        #    value path applies;
        #  * prop_zero: the stored-nonzero count in the window bounds
        #    the non-zero unmasked pixels from above, so
        #    cnt <= (1-zero_tol)*(tot-n_missing) can never pass the
        #    exact check (necessary condition; false keeps fine, false
        #    drops impossible).
        # nan_band (intra pileup masking) breaks the analytic missing
        # count, so that path keeps the single-phase exact route.
        tot = win_h * win_w
        cand = inbound.copy()
        if nan_band == 0 and n_pat > 64:
            rpre = np.zeros(shape[0] + 1)
            rpre[1:] = np.cumsum(miss_rows)
            cpre = np.zeros(shape[1] + 1)
            cpre[1:] = np.cumsum(miss_cols)
            hi_c = np.clip(high, 0, shape[0] - win_h)
            lf_c = np.clip(left, 0, shape[1] - win_w)
            mr = rpre[hi_c + win_h] - rpre[hi_c]
            mc = cpre[lf_c + win_w] - cpre[lf_c]
            n_miss_a = tot - (win_h - mr) * (win_w - mc)
            with np.errstate(invalid="ignore", divide="ignore"):
                cand &= (n_miss_a / tot) < missing_tol
            # stored nonzero pixels per (window, window-row), via two
            # vectorised searchsorteds over the nonzero flat keys
            mdat = matrix.data
            nzrows = np.repeat(
                np.arange(matrix.shape[0], dtype=np.int64),
                np.diff(matrix.indptr),
            )
            nzsel = mdat != 0
            ncols = np.int64(matrix.shape[1])
            nzflat = nzrows[nzsel] * ncols + matrix.indices[nzsel]
            ci = np.flatnonzero(cand)
            if len(ci):
                uu = np.arange(win_h, dtype=np.int64)
                ru0 = (hi_c[ci, None] + uu[None, :]) - kh
                ok_r = (ru0 >= 0) & (ru0 < matrix.shape[0])
                c_lo = np.clip(lf_c[ci] - kw, 0, matrix.shape[1])
                c_hi = np.clip(lf_c[ci] - kw + win_w, 0, matrix.shape[1])
                lo_key = ru0 * ncols + c_lo[:, None]
                hi_key = ru0 * ncols + c_hi[:, None]
                cnt = np.searchsorted(nzflat, hi_key) - np.searchsorted(
                    nzflat, lo_key
                )
                cnt = np.where(ok_r, cnt, 0).sum(axis=1)
                need = (1 - zero_tol) * (tot - n_miss_a[ci])
                cand[ci] &= cnt > need - 1e-9
        # ---- phase 2: exact validation (value reads) on survivors -- #
        survivors = np.flatnonzero(cand)
        n_s = len(survivors)
        u = np.arange(win_h, dtype=np.int64)
        v = np.arange(win_w, dtype=np.int64)
        ridx = np.clip(
            high[survivors, None] + u[None, :], 0, shape[0] - 1
        )
        cidx = np.clip(
            left[survivors, None] + v[None, :], 0, shape[1] - 1
        )
        rr = np.broadcast_to(ridx[:, :, None], (n_s, win_h, win_w))
        cc = np.broadcast_to(cidx[:, None, :], (n_s, win_h, win_w))
        # value reads subtract the virtual pad offset; pixels that land
        # in the (never materialised) margins read as the pad's zeros
        ru = rr.ravel() - kh
        cu = cc.ravel() - kw
        ok = (
            (ru >= 0)
            & (ru < matrix.shape[0])
            & (cu >= 0)
            & (cu < matrix.shape[1])
        )
        wins = np.zeros(n_s * win_h * win_w)
        if ok.any():
            wins[ok] = _csr_point_values(matrix, ru[ok], cu[ok])
        wins = wins.reshape(n_s, win_h, win_w)
        wins = np.where(miss_rows[ridx][:, :, None], np.nan, wins)
        wins = np.where(miss_cols[cidx][:, None, :], np.nan, wins)
        if nan_band:
            d = rr - cc
            wins = np.where((d >= 1) & (d <= nan_band), np.nan, wins)

        n_missing = np.sum(~np.isfinite(wins), axis=(1, 2))
        n_zero = np.sum(wins == 0, axis=(1, 2))
        with np.errstate(invalid="ignore", divide="ignore"):
            prop_undetected = n_missing / tot
            prop_zero = n_zero / (tot - n_missing)
        valid_s = (
            inbound[survivors]
            & (prop_undetected < missing_tol)
            & (prop_zero < zero_tol)
        )
        valid = np.zeros(n_pat, dtype=bool)
        valid[survivors] = valid_s
        if valid_s.any():
            sv = survivors[valid_s]
            scores = _csr_point_values(
                conv,
                np.clip(p1[sv] - kh, 0, conv.shape[0] - 1),
                np.clip(p2[sv] - kw, 0, conv.shape[1] - 1),
            )
            validated_coords.loc[valid, "score"] = scores
            pattern_windows[valid] = wins[valid_s]

    if drop:
        return validated_coords.loc[valid, :], pattern_windows[valid, :, :]
    return validated_coords, pattern_windows


def _pattern_detector_sparse(
    contact_map, kernel_config, kernel_matrix, coords, dump, full, tsvd
):
    """Detection on a sparse-resident map: matrix, missing mask,
    correlation and p-value maps stay scipy-sparse end to end; the
    Pearson scan runs through the halo-tiled device engine
    (``ops.tiled``).  Mirrors the reference's sparse flow
    (``detection.py:177-345`` + ``_normxcorr2_sparse``) the way the dense
    path above mirrors its dense flow."""
    smat = (
        contact_map.sparse
        if getattr(contact_map, "sparse", None) is not None
        else contact_map.matrix  # O(nnz) sparse view of a banded map
    ).tocsr()
    km, kn = kernel_matrix.shape
    kh, kw = (km - 1) // 2, (kn - 1) // 2
    if min(smat.shape) <= max(kernel_matrix.shape):
        return None, None
    run_mode = "detect" if coords is None else "quantify"
    sym_upper = not contact_map.inter

    def save_dump(base, mat):
        sp.save_npz(
            pathlib.Path(dump) / f"{contact_map.name}_{base}",
            sp.csr_matrix(mat),
        )

    if full and not sym_upper:
        # Inter maps: the (framed) missing mask is exactly a crossing of
        # two boolean vectors, so the tiled engine builds mask blocks on
        # device — no mask matrix is ever materialised or uploaded.
        from chromosight_tpu.ops.tiled import normxcorr2_sparse_tiled

        miss_r = preproc.missing_flags(
            contact_map.detectable_bins[0], smat.shape[0]
        )
        miss_c = preproc.missing_flags(
            contact_map.detectable_bins[1], smat.shape[1]
        )
        # In detect mode only candidate pixels (>= pearson) are ever
        # consumed downstream, so the engine can filter on device and
        # skip downloading the full correlation map; --dump needs the
        # complete 03_normxcorr2 snapshot, so it keeps the full map.
        keep_min = None
        if run_mode == "detect" and not dump:
            pearson_min = float(kernel_config["pearson"])
            if pearson_min > 0:
                keep_min = pearson_min
        corr, logp = normxcorr2_sparse_tiled(
            smat,
            kernel_matrix,
            sym_upper=False,
            full=True,
            missing_vectors=(miss_r, miss_c),
            missing_tol=kernel_config["max_perc_undetected"] / 100,
            tsvd=tsvd,
            pval=True,
            keep_min=keep_min,
        )
    else:
        missing_mask = None
        if full:
            missing_mask = preproc.make_missing_mask(
                smat.shape,
                contact_map.detectable_bins[0],
                contact_map.detectable_bins[1],
                max_dist=contact_map.max_dist,
                sym_upper=sym_upper,
            ).tocsr()
        corr, logp = normxcorr2(
            smat,
            kernel_matrix,
            max_dist=contact_map.max_dist,
            sym_upper=sym_upper,
            full=full,
            missing_mask=missing_mask,
            missing_tol=kernel_config["max_perc_undetected"] / 100,
            tsvd=tsvd,
            pval=True,
        )
    corr = corr.tocsr()
    if dump:
        save_dump("03_normxcorr2", corr)
    if not contact_map.inter:
        corr = preproc.diag_trim(corr, contact_map.max_dist)
        if dump:
            save_dump("04_diag_trim", corr)

    if run_mode == "detect":
        with observability.stage("host: foci"):
            coords, foci_mat = pick_foci(corr, kernel_config["pearson"])
        if coords is None:
            return None, None
        if dump:
            save_dump("05_foci", foci_mat)
    coords = np.array(coords, dtype=np.int64, copy=True)

    det = [np.array(d, copy=True) for d in contact_map.detectable_bins]
    with observability.stage("host: validate"):
        if full:
            # virtual padding: coords/detectable bins move into padded
            # coordinates, but the O(nnz) zero_pad_sparse CSR rebuilds
            # are skipped — the validator subtracts the offset on reads
            # (pad pixels evaluate to the margins' zeros)
            det[0] = det[0] + kh
            det[1] = det[1] + kw
            coords[:, 0] += kh
            coords[:, 1] += kw

        if not contact_map.inter and kernel_config["max_dist"] == 0:
            coords[:, 0] = coords[:, 1]

        filtered_coords, filtered_windows = _validate_patterns_sparse(
            coords,
            smat,
            corr,
            det,
            kernel_matrix,
            zero_tol=kernel_config["max_perc_zero"] / 100,
            missing_tol=kernel_config["max_perc_undetected"] / 100,
            drop=run_mode == "detect",
            nan_band=max(km, kn) if not contact_map.inter else 0,
            pad=(kh, kw) if full else None,
        )
    if full:
        filtered_coords.bin1 -= kh
        filtered_coords.bin2 -= kw

    b1 = filtered_coords.bin1.to_numpy(dtype=np.int64)
    b2 = filtered_coords.bin2.to_numpy(dtype=np.int64)
    logp = logp.tocsr()
    inb = (
        (b1 >= 0) & (b1 < logp.shape[0]) & (b2 >= 0) & (b2 < logp.shape[1])
    )
    lp = np.full(len(b1), np.nan)
    if inb.any():
        lp[inb] = _csr_point_values(logp, b1[inb], b2[inb])
    filtered_coords = filtered_coords.copy()
    filtered_coords["pvalue"] = 10**lp
    return filtered_coords, filtered_windows
