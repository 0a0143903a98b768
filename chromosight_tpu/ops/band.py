"""Diagonal-band (sheared) engine for genome-scale intra-chromosomal maps.

A human 5 kb chromosome is ~50k bins; its dense matrix (10 GB fp32) does
not fit HBM, but detection only scans ``max_dist`` diagonals
(reference ``contacts_map.py:629-638`` keeps the band, and
``detection.py:269-272`` re-trims the correlation output).  This module
stores the matrix as a band tensor::

    B[i, d] = M[i, i + d]      for d in [0, W)

and runs the whole fused normxcorr2 pipeline in band coordinates.  A k x k
matrix-space kernel becomes a sheared (k, 2k-1) band-space kernel::

    out[i, d] = sum_{u,v} K[u, v] * B[i + u - kh, d + (v - u)]

so every convolution stays a dense XLA conv on an (n, W)-shaped tensor -
contiguous, and row-shardable over a device mesh (XLA GSPMD inserts the
halo exchanges for the sharded row dimension).

Numerical semantics replicate the reference "full" mode exactly (framing
margins, missing-mask corrections, thresholds, clamps) - see
``ops/normxcorr.py`` for the list of parity rules.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from chromosight_tpu.ops.convolve import DEFAULT_THRESHOLD, _snap_small

# --------------------------------------------------------------------- #
# Host-side band assembly
# --------------------------------------------------------------------- #


def coo_to_band(rows, cols, vals, n, width, dtype=np.float64):
    """Scatter COO triplets into the upper band B[i, d] = M[i, i+d].

    Entries with d outside [0, width) are dropped, so callers may pass
    either symmetric or upper-triangle-only triplets.
    """
    from chromosight_tpu import native

    nb = native.coo_to_band(rows, cols, vals, n, width, dtype=dtype)
    if nb is not None:
        return nb
    band = np.zeros((n, width), dtype=dtype)
    d = cols - rows
    keep = (d >= 0) & (d < width)
    band[rows[keep], d[keep]] = vals[keep]
    return band


def band_to_dense(band, n=None):
    """Expand a band tensor back to a dense upper-triangular matrix."""
    nb, width = band.shape
    n = nb if n is None else n
    out = np.zeros((n, n), dtype=band.dtype)
    i, d = np.nonzero(band)
    j = i + d
    ok = j < n
    out[i[ok], j[ok]] = band[i[ok], d[ok]]
    return out


def band_window(band, p1, p2, half_h, half_w, keep_dist):
    """Extract the dense window [p1-half_h+1:p1+half_h, p2-half_w+1:p2+half_w]
    from a band tensor (matrix coordinates), zero outside the band."""
    n, width = band.shape
    rows = np.arange(p1 - half_h + 1, p1 + half_h)
    cols = np.arange(p2 - half_w + 1, p2 + half_w)
    ii = rows[:, None]
    jj = cols[None, :]
    d = jj - ii
    valid = (ii >= 0) & (ii < n) & (d >= 0) & (d < width)
    out = np.zeros((len(rows), len(cols)), dtype=band.dtype)
    ic = np.clip(ii, 0, n - 1)
    dc = np.clip(d, 0, width - 1)
    vals = band[ic, dc]
    out[:] = np.where(valid, vals, 0.0)
    return out


# --------------------------------------------------------------------- #
# Device-side band preprocessing
# --------------------------------------------------------------------- #
def _iota2(shape, dim, dtype=jnp.int32):
    return lax.broadcasted_iota(dtype, shape, dim)


def sliding_vector(vec, n_rows, width):
    """Gather-free skew: out[i, d] = vec[i + d].

    Builds the (n_rows, width) view without a computed-index gather, by a
    tile + reshape trick: tiling a length-L vector and reshaping to
    (width, L+1) makes row d equal to the vector shifted by d (because
    (L+1) mod L = 1).  ``vec`` must have length >= n_rows + width.
    """
    L = vec.shape[0]
    if L < n_rows + width:
        raise ValueError("vec too short for requested window")
    skew = jnp.tile(vec, width + 1)[: width * (L + 1)].reshape(width, L + 1)
    return skew[:, :n_rows].T


@partial(jax.jit, static_argnames=("width",))
def band_finalize_upload(band, width):
    """Cast an uploaded band to f32 and zero-pad its columns to the
    compute-width bucket.

    Lets the host upload only ``keep_distance + 1`` columns (and
    optionally bf16 values) instead of the full power-of-two bucket —
    ~18% fewer bytes for the human-5kb loops config (418 -> 512 columns),
    and half again with bf16 — while every downstream program still sees
    the bucketed f32 shape and compiles once per bucket."""
    band = band.astype(jnp.float32)
    pad = width - band.shape[1]
    if pad:
        band = jnp.pad(band, ((0, 0), (0, pad)))
    return band


@partial(jax.jit, static_argnames=("width",))
def band_weighted_finalize(counts, weights, width):
    """Apply balancing weights to an uploaded RAW-count band and pad to
    the compute-width bucket: out[i, d] = counts[i, d] * w[i] * w[i + d]
    where counts > 0, else exactly 0.

    The exact-uint16 upload path: the host ships half the bytes of the
    balanced f32 band (counts are exact in uint16; weights are one f32
    vector), and this single per-bucket program reproduces the fused
    native scatter's values — cells with no pixel stay 0.0 even when the
    bin weight is NaN, matching ``band_scatter_fused``'s zero-initialised
    output (NaN products at scattered pixels propagate identically and
    are zeroed downstream by the standard NaN-zeroing step).
    """
    n_pad, w_up = counts.shape
    band = counts.astype(jnp.float32)
    w = weights.astype(jnp.float32)
    w_pad = jnp.concatenate([w, jnp.zeros((w_up,), jnp.float32)])
    w_j = sliding_vector(w_pad, n_pad, w_up)
    band = jnp.where(counts > 0, band * w[:, None] * w_j, 0.0)
    pad = width - w_up
    if pad:
        band = jnp.pad(band, ((0, 0), (0, pad)))
    return band


@partial(jax.jit, static_argnames=("width",))
def band_weighted_finalize_u8(counts, exc_idx, exc_val, weights, width):
    """uint8 + exceptions variant of :func:`band_weighted_finalize`: the
    host ships a 1-byte RAW-count band plus a short (flat index, value)
    exception list for counts > 255 (padded to a power-of-two capacity
    with out-of-range indices, which the scatter drops).  Exception
    values are f32-exact (native tier caps them at 2^24), so the result
    is bit-identical to the uint16 path's."""
    n_pad, w_up = counts.shape
    flat = counts.astype(jnp.float32).reshape(-1)
    flat = flat.at[exc_idx].set(exc_val.astype(jnp.float32), mode="drop")
    band = flat.reshape(n_pad, w_up)
    w = weights.astype(jnp.float32)
    w_pad = jnp.concatenate([w, jnp.zeros((w_up,), jnp.float32)])
    w_j = sliding_vector(w_pad, n_pad, w_up)
    band = jnp.where(band > 0, band * w[:, None] * w_j, 0.0)
    pad = width - w_up
    if pad:
        band = jnp.pad(band, ((0, 0), (0, pad)))
    return band


def _unpack_u4(head, tail_packed, exc_idx, exc_val, w_up):
    """Expand the split u8-head / nibble-packed-tail count upload into
    the (n_pad, w_up) f32 count band: even tail columns live in the low
    nibble, odd in the high (matching the native packer), exceptions
    (head > 255 / tail > 15) scatter over the unpacked flat layout."""
    n_pad, d0 = head.shape
    lo = (tail_packed & np.uint8(0xF)).astype(jnp.float32)
    hi = (tail_packed >> 4).astype(jnp.float32)
    tail = jnp.stack([lo, hi], axis=-1).reshape(n_pad, -1)[:, : w_up - d0]
    band = jnp.concatenate([head.astype(jnp.float32), tail], axis=1)
    flat = band.reshape(-1)
    flat = flat.at[exc_idx].set(exc_val.astype(jnp.float32), mode="drop")
    return flat.reshape(n_pad, w_up)


@partial(jax.jit, static_argnames=("width", "w_up"))
def band_weighted_finalize_u4(
    head, tail_packed, exc_idx, exc_val, weights, width, w_up
):
    """uint4-split variant of :func:`band_weighted_finalize_u8`: the
    host ships a u8 head (near-diagonal columns) plus a nibble-packed
    tail and the same padded exception list; values are f32-exact, so
    the result is bit-identical to the u8 and u16 paths'."""
    band = _unpack_u4(head, tail_packed, exc_idx, exc_val, w_up)
    n_pad = band.shape[0]
    w = weights.astype(jnp.float32)
    w_pad = jnp.concatenate([w, jnp.zeros((w_up,), jnp.float32)])
    w_j = sliding_vector(w_pad, n_pad, w_up)
    band = jnp.where(band > 0, band * w[:, None] * w_j, 0.0)
    pad = width - w_up
    if pad:
        band = jnp.pad(band, ((0, 0), (0, pad)))
    return band


@partial(jax.jit, static_argnames=("width", "w_up"))
def band_counts_finalize_u4(head, tail_packed, exc_idx, exc_val, width, w_up):
    """Raw (unbalanced) variant of :func:`band_weighted_finalize_u4`."""
    band = _unpack_u4(head, tail_packed, exc_idx, exc_val, w_up)
    pad = width - w_up
    if pad:
        band = jnp.pad(band, ((0, 0), (0, pad)))
    return band


@partial(jax.jit, static_argnames=("width",))
def band_counts_finalize_u8(counts, exc_idx, exc_val, width):
    """Raw (unbalanced) variant of :func:`band_weighted_finalize_u8`:
    scatter the exceptions over the cast uint8 band and pad to the
    compute-width bucket — no weights product."""
    n_pad, w_up = counts.shape
    flat = counts.astype(jnp.float32).reshape(-1)
    flat = flat.at[exc_idx].set(exc_val.astype(jnp.float32), mode="drop")
    band = flat.reshape(n_pad, w_up)
    pad = width - w_up
    if pad:
        band = jnp.pad(band, ((0, 0), (0, pad)))
    return band


@partial(jax.jit, static_argnames=())
def band_diag_stats(band, detect):
    """Per-diagonal sums/counts of positive, detectable pixels.

    The distance law in band space is just masked column statistics.
    """
    return _diag_stats_impl(band, detect)


@partial(jax.jit, static_argnames=("max_val", "zero_nan"))
def band_preprocess(band, detect, max_val, keep_dist, n_diags, zero_nan):
    """Fully-fused on-device intra preprocessing (smooth=False path):
    distance law (per-diagonal mean of positive detectable pixels) ->
    detrend -> band trim -> optional NaN zeroing, in one dispatch.

    Avoids the law's host round trip so the host can queue the whole
    per-chromosome pipeline without blocking on the device.
    ``keep_dist`` / ``n_diags`` are traced scalars and the band arrives
    row-padded to its shape bucket (padding rows masked out by ``detect``),
    so the whole genome compiles one program per shape bucket, not one per
    chromosome length.
    """
    dt = band.dtype
    n, width = band.shape
    sums, counts = _diag_stats_impl(band, detect)
    law = jnp.where(counts > 0, sums / counts, jnp.zeros((), dt))
    d_idx = jnp.arange(width)
    law = jnp.where(d_idx < n_diags, law, jnp.zeros((), dt))
    out = jnp.where(band != 0, band / law[None, :], jnp.zeros((), dt))
    if max_val is not None:
        out = jnp.where(out >= max_val, jnp.ones((), dt), out)
    out = jnp.where((d_idx <= keep_dist)[None, :], out, jnp.zeros((), dt))
    if zero_nan:
        out = jnp.where(jnp.isnan(out), jnp.zeros((), dt), out)
    return out


def _diag_stats_impl(band, detect):
    n, width = band.shape
    i = _iota2((n, width), 0)
    d = _iota2((n, width), 1)
    j = i + d
    det_pad = jnp.concatenate([detect, jnp.zeros((width,), detect.dtype)])
    det_j = sliding_vector(det_pad, n, width)
    w = (j < n) & (band > 0) & detect[:, None] & det_j
    sums = jnp.sum(jnp.where(w, band, 0), axis=0)
    counts = jnp.sum(w.astype(band.dtype), axis=0)
    return sums, counts


@partial(jax.jit, static_argnames=("max_val", "keep_dist"))
def band_detrend_trim(band, law, max_val, keep_dist):
    """Detrend by the distance law and trim columns beyond keep_dist.

    Column d of the band IS diagonal d, so detrending is a broadcast
    division (reference semantics incl. the >=max_val -> 1 reset).
    """
    dt = band.dtype
    width = band.shape[1]
    law_cols = law[:width].astype(dt)
    out = jnp.where(band != 0, band / law_cols[None, :], jnp.zeros((), dt))
    if max_val is not None:
        out = jnp.where(out >= max_val, jnp.ones((), dt), out)
    d = _iota2(band.shape, 1)
    return jnp.where(d <= keep_dist, out, jnp.zeros((), dt))


# --------------------------------------------------------------------- #
# Sheared kernels and band convolution
# --------------------------------------------------------------------- #
def shear_kernel(kernel):
    """Map a (mk, nk) matrix-space kernel to its (mk, nk+mk-1) band-space
    sheared form: K_sh[u, v - u + mk - 1] = K[u, v]."""
    kernel = np.asarray(kernel)
    mk, nk = kernel.shape
    sheared = np.zeros((mk, nk + mk - 1), dtype=kernel.dtype)
    for u in range(mk):
        sheared[u, mk - 1 - u : mk - 1 - u + nk] = kernel[u]
    return sheared


def _band_conv_valid(x, sheared):
    """Valid 2D conv of a padded band tensor with a sheared kernel.

    Delegates to ``ops.convolve.conv2d_valid`` (shifted multiply-adds).
    ``sheared`` may instead be a
    ``(lk, rk)`` factor pair (tSVD path) — see
    :func:`_band_conv_valid_sep`.
    """
    if isinstance(sheared, tuple):
        return _band_conv_valid_sep(x, *sheared)
    from chromosight_tpu.ops.convolve import conv2d_valid

    return conv2d_valid(x, sheared)


def _band_conv_valid_sep(x, lk, rk):
    """Valid band-space conv with a rank-factorised matrix-space kernel.

    The sheared form of a rank-1 kernel ``l (x) r`` has row ``u`` equal
    to ``l[u] * r`` shifted right by ``mk - 1 - u``, so the sheared
    valid conv decomposes as

        out[i, c] = sum_f sum_u lk[u, f] * R1_f[i + u, c + mk - 1 - u]
        R1_f      = valid 1D correlation of x's rows with rk[f]

    — ONE stacked banded-Toeplitz matmul computes every R1_f (rank
    Toeplitz blocks instead of the full sheared kernel's mk), then
    rank*mk shifted-slice FMAs accumulate at HBM bandwidth.  This is
    the band-engine realisation of the reference's factorised xcorr2
    (``/root/reference/chromosight/utils/detection.py:648-665``): the
    same rank-r math, so results match the reconstructed-kernel path to
    float-reassociation.

    Parameters: ``lk (mk, r)``, ``rk (r, nk)`` from
    ``preprocessing.factorise_kernel``.
    """
    from chromosight_tpu.ops.convolve import _row_toeplitz

    H, w_in = x.shape
    mk, r = lk.shape
    nk = rk.shape[1]
    dt = x.dtype
    w_mid = w_in - nk + 1
    T = jnp.concatenate(
        [_row_toeplitz(rk[f], w_in, dt) for f in range(r)], axis=1
    )
    R1 = jnp.dot(
        x, T, precision=lax.Precision.HIGHEST, preferred_element_type=dt
    )
    h_out = H - mk + 1
    w_out = w_mid - (mk - 1)
    out = None
    for f in range(r):
        R1f = lax.dynamic_slice_in_dim(R1, f * w_mid, w_mid, axis=1)
        for u in range(mk):
            term = (
                lax.dynamic_slice(R1f, (u, (mk - 1) - u), (h_out, w_out))
                * lk[u, f]
            )
            out = term if out is None else out + term
    return out


def _scale_sheared(sheared, scale):
    """Scale a sheared kernel (array) or factor pair (tuple) by a
    scalar — the factor pair folds the scale into rk."""
    if isinstance(sheared, tuple):
        lk, rk = sheared
        return (lk, rk * scale)
    return sheared * scale


def _band_window_sum(x, mk, nk):
    """Parallelogram window sum in band space: a 1D width-nk sum along d
    followed by an mk-tap anti-diagonal accumulation
    out[i, d] = sum_u r[i+u, d + (mk-1) - u].  Unrolled shifted-slice adds
    stream at HBM bandwidth (O(mk + nk) passes)."""
    w_mid = x.shape[1] - nk + 1
    r = None
    for v in range(nk):
        term = lax.dynamic_slice_in_dim(x, v, w_mid, axis=1)
        r = term if r is None else r + term
    h_out = x.shape[0] - mk + 1
    w_out = w_mid - mk + 1
    out = None
    for u in range(mk):
        term = lax.dynamic_slice(r, (u, (mk - 1) - u), (h_out, w_out))
        out = term if out is None else out + term
    return out


# --------------------------------------------------------------------- #
# Device-side sparse extraction: only candidate pixels and gathered scores
# ever leave the device, never the full correlation map.
# --------------------------------------------------------------------- #
@partial(jax.jit, static_argnames=("cap",))
def extract_candidates(corr, cand, cap):
    """Indices and values of up to ``cap`` candidate pixels, plus the true
    candidate count (to detect overflow)."""
    ii, dd = jnp.nonzero(cand, size=cap, fill_value=-1)
    vals = corr[
        jnp.clip(ii, 0, corr.shape[0] - 1),
        jnp.clip(dd, 0, corr.shape[1] - 1),
    ]
    vals = jnp.where(ii >= 0, vals, 0.0)
    return (
        ii.astype(jnp.int32),
        dd.astype(jnp.int32),
        vals,
        jnp.sum(cand),
    )


@partial(jax.jit, static_argnames=("cap",))
def extract_candidates_packed(corr, cand, cap):
    """Single-transfer candidate extraction: rows/diags/values/count packed
    into one (4, cap) float32 array (indices are exact in f32 up to 2^24
    rows - far beyond any chromosome).  One host fetch instead of four."""
    ii, dd, vals, count = extract_candidates(corr, cand, cap)
    return jnp.stack(
        [
            ii.astype(jnp.float32),
            dd.astype(jnp.float32),
            vals.astype(jnp.float32),
            jnp.full((cap,), count, jnp.float32),
        ]
    )


@partial(jax.jit, static_argnames=("cap", "row_k"))
def extract_candidates_topk_packed(corr, cand, cap, row_k=32):
    """Two-stage ``top_k`` candidate extraction in the packed format of
    :func:`extract_candidates_packed`.

    A per-row ``top_k(row_k)`` followed by a global ``top_k(cap)`` over
    the (n*row_k) survivors returns the same candidate set as
    ``jnp.nonzero``, whose cost does not shrink with ``cap``
    (tools/probe_extract.py times both and checks set parity).

    The payload row (index 3) carries the true candidate count, negated
    minus one when some row holds more than ``row_k`` candidates - in
    that case the per-row stage may have dropped candidates and the
    caller must fall back to the exact ``nonzero`` formulation.  Entry
    order is by descending score, not row-major; callers sort anyway.
    """
    s = jnp.where(cand, corr, -jnp.inf)
    row_over = jnp.max(jnp.sum(cand, axis=1)) > row_k
    rtop, ridx = jax.lax.top_k(s, row_k)  # (n, row_k)
    top, idx2 = jax.lax.top_k(rtop.reshape(-1), cap)
    valid = jnp.isfinite(top)
    rows = idx2 // row_k
    cols = ridx.reshape(-1)[idx2]
    count = jnp.sum(cand).astype(jnp.float32)
    payload = jnp.where(row_over, -(count + 1.0), count)
    return jnp.stack(
        [
            jnp.where(valid, rows, -1).astype(jnp.float32),
            jnp.where(valid, cols, 0).astype(jnp.float32),
            jnp.where(valid, top, 0.0),
            jnp.full((cap,), payload, jnp.float32),
        ]
    )


@jax.jit
def gather_band_values(arr, rows, diags):
    """Gather arr[rows, diags] with clipped indices (caller masks)."""
    return arr[
        jnp.clip(rows, 0, arr.shape[0] - 1),
        jnp.clip(diags, 0, arr.shape[1] - 1),
    ]


@jax.jit
def gather_scores_logp(corr, logp, rows, diags):
    """Paired gather of scores and log-p values in one device call."""
    r = jnp.clip(rows, 0, corr.shape[0] - 1)
    d = jnp.clip(diags, 0, corr.shape[1] - 1)
    return jnp.stack([corr[r, d], logp[r, d]])


@partial(jax.jit, static_argnames=("win_h", "win_w"))
def gather_tail_packed(corr, logp, band, p1, dsc, win_h, win_w):
    """Fused final-coordinate gather: scores, log-p values and raw
    pattern windows in ONE dispatch and ONE (n_pat, 2 + win_h*win_w)
    download (column 0 = score, 1 = logp, 2: = window row-major).

    Replaces the back-to-back :func:`gather_scores_logp` +
    :func:`gather_windows_dev` pair in the detect tail - same math,
    one fewer program dispatch and host roundtrip per chromosome.
    """
    r = jnp.clip(p1, 0, corr.shape[0] - 1)
    d = jnp.clip(dsc, 0, corr.shape[1] - 1)
    pair = jnp.stack([corr[r, d], logp[r, d]], axis=1)  # (n_pat, 2)
    wins = gather_windows_dev(band, p1, p1 + dsc, win_h, win_w)
    return jnp.concatenate(
        [pair, wins.reshape(p1.shape[0], win_h * win_w)], axis=1
    )


@partial(jax.jit, static_argnames=("win_h", "win_w"))
def gather_windows_dev(band, p1, p2, win_h, win_w):
    """Extract raw pattern windows around matrix coords on device.

    Returns (n_pat, win_h, win_w) values with zeros outside the band /
    matrix; NaN rules (missing bins, lower diagonals, frame padding) are
    applied on host by the validator.  Keeps the full band tensor on
    device - only the tiny window stack crosses the host link.
    """
    n, width = band.shape
    half_h, half_w = win_h // 2 + 1, win_w // 2 + 1
    a = jnp.arange(win_h)
    b = jnp.arange(win_w)
    r = p1[:, None] - half_h + 1 + a[None, :]
    c = p2[:, None] - half_w + 1 + b[None, :]
    rr = r[:, :, None]
    cc = c[:, None, :]
    d = cc - rr
    ok = (rr >= 0) & (rr < n) & (d >= 0) & (d < width)
    vals = band[
        jnp.clip(rr, 0, n - 1), jnp.clip(d, 0, width - 1)
    ]
    return jnp.where(ok, vals, jnp.zeros((), band.dtype))


# --------------------------------------------------------------------- #
# Fused band normxcorr2
# --------------------------------------------------------------------- #
def _pad_band(x, mk, nk):
    """Pad a band tensor for 'full'-mode convolution: (mk-1) rows top and
    bottom (the vertical frame) and R = kh + kw columns on each side,
    where R is the sheared kernel's diagonal reach
    (B[i + u - kh, d + (v - kw) - (u - kh)] spans d-offsets in [-R, R]).
    With this symmetric column pad the valid-conv output column c equals
    the band diagonal d directly, for square AND rectangular kernels
    (for mk == nk it reduces to the former (mk-1, nk-1) pad)."""
    r = (mk - 1) // 2 + (nk - 1) // 2
    return jnp.pad(x, ((mk - 1, mk - 1), (r, r)))


def _frame_mask_rules(pi, pd, n, max_dist, kernel_shape):
    """Missing-mask frame rules in padded band coordinates, shared by the
    single-device framing (``_band_frame``) and the shard_map slab engine
    (``parallel/shard_map_band.py``) so the two cannot drift.

    ``pi`` is the global matrix row of each cell, ``pd`` the matrix
    diagonal (column minus the sheared reach).  Reference semantics:
    ``frame_missing_mask`` (preprocessing.py:404-498) — top frame rows
    are missing at every reachable diagonal, the below-diagonal margin is
    drawn in framed coordinates (offset by nk - mk), and the right margin
    covers matrix columns >= n for the bottom ``max_dist + mk + 1`` rows.
    """
    mk, nk = kernel_shape
    big_k = max(mk, nk)
    top_frame = pi < 0
    below_diag = (pd >= mk - nk - big_k) & (pd <= mk - nk - 1)
    pj = pi + pd
    right_margin = (pj >= n) & (pi >= n - max_dist - 2)
    return top_frame | below_diag | right_margin


def _pearson_core(
    sig_p,
    mask_p,
    kernel,
    sheared,
    sheared_sq,
    kernel_shape,
    missing_tol,
    threshold,
):
    """Six convolutions + the missing-corrected Pearson algebra + log-p
    on a framed, padded slab.  Returns (out, logp) with conv-output rows
    (callers slice rows ``kh : kh + n_out``); shared by the global band
    engine and the shard_map slab engine."""
    mk, nk = kernel_shape
    dt = sig_p.dtype
    ksize = mk * nk
    ksize_f = jnp.asarray(ksize, dt)
    kernel = kernel.astype(dt)
    ksum = jnp.sum(kernel)
    k2sum = jnp.sum(kernel**2)

    def xc(x, sk):
        out = _band_conv_valid(x, sk)
        return _snap_small(out, threshold)

    def ws(x, scale):
        out = _band_window_sum(x, mk, nk) * scale
        return _snap_small(out, threshold)

    conv_sk = xc(sig_p, _scale_sheared(sheared, 1 / ksize_f))
    sig_mean0 = ws(sig_p, 1 / ksize_f)
    sig2_mean0 = ws(sig_p**2, 1 / ksize_f)
    n_miss = ws(mask_p, jnp.ones((), dt))
    conv_mk = xc(mask_p, sheared)
    conv_mk2 = xc(mask_p, sheared_sq)

    n_pres = ksize_f - n_miss
    kmean_eff = (ksum - conv_mk) / n_pres
    k2mean_eff = (k2sum - conv_mk2) / n_pres
    corr_f = ksize_f / n_pres
    sig_mean = sig_mean0 * corr_f
    sig2_mean = sig2_mean0 * corr_f
    denom = jnp.sqrt((sig2_mean - sig_mean**2) * (k2mean_eff - kmean_eff**2))
    min_pres = int((1 - missing_tol) * ksize)
    denom = jnp.where(n_pres < min_pres, jnp.zeros((), dt), denom)
    num = (conv_sk - sig_mean * kmean_eff / corr_f) * corr_f
    inv_denom = jnp.where(
        jnp.abs(denom) < 1e-10, jnp.zeros((), dt), 1.0 / denom
    )
    out = num * inv_denom

    out = jnp.where(jnp.isfinite(out), out, jnp.zeros((), dt))
    out = jnp.clip(out, -1.0, 1.0)

    # p-values with per-window observation counts, in log space: ndtr
    # underflows to 0 below ~1e-38 in f32, flooring highly significant
    # loops at p=0; log_ndtr keeps the full dynamic range.
    z = jnp.arctanh(out)
    logtail = jax.scipy.special.log_ndtr(-jnp.abs(z * jnp.sqrt(n_pres - 3)))
    logp = (logtail + jnp.log(jnp.asarray(2.0, dt))) / jnp.log(
        jnp.asarray(10.0, dt)
    )
    return out, logp


def _band_frame(band, missing, kernel_shape, n, max_dist):
    """Framed + padded signal band and missing mask shared by the single-
    and multi-kernel fused Pearson programs.

    Margin semantics follow frame_missing_mask (preprocessing.py:404-498)
    translated to band coordinates:
     * top margin rows (matrix row < 0): masked at every reachable
       diagonal (all of them lie below max_dist + nk);
     * below-diagonal margin: masked (framed-coordinate extent, see
       below);
     * right margin (col >= n) masked for rows >= n - max_dist - 2;
     * interior: (missing[i] | missing[j]) & (d <= max_dist).
    Returns (sig_p, mask_p), both padded via ``_pad_band``.
    """
    n_pad, width = band.shape
    mk, nk = kernel_shape
    big_k = max(mk, nk)
    dt = band.dtype

    i = _iota2((n_pad, width), 0)
    d = _iota2((n_pad, width), 1)
    j = i + d

    # Signal is zero outside the real matrix; band rows beyond n are
    # already zero.
    in_matrix = (j < n) & (i < n)
    sig = jnp.where(in_matrix, band, jnp.zeros((), dt))

    miss_i = missing
    miss_pad = jnp.concatenate([missing, jnp.zeros((width,), missing.dtype)])
    miss_j = sliding_vector(miss_pad, n_pad, width)
    mask = (miss_i[:, None] | miss_j) & (d <= max_dist) & in_matrix

    # ---------------- pad for convolution ---------------- #
    sig_p = _pad_band(sig, mk, nk)
    mask_p = _pad_band(mask, mk, nk).astype(dt)
    # Frame contributions in padded coordinates: padded row r corresponds
    # to matrix row i = r - (mk-1); padded col c -> diagonal
    # d = c - R with R the sheared reach (see _pad_band).  Top frame rows
    # (i < 0) and the below-diagonal margin (d in [-big_k, -1]) are
    # missing.
    kh = (mk - 1) // 2
    kw = (nk - 1) // 2
    reach = kh + kw
    pi = _iota2(sig_p.shape, 0) - (mk - 1)
    pd = _iota2(sig_p.shape, 1) - reach
    # Bottom frame rows (i >= n) are unmasked by themselves (margin_2
    # zeros, preprocessing.py:460-467): their signal is zero ("present
    # zeros"); only the right-margin rule reaches them.  The shared
    # rules helper covers the top frame, the framed-coordinate
    # below-diagonal margin (for mk > nk it overlaps the upper triangle,
    # where any nonzero signal makes the reference raise
    # check_missing_mask — the band caller mirrors that check host-side
    # before dispatch), and the right margin in padded coordinates so it
    # also reaches cells in the pad columns and the row pad.
    frame = _frame_mask_rules(pi, pd, n, max_dist, kernel_shape)
    mask_p = jnp.where(frame, jnp.asarray(1, dt), mask_p)
    return sig_p, mask_p


@partial(
    jax.jit,
    static_argnames=("kernel_shape", "missing_tol", "threshold"),
)
def band_normxcorr(
    band,
    missing,
    kernel,
    sheared,
    sheared_sq,
    kernel_shape,
    n,
    max_dist,
    missing_tol,
    pearson_min,
    threshold=DEFAULT_THRESHOLD,
):
    """Full-mode missing-corrected Pearson map in band coordinates.

    Parameters
    ----------
    band : (n_pad, W) float tensor - preprocessed upper band (detrended,
        trimmed), row-padded to n_pad >= n (padding rows are zero).
    missing : (n_pad,) bool - missing-bin flags (True = missing); padded
        rows must be False (they are masked analytically via ``n``).
    kernel : (mk, nk) kernel (matrix space).
    sheared, sheared_sq : sheared forms of kernel and kernel**2.
    kernel_shape : static ints; n, max_dist, pearson_min are traced
        scalars, so one compiled program serves every chromosome that
        shares a (n_pad, width) shape bucket.

    Returns (corr, log10_pvals, candidates) all shaped (n_pad, W):
    corr[i, d] is the Pearson coefficient at matrix pixel (i, i+d), already
    diag-trimmed to d <= max_dist with non-finite -> 0 and clamping applied.
    """
    n_pad, width = band.shape
    mk, nk = kernel_shape
    dt = band.dtype

    sig_p, mask_p = _band_frame(band, missing, kernel_shape, n, max_dist)
    kh = (mk - 1) // 2

    # Six convolutions + Pearson algebra + log-p (shared core).  Valid
    # conv output has (n_pad + mk - 1) rows and `width` columns; with
    # the symmetric reach pad, out_band[i, d] lives at conv row i + kh,
    # col d (matching B[i + u - kh, d + (v - kw) - (u - kh)] against the
    # padded-conv index B[r + u - (mk-1), c + v - u - R] gives
    # r = i + kh, c = d) — true for rectangular kernels too.
    out, logp = _pearson_core(
        sig_p,
        mask_p,
        kernel,
        sheared,
        sheared_sq,
        kernel_shape,
        missing_tol,
        threshold,
    )
    out = lax.dynamic_slice_in_dim(out, kh, n_pad, axis=0)
    logp = lax.dynamic_slice_in_dim(logp, kh, n_pad, axis=0)

    # diag-trim to max_dist and clip to the real matrix
    oi = _iota2(out.shape, 0)
    od = _iota2(out.shape, 1)
    keep = (od <= max_dist) & (oi < n) & ((oi + od) < n)
    out = jnp.where(keep, out, jnp.zeros((), dt))
    cand = (out >= pearson_min) & (out != 0)
    return out, logp, cand


@partial(
    jax.jit,
    static_argnames=("kernel_shape", "missing_tol", "threshold"),
)
def band_normxcorr_multi(
    band,
    missing,
    kernels,
    sheareds,
    sheareds_sq,
    kernel_shape,
    n,
    max_dist,
    missing_tol,
    pearson_min,
    threshold=DEFAULT_THRESHOLD,
):
    """``band_normxcorr`` for K same-shape kernels in one fused program.

    Multi-kernel configs (the borders preset ships three kernels,
    reference ``kernels/borders.json``; quantify scores every kernel at
    the same coordinates, reference ``cli/chromosight.py:407-439``)
    correlate the SAME preprocessed band with each kernel.  Fusing the K
    sweeps shares the framing prologue and the three signal window sums
    (kernel-independent) and reads the band once for all K conv
    passes — one dispatch instead of K.

    ``kernels`` is (K, mk, nk); ``sheareds``/``sheareds_sq`` are the
    (K, mk, nk + mk - 1) sheared stacks.  Returns (corr, log10_pvals,
    candidates), each (K, n_pad, W), slice k identical to the
    single-kernel program run on ``kernels[k]``.
    """
    from chromosight_tpu.ops.convolve import conv2d_valid_multik

    n_pad, width = band.shape
    mk, nk = kernel_shape
    dt = band.dtype
    ksize = mk * nk
    ksize_f = jnp.asarray(ksize, dt)
    kernels = kernels.astype(dt)
    n_k = kernels.shape[0]
    ksum = jnp.sum(kernels, axis=(1, 2))[:, None, None]
    k2sum = jnp.sum(kernels**2, axis=(1, 2))[:, None, None]

    sig_p, mask_p = _band_frame(band, missing, kernel_shape, n, max_dist)
    kh = (mk - 1) // 2

    # ---- 3 shared window sums + 3 batched per-kernel convolutions ---- #
    def ws(x, scale):
        out = _band_window_sum(x, mk, nk) * scale
        return _snap_small(out, threshold)

    sig_mean0 = ws(sig_p, 1 / ksize_f)
    sig2_mean0 = ws(sig_p**2, 1 / ksize_f)
    n_miss = ws(mask_p, jnp.ones((), dt))
    conv_sk = _snap_small(
        conv2d_valid_multik(sig_p, sheareds / ksize_f), threshold
    )
    conv_m = _snap_small(
        conv2d_valid_multik(
            mask_p, jnp.concatenate([sheareds, sheareds_sq]).astype(dt)
        ),
        threshold,
    )
    conv_mk, conv_mk2 = conv_m[:n_k], conv_m[n_k:]

    # ---- epilogue: shared stats broadcast against the K conv maps ---- #
    n_pres = ksize_f - n_miss
    kmean_eff = (ksum - conv_mk) / n_pres
    k2mean_eff = (k2sum - conv_mk2) / n_pres
    corr_f = ksize_f / n_pres
    sig_mean = sig_mean0 * corr_f
    sig2_mean = sig2_mean0 * corr_f
    denom = jnp.sqrt(
        (sig2_mean - sig_mean**2)[None] * (k2mean_eff - kmean_eff**2)
    )
    min_pres = int((1 - missing_tol) * ksize)
    denom = jnp.where(n_pres[None] < min_pres, jnp.zeros((), dt), denom)
    num = (conv_sk - sig_mean[None] * kmean_eff / corr_f[None]) * corr_f[None]
    inv_denom = jnp.where(
        jnp.abs(denom) < 1e-10, jnp.zeros((), dt), 1.0 / denom
    )
    out = num * inv_denom

    out = jnp.where(jnp.isfinite(out), out, jnp.zeros((), dt))
    out = jnp.clip(out, -1.0, 1.0)

    z = jnp.arctanh(out)
    logtail = jax.scipy.special.log_ndtr(
        -jnp.abs(z * jnp.sqrt(n_pres - 3)[None])
    )
    logp = (logtail + jnp.log(jnp.asarray(2.0, dt))) / jnp.log(
        jnp.asarray(10.0, dt)
    )

    out = lax.dynamic_slice_in_dim(out, kh, n_pad, axis=1)
    logp = lax.dynamic_slice_in_dim(logp, kh, n_pad, axis=1)

    oi = _iota2((n_pad, width), 0)[None]
    od = _iota2((n_pad, width), 1)[None]
    keep = (od <= max_dist) & (oi < n) & ((oi + od) < n)
    out = jnp.where(keep, out, jnp.zeros((), dt))
    cand = (out >= pearson_min) & (out != 0)
    return out, logp, cand


@partial(
    jax.jit,
    static_argnames=("kernel_shape", "missing_tol", "threshold"),
)
def band_normxcorr_at(
    band,
    missing,
    rows,
    diags,
    kernels,
    sheareds,
    sheareds_sq,
    kernel_shape,
    n,
    max_dist,
    missing_tol,
    threshold=DEFAULT_THRESHOLD,
):
    """Missing-corrected Pearson + log10-p at T requested band pixels for
    K same-shape kernels, without sweeping the band.

    Quantify mode scores user-supplied coordinates only (reference
    ``cli/chromosight.py:295-496`` still sweeps the whole matrix to read
    back a handful of pixels); with ``max_dist`` set to the furthest
    requested pair the band can be an order of magnitude wider than the
    detect scan, so the full-width sweep is almost entirely wasted work.
    The Pearson value at band pixel (i, d) depends only on the
    (mk, nk+mk-1) parallelogram patch of the framed band at rows
    [i+kh, i+kh+mk) and columns [d, d+nk+mk-1) — each of the six
    convolutions of ``_pearson_core`` collapses to a dot product of that
    patch with a fixed stencil.  One gather + one (T, mk*(nk+mk-1)) @
    (stencils) matmul replaces the six full-width convolutions.

    ``rows``/``diags`` are (T,) int32 matrix rows / diagonals (padded
    entries may hold anything in-range; callers mask).  Returns
    (corr, logp), each (K, T): slice k matches
    ``band_normxcorr(kernels[k])``'s maps gathered at (rows, diags) up
    to matmul summation order (~1e-6 relative on f32 scores).
    """
    n_pad, width = band.shape
    mk, nk = kernel_shape
    wk = nk + mk - 1
    kh = (mk - 1) // 2
    dt = band.dtype
    ksize = mk * nk
    ksize_f = jnp.asarray(ksize, dt)
    kernels = kernels.astype(dt)
    n_k = kernels.shape[0]
    ksum = jnp.sum(kernels, axis=(1, 2))  # (K,)
    k2sum = jnp.sum(kernels**2, axis=(1, 2))

    sig_p, mask_p = _band_frame(band, missing, kernel_shape, n, max_dist)

    # corr[i, d] of the sweep engine is conv-output row i+kh, col d: the
    # patch of the padded arrays at rows [i+kh, i+kh+mk), cols [d, d+wk)
    # (see the index derivation in band_normxcorr).  Clip keeps the
    # gather in-bounds for out-of-band requests; callers mask those.
    r0 = jnp.clip(rows + kh, 0, sig_p.shape[0] - mk)
    c0 = jnp.clip(diags, 0, sig_p.shape[1] - wk)
    ri = r0[:, None, None] + jnp.arange(mk)[None, :, None]
    ci = c0[:, None, None] + jnp.arange(wk)[None, None, :]
    P = sig_p[ri, ci].reshape(-1, mk * wk)  # (T, mk*wk)
    M = mask_p[ri, ci].reshape(-1, mk * wk)

    # Stencils: the sheared kernels (conv) and the parallelogram support
    # (window sums; shear of ones((mk, nk)) — row u spans columns
    # [mk-1-u, mk-1-u+nk), the same support _band_window_sum accumulates)
    uu = jnp.arange(mk)[:, None]
    vv = jnp.arange(wk)[None, :]
    ones_sh = ((vv >= mk - 1 - uu) & (vv < mk - 1 - uu + nk)).astype(dt)
    ones_sh = ones_sh.reshape(-1)
    shf = sheareds.astype(dt).reshape(n_k, -1)
    shf2 = sheareds_sq.astype(dt).reshape(n_k, -1)

    def dot(a, b):
        return jnp.dot(
            a, b, precision=lax.Precision.HIGHEST,
            preferred_element_type=dt,
        )

    conv_sk = _snap_small(dot(P, (shf / ksize_f).T), threshold)  # (T, K)
    sig_mean0 = _snap_small(dot(P, ones_sh) / ksize_f, threshold)  # (T,)
    sig2_mean0 = _snap_small(dot(P * P, ones_sh) / ksize_f, threshold)
    n_miss = _snap_small(dot(M, ones_sh), threshold)
    conv_mk = _snap_small(dot(M, shf.T), threshold)  # (T, K)
    conv_mk2 = _snap_small(dot(M, shf2.T), threshold)

    # Identical algebra to _pearson_core, broadcast over (T, K)
    n_pres = (ksize_f - n_miss)[:, None]
    kmean_eff = (ksum[None, :] - conv_mk) / n_pres
    k2mean_eff = (k2sum[None, :] - conv_mk2) / n_pres
    corr_f = ksize_f / n_pres
    sig_mean = sig_mean0[:, None] * corr_f
    sig2_mean = sig2_mean0[:, None] * corr_f
    denom = jnp.sqrt(
        (sig2_mean - sig_mean**2) * (k2mean_eff - kmean_eff**2)
    )
    min_pres = int((1 - missing_tol) * ksize)
    denom = jnp.where(n_pres < min_pres, jnp.zeros((), dt), denom)
    num = (conv_sk - sig_mean * kmean_eff / corr_f) * corr_f
    inv_denom = jnp.where(
        jnp.abs(denom) < 1e-10, jnp.zeros((), dt), 1.0 / denom
    )
    out = num * inv_denom
    out = jnp.where(jnp.isfinite(out), out, jnp.zeros((), dt))
    out = jnp.clip(out, -1.0, 1.0)

    z = jnp.arctanh(out)
    logtail = jax.scipy.special.log_ndtr(
        -jnp.abs(z * jnp.sqrt(n_pres - 3))
    )
    logp = (logtail + jnp.log(jnp.asarray(2.0, dt))) / jnp.log(
        jnp.asarray(10.0, dt)
    )

    # The sweep engine zeroes corr outside the diag-trimmed matrix
    # region before the tail gathers it; logp stays untrimmed there too.
    keep = (diags <= max_dist) & (rows < n) & ((rows + diags) < n)
    out = jnp.where(keep[:, None], out, jnp.zeros((), dt))
    return out.T, logp.T


@partial(
    jax.jit,
    static_argnames=("kernel_shape", "missing_tol"),
)
def band_normxcorr_at_packed(
    band,
    missing,
    rows,
    diags,
    kernels,
    sheareds,
    sheareds_sq,
    kernel_shape,
    n,
    max_dist,
    missing_tol,
):
    """:func:`band_normxcorr_at` plus the kernel-independent raw-window
    gather, fused into ONE dispatch and one (T, 2K + mk*nk) download:
    columns [0, K) = per-kernel scores, [K, 2K) = per-kernel log10-p,
    [2K, 2K + mk*nk) = the row-major raw window around each coordinate.

    Quantify's tail previously paid two program dispatches and two host
    roundtrips per map (the at-program, then ``gather_windows_dev``);
    the windows ride the same dispatch here.
    """
    mk, nk = kernel_shape
    corr, logp = band_normxcorr_at(
        band,
        missing,
        rows,
        diags,
        kernels,
        sheareds,
        sheareds_sq,
        kernel_shape,
        n,
        max_dist,
        missing_tol,
    )
    wins = gather_windows_dev(band, rows, rows + diags, mk, nk)
    return jnp.concatenate(
        [corr.T, logp.T, wins.reshape(rows.shape[0], mk * nk)], axis=1
    )
