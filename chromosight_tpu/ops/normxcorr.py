"""Fused normalized cross-correlation (sliding-window Pearson) on device.

This is the hot core of the framework.  The reference computes the Pearson
map through ~6 separate sparse convolutions plus sparse elementwise fixups
(reference ``utils/detection.py:917-1131`` for the sparse engine and
``1134-1273`` for the dense engine).  Here the whole computation - framing,
the three true convolutions (signal*K, mask*K, mask*K^2), the three
separable window sums (signal, signal^2, mask), the missing-corrected
Pearson algebra, clamping and p-values - is traced into a single XLA
program, so the signal tensor is streamed from HBM once and everything
else stays fused.

Numerical parity notes (all replicated from the reference):
* every convolution output below 1e-4 in magnitude snaps to 0
  (``detection.py:595`` default threshold propagated to all xcorr2 calls);
* denominators below 1e-10 give a 0 coefficient (``detection.py:1011,
  1088-1091``);
* windows with fewer than ``int((1 - missing_tol) * kernel_size)`` present
  pixels are zeroed (``detection.py:1069-1072``);
* coefficients are clamped to [-1, 1] and non-finite values become 0
  (``detection.py:1101-1106``);
* ``sym_upper`` keeps the upper triangle in *framed* coordinates
  (``detection.py:1098-1099``).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from chromosight_tpu.ops.convolve import (
    DEFAULT_THRESHOLD,
    conv2d_valid,
    conv2d_valid_separable,
    pad_margins,
    window_sum_valid,
    _snap_small,
)


def _iota2(shape, dim, dtype=jnp.int32):
    return lax.broadcasted_iota(dtype, shape, dim)


def make_missing_mask_dense(
    shape, missing_rows, missing_cols, max_dist=None, sym_upper=False
):
    """Dense boolean missing-pixel mask from per-bin missing flags.

    Equivalent to the reference ``preprocessing.make_missing_mask``
    (``preprocessing.py:535-633``): for upper-symmetric matrices each
    missing bin masks its row segment to the right and column segment
    upwards, up to ``max_dist`` diagonals; otherwise full crosses.

    Parameters
    ----------
    shape : (int, int) static
    missing_rows, missing_cols : bool arrays of length shape[0]/shape[1]
        True where the bin is NOT detectable.
    """
    sm, sn = shape
    i = _iota2(shape, 0)
    j = _iota2(shape, 1)
    if sym_upper:
        md = min(shape) if max_dist is None else max_dist
        d = j - i
        return (missing_rows[:, None] | missing_cols[None, :]) & (
            (d >= 0) & (d <= md)
        )
    return missing_rows[:, None] | missing_cols[None, :]


def frame_missing_mask_dense(mask, kernel_shape, sym_upper=False, max_dist=None):
    """Frame a dense missing mask with kernel-sized margins.

    Dense equivalent of the reference ``preprocessing.frame_missing_mask``
    (``preprocessing.py:404-498``), including its asymmetric margin rules
    for upper-symmetric banded matrices and the below-diagonal margin of
    ``max(kernel_shape)`` diagonals.
    """
    ms, ns = mask.shape
    mk, nk = kernel_shape
    big_k = max(nk, mk)
    banded = sym_upper and (max_dist is not None)

    inner = mask
    if banded:
        # diag_trim(mask, max_dist + big_k): keep upper diagonals only
        i = _iota2(mask.shape, 0)
        j = _iota2(mask.shape, 1)
        d = j - i
        inner = inner & (d >= 0) & (d <= max_dist + big_k)

    framed = jnp.pad(inner, ((mk - 1, mk - 1), (nk - 1, nk - 1)))
    fshape = framed.shape
    r = _iota2(fshape, 0)
    c = _iota2(fshape, 1)
    in_rows = (r >= mk - 1) & (r < mk - 1 + ms)
    in_cols = (c >= nk - 1) & (c < nk - 1 + ns)
    if banded:
        max_m = max_dist + mk
        max_n = max_dist + nk
        top = (r < mk - 1) & in_cols & (c - (nk - 1) < max_n)
        corner = (r < mk - 1) & (c < nk - 1)
        right = (c >= nk - 1 + ns) & (r >= (ms + 2 * (mk - 1)) - (max_m + 1))
        frame_true = top | corner | right
    else:
        frame_true = ~(in_rows & in_cols)
    framed = framed | frame_true
    if sym_upper:
        d = c - r
        framed = framed | ((d >= -big_k) & (d <= -1))
    return framed


def _xc(x, kernel, kernel_shape, threshold, tsvd_lr=None):
    """Framed-shape-preserving conv with reference thresholding."""
    if tsvd_lr is not None:
        out = conv2d_valid_separable(x, tsvd_lr[0], tsvd_lr[1])
    else:
        out = conv2d_valid(x, kernel)
    return pad_margins(_snap_small(out, threshold), kernel_shape)


def _ws(x, kernel_shape, scale, threshold):
    """Window sum scaled by `scale`, thresholded, padded back."""
    out = window_sum_valid(x, kernel_shape) * scale
    return pad_margins(_snap_small(out, threshold), kernel_shape)


@partial(
    jax.jit,
    static_argnames=(
        "kernel_shape",
        "full",
        "sym_upper",
        "with_mask",
        "missing_tol",
        "pval",
        "threshold",
        "with_tsvd",
        "force_window_nobs",
    ),
)
def _normxcorr_impl(
    signal,
    kernel,
    mask,
    tsvd_pack,
    kernel_shape,
    full,
    sym_upper,
    with_mask,
    missing_tol,
    pval,
    threshold,
    with_tsvd,
    force_window_nobs=False,
):
    mk, nk = kernel_shape
    dt = signal.dtype
    ksize = mk * nk
    ksize_f = jnp.asarray(ksize, dt)
    kernel = kernel.astype(dt)
    ksum = jnp.sum(kernel)
    k2sum = jnp.sum(kernel**2)
    kmean = jnp.mean(kernel)
    kstd = jnp.std(kernel)
    # The reference factorises each convolved kernel variant independently
    # when tsvd is enabled (detection.py:1016, 1037, 1043): the scaled
    # kernel K/ksize for the numerator, K and K^2 for the mask convolutions.
    if with_tsvd:
        tsvd_num, tsvd_k, tsvd_k2 = tsvd_pack
    else:
        tsvd_num = tsvd_k = tsvd_k2 = None

    if full:
        framed = jnp.pad(signal, ((mk - 1, mk - 1), (nk - 1, nk - 1)))
    else:
        framed = signal
    if with_mask:
        m = mask.astype(dt)

    if not with_mask:
        sig_mean = _ws(framed, kernel_shape, 1 / ksize_f, threshold)
        sig2_mean = _ws(framed**2, kernel_shape, 1 / ksize_f, threshold)
        denom = jnp.sqrt(sig2_mean - sig_mean**2) * kstd
        inv_denom = jnp.where(
            jnp.abs(denom) < 1e-10, jnp.zeros((), dt), 1.0 / denom
        )
        num = (
            _xc(framed, kernel / ksize_f, kernel_shape, threshold, tsvd_num)
            - sig_mean * kmean
        )
        out = num * inv_denom
        n_obs = jnp.full(framed.shape, ksize_f)
    else:
        n_miss = _ws(m, kernel_shape, jnp.ones((), dt), threshold)
        n_pres = ksize_f - n_miss
        conv_mk = _xc(m, kernel, kernel_shape, threshold, tsvd_k)
        conv_mk2 = _xc(m, kernel**2, kernel_shape, threshold, tsvd_k2)
        kmean_eff = (ksum - conv_mk) / n_pres
        k2mean_eff = (k2sum - conv_mk2) / n_pres
        corr_f = ksize_f / n_pres
        sig_mean = _ws(framed, kernel_shape, 1 / ksize_f, threshold) * corr_f
        sig2_mean = (
            _ws(framed**2, kernel_shape, 1 / ksize_f, threshold) * corr_f
        )
        denom = jnp.sqrt(
            (sig2_mean - sig_mean**2) * (k2mean_eff - kmean_eff**2)
        )
        # Require enough present data points inside the window
        min_pres = int((1 - missing_tol) * ksize)
        denom = jnp.where(n_pres < min_pres, jnp.zeros((), dt), denom)
        num = (
            _xc(framed, kernel / ksize_f, kernel_shape, threshold, tsvd_num)
            - sig_mean * kmean_eff / corr_f
        ) * corr_f
        inv_denom = jnp.where(
            jnp.abs(denom) < 1e-10, jnp.zeros((), dt), 1.0 / denom
        )
        out = num * inv_denom
        # Reference parity (detection.py:1120-1121): the sparse engine uses
        # per-window observation counts only in full mode; otherwise the
        # constant kernel size.  The tiled sparse path frames globally and
        # runs tiles with full=False, so it forces per-window counts here.
        if full or force_window_nobs:
            n_obs = n_pres
        else:
            n_obs = jnp.full(framed.shape, ksize_f)

    if sym_upper:
        r = _iota2(out.shape, 0)
        c = _iota2(out.shape, 1)
        out = jnp.where(c >= r, out, jnp.zeros((), dt))
    out = jnp.where(jnp.isfinite(out), out, jnp.zeros((), dt))
    out = jnp.clip(out, -1.0, 1.0)

    if pval:
        # log10 p via the log-tail: ndtr underflows to 0 below ~1e-38 in
        # f32, flooring highly significant loops at p=0; log_ndtr keeps
        # the full dynamic range (log10 2p = (log ndtr(-|z|sqrt(n-3)) +
        # ln 2) / ln 10).
        z = jnp.arctanh(out)
        logtail = jax.scipy.special.log_ndtr(
            -jnp.abs(z * jnp.sqrt(n_obs - 3))
        )
        pvals = (logtail + jnp.log(jnp.asarray(2.0, dt))) / jnp.log(
            jnp.asarray(10.0, dt)
        )
    else:
        pvals = None

    if full:
        out = out[mk - 1 : out.shape[0] - (mk - 1), nk - 1 : out.shape[1] - (nk - 1)]
        if pvals is not None:
            pvals = pvals[
                mk - 1 : pvals.shape[0] - (mk - 1),
                nk - 1 : pvals.shape[1] - (nk - 1),
            ]
    return out, pvals


def _ones_toeplitz(w_in, taps, dtype):
    """Banded (w_in, w_in - taps + 1) matrix of ones: multiplying by it
    performs a valid 1D sliding-window sum along the width as a matmul."""
    r = _iota2((w_in, w_in - taps + 1), 0)
    c = _iota2((w_in, w_in - taps + 1), 1)
    t = r - c
    return ((t >= 0) & (t < taps)).astype(dtype)


def normxcorr_crossing_valid(
    block,
    rvec,
    cvec,
    kernel,
    kernel_shape,
    missing_tol,
    pval,
    threshold,
):
    """Missing-corrected Pearson where the missing mask is exactly a
    crossing (rvec | cvec) — the inter-map detect case.

    Same algebra and parity rules as ``_normxcorr_impl`` (with_mask,
    full=False, per-window n_obs), but the three mask convolutions
    collapse analytically: with m = 1 - (1-r)(1-c),
        conv(m * K)[i, j]  = ksum  - sum_u (1-r[i+u]) * (K @ (1-c))[u, j]
        conv(m * K^2)      = k2sum - ... (same with K^2)
        window_count(m)    = ksize - (sum_u (1-r)) * (sum_v (1-c))
    i.e. rank-mk outer products instead of dense convolutions — on a
    2048-wide tile this removes half the dense reduction work, which
    dominates genome-scale --inter scans.  The remaining dense work is
    the three signal reductions: one fori pass over kernel rows with
    row-sum accumulators, then banded-Toeplitz column window sums as
    matmuls.

    Inputs are in *framed* coordinates (margins marked missing in
    rvec/cvec, zero signal outside the matrix).  Returns
    (corr, log10_pvals) in VALID shape (H - mk + 1, W - nk + 1) — the
    caller's tile slice [0:T, 0:T] of the valid output equals the
    padded output's [kh:kh+T, kw:kw+T].
    """
    mk, nk = kernel_shape
    dt = block.dtype
    H, W = block.shape
    h_out, w_out = H - mk + 1, W - nk + 1
    ksize = mk * nk
    ksize_f = jnp.asarray(ksize, dt)
    kernel = kernel.astype(dt)
    k2 = kernel * kernel
    ksum = jnp.sum(kernel)
    k2sum = jnp.sum(k2)
    kern_scaled = kernel / ksize_f

    def snap(x):
        return _snap_small(x, threshold)

    # ---- signal reductions ---- #
    # fori over kernel rows, 3 accumulators
    def body(u, accs):
        conv_acc, row_acc, row2_acc = accs
        srow = lax.dynamic_slice(block, (u, 0), (h_out, W))
        krow = lax.dynamic_slice(kern_scaled, (u, 0), (1, nk))
        t = None
        for v in range(nk):
            x = lax.slice(srow, (0, v), (h_out, v + w_out)) * krow[0, v]
            t = x if t is None else t + x
        return (conv_acc + t, row_acc + srow, row2_acc + srow * srow)

    z2 = jnp.zeros((h_out, w_out), dt)
    zr = jnp.zeros((h_out, W), dt)
    conv_sk, row_s, row_s2 = lax.fori_loop(0, mk, body, (z2, zr, zr))
    conv_sk = snap(conv_sk)
    tones = _ones_toeplitz(W, nk, dt)
    sig_mean0 = snap(
        jnp.dot(row_s, tones, precision=lax.Precision.HIGHEST) / ksize_f
    )
    sig2_mean0 = snap(
        jnp.dot(row_s2, tones, precision=lax.Precision.HIGHEST)
        / ksize_f
    )

    # ---- mask reductions: rank-collapsed crossing convolutions ---- #
    nr = 1.0 - rvec.astype(dt)  # present-row indicator
    nc = 1.0 - cvec.astype(dt)
    NR = jnp.stack(
        [lax.slice(nr, (u,), (u + h_out,)) for u in range(mk)]
    )  # (mk, h_out)
    NC = jnp.stack(
        [lax.slice(nc, (v,), (v + w_out,)) for v in range(nk)]
    )  # (nk, w_out)
    G = jnp.dot(kernel, NC, precision=lax.Precision.HIGHEST)
    H2 = jnp.dot(k2, NC, precision=lax.Precision.HIGHEST)
    conv_mk = snap(
        ksum - jnp.dot(NR.T, G, precision=lax.Precision.HIGHEST)
    )
    conv_mk2 = snap(
        k2sum - jnp.dot(NR.T, H2, precision=lax.Precision.HIGHEST)
    )
    n_miss = snap(
        ksize_f - jnp.outer(jnp.sum(NR, axis=0), jnp.sum(NC, axis=0))
    )

    # ---- Pearson algebra (identical to _normxcorr_impl) ---- #
    n_pres = ksize_f - n_miss
    kmean_eff = (ksum - conv_mk) / n_pres
    k2mean_eff = (k2sum - conv_mk2) / n_pres
    corr_f = ksize_f / n_pres
    sig_mean = sig_mean0 * corr_f
    sig2_mean = sig2_mean0 * corr_f
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
    if pval:
        z = jnp.arctanh(out)
        logtail = jax.scipy.special.log_ndtr(
            -jnp.abs(z * jnp.sqrt(n_pres - 3))
        )
        pvals = (logtail + jnp.log(jnp.asarray(2.0, dt))) / jnp.log(
            jnp.asarray(10.0, dt)
        )
    else:
        pvals = None
    return out, pvals


def build_tsvd_pack(kernel, tsvd, dtype):
    """Factorise the three convolved kernel variants for the tSVD path.

    The reference factorises each convolved kernel independently when tsvd
    is enabled (detection.py:1016, 1037, 1043): K/ksize for the numerator
    and K, K^2 for the mask convolutions.
    """
    from chromosight_tpu.preprocessing import factorise_kernel

    import numpy as _np

    knp = _np.asarray(kernel, dtype=_np.float64)
    ksize = knp.shape[0] * knp.shape[1]

    def _fact(mat):
        left, right = factorise_kernel(mat, prop_info=tsvd)
        return (jnp.asarray(left, dtype), jnp.asarray(right, dtype))

    return (_fact(knp / ksize), _fact(knp), _fact(knp**2))


def normxcorr2_dense(
    signal,
    kernel,
    max_dist=None,
    sym_upper=False,
    full=False,
    missing_mask=None,
    missing_tol=0.75,
    tsvd=None,
    pval=False,
    threshold=DEFAULT_THRESHOLD,
):
    """Missing-aware sliding-window Pearson correlation on dense tensors.

    Drop-in behavioural equivalent of the reference ``normxcorr2``
    (``detection.py:807-914``), with the missing mask given as a dense
    boolean matrix in *unframed* coordinates.  When ``full`` is True the
    mask is framed internally with ``frame_missing_mask_dense``.

    Returns (corr, log10_pvals_or_None), both shaped like ``signal``.
    """
    signal = jnp.asarray(signal)
    kernel_arr = jnp.asarray(kernel, signal.dtype)
    if kernel_arr.ndim != 2:
        raise ValueError("kernel must be 2D")
    if float(jnp.std(kernel_arr)) == 0.0:
        raise ValueError("Cannot have flat kernel.")
    mk, nk = kernel_arr.shape

    with_mask = missing_mask is not None
    framed_mask = None
    if with_mask:
        mask = jnp.asarray(missing_mask)
        if mask.dtype != jnp.bool_:
            raise ValueError(f"Missing mask dtype is {mask.dtype}. Should be bool.")
        if mask.shape != signal.shape:
            raise ValueError("Signal and missing mask do not have the same shape")
        if min(kernel_arr.shape) >= max(signal.shape):
            raise ValueError("cannot have kernel bigger than signal")
        if full:
            framed_mask = frame_missing_mask_dense(
                mask, (mk, nk), sym_upper=sym_upper, max_dist=max_dist
            )
        else:
            framed_mask = mask

    tsvd_pack = None
    with_tsvd = False
    if tsvd is not None:
        tsvd_pack = build_tsvd_pack(kernel, tsvd, signal.dtype)
        with_tsvd = True

    _dummy = (jnp.zeros((1, 1)), jnp.zeros((1, 1)))
    corr, pvals = _normxcorr_impl(
        signal,
        kernel_arr,
        framed_mask if with_mask else jnp.zeros((1, 1), bool),
        tsvd_pack if with_tsvd else (_dummy, _dummy, _dummy),
        (mk, nk),
        bool(full),
        bool(sym_upper),
        with_mask,
        float(missing_tol),
        bool(pval),
        threshold,
        with_tsvd,
    )
    return corr, pvals
