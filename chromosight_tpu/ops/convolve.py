"""2D cross-correlation primitives on dense device tensors.

The reference implements `xcorr2` as a sum of banded sparse matmuls, one per
kernel row/column (reference ``utils/detection.py:595-804``).  Here they
are dense device cross-correlations (no kernel flip) computed as shifted
multiply-adds, with the reference's special cases mapped to cheaper
structures:

* constant (uniform) kernels -> separable window sums as shifted-slice
  adds (O(k) instead of O(k^2) work per pixel);
* tSVD-factorised kernels -> rank-k separable convolution expressed as two
  chained convs with channel contraction.

All functions reproduce the reference's numerical quirks needed for output
parity: conv outputs below ``threshold`` (1e-4 through the public `xcorr2`,
reference ``detection.py:595``) are snapped to zero, and "valid"-mode
outputs are zero-padded back to the input shape with (k-1)//2 margins
(reference ``detection.py:715-723``).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

DEFAULT_THRESHOLD = 1e-4

def _row_toeplitz(kernel_row, w_in, dtype):
    """Banded Toeplitz matrix T with T[w, c] = kernel_row[w - c] for
    0 <= w - c < len(kernel_row); shape (w_in, w_in - ktaps + 1).

    Multiplying a signal row (length w_in) by T performs its valid 1D
    correlation with ``kernel_row``.
    """
    ktaps = kernel_row.shape[0]
    w_out = w_in - ktaps + 1
    r = lax.broadcasted_iota(jnp.int32, (w_in, w_out), 0)
    c = lax.broadcasted_iota(jnp.int32, (w_in, w_out), 1)
    t = r - c
    inband = (t >= 0) & (t < ktaps)
    vals = jnp.take(
        kernel_row.astype(dtype), jnp.clip(t, 0, ktaps - 1)
    )
    return jnp.where(inband, vals, jnp.zeros((), dtype))


def conv2d_valid_multik(signal, kernels):
    """Valid-mode cross-correlation with K same-shape kernels at once, as
    shifted multiply-adds.

    ``kernels`` is (K, mk, nk); returns (K, H', W').  Multi-kernel configs
    (e.g. the borders preset's three kernels, reference
    ``kernels/borders.json``) correlate the same signal with every kernel;
    sharing one pass reads the signal once for all K.

    A ``fori_loop`` over kernel rows bounds live memory to the
    accumulator plus one fused row pass (a fully unrolled mk*nk chain
    leaves XLA free to materialise dozens of tile-sized temporaries —
    observed OOM at (8, 2048, 2048) under vmap); the nk taps within a
    row stay unrolled and fuse into a single elementwise pass.  The
    accumulator starts from row 0's term rather than zeros, so it
    carries the signal's sharding type inside ``shard_map``.

    Shift-FMA is the only formulation: it was the fastest measured at
    every shape the pipeline runs, against one banded-Toeplitz matmul per
    kernel row and against a chunked block-Toeplitz.  On one NVIDIA H100
    80GB HBM3 (power limit 700 W), ``band_normxcorr`` on the genome's chr1
    loops band (57344 x 512, sheared 17 x 33 kernel) took 9.15-9.49 ms
    against 43.06 ms Toeplitz and 20.60-31.67 ms chunked (C = 64-256); on
    a 128-column band 3.27 ms against 6.19 ms Toeplitz; a conv over 32
    tiles of 2064^2 9.52 ms against 21.66-37.46 ms chunked.  On an Intel
    Xeon CPU the loops sweep took 9.8-10.6 ms against 19.2-19.9 ms
    Toeplitz on the example band (512 x 256) and 230-286 ms against
    533-560 ms on 8192 rows of the genome band; the three-kernel borders
    sweep 9.3-9.9 ms against 33.9-34.8 ms (512 x 128) and 290-332 ms
    against 614-648 ms (16384 x 128).
    """
    k, mk, nk = kernels.shape
    h_out = signal.shape[0] - mk + 1
    w_out = signal.shape[1] - nk + 1
    kern = kernels.astype(signal.dtype)

    def row_term(u):
        row = lax.dynamic_slice(signal, (u, 0), (h_out, signal.shape[1]))
        krow = lax.dynamic_slice(kern, (0, u, 0), (k, 1, nk))
        term = None
        for v in range(nk):
            t = (
                lax.dynamic_slice_in_dim(row, v, w_out, axis=1)[None]
                * krow[:, :, v, None]
            )
            term = t if term is None else term + t
        return term

    return lax.fori_loop(1, mk, lambda u, acc: acc + row_term(u), row_term(0))


def conv2d_valid(signal, kernel):
    """Valid-mode 2D cross-correlation of a 2D signal with a 2D kernel
    (:func:`conv2d_valid_multik` with one kernel)."""
    return conv2d_valid_multik(signal, kernel[None])[0]


def window_sum_valid(signal, window_shape):
    """Valid-mode sliding-window sum (correlation with a kernel of ones).

    Separable O(mk + nk) shifted-slice accumulation: plain adds stream at
    memory bandwidth.
    """
    mk, nk = window_shape
    h_out = signal.shape[0] - mk + 1
    rows = None
    for u in range(mk):
        term = lax.dynamic_slice_in_dim(signal, u, h_out, axis=0)
        rows = term if rows is None else rows + term
    w_out = signal.shape[1] - nk + 1
    out = None
    for v in range(nk):
        term = lax.dynamic_slice_in_dim(rows, v, w_out, axis=1)
        out = term if out is None else out + term
    return out


def conv2d_valid_separable(signal, left, right):
    """Valid-mode correlation with a rank-r factorised kernel.

    ``left`` is (mk, r), ``right`` is (r, nk); the implied kernel is
    ``left @ right`` (reference tSVD path, ``detection.py:648-665``).
    Computed as r row-convolutions followed by a channel-contracting
    column-convolution: O(r*(mk+nk)) work per pixel instead of O(mk*nk).
    """
    mk, r = left.shape
    nk = right.shape[1]
    h_out = signal.shape[0] - mk + 1
    w_out = signal.shape[1] - nk + 1
    # Row pass: mid[f, i, j] = sum_u left[u, f] * signal[i+u, j], expressed
    # as a stack of row shifts contracted in one einsum.
    shifted = jnp.stack(
        [lax.dynamic_slice_in_dim(signal, u, h_out, axis=0) for u in range(mk)]
    )  # (mk, h_out, W)
    mid = jnp.einsum(
        "uf,uhw->fhw",
        left.astype(signal.dtype),
        shifted,
        precision=lax.Precision.HIGHEST,
        preferred_element_type=signal.dtype,
    )
    # Column pass with channel contraction:
    # out[i, j] = sum_f sum_v right[f, v] * mid[f, i, j+v]
    shifted2 = jnp.stack(
        [lax.dynamic_slice_in_dim(mid, v, w_out, axis=2) for v in range(nk)],
        axis=1,
    )  # (r, nk, h_out, w_out)
    out = jnp.einsum(
        "fv,fvhw->hw",
        right.astype(signal.dtype),
        shifted2,
        precision=lax.Precision.HIGHEST,
        preferred_element_type=signal.dtype,
    )
    return out


def _snap_small(x, threshold):
    if threshold is None:
        return x
    return jnp.where(jnp.abs(x) < threshold, jnp.zeros((), x.dtype), x)


def pad_margins(valid_out, kernel_shape):
    """Zero-pad a valid-mode output back to the original signal shape with
    (k-1)//2 margins on each side (reference ``detection.py:797-804``)."""
    mk, nk = kernel_shape
    kh, kw = (mk - 1) // 2, (nk - 1) // 2
    # valid output is (H-mk+1, W-nk+1); padding kh/kw on both sides restores
    # (H-1+1-mk+2kh, ...) = (H - (mk-1) + 2*(mk-1)//2) which equals H for odd
    # kernels and H-1 for even ones - identical to the reference behaviour.
    return jnp.pad(valid_out, ((kh, kh), (kw, kw)))


@partial(jax.jit, static_argnames=("kernel_shape", "threshold", "separable"))
def _xcorr2_impl(signal, kernel, kernel_shape, threshold, separable):
    if separable:
        left, right = kernel
        out = conv2d_valid_separable(signal, left, right)
    else:
        out = conv2d_valid(signal, kernel)
    out = _snap_small(out, threshold)
    return pad_margins(out, kernel_shape)


def xcorr2(signal, kernel, threshold=DEFAULT_THRESHOLD):
    """Dense cross-correlation with reference-parity thresholding/padding.

    Accepts either a 2D kernel array or a tuple (left, right) of factorised
    singular matrices (the tSVD path).  Output has the same shape as the
    signal, with zero margins where the kernel would overlap the edges.
    """
    signal = jnp.asarray(signal)
    if isinstance(kernel, tuple):
        left = jnp.asarray(kernel[0], signal.dtype)
        right = jnp.asarray(kernel[1], signal.dtype)
        if left.shape[1] != right.shape[0]:
            raise ValueError("Kernel factorisation is invalid")
        kshape = (left.shape[0], right.shape[1])
        return _xcorr2_impl(
            signal, (left, right), kshape, threshold, separable=True
        )
    kernel = jnp.asarray(kernel, signal.dtype)
    return _xcorr2_impl(
        signal, kernel, kernel.shape, threshold, separable=False
    )
