"""Device-side preprocessing: distance law, detrending, diagonal trimming.

These are the XLA equivalents of the reference's sparse preprocessing
(``utils/preprocessing.py``), operating on dense contact-map tensors that
live in HBM.  The distance law is computed with a shear gather (each row
rolled so diagonals become columns) followed by masked column reductions -
O(n * n_diags) contiguous work that vectorises on the device, replacing the
reference's per-diagonal Python loop (``preprocessing.py:178-188``).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax


def _iota2(shape, dim, dtype=jnp.int32):
    return lax.broadcasted_iota(dtype, shape, dim)


@partial(jax.jit, static_argnames=("n_diags",))
def diag_sums_counts(mat, detect, n_diags):
    """Per-diagonal sums and counts of positive, detectable pixels.

    Parameters
    ----------
    mat : (n, n) dense tensor (symmetric or upper triangle - only upper
        diagonals 0..n_diags-1 are read).
    detect : (n,) bool - detectable-bin flags.
    n_diags : static int.

    Returns (sums, counts) of shape (n_diags,).
    """
    from chromosight_tpu.ops.band import sliding_vector

    n = mat.shape[0]
    i = _iota2((n, n_diags), 0)
    d = _iota2((n, n_diags), 1)
    j = i + d
    valid = j < n
    jc = jnp.minimum(j, n - 1)
    # Shear gather: vals[i, d] = mat[i, i + d]
    vals = jnp.take_along_axis(mat, jc, axis=1)
    det_pad = jnp.concatenate([detect, jnp.zeros((n_diags,), detect.dtype)])
    det_j = sliding_vector(det_pad, n, n_diags)
    w = valid & (vals > 0) & detect[:, None] & det_j
    wf = w.astype(mat.dtype)
    sums = jnp.sum(jnp.where(w, vals, 0), axis=0)
    counts = jnp.sum(wf, axis=0)
    return sums, counts


def distance_law_dense(mat, detect, n_diags, smooth=False):
    """Distance law on a dense intra matrix; optional isotonic smoothing.

    Returns a host numpy array of length n (entries beyond n_diags are 0),
    matching the reference ``distance_law`` semantics
    (``preprocessing.py:129-197``).
    """
    import numpy as np

    n = mat.shape[0]
    n_diags = int(min(n, n_diags))
    sums, counts = diag_sums_counts(mat, detect, n_diags)
    sums = np.asarray(sums, dtype=np.float64)
    counts = np.asarray(counts, dtype=np.float64)
    law = np.zeros(n)
    with np.errstate(invalid="ignore", divide="ignore"):
        law[:n_diags] = sums / counts
    if smooth and n > 2:
        from chromosight_tpu.preprocessing import pava_decreasing

        law[~np.isfinite(law)] = 0
        law = pava_decreasing(law)
    return law


@partial(jax.jit, static_argnames=("max_val",))
def detrend_dense(mat, law, max_val):
    """Divide each nonzero pixel by the distance law at |i-j|; values
    >= max_val reset to 1 (reference ``preprocessing.py:256-310``).

    NaN pixels (missing bins in balanced maps) stay NaN, mirroring the
    reference where only explicit sparse entries are touched.
    """
    n = mat.shape[0]
    dt = mat.dtype
    i = _iota2((n, n), 0)
    j = _iota2((n, n), 1)
    d = jnp.abs(j - i)
    law_d = jnp.take(law.astype(dt), d)
    out = jnp.where(mat != 0, mat / law_d, jnp.zeros((), dt))
    if max_val is not None:
        out = jnp.where(out >= max_val, jnp.ones((), dt), out)
    return out


@partial(jax.jit, static_argnames=("max_val", "keep_dist"))
def detrend_trim_dense(mat, law, max_val, keep_dist):
    """Fused detrend + upper-band trim on a dense intra matrix.

    Divides each nonzero pixel by the distance law at |i-j| (reference
    ``preprocessing.py:256-310``), resets values >= max_val to 1, then
    keeps only upper diagonals 0..keep_dist (reference ``diag_trim`` csr
    semantics, ``preprocessing.py:112-117`` via ``contacts_map.py:618-627``).
    """
    n = mat.shape[0]
    dt = mat.dtype
    i = _iota2((n, n), 0)
    j = _iota2((n, n), 1)
    d = jnp.abs(j - i)
    law_d = jnp.take(law.astype(dt), d)
    out = jnp.where(mat != 0, mat / law_d, jnp.zeros((), dt))
    if max_val is not None:
        out = jnp.where(out >= max_val, jnp.ones((), dt), out)
    band = ((j - i) >= 0) & ((j - i) <= keep_dist)
    return jnp.where(band, out, jnp.zeros((), dt))


@jax.jit
def diag_trim_dense(mat, n_keep):
    """Keep upper diagonals 0..n_keep of a dense matrix (csr semantics)."""
    i = _iota2(mat.shape, 0)
    j = _iota2(mat.shape, 1)
    d = j - i
    return jnp.where((d >= 0) & (d <= n_keep), mat, jnp.zeros((), mat.dtype))


@jax.jit
def inter_median_scale(mat, structure):
    """Divide an inter matrix by the median of its stored entries.

    Dense equivalent of the reference ``preprocess_inter_matrix``
    (``contacts_map.py:598-601``): NaNs among stored entries are zeroed
    first, then all stored entries (including those zeros) enter the
    median.
    """
    dt = mat.dtype
    mat = jnp.where(jnp.isnan(mat), jnp.zeros((), dt), mat)
    flat = mat.ravel()
    order = jnp.argsort(
        jnp.where(structure.ravel(), flat, jnp.asarray(jnp.inf, dt))
    )
    svals = flat[order]
    n_struct = jnp.sum(structure)
    lo = (n_struct - 1) // 2
    hi = n_struct // 2
    med = (svals[lo] + svals[hi]) / 2
    return mat / med
