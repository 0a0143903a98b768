"""Plain references and checks shared by the tests and ``chip_smoke.py``.

The float64 numpy oracle of the band engine's Pearson sweep is the plain
reference that ``ops.band.band_normxcorr`` is checked against:
the six convolutions, missing-corrected Pearson algebra, guards and
log-p of ``ops.band._pearson_core``, computed with
``scipy.signal.correlate2d`` in float64.  Framing (0/1 mask assembly and
zero padding) is exact in any float width, so :func:`band_oracle` takes
the framed arrays from the engine (``ops.band._band_frame``): the
comparison isolates the float32 convolutions and algebra.
"""

from __future__ import annotations

import numpy as np


def shear64(kernel):
    """Float64 sheared (band-space) form of a matrix-space kernel."""
    from chromosight_tpu.ops.band import shear_kernel

    return np.asarray(shear_kernel(np.asarray(kernel, np.float64)))


def pearson64(sig_p, mask_p, kernel, missing_tol=0.5, threshold=1e-4):
    """(corr, n_pres, log10_p) on the valid-conv grid of a framed band.

    ``sig_p`` and ``mask_p`` are framed, padded float64 arrays as
    ``ops.band._band_frame`` returns them (or any row slice of them);
    the outputs have ``rows - mk + 1`` rows and the band's width."""
    from scipy.signal import correlate2d
    from scipy.special import log_ndtr

    K = np.asarray(kernel, np.float64)
    mk, nk = K.shape
    ksize = mk * nk
    sh_k, sh_k2, sh_1 = shear64(K), shear64(K**2), shear64(np.ones_like(K))
    ksum, k2sum = K.sum(), (K**2).sum()

    def snap(x):
        x = np.asarray(x)
        x[np.abs(x) < threshold] = 0.0
        return x

    conv_sk = snap(correlate2d(sig_p, sh_k / ksize, mode="valid"))
    sig_mean0 = snap(correlate2d(sig_p, sh_1, mode="valid") / ksize)
    sig2_mean0 = snap(correlate2d(sig_p**2, sh_1, mode="valid") / ksize)
    n_miss = snap(correlate2d(mask_p, sh_1, mode="valid"))
    conv_mk = snap(correlate2d(mask_p, sh_k, mode="valid"))
    conv_mk2 = snap(correlate2d(mask_p, sh_k2, mode="valid"))

    with np.errstate(divide="ignore", invalid="ignore"):
        n_pres = ksize - n_miss
        kmean_eff = (ksum - conv_mk) / n_pres
        k2mean_eff = (k2sum - conv_mk2) / n_pres
        corr_f = ksize / n_pres
        sig_mean = sig_mean0 * corr_f
        sig2_mean = sig2_mean0 * corr_f
        denom = np.sqrt(
            (sig2_mean - sig_mean**2) * (k2mean_eff - kmean_eff**2)
        )
        denom[n_pres < int((1 - missing_tol) * ksize)] = 0.0
        num = (conv_sk - sig_mean * kmean_eff / corr_f) * corr_f
        out = np.where(np.abs(denom) < 1e-10, 0.0, num / denom)
        out[~np.isfinite(out)] = 0.0
        np.clip(out, -1.0, 1.0, out=out)
        z = np.arctanh(out)
        logp = (log_ndtr(-np.abs(z * np.sqrt(n_pres - 3))) + np.log(2.0)) / (
            np.log(10.0)
        )
    return out, n_pres, logp


def band_oracle(
    band, missing, kernel, n, max_dist, missing_tol=0.5, rows=None
):
    """Oracle of ``band_normxcorr``'s (corr, log10_p) in band coordinates.

    ``rows = (lo, hi)`` restricts the oracle to output rows [lo, hi)
    (the convolutions then read only the framed rows they need); the
    result also carries ``n_pres``.  Returns (corr, logp, n_pres), each
    (hi - lo, width), with corr diag-trimmed as the engine's epilogue
    trims it."""
    import jax.numpy as jnp

    from chromosight_tpu.ops.band import _band_frame

    K = np.asarray(kernel, np.float64)
    mk, nk = K.shape
    kh = (mk - 1) // 2
    n_pad = band.shape[0]
    lo, hi = (0, n_pad) if rows is None else rows
    sig_p, mask_p = _band_frame(
        jnp.asarray(band, jnp.float32), jnp.asarray(missing), (mk, nk), n,
        max_dist,
    )
    # band row i is conv row i + kh, which reads framed rows
    # [i + kh, i + kh + mk)
    sl = slice(lo + kh, hi + kh + mk - 1)
    sig = np.asarray(sig_p[sl], np.float64)
    mask = np.asarray(mask_p[sl], np.float64)
    out, n_pres, logp = pearson64(sig, mask, K, missing_tol)
    i, d = np.indices(out.shape)
    i = i + lo
    keep = (d <= max_dist) & (i < n) & ((i + d) < n)
    out[~keep] = 0.0
    return out, logp, n_pres


def matmul_precisions(fn, *args, static_argnums=(), **kwargs):
    """The precision of every dot_general and conv_general_dilated in the
    jaxpr of ``fn(*args, **kwargs)``, nested jaxprs included."""
    import jax
    from jax import lax
    from jax.extend import core as jcore

    found = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name in ("dot_general", "conv_general_dilated"):
                p = eqn.params.get("precision")
                if isinstance(p, tuple):
                    p = p[0] if len(set(p)) == 1 else p
                found.append(p if p is not None else lax.Precision.DEFAULT)
            for v in eqn.params.values():
                for x in v if isinstance(v, (tuple, list)) else (v,):
                    if isinstance(x, jcore.ClosedJaxpr):
                        walk(x.jaxpr)
                    elif isinstance(x, jcore.Jaxpr):
                        walk(x)

    walk(jax.make_jaxpr(fn, static_argnums=static_argnums)(*args, **kwargs).jaxpr)
    return found


def genome_fingerprint(path):
    """Cheap identity of a synthetic genome: pixel count plus a checksum
    of a deterministic pixel sample (the generator is seeded, so this is
    stable across machines)."""
    from chromosight_tpu.io import hdf5

    with hdf5.File(path) as f:
        ct = f["pixels/count"]
        n = ct.shape[0]
        sample = ct[:: max(n // 4096, 1)][:4096]
    return {"nnz": int(n), "checksum": int(np.asarray(sample, np.int64).sum())}
