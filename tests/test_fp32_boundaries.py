"""Adversarial fp32-vs-fp64 decision-boundary tests.

The band engine computes the missing-corrected Pearson in float32; the
reference computes it in float64.  Scores agreeing to 5e-5 on golden
points does not by itself prove calls are stable at the three decision
boundaries where an f32 engine can flip a call vs the f64 reference
(reference ``utils/detection.py:1002-1092``):

1. the ``min_pres = int((1 - missing_tol) * ksize)`` window cutoff —
   an integer comparison on a conv-summed count;
2. the 1e-10 denominator guard — near-constant windows where the
   ``E[x^2] - E[x]^2`` cancellation is pure noise in f32;
3. the pearson threshold itself — scores engineered to straddle it.

Each test engineers windows AT the boundary and asserts call-set
stability against the float64 numpy oracle ``ops.oracle`` (the exact same
algebra as ``ops.band._pearson_core``).
"""

import numpy as np
import pytest

import chromosight_tpu.kernels as ck


MK = NK = 17
KSIZE = MK * NK
MISSING_TOL = 0.5
MIN_PRES = int((1 - MISSING_TOL) * KSIZE)  # 144
PEARSON = 0.3
N, WIDTH, MAX_DIST = 512, 128, 100


def _run_engine(band, missing, K):
    """Engine and float64 oracle (``ops.oracle.band_oracle``) correlation
    maps on the same framed inputs, with the oracle's n_pres."""
    import jax.numpy as jnp

    from chromosight_tpu.ops.band import band_normxcorr, shear_kernel
    from chromosight_tpu.ops.oracle import band_oracle

    band32 = jnp.asarray(band, jnp.float32)
    miss = jnp.asarray(missing)
    corr, _logp, cand = band_normxcorr(
        band32,
        miss,
        jnp.asarray(K, jnp.float32),
        jnp.asarray(shear_kernel(np.asarray(K)), jnp.float32),
        jnp.asarray(shear_kernel(np.asarray(K) ** 2), jnp.float32),
        (MK, NK),
        N,
        MAX_DIST,
        MISSING_TOL,
        PEARSON,
    )
    out64, _logp64, n_pres = band_oracle(
        band32, missing, K, N, MAX_DIST, MISSING_TOL
    )
    return np.asarray(corr, np.float64), out64, n_pres


def _base_band(rng):
    """Detrended-looking positive band with real per-window variance."""
    return 1.0 + 0.2 * rng.standard_normal((N, WIDTH))


def test_min_pres_cutoff_exact_at_boundary():
    """Windows with exactly min_pres present pixels are kept, one fewer
    dropped — in BOTH engines (the count rides an f32 conv sum, exact
    for integers <= 2^24, so the integer comparison must never flip).

    1 missing row + 8 missing cols  -> 17+136-8  = 145 miss, 144 = keep
    6 missing rows + 4 missing cols -> 102+68-24 = 146 miss, 143 = drop
    """
    rng = np.random.default_rng(7)
    band = _base_band(rng)
    missing = np.zeros(N, bool)

    # window A centered (100, 140): rows 92..108, cols 132..148
    missing[96] = True  # 1 missing row
    missing[np.arange(132, 140)] = True  # 8 missing cols
    # window B centered (300, 340): rows 292..308, cols 332..348
    rows_b = np.arange(293, 299)  # 6 rows
    cols_b = np.arange(333, 337)  # 4 cols
    missing[rows_b] = True
    missing[cols_b] = True

    # missing bins carry zero signal (real preprocessing erases them)
    band[missing, :] = 0.0
    mi = np.flatnonzero(missing)
    ii, dd = np.indices(band.shape)
    band[np.isin(ii + dd, mi)] = 0.0

    corr32, corr64, n_pres = _run_engine(band, missing, get_K())

    a = (100, 40)  # (row, diagonal) of center A
    b = (300, 40)
    assert n_pres[a] == MIN_PRES  # engineered exactly at the cutoff
    assert n_pres[b] == MIN_PRES - 1
    # keep/drop decisions: exact agreement, in the engineered direction
    assert corr64[a] != 0.0 and corr32[a] != 0.0
    assert corr64[b] == 0.0 and corr32[b] == 0.0
    # and the kept boundary window's score still meets the parity budget
    assert abs(corr32[a] - corr64[a]) < 5e-5


def get_K():
    return np.asarray(ck.loops["kernels"][0], np.float64)


def test_denominator_guard_constant_and_near_constant_windows():
    """Exactly-constant windows zero out in both engines; windows with
    genuinely tiny variance may legitimately flip in f32 — but every
    zero/nonzero disagreement must lie inside the provable f32
    ambiguity region (window variance below the f32 cancellation noise
    ~1e-5 for O(1) signals), never outside it."""
    rng = np.random.default_rng(13)
    band = _base_band(rng)
    missing = np.zeros(N, bool)

    # exactly-constant patch covering the window at (64, 40) and margin
    band[40:120, 10:90] = 1.0
    # near-constant with clearly-visible variance: one +0.1 pixel
    band[200, 40] += 0.1
    # ambiguous: variance ~(5e-4)^2/289 ~ 1e-9, below f32 cancellation
    band[340:420, 10:90] = 1.0
    band[380, 40] += 5e-4

    corr32, corr64, _ = _run_engine(band, missing, get_K())

    # constant window: zero in both (variance is exactly 0 in f32 AND f64)
    assert corr32[64, 40] == 0.0 and corr64[64, 40] == 0.0
    # visible-variance window: nonzero in both
    assert corr32[200, 40] != 0.0 and corr64[200, 40] != 0.0

    # call-set stability: every zero/nonzero disagreement across the
    # whole map sits in the f32 ambiguity region of the oracle's window
    # variance (cancellation noise), never at a confidently-nonzero
    # window
    from scipy.signal import correlate2d

    from chromosight_tpu.ops.band import _band_frame
    from chromosight_tpu.ops.oracle import shear64

    import jax.numpy as jnp

    sig_p, _ = _band_frame(
        jnp.asarray(band, jnp.float32),
        jnp.asarray(missing),
        (MK, NK),
        N,
        MAX_DIST,
    )
    sig_p = np.asarray(sig_p, np.float64)
    sh_1 = shear64(np.ones((MK, NK)))
    m1 = correlate2d(sig_p, sh_1, mode="valid") / KSIZE
    m2 = correlate2d(sig_p**2, sh_1, mode="valid") / KSIZE
    var64 = (m2 - m1**2)[(MK - 1) // 2 :][:N]
    flip = (corr32 == 0.0) != (corr64 == 0.0)
    assert var64[flip].size == 0 or var64[flip].max() < 1e-5


def test_pearson_threshold_straddle():
    """Windows engineered at pearson = 0.3 +/- 1e-2 (clear) and
    +/- 1e-6 (inside f32 noise): clear windows must classify
    identically in the f32 engine and the f64 oracle; ambiguous windows
    may flip but their scores must stay within the 5e-5 parity budget
    of the engineered value."""
    import jax.numpy as jnp

    rng = np.random.default_rng(29)
    K = get_K()
    kc = (K - K.mean()).ravel()
    kc /= np.linalg.norm(kc)
    q = rng.standard_normal(KSIZE)
    q -= q.mean()
    q -= (q @ kc) * kc
    q /= np.linalg.norm(q)

    band = np.full((N, WIDTH), 1.0)
    targets = {
        (60, 40): PEARSON + 1e-2,
        (140, 40): PEARSON - 1e-2,
        (220, 40): PEARSON + 1e-6,
        (300, 40): PEARSON - 1e-6,
    }
    for (r, d), rho in targets.items():
        w = rho * kc + np.sqrt(1 - rho**2) * q
        # unit amplitude: window variance 1/ksize, the contrast scale of
        # real detrended windows — at much lower contrast the f32
        # mean-square cancellation noise (~eps/variance relative) alone
        # pushes scores past the 5e-5 parity budget
        patch = (1.0 + w).reshape(MK, NK)
        # window at band (r, d) covers matrix rows r-8..r+8, cols
        # (r+d)-8..(r+d)+8 -> band[i, dd] with dd = col - i
        for u in range(MK):
            i = r - 8 + u
            for v in range(NK):
                dd = d + 8 - u + v - 8  # (r+d-8+v) - i
                band[i, dd] = patch[u, v]

    corr32, corr64, _ = _run_engine(band, np.zeros(N, bool), K)

    for (r, d), rho in targets.items():
        got32, got64 = corr32[r, d], corr64[r, d]
        # the oracle runs the f64 algebra on the same f32-quantized
        # inputs the engine sees (isolating algebra precision), so it
        # hits the engineered score to input-quantization accuracy
        assert abs(got64 - rho) < 1e-6
        # engine within the parity budget of the engineered score
        assert abs(got32 - rho) < 5e-5
        if abs(rho - PEARSON) > 1e-3:
            # clear windows: same side of the threshold, both engines
            assert (got32 >= PEARSON) == (rho >= PEARSON)
            assert (got64 >= PEARSON) == (rho >= PEARSON)


def test_oracle_row_slices_match_the_full_oracle():
    """The oracle of a row slice (what chip_smoke.py runs at genome
    scale) equals those rows of the whole-band oracle, at both ends of
    the band where the frame rules apply."""
    from chromosight_tpu.ops.oracle import band_oracle

    rng = np.random.default_rng(3)
    band = _base_band(rng)
    missing = np.zeros(N, bool)
    missing[[7, 200, 505]] = True
    K = get_K()
    full = band_oracle(band, missing, K, N, MAX_DIST, MISSING_TOL)
    for lo, hi in [(0, 60), (230, 300), (N - 60, N)]:
        part = band_oracle(band, missing, K, N, MAX_DIST, MISSING_TOL, rows=(lo, hi))
        for a, b in zip(part, full):
            assert np.array_equal(a, b[lo:hi], equal_nan=True)
