"""Detection-engine tests on synthetic data, mirroring the reference test
strategy (reference tests/test_detection.py): scipy oracles for the
convolution engine, planted-kernel recovery for every builtin pattern,
missing-mask Pearson vs direct pearsonr, and handcrafted foci labeling."""

import numpy as np
import pandas as pd
import pytest
import scipy.signal as sig
import scipy.sparse as sp
from scipy.stats import multivariate_normal, pearsonr

import chromosight_tpu.detection as cud
import chromosight_tpu.kernels as ck
import chromosight_tpu.preprocessing as cup


# ------------------------------------------------------------------ #
# Synthetic data
# ------------------------------------------------------------------ #
def gauss_blob(meanx, meany, std, shape=(100, 100)):
    """2D gaussian bump evaluated on a grid (synthetic pattern)."""
    rv = multivariate_normal(mean=(meanx, meany), cov=np.eye(2) * std)
    x = np.linspace(-10, 10, shape[0])
    y = np.linspace(-10, 10, shape[1])
    xx, yy = np.meshgrid(x, y)
    pos = np.dstack((xx, yy))
    return rv.pdf(pos)


def speckled_matrix(shape=(100, 100), seed=3, density=0.1):
    rng = np.random.RandomState(seed)
    mat = rng.rand(*shape) * (rng.rand(*shape) < density)
    return mat


class DummyMap:
    """Minimal stand-in for ContactMap (same trick as the reference's
    DummyMap, tests/test_detection.py:88-100)."""

    def __init__(self, matrix, max_dist=None, detectable_bins=None, inter=False):
        self.dense = np.asarray(matrix, dtype=np.float64)
        self.matrix = sp.csr_matrix(self.dense)
        self.inter = inter
        self.max_dist = max_dist
        self.name = "dummy"
        if detectable_bins is None:
            detectable_bins = (
                np.arange(self.dense.shape[0]),
                np.arange(self.dense.shape[1]),
            )
        self.detectable_bins = detectable_bins


# ------------------------------------------------------------------ #
# xcorr2 against scipy oracle
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("kshape", [(3, 3), (7, 7), (5, 9), (17, 17)])
def test_xcorr2_matches_scipy(kshape):
    rng = np.random.RandomState(0)
    S = rng.rand(80, 70)
    K = rng.rand(*kshape)
    got = np.asarray(cud.xcorr2(S, K))
    oracle = sig.correlate2d(S, K, mode="valid")
    oracle[np.abs(oracle) < 1e-4] = 0
    kh, kw = (kshape[0] - 1) // 2, (kshape[1] - 1) // 2
    padded = np.zeros_like(S)
    padded[kh : kh + oracle.shape[0], kw : kw + oracle.shape[1]] = oracle
    assert np.allclose(got, padded, atol=5e-5)


def test_xcorr2_sparse_dense_equivalence():
    rng = np.random.RandomState(1)
    S = rng.rand(60, 60) * (rng.rand(60, 60) < 0.2)
    K = rng.rand(7, 7)
    dense_out = np.asarray(cud.xcorr2(S, K))
    sparse_out = cud.xcorr2(sp.csr_matrix(S), K)
    assert sp.issparse(sparse_out)
    assert np.allclose(sparse_out.toarray(), dense_out, atol=1e-6)


def test_xcorr2_tsvd_matches_truncated_kernel():
    """The tSVD path must equal an exact convolution with the reconstructed
    low-rank kernel (the truncation error itself is by design)."""
    rng = np.random.RandomState(2)
    S = rng.rand(60, 60)
    K = ck.loops["kernels"][0]
    left, right = cup.factorise_kernel(K, prop_info=0.999)
    tsvd_out = np.asarray(cud.xcorr2(S, K, tsvd=0.999))
    oracle = sig.correlate2d(S, left @ right, mode="valid")
    oracle[np.abs(oracle) < 1e-4] = 0
    padded = np.zeros_like(S)
    padded[8:-8, 8:-8] = oracle
    assert np.allclose(tsvd_out, padded, atol=1e-3)
    # and stays close to the full convolution in relative terms
    full = np.asarray(cud.xcorr2(S, K))
    denom = np.maximum(np.abs(full), 1.0)
    assert np.max(np.abs(tsvd_out - full) / denom) < 0.05


# ------------------------------------------------------------------ #
# normxcorr2
# ------------------------------------------------------------------ #
def test_normxcorr2_bounded():
    S = speckled_matrix()
    K = ck.loops["kernels"][0]
    corr, _ = cud.normxcorr2(S, K)
    corr = np.asarray(corr)
    assert corr.min() >= -1
    assert corr.max() <= 1


def test_normxcorr2_sparse_dense_equivalence():
    S = speckled_matrix(seed=5)
    K = ck.loops_small["kernels"][0]
    dense_corr, dense_p = cud.normxcorr2(S, K, pval=True)
    sparse_corr, sparse_p = cud.normxcorr2(sp.csr_matrix(S), K, pval=True)
    assert np.allclose(
        sparse_corr.toarray(), np.asarray(dense_corr), atol=1e-5
    )


def test_normxcorr2_matches_pearsonr():
    rng = np.random.RandomState(7)
    S = rng.rand(40, 40)
    K = rng.rand(7, 7) + 1e-3
    corr, _ = cud.normxcorr2(S, K)
    corr = np.asarray(corr)
    for i, j in [(5, 9), (10, 30), (20, 20), (33, 8)]:
        win = S[i - 3 : i + 4, j - 3 : j + 4]
        expected = pearsonr(win.ravel(), K.ravel())[0]
        assert corr[i, j] == pytest.approx(expected, abs=1e-5)


def test_normxcorr2_missing_mask_matches_masked_pearsonr():
    """Missing-corrected coefficients equal direct pearsonr on the present
    pixels only (mirrors reference tests/test_detection.py:366-406)."""
    rng = np.random.RandomState(11)
    n = 36
    S = rng.rand(n, n)
    K = rng.rand(9, 9) + 1e-3
    miss = np.zeros(n, bool)
    miss[[4, 5, 17]] = True
    from chromosight_tpu.ops.normxcorr import make_missing_mask_dense

    mask = np.asarray(
        make_missing_mask_dense((n, n), miss, miss, sym_upper=False)
    )
    S = np.where(mask, 0.0, S)
    corr, _ = cud.normxcorr2(
        S, K, full=True, missing_mask=mask, missing_tol=0.9
    )
    corr = np.asarray(corr)
    for i, j in [(10, 10), (4, 20), (18, 6), (30, 30)]:
        # window fully inside the unframed matrix
        win = S[i - 4 : i + 5, j - 4 : j + 5].ravel()
        wm = mask[i - 4 : i + 5, j - 4 : j + 5].ravel()
        if win.size != 81:
            continue
        present = ~wm
        if present.sum() < int(0.1 * 81):
            expected = 0.0
        else:
            expected = pearsonr(win[present], K.ravel()[present])[0]
        assert corr[i, j] == pytest.approx(expected, abs=1e-4)


def test_normxcorr2_flat_kernel_raises():
    with pytest.raises(ValueError):
        cud.normxcorr2(np.random.rand(20, 20), np.ones((3, 3)))


# ------------------------------------------------------------------ #
# Planted-pattern recovery with every builtin kernel
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("name", ck.kernel_names)
def test_planted_kernel_recovered(name):
    """Planting a kernel into a noisy background must yield a correlation
    peak at the planted position (reference tests/test_detection.py:340-364)."""
    cfg = getattr(ck, name)
    K = cfg["kernels"][0]
    km, kn = K.shape
    n = max(4 * km, 100)
    rng = np.random.RandomState(42)
    S = rng.rand(n, n) * 0.05
    pi, pj = n // 2, n // 2 + km
    S[
        pi - km // 2 : pi + km // 2 + 1, pj - kn // 2 : pj + kn // 2 + 1
    ] += K
    corr, _ = cud.normxcorr2(S, K)
    corr = np.asarray(corr)
    peak = np.unravel_index(np.argmax(corr), corr.shape)
    assert abs(peak[0] - pi) <= 1 and abs(peak[1] - pj) <= 1
    assert corr[pi, pj] > 0.5


# ------------------------------------------------------------------ #
# Foci labeling
# ------------------------------------------------------------------ #
def test_label_foci_4way():
    """Handcrafted matrix with known 4-way connected components; 8-way
    touching pixels must split (reference tests/test_detection.py:204-238)."""
    M = np.array(
        [
            [1, 0, 0, 0],
            [1, 0, 1, 0],
            [1, 0, 1, 1],
            [0, 0, 0, 0],
        ]
    )
    num, lab = cud.label_foci(sp.coo_matrix(M))
    assert num == 2
    dense = lab.toarray()
    assert dense[0, 0] == dense[1, 0] == dense[2, 0] == 1
    assert dense[1, 2] == dense[2, 2] == dense[2, 3] == 2


def test_label_foci_diagonal_not_connected():
    M = np.eye(5)
    num, lab = cud.label_foci(sp.coo_matrix(M))
    assert num == 5


def test_filter_foci():
    M = np.array(
        [
            [1, 1, 0, 0],
            [0, 0, 0, 0],
            [0, 0, 2, 0],
            [0, 0, 0, 0],
        ]
    )
    num, filtered = cud.filter_foci(sp.coo_matrix(M), min_size=2)
    assert num == 1
    assert filtered.nnz == 2


def test_pick_foci_finds_maxima():
    conv = np.zeros((30, 30))
    conv[10, 10] = 0.8
    conv[10, 11] = 0.7
    conv[20, 20] = 0.9
    conv[20, 21] = 0.85
    conv[5, 5] = 0.95  # single-pixel focus, must be dropped (min_size=2)
    coords, foci = cud.pick_foci(conv, 0.5)
    assert coords.shape == (2, 2)
    assert [10, 10] in coords.tolist()
    assert [20, 20] in coords.tolist()
    assert [5, 5] not in coords.tolist()


def test_pick_foci_none_when_below_threshold():
    coords, foci = cud.pick_foci(np.zeros((20, 20)), 0.5)
    assert coords is None and foci is None


# ------------------------------------------------------------------ #
# Neighbour suppression and validation
# ------------------------------------------------------------------ #
def test_remove_neighbours_keeps_max_scores():
    import pandas as pd

    patterns = pd.DataFrame(
        {
            "bin1": [10, 12, 50, 52, 100],
            "bin2": [10, 12, 50, 52, 100],
            "score": [0.5, 0.9, 0.8, 0.2, 0.7],
        }
    )
    keep = cud.remove_neighbours(patterns, win_size=8)
    assert keep.tolist() == [False, True, True, False, True]


def test_validate_patterns_filters_zero_windows():
    n = 50
    mat = np.ones((n, n))
    mat[20:35, 20:35] = 0  # a hole of zeros
    conv = np.random.RandomState(0).rand(n, n)
    K = np.ones((7, 7))
    coords = np.array([[10, 10], [27, 27], [2, 2]])
    det = (np.arange(n), np.arange(n))
    filtered, wins = cud.validate_patterns(
        coords, mat, conv, det, K, zero_tol=0.3, missing_tol=0.75
    )
    kept = set(zip(filtered.bin1, filtered.bin2))
    assert (10, 10) in kept          # clean window
    assert (27, 27) not in kept      # all-zero window
    assert (2, 2) not in kept        # out of bounds
    assert wins.shape[1:] == (7, 7)


def test_pattern_detector_finds_planted_loops():
    """End-to-end pattern_detector on a DummyMap with planted loops."""
    K = ck.loops_small["kernels"][0]
    km = K.shape[0]
    n = 120
    rng = np.random.RandomState(0)
    S = rng.rand(n, n) * 0.1
    S = np.triu(S + S.T)
    for p in [(30, 60), (50, 90)]:
        S[
            p[0] - km // 2 : p[0] + km // 2 + 1,
            p[1] - km // 2 : p[1] + km // 2 + 1,
        ] += K
    cfg = dict(ck.loops_small)
    cfg["max_perc_undetected"] = 100.0
    cfg["max_perc_zero"] = 100.0
    cm = DummyMap(S, max_dist=100)
    patterns, windows = cud.pattern_detector(cm, cfg, K, full=True)
    found = set(zip(patterns.bin1, patterns.bin2))
    assert any(abs(b1 - 30) <= 1 and abs(b2 - 60) <= 1 for b1, b2 in found)
    assert any(abs(b1 - 50) <= 1 and abs(b2 - 90) <= 1 for b1, b2 in found)


def test_sliding_vector_skew():
    import jax.numpy as jnp

    from chromosight_tpu.ops.band import sliding_vector

    vec = np.arange(40, dtype=np.float32)
    out = np.asarray(sliding_vector(jnp.asarray(vec), 30, 10))
    i, d = np.indices((30, 10))
    assert np.array_equal(out, (i + d).astype(np.float32))


def test_xcorr2_rectangular_kernel():
    rng = np.random.RandomState(3)
    S = rng.rand(50, 64)
    K = rng.rand(3, 11)
    got = np.asarray(cud.xcorr2(S, K))
    oracle = sig.correlate2d(S, K, mode="valid")
    oracle[np.abs(oracle) < 1e-4] = 0
    padded = np.zeros_like(S)
    padded[1:-1, 5:-5] = oracle
    assert np.allclose(got, padded, atol=5e-5)


def test_normxcorr2_full_without_mask():
    """full=True without a missing mask pads margins but uses the plain
    Pearson branch (reference detection.py:1001-1018)."""
    rng = np.random.RandomState(5)
    S = rng.rand(30, 30)
    K = rng.rand(5, 5) + 1e-3
    corr, _ = cud.normxcorr2(S, K, full=True)
    corr = np.asarray(corr)
    assert corr.shape == S.shape
    # interior values match the non-full computation
    corr2, _ = cud.normxcorr2(S, K)
    corr2 = np.asarray(corr2)
    assert np.allclose(corr[5:-5, 5:-5], corr2[5:-5, 5:-5], atol=1e-5)


def test_pick_foci_tiebreak_row_major():
    conv = np.zeros((20, 20))
    # two pixels with identical max score in one focus: first row-major wins
    conv[5, 5] = 0.7
    conv[5, 6] = 0.7
    coords, _ = cud.pick_foci(conv, 0.5)
    assert coords.tolist() == [[5, 5]]


@pytest.mark.slow
def test_detect_deterministic(tmp_path):
    """Two identical detect runs must produce byte-identical outputs."""
    import pathlib
    import subprocess
    import sys

    import os

    cool = str(pathlib.Path(__file__).parents[1] / "data_test" / "example.cool")
    # determinism is a host/compiler property; pin the subprocesses to CPU
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    outs = []
    for name in ("a", "b"):
        prefix = str(tmp_path / name)
        r = subprocess.run(
            [sys.executable, "-m", "chromosight_tpu.cli.main", "detect",
             "--no-plotting", cool, prefix],
            capture_output=True, text=True, env=env,
        )
        assert r.returncode == 0, r.stderr[-1500:]
        outs.append(open(prefix + ".tsv", "rb").read())
    assert outs[0] == outs[1]


# ------------------------------------------------------------------ #
# Sparse window validation (genome-scale inter path)
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("drop", [True, False])
def test_validate_patterns_sparse_matches_dense(drop):
    """_validate_patterns_sparse (per-pattern sparse gathers, never
    densifies the matrix) must reproduce validate_patterns exactly."""
    rng = np.random.RandomState(21)
    n1, n2 = 140, 120
    mat = rng.rand(n1, n2) * (rng.rand(n1, n2) < 0.2)
    conv = rng.rand(n1, n2) * (rng.rand(n1, n2) < 0.1)
    K = rng.rand(9, 9)
    det = (
        np.flatnonzero(rng.rand(n1) > 0.1),
        np.flatnonzero(rng.rand(n2) > 0.1),
    )
    # candidates spread over the matrix incl. out-of-bound edges
    coords = np.stack(
        [rng.randint(0, n1, 40), rng.randint(0, n2, 40)], axis=1
    )
    want_c, want_w = cud.validate_patterns(
        coords, mat, conv, det, K, drop=drop, zero_tol=0.3, missing_tol=0.5
    )
    got_c, got_w = cud._validate_patterns_sparse(
        coords,
        sp.csr_matrix(mat),
        sp.csr_matrix(conv),
        det,
        K,
        drop=drop,
        zero_tol=0.3,
        missing_tol=0.5,
    )
    pd.testing.assert_frame_equal(
        want_c.reset_index(drop=True), got_c.reset_index(drop=True)
    )
    np.testing.assert_array_equal(np.isnan(want_w), np.isnan(got_w))
    ok = np.isfinite(want_w)
    np.testing.assert_allclose(want_w[ok], got_w[ok])


def test_validate_patterns_sparse_nan_band():
    """nan_band reproduces the dense caller's below-diagonal NaN masking
    for symmetric matrices (pattern_detector lines for intra maps)."""
    rng = np.random.RandomState(22)
    n = 100
    mat = rng.rand(n, n) * (rng.rand(n, n) < 0.3)
    conv = rng.rand(n, n) * (rng.rand(n, n) < 0.1)
    K = rng.rand(7, 7)
    big_k = 7
    det = (np.arange(n), np.arange(n))
    coords = np.stack(
        [rng.randint(10, n - 10, 25), rng.randint(10, n - 10, 25)], axis=1
    )
    mat_nan = np.array(mat, dtype=float)
    i, j = np.indices((n, n), sparse=True)
    band = ((i - j) >= 1) & ((i - j) <= big_k)
    mat_nan = np.where(band, np.nan, mat_nan)
    want_c, want_w = cud.validate_patterns(
        coords, mat_nan, conv, det, K, drop=True
    )
    got_c, got_w = cud._validate_patterns_sparse(
        coords, sp.csr_matrix(mat), sp.csr_matrix(conv), det, K,
        drop=True, nan_band=big_k,
    )
    pd.testing.assert_frame_equal(
        want_c.reset_index(drop=True), got_c.reset_index(drop=True)
    )
    np.testing.assert_array_equal(np.isnan(want_w), np.isnan(got_w))


class SparseDummyMap:
    """Sparse-resident stand-in for a genome-scale inter ContactMap."""

    def __init__(self, matrix, detectable_bins, inter=True):
        self.sparse = sp.csr_matrix(matrix)
        self.inter = inter
        self.max_dist = None
        self.name = "sparse-dummy"
        self.detectable_bins = detectable_bins
        self.shape = matrix.shape
        self.dense = None


def _inter_fixture(seed=33):
    rng = np.random.RandomState(seed)
    n1, n2 = 160, 140
    mat = rng.rand(n1, n2) * (rng.rand(n1, n2) < 0.15)
    miss_r = rng.rand(n1) < 0.05
    miss_c = rng.rand(n2) < 0.05
    mat[miss_r, :] = 0.0
    mat[:, miss_c] = 0.0
    det = (np.flatnonzero(~miss_r), np.flatnonzero(~miss_c))
    cfg = {
        "pearson": 0.3,
        "max_perc_undetected": 50.0,
        "max_perc_zero": 40.0,
        "max_dist": 100,
    }
    K = np.asarray(ck.loops["kernels"][0])[5:12, 5:12]
    return mat, det, cfg, K


def test_pattern_detector_sparse_inter_detect_matches_dense(monkeypatch):
    """The sparse inter detector (tiled engine + vector masks + sparse
    validation) must call the same patterns as the dense path."""
    monkeypatch.setenv("CHROMOSIGHT_TPU_TILE", "64")
    mat, det, cfg, K = _inter_fixture()
    want_c, want_w = cud.pattern_detector(
        DummyMap(mat, detectable_bins=det, inter=True), cfg, K, full=True
    )
    got_c, got_w = cud.pattern_detector(
        SparseDummyMap(mat, det), cfg, K, full=True
    )
    assert want_c is not None and got_c is not None
    key = ["bin1", "bin2"]
    w = want_c.sort_values(key).reset_index(drop=True)
    g = got_c.sort_values(key).reset_index(drop=True)
    assert (w[key].values == g[key].values).all()
    assert np.allclose(w.score, g.score, atol=2e-4)
    assert np.allclose(w.pvalue, g.pvalue, rtol=1e-3, atol=1e-8)


def test_pattern_detector_sparse_inter_quantify_matches_dense(monkeypatch):
    """Quantify mode (fixed coordinates, drop=False) through the sparse
    inter path: same scores/NaN validation outcomes as the dense path."""
    monkeypatch.setenv("CHROMOSIGHT_TPU_TILE", "64")
    mat, det, cfg, K = _inter_fixture(seed=34)
    rng = np.random.RandomState(35)
    coords = np.stack(
        [rng.randint(0, mat.shape[0], 30), rng.randint(0, mat.shape[1], 30)],
        axis=1,
    )
    want_c, want_w = cud.pattern_detector(
        DummyMap(mat, detectable_bins=det, inter=True),
        cfg,
        K,
        coords=coords,
        full=True,
    )
    got_c, got_w = cud.pattern_detector(
        SparseDummyMap(mat, det), cfg, K, coords=coords, full=True
    )
    assert len(want_c) == len(got_c) == 30
    assert np.array_equal(np.isnan(want_c.score), np.isnan(got_c.score))
    ok = ~np.isnan(want_c.score)
    assert np.allclose(want_c.score[ok], got_c.score[ok], atol=2e-4)
    assert np.array_equal(np.isnan(want_w), np.isnan(got_w))


def test_csr_point_values_segmented_matches_flat(monkeypatch):
    """The O(queries)-memory per-row-segment path (big matrices) must
    agree with the flat-key path, including absent pixels and
    out-of-range queries."""
    rng = np.random.RandomState(11)
    mat = sp.random(300, 250, density=0.05, random_state=rng, format="csr")
    qr = rng.randint(-5, 305, 2000)
    qc = rng.randint(-5, 255, 2000)
    flat = cud._csr_point_values(mat, qr, qc)
    monkeypatch.setattr(cud, "_POINT_QUERY_FLAT_NNZ", 0)
    seg = cud._csr_point_values(mat, qr, qc)
    assert np.array_equal(flat, seg)
    dense = mat.toarray()
    inb = (qr >= 0) & (qr < 300) & (qc >= 0) & (qc < 250)
    assert np.array_equal(seg[inb], dense[qr[inb], qc[inb]])
    assert (seg[~inb] == 0).all()
