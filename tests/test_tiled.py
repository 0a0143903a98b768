"""Tiled sparse engine tests: tile-vs-dense parity across every mode
combination (the tiled path must reproduce the whole-matrix fused engine
pixel for pixel), sparse frame construction vs the device oracle, and a
genome-scale banded matrix scanned through the public API without
densification (reference sparse engines: detection.py:627-723, 917-1131)."""

import numpy as np
import pytest
# Full CLI / end-to-end runs: minutes on one core. `pytest -m "not slow"` is the fast tier.
pytestmark = pytest.mark.slow

import scipy.sparse as sp

import chromosight_tpu.detection as cud
import chromosight_tpu.preprocessing as cup
from chromosight_tpu.ops.tiled import (
    normxcorr2_sparse_tiled,
    xcorr2_sparse_tiled,
)


def _sparse_signal(shape=(210, 190), density=0.05, seed=0):
    rng = np.random.RandomState(seed)
    mat = rng.rand(*shape) * (rng.rand(*shape) < density)
    return sp.csr_matrix(mat)


def _mask_for(signal, seed=1):
    """Random missing rows/cols crossing mask consistent with the signal
    (missing positions must hold zero signal)."""
    rng = np.random.RandomState(seed)
    sm, sn = signal.shape
    miss_r = rng.rand(sm) < 0.05
    miss_c = rng.rand(sn) < 0.05
    mask = np.zeros(signal.shape, dtype=bool)
    mask[miss_r, :] = True
    mask[:, miss_c] = True
    sig = signal.toarray()
    sig[mask] = 0.0
    return sp.csr_matrix(sig), sp.csr_matrix(mask)


# ------------------------------------------------------------------ #
# xcorr2: tiled vs dense engine
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("kshape", [(7, 7), (5, 9), (9, 5)])
@pytest.mark.parametrize("tile", [64, 128])
def test_xcorr2_tiled_matches_dense(kshape, tile):
    signal = _sparse_signal()
    rng = np.random.RandomState(2)
    kernel = rng.rand(*kshape)
    want = np.asarray(cud.xcorr2(signal.toarray(), kernel))
    got = xcorr2_sparse_tiled(signal, kernel, tile=tile).toarray()
    assert np.allclose(got, want, atol=1e-4)


def test_xcorr2_tiled_factorised_kernel():
    signal = _sparse_signal(seed=5)
    rng = np.random.RandomState(3)
    kernel = np.outer(rng.rand(7), rng.rand(7))
    fact = cup.factorise_kernel(kernel, prop_info=0.999)
    want = np.asarray(cud.xcorr2(signal.toarray(), kernel))
    got = xcorr2_sparse_tiled(signal, fact, tile=96).toarray()
    assert np.allclose(got, want, atol=1e-3)


# ------------------------------------------------------------------ #
# normxcorr2: tiled vs dense engine, all mode combinations
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("sym_upper", [False, True])
def test_normxcorr2_tiled_matches_dense(full, with_mask, sym_upper):
    signal = _sparse_signal()
    if sym_upper:
        signal = sp.triu(signal.tocsr()[: 190, :190])
    rng = np.random.RandomState(4)
    kernel = rng.rand(7, 7)
    mask = None
    if with_mask:
        signal, mask = _mask_for(signal.tocsr())
        if sym_upper:
            mask = sp.triu(mask).tocsr()
    dense_mask = np.asarray(mask.todense()) if mask is not None else None
    want, want_p = cud.normxcorr2(
        np.asarray(signal.todense()),
        kernel,
        full=full,
        sym_upper=sym_upper,
        missing_mask=dense_mask,
        pval=True,
    )
    got, got_p = normxcorr2_sparse_tiled(
        signal.tocsr(),
        kernel,
        full=full,
        sym_upper=sym_upper,
        missing_mask=mask,
        pval=True,
        tile=64,
    )
    got = got.toarray()
    assert np.allclose(got, want, atol=2e-4)
    # p-values agree wherever a correlation coefficient exists; the dense
    # engine also reports (meaningless) p-values at corr==0 positions,
    # which the sparse container cannot represent (reference parity).
    nz = got != 0
    # full+mask is the one mode where n_obs semantics differ between the
    # whole-matrix engine (per-window counts everywhere) and the sparse
    # reference semantics the tiled path reproduces -- but per-window
    # counts are what both use there, so all modes must agree.
    assert np.allclose(got_p.toarray()[nz], np.asarray(want_p)[nz], atol=2e-3)


def test_normxcorr2_tiled_rect_kernel():
    signal = _sparse_signal(seed=7)
    rng = np.random.RandomState(8)
    kernel = rng.rand(3, 9)
    want, _ = cud.normxcorr2(np.asarray(signal.todense()), kernel)
    got, _ = normxcorr2_sparse_tiled(signal, kernel, tile=80)
    assert np.allclose(got.toarray(), want, atol=2e-4)


def test_normxcorr2_public_api_dispatches_sparse(monkeypatch):
    """Above the dense limit the public API must route sparse inputs
    through the tiled engine (and hence accept a sparse missing mask)."""
    monkeypatch.setenv("CHROMOSIGHT_TPU_DENSE_LIMIT", "100")
    monkeypatch.setenv("CHROMOSIGHT_TPU_TILE", "64")
    signal = _sparse_signal()
    signal, mask = _mask_for(signal)
    rng = np.random.RandomState(9)
    kernel = rng.rand(7, 7)
    got, _ = cud.normxcorr2(signal, kernel, missing_mask=mask, full=True)
    assert sp.issparse(got)
    want, _ = cud.normxcorr2(
        np.asarray(signal.todense()),
        kernel,
        missing_mask=np.asarray(mask.todense()),
        full=True,
    )
    assert np.allclose(got.toarray(), want, atol=2e-4)


# ------------------------------------------------------------------ #
# Sparse frame construction vs device oracle
# ------------------------------------------------------------------ #
@pytest.mark.parametrize(
    "sym_upper,max_dist", [(False, None), (True, None), (True, 40)]
)
def test_frame_missing_mask_sparse_matches_dense(sym_upper, max_dist):
    from chromosight_tpu.ops.normxcorr import frame_missing_mask_dense

    rng = np.random.RandomState(11)
    mask = rng.rand(90, 90) < 0.04
    if sym_upper:
        mask = np.triu(mask)
    got = cup.frame_missing_mask(
        sp.csr_matrix(mask), (9, 7), sym_upper=sym_upper, max_dist=max_dist
    )
    want = np.asarray(
        frame_missing_mask_dense(
            mask, (9, 7), sym_upper=sym_upper, max_dist=max_dist
        )
    )
    assert np.array_equal(got.toarray(), want)


# ------------------------------------------------------------------ #
# Genome-scale: 50k x 50k banded sparse matrix, never densified
# ------------------------------------------------------------------ #
def test_normxcorr2_sparse_genome_scale(monkeypatch):
    """A 50_000^2 sparse banded matrix (20 GB dense) runs through the
    public normxcorr2 in bounded memory: only diagonal tiles are scanned.
    Spot-check coefficients against directly-computed window Pearson."""
    # Small tiles minimise the scanned halo area on a banded matrix:
    # ~n/T diagonal tiles of (T+k-1)^2 pixels each.
    monkeypatch.setenv("CHROMOSIGHT_TPU_TILE", "1024")
    n, hw = 50_000, 50
    rng = np.random.RandomState(13)
    nnz = 400_000
    i = rng.randint(0, n, nnz)
    d = rng.randint(0, hw, nnz)
    keep = i + d < n
    i, d = i[keep], d[keep]
    signal = sp.coo_matrix(
        (rng.rand(len(i)), (i, i + d)), shape=(n, n)
    ).tocsr()
    kernel = np.outer(np.hanning(7), np.hanning(7)) + 0.1

    corr, _ = cud.normxcorr2(signal, kernel, sym_upper=True)
    assert sp.issparse(corr)
    assert corr.shape == (n, n)
    assert corr.nnz > 0
    # triu guarantee
    cc = corr.tocoo()
    assert np.all(cc.col >= cc.row)

    # Spot-check the strongest coefficients against a direct host Pearson
    # on the extracted 7x7 window.
    order = np.argsort(-np.abs(cc.data))[:20]
    for t in order:
        r, c, v = int(cc.row[t]), int(cc.col[t]), cc.data[t]
        if r < 3 or c < 3 or r >= n - 3 or c >= n - 3:
            continue
        win = signal[r - 3 : r + 4, c - 3 : c + 4].toarray()
        kf = kernel.ravel()
        wf = win.ravel()
        denom = wf.std() * kf.std()
        if denom < 1e-12:
            continue
        want = ((wf * kf).mean() - wf.mean() * kf.mean()) / denom
        assert abs(v - np.clip(want, -1, 1)) < 1e-3


def _allclose_with_snap_flips(got, want, snap=1e-4, atol=5e-6):
    """Equality up to fp reassociation: where both paths report a value
    they agree to atol; a pixel present in only one path must sit at the
    snap threshold (the 1e-4 convolution snap decided differently on a
    ~1e-7-different value)."""
    both = (got != 0) & (want != 0)
    if not np.allclose(got[both], want[both], atol=atol):
        return False
    only = (got != 0) ^ (want != 0)
    return np.all(np.abs(got[only] - want[only]) < 2 * snap + atol)


def test_normxcorr2_tiled_missing_vectors_matches_mask():
    """Crossing-mask vectors (rank-collapsed device math, nothing
    mask-shaped uploaded) must reproduce the explicit sparse-matrix mask
    path up to fp reassociation (the crossing engine computes the mask
    convolutions as exact outer products, so sums associate
    differently), including full-mode frame margins and p-values."""
    rng = np.random.RandomState(31)
    n1, n2 = 170, 150
    mat = rng.rand(n1, n2) * (rng.rand(n1, n2) < 0.08)
    miss_r = rng.rand(n1) < 0.06
    miss_c = rng.rand(n2) < 0.06
    mat[miss_r, :] = 0.0
    mat[:, miss_c] = 0.0
    signal = sp.csr_matrix(mat)
    mask = sp.csr_matrix(miss_r[:, None] | miss_c[None, :])
    kernel = rng.rand(7, 7)
    want, want_p = normxcorr2_sparse_tiled(
        signal, kernel, full=True, missing_mask=mask, pval=True, tile=64
    )
    got, got_p = normxcorr2_sparse_tiled(
        signal,
        kernel,
        full=True,
        missing_vectors=(miss_r, miss_c),
        pval=True,
        tile=64,
    )
    assert _allclose_with_snap_flips(got.toarray(), want.toarray())
    gp, wp = got_p.toarray(), want_p.toarray()
    both = (got.toarray() != 0) & (want.toarray() != 0)
    assert np.allclose(gp[both], wp[both], atol=5e-4)


def test_xcorr2_public_api_dispatches_sparse(monkeypatch):
    """Above the dense limit the public xcorr2 routes sparse inputs
    through the tiled engine and returns an equivalent sparse result."""
    monkeypatch.setenv("CHROMOSIGHT_TPU_DENSE_LIMIT", "100")
    monkeypatch.setenv("CHROMOSIGHT_TPU_TILE", "64")
    signal = _sparse_signal(seed=41)
    rng = np.random.RandomState(42)
    kernel = rng.rand(7, 7)
    got = cud.xcorr2(signal, kernel)
    assert sp.issparse(got)
    want = np.asarray(cud.xcorr2(signal.toarray(), kernel))
    assert np.allclose(got.toarray(), want, atol=1e-4)


# ------------------------------------------------------------------ #
# batched dispatch engine
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("mode", ["none", "coo", "vec"])
def test_normxcorr2_tiled_batched_matches_per_tile(mode, monkeypatch):
    """The batched fused program (B tiles per dispatch) must reproduce
    the per-tile path bit for bit, in every mask mode, including the
    partial final batch padded with empty tiles."""
    signal = _sparse_signal(shape=(400, 350), density=0.02, seed=7)
    rng = np.random.RandomState(8)
    kernel = rng.rand(7, 7)
    kwargs = dict(full=True, pval=True, tile=96)
    if mode == "coo":
        signal, mask = _mask_for(signal)
        kwargs.update(missing_mask=mask)
    elif mode == "vec":
        sm, sn = signal.shape
        miss_r = rng.rand(sm) < 0.05
        miss_c = rng.rand(sn) < 0.05
        sig = signal.toarray()
        sig[miss_r, :] = 0
        sig[:, miss_c] = 0
        signal = sp.csr_matrix(sig)
        kwargs.update(missing_vectors=(miss_r, miss_c))

    monkeypatch.setenv("CHROMOSIGHT_TPU_TILE_BATCH", "1")
    corr1, p1 = normxcorr2_sparse_tiled(signal, kernel, **kwargs)
    monkeypatch.setenv("CHROMOSIGHT_TPU_TILE_BATCH", "4")
    corr4, p4 = normxcorr2_sparse_tiled(signal, kernel, **kwargs)
    if mode == "vec":
        # the batched path runs the rank-collapsed crossing engine:
        # equal up to fp reassociation (snap-boundary flips possible)
        assert _allclose_with_snap_flips(corr1.toarray(), corr4.toarray())
        both = (corr1.toarray() != 0) & (corr4.toarray() != 0)
        assert np.allclose(
            p1.toarray()[both], p4.toarray()[both], atol=5e-4
        )
    else:
        assert np.array_equal(corr1.toarray(), corr4.toarray())
        assert np.array_equal(p1.toarray(), p4.toarray())


def test_normxcorr2_tiled_keep_min_subset(monkeypatch):
    """keep_min extraction must return exactly the >= keep_min subset of
    the full scan (detect-mode fast path), including p-values."""
    signal = _sparse_signal(shape=(400, 350), density=0.01, seed=9)
    rng = np.random.RandomState(10)
    kernel = rng.rand(7, 7)
    miss_r = rng.rand(400) < 0.05
    miss_c = rng.rand(350) < 0.05
    sig = signal.toarray()
    sig[miss_r, :] = 0
    sig[:, miss_c] = 0
    signal = sp.csr_matrix(sig)
    kwargs = dict(
        full=True,
        pval=True,
        tile=96,
        missing_vectors=(miss_r, miss_c),
    )
    corr_full, p_full = normxcorr2_sparse_tiled(signal, kernel, **kwargs)
    corr_k, p_k = normxcorr2_sparse_tiled(
        signal, kernel, keep_min=0.2, **kwargs
    )
    dense_full = corr_full.toarray()
    want = np.where(dense_full >= 0.2, dense_full, 0.0)
    got = corr_k.toarray()
    # different static capacities compile different programs, so values
    # may reassociate by ~1e-6; presence may flip only AT the threshold
    both = (got != 0) & (want != 0)
    assert np.allclose(got[both], want[both], atol=1e-5)
    only = (got != 0) ^ (want != 0)
    assert np.all(np.abs(dense_full[only] - 0.2) < 1e-5)
    pw = p_full.toarray()
    assert np.allclose(p_k.toarray()[both], pw[both], atol=5e-4)


def test_normxcorr2_tiled_keep_min_overflow(monkeypatch):
    """Tiles whose candidate count overflows the starting capacity are
    rerouted to the airtight per-tile path, never truncated."""
    monkeypatch.setenv("CHROMOSIGHT_TPU_TILE_CAP0", "1024")
    # dense blob of near-identical windows -> thousands of candidates in
    # one tile
    rng = np.random.RandomState(12)
    base = np.zeros((300, 300))
    blob = rng.rand(80, 80) * 0.1 + 1.0
    base[40:120, 60:140] = blob
    kernel = np.ones((7, 7)) + rng.rand(7, 7) * 0.01
    sig = sp.csr_matrix(base)
    kwargs = dict(full=True, pval=True, tile=96)
    corr_full, _ = normxcorr2_sparse_tiled(sig, kernel, **kwargs)
    lo = 0.01
    corr_k, _ = normxcorr2_sparse_tiled(sig, kernel, keep_min=lo, **kwargs)
    dense_full = corr_full.toarray()
    n_cand = int((dense_full >= lo).sum())
    assert n_cand > 1024  # the overflow actually triggers
    got = corr_k.toarray()
    # overflow tiles fall back to full (!=0) extraction, so the result
    # must contain at least the candidate subset with equal values
    m = dense_full >= lo
    assert np.array_equal(got[m], dense_full[m])


def test_normxcorr2_tiled_keep_min_small_tile():
    """Tiny (or non-power-of-two) tile sizes: every extraction capacity
    must clamp to the T*T flat tile size or lax.top_k raises (regression:
    cap_ex from _pow2's 1024 floor exceeded T*T for T < 32, crashing
    detect --inter under CHROMOSIGHT_TPU_TILE=50)."""
    rng = np.random.RandomState(21)
    signal = _sparse_signal(shape=(160, 140), density=0.02, seed=20)
    miss_r = rng.rand(160) < 0.05
    miss_c = rng.rand(140) < 0.05
    sig = signal.toarray()
    sig[miss_r, :] = 0
    sig[:, miss_c] = 0
    signal = sp.csr_matrix(sig)
    kernel = rng.rand(7, 7)
    kwargs = dict(
        full=True, pval=True, missing_vectors=(miss_r, miss_c)
    )
    corr_ref, _ = normxcorr2_sparse_tiled(signal, kernel, tile=96, **kwargs)
    corr_k, _ = normxcorr2_sparse_tiled(
        signal, kernel, tile=50, keep_min=0.3, **kwargs
    )
    dense_ref = corr_ref.toarray()
    want = np.where(dense_ref >= 0.3, dense_ref, 0.0)
    got = corr_k.toarray()
    both = (got != 0) & (want != 0)
    assert np.allclose(got[both], want[both], atol=1e-5)
    only = (got != 0) ^ (want != 0)
    assert np.all(np.abs(dense_ref[only] - 0.3) < 1e-5)


def test_normxcorr2_tiled_multidevice_matches_single(monkeypatch):
    """Round-robin data parallelism over jax.devices() (the tiled
    engine's multi-device path, C17) must reproduce the single-device
    scan exactly: same program, same inputs, only placement differs."""
    import jax

    if len(jax.devices()) < 2:
        pytest.skip("needs a multi-device backend")
    signal = _sparse_signal(shape=(400, 350), density=0.02, seed=13)
    rng = np.random.RandomState(14)
    kernel = rng.rand(7, 7)
    miss_r = rng.rand(400) < 0.05
    miss_c = rng.rand(350) < 0.05
    sig = signal.toarray()
    sig[miss_r, :] = 0
    sig[:, miss_c] = 0
    signal = sp.csr_matrix(sig)
    kwargs = dict(
        full=True,
        pval=True,
        tile=96,
        missing_vectors=(miss_r, miss_c),
    )
    monkeypatch.setenv("CHROMOSIGHT_TPU_TILE_BATCH", "2")
    monkeypatch.setenv("CHROMOSIGHT_TPU_TILE_MULTIDEV", "0")
    corr_s, p_s = normxcorr2_sparse_tiled(signal, kernel, **kwargs)
    monkeypatch.setenv("CHROMOSIGHT_TPU_TILE_MULTIDEV", "1")
    corr_m, p_m = normxcorr2_sparse_tiled(signal, kernel, **kwargs)
    assert np.array_equal(corr_s.toarray(), corr_m.toarray())
    assert np.array_equal(p_s.toarray(), p_m.toarray())


def test_iter_tile_counts_matches_host_tiles():
    """The counting prepass (capacity sizing for the streaming batched
    engine) must mirror _iter_tiles_host's enumeration exactly: same
    tiles, same nnz, same mask nnz."""
    from chromosight_tpu.ops.tiled import _iter_tile_counts, _iter_tiles_host

    for seed, shape, density, T, kshape in [
        (0, (500, 700), 0.01, 128, (7, 9)),
        (1, (300, 300), 0.15, 96, (17, 17)),
        (2, (130, 90), 0.002, 64, (3, 3)),
    ]:
        signal = _sparse_signal(shape=shape, density=density, seed=seed)
        _, mask = _mask_for(signal, seed=seed + 10)
        mk, nk = kshape
        tiles = list(_iter_tiles_host(signal, mask, T, mk, nk))
        counts = list(_iter_tile_counts(signal, mask, T, mk, nk, True))
        assert len(counts) == len(tiles)
        for t, (nnz, mnnz) in zip(tiles, counts):
            assert t[6] == nnz
            assert len(t[5][1]) == mnnz
        # no-mask variant: mask nnz reported as 0
        counts0 = list(_iter_tile_counts(signal, None, T, mk, nk, False))
        assert [c[0] for c in counts0] == [c[0] for c in counts]
        assert all(c[1] == 0 for c in counts0)


@pytest.mark.parametrize("width", [40, 128, 300])
def test_conv2d_valid_multik_matches_scipy(width):
    """The shift-FMA conv (the one formulation, at band and tile widths
    alike) against scipy's float64 correlate2d, for each kernel of a
    stack and through the single-kernel entry point."""
    import jax.numpy as jnp
    from scipy.signal import correlate2d

    from chromosight_tpu.ops.convolve import conv2d_valid, conv2d_valid_multik

    rng = np.random.default_rng(width)
    signal = rng.random((50, width)).astype(np.float32)
    kernels = rng.random((3, 9, 13)).astype(np.float32)
    got = np.asarray(conv2d_valid_multik(jnp.asarray(signal), jnp.asarray(kernels)))
    assert got.shape == (3, 42, width - 12)
    for k in range(3):
        want = correlate2d(
            signal.astype(np.float64), kernels[k].astype(np.float64), mode="valid"
        )
        np.testing.assert_allclose(got[k], want, rtol=1e-5, atol=1e-4)
    one = np.asarray(conv2d_valid(jnp.asarray(signal), jnp.asarray(kernels[1])))
    np.testing.assert_array_equal(one, got[1])
