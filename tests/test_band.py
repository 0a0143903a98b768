"""Band-engine tests: parity of the diagonal-band path against the dense
path, band assembly round-trips, and sheared-kernel construction."""

import subprocess
import sys

import numpy as np
import pandas as pd
import pytest

from chromosight_tpu.ops.band import (
    band_to_dense,
    band_window,
    coo_to_band,
    shear_kernel,
)


def test_coo_band_roundtrip():
    rng = np.random.RandomState(0)
    n, w = 50, 12
    dense = np.triu(rng.rand(n, n))
    i, j = np.indices((n, n))
    dense[(j - i) >= w] = 0
    r, c = np.nonzero(dense)
    band = coo_to_band(r, c, dense[r, c], n, w)
    back = band_to_dense(band, n)
    assert np.allclose(back, dense)


def test_band_window_matches_dense():
    rng = np.random.RandomState(1)
    n, w = 40, 15
    dense = np.triu(rng.rand(n, n))
    i, j = np.indices((n, n))
    dense[(j - i) >= w] = 0
    r, c = np.nonzero(dense)
    band = coo_to_band(r, c, dense[r, c], n, w)
    win = band_window(band, 10, 18, 4, 4, w)
    expected = dense[7:14, 15:22]
    assert np.allclose(win, expected)


def test_shear_kernel():
    K = np.arange(9).reshape(3, 3).astype(float)
    sh = shear_kernel(K)
    assert sh.shape == (3, 5)
    # K_sh[u, v - u + mk - 1] = K[u, v]
    for u in range(3):
        for v in range(3):
            assert sh[u, v - u + 2] == K[u, v]


def _run_band_vs_dense(K, n=150, max_dist=40):
    """Run both engines on the same synthetic banded matrix; return the max
    abs difference over all kept diagonals."""
    import jax.numpy as jnp

    from chromosight_tpu.ops.band import band_normxcorr
    from chromosight_tpu.ops.normxcorr import (
        make_missing_mask_dense,
        normxcorr2_dense,
    )
    from chromosight_tpu.ops.preprocess import diag_trim_dense

    np.random.seed(0)
    K = np.asarray(K, np.float64)
    mk, nk = K.shape
    keep = max_dist + max(mk, nk)
    dense = np.random.rand(n, n)
    i, j = np.indices((n, n))
    dense[(j - i < 0) | (j - i > keep)] = 0
    miss = np.zeros(n, bool)
    miss[[0, 1, 30, 77]] = True
    dense[miss, :] = 0
    dense[:, miss] = 0

    mask2d = np.asarray(
        make_missing_mask_dense(
            (n, n), miss, miss, max_dist=max_dist, sym_upper=True
        )
    )
    corr_d, _ = normxcorr2_dense(
        dense,
        K,
        max_dist=max_dist,
        sym_upper=True,
        full=True,
        missing_mask=mask2d,
        missing_tol=0.5,
        pval=True,
    )
    corr_d = np.asarray(diag_trim_dense(jnp.asarray(np.asarray(corr_d)), max_dist))

    width = keep + 1
    r, c = np.nonzero(dense)
    band = coo_to_band(r, c, dense[r, c], n, width)
    n_pad = 256
    band_p = np.zeros((n_pad, width), np.float32)
    band_p[:n] = band
    miss_p = np.zeros(n_pad, bool)
    miss_p[:n] = miss
    corr_b, logp_b, cand_b = band_normxcorr(
        jnp.asarray(band_p),
        jnp.asarray(miss_p),
        jnp.asarray(K, jnp.float32),
        jnp.asarray(shear_kernel(K), jnp.float32),
        jnp.asarray(shear_kernel(K**2), jnp.float32),
        K.shape,
        n,
        max_dist,
        0.5,
        0.3,
    )
    corr_b = np.asarray(corr_b)[:n]
    err = 0.0
    for d in range(max_dist + 1):
        ii = np.arange(0, n - d)
        err = max(err, np.abs(corr_b[ii, d] - corr_d[ii, ii + d]).max())
    return err


def test_band_normxcorr_matches_dense_engine():
    """Band engine == dense engine on a synthetic banded matrix."""
    import chromosight_tpu.kernels as ck

    assert _run_band_vs_dense(ck.loops_small["kernels"][0]) < 5e-5


def test_band_normxcorr_rectangular_kernels():
    """Wide rectangular (nk > mk) kernels must match the dense engine
    exactly (stripe-like custom kernels are valid reference configs);
    tall kernels (mk > nk) are rejected by the pipeline instead — the
    reference's framed below-diagonal margin overlaps the upper triangle
    there and its sparse engine raises (check_missing_mask)."""
    rng = np.random.RandomState(3)
    for shape in [(3, 9), (5, 11), (1, 7), (3, 17)]:
        K = rng.rand(*shape) + 0.1
        err = _run_band_vs_dense(K)
        assert err < 5e-5, f"kernel {shape}: max diff {err}"


def test_band_pipeline_rejects_tall_kernels(tmp_path, example_cool):
    """mk > nk kernels must raise like the reference sparse engine does
    (check_missing_mask, ref detection.py:1022) instead of returning
    silently wrong correlations."""
    import pytest

    from chromosight_tpu.detection import pattern_detector
    from chromosight_tpu.runtime.genome import HicGenome
    import chromosight_tpu.kernels as ck

    import shutil

    path = str(tmp_path / "example.cool")
    shutil.copy(example_cool, path)
    cfg = dict(ck.loops_small)
    hg = HicGenome(path, kernel_config=cfg)
    hg.normalize("auto")
    hg.compute_max_dist()
    hg.make_sub_matrices()
    sub = hg.sub_mats.iloc[0]
    sub.contact_map.create_mat()
    K = np.random.RandomState(0).rand(9, 3) + 0.1
    with pytest.raises(
        ValueError,
        match=r"^There are \d+ non-zero elements reported as missing\.$",
    ):
        pattern_detector(sub.contact_map, cfg, K, full=True)


def test_band_full_false_routes_sparse(tmp_path, example_cool, monkeypatch):
    """pattern_detector(full=False) on a banded map must not expand the
    band to a dense matrix (O(n^2) at genome scale): it routes through
    the sparse path instead."""
    import shutil

    import chromosight_tpu.kernels as ck
    import chromosight_tpu.ops.band as band_mod
    from chromosight_tpu.detection import pattern_detector
    from chromosight_tpu.runtime.genome import HicGenome

    path = str(tmp_path / "example.cool")
    shutil.copy(example_cool, path)
    cfg = dict(ck.loops_small)
    hg = HicGenome(path, kernel_config=cfg)
    hg.normalize("auto")
    hg.compute_max_dist()
    hg.make_sub_matrices()
    sub = hg.sub_mats.iloc[0]
    sub.contact_map.create_mat()
    assert sub.contact_map.band_dev is not None

    def _boom(*a, **k):
        raise AssertionError("band_to_dense called on full=False path")

    monkeypatch.setattr(band_mod, "band_to_dense", _boom)
    coords, windows = pattern_detector(
        sub.contact_map, cfg, cfg["kernels"][0], full=False
    )
    # full=False on real data finds foci like the reference non-full mode
    assert coords is None or {"bin1", "bin2", "score"} <= set(coords.columns)


@pytest.mark.slow
def test_band_cli_detect_matches_dense(tmp_path, example_cool):
    """Forcing the band engine on the example dataset must reproduce the
    dense engine's 89 golden loop calls."""
    import os

    env = dict(os.environ)
    env["CHROMOSIGHT_TPU_BAND_THRESHOLD"] = "100"
    env["JAX_PLATFORMS"] = "cpu"
    out_band = str(tmp_path / "band")
    r = subprocess.run(
        [
            sys.executable, "-m", "chromosight_tpu.cli.main",
            "detect", "--no-plotting", example_cool, out_band,
        ],
        env=env,
        capture_output=True,
        text=True,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    env["CHROMOSIGHT_TPU_BAND_THRESHOLD"] = "1000000"
    out_dense = str(tmp_path / "dense")
    r = subprocess.run(
        [
            sys.executable, "-m", "chromosight_tpu.cli.main",
            "detect", "--no-plotting", example_cool, out_dense,
        ],
        env=env,
        capture_output=True,
        text=True,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    b = pd.read_csv(out_band + ".tsv", sep="\t")
    d = pd.read_csv(out_dense + ".tsv", sep="\t")
    assert len(b) == len(d) == 89
    assert set(zip(b.bin1, b.bin2)) == set(zip(d.bin1, d.bin2))
    m = b.merge(d, on=["bin1", "bin2"])
    assert np.abs(m.score_x - m.score_y).max() < 1e-4


@pytest.mark.slow
def test_band_cli_quantify_matches_dense(tmp_path, example_cool, example_bed2):
    """Quantify through the band engine == dense engine."""
    import os

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    outs = {}
    for name, thresh in [("band", "100"), ("dense", "1000000")]:
        env["CHROMOSIGHT_TPU_BAND_THRESHOLD"] = thresh
        prefix = str(tmp_path / name)
        r = subprocess.run(
            [
                sys.executable, "-m", "chromosight_tpu.cli.main",
                "quantify", "--no-plotting", example_bed2, example_cool,
                prefix,
            ],
            env=env,
            capture_output=True,
            text=True,
        )
        assert r.returncode == 0, r.stderr[-2000:]
        outs[name] = pd.read_csv(prefix + ".tsv", sep="\t")
    b, d = outs["band"], outs["dense"]
    assert len(b) == len(d)
    bs = b.score.to_numpy()
    ds = d.score.to_numpy()
    both = np.isfinite(bs) & np.isfinite(ds)
    assert (np.isfinite(bs) == np.isfinite(ds)).all()
    assert np.abs(bs[both] - ds[both]).max() < 1e-4


def test_band_preprocess_matches_staged_path():
    """The fused single-dispatch preprocess equals the staged
    stats -> detrend -> trim -> nan pipeline."""
    import jax.numpy as jnp

    from chromosight_tpu.ops.band import (
        band_detrend_trim,
        band_diag_stats,
        band_preprocess,
    )

    rng = np.random.RandomState(0)
    n, width = 200, 64
    band = rng.rand(n, width).astype(np.float32)
    band[band < 0.2] = 0
    band[rng.rand(n, width) < 0.05] = np.nan
    detect = np.ones(n, bool)
    detect[[3, 50]] = False
    keep_dist = 40
    n_diags = min(keep_dist + 1, n)

    fused = np.asarray(
        band_preprocess(
            jnp.asarray(band), jnp.asarray(detect), 10, keep_dist,
            n_diags, zero_nan=True,
        )
    )

    sums, counts = band_diag_stats(jnp.asarray(band), jnp.asarray(detect))
    law = np.zeros(width)
    with np.errstate(invalid="ignore", divide="ignore"):
        law[:n_diags] = (
            np.asarray(sums, np.float64)[:n_diags]
            / np.asarray(counts, np.float64)[:n_diags]
        )
    law[np.isnan(law)] = 0
    staged = np.array(
        band_detrend_trim(
            jnp.asarray(band), jnp.asarray(law, jnp.float32), 10, keep_dist
        ),
        copy=True,
    )
    staged[np.isnan(staged)] = 0
    assert np.allclose(fused, staged, atol=1e-5, equal_nan=True)


def test_sliding_vector_exact_length():
    import jax.numpy as jnp

    from chromosight_tpu.ops.band import sliding_vector

    vec = np.arange(12, dtype=np.float32)
    out = np.asarray(sliding_vector(jnp.asarray(vec), 8, 4))
    i, d = np.indices((8, 4))
    assert np.array_equal(out, (i + d).astype(np.float32))
    with pytest.raises(ValueError):
        sliding_vector(jnp.asarray(vec), 10, 4)


def test_warm_band_programs_compiles_cleanly(example_cool, monkeypatch):
    """The pre-fetch program warmup thread compiles the real bucket
    shapes without error (a mismatch would fall back silently and waste
    compiles — the stderr marker catches that)."""
    import io as _io
    import sys as _sys

    import numpy as np

    import chromosight_tpu.detection as cid
    import chromosight_tpu.kernels as ck
    from chromosight_tpu.runtime.genome import HicGenome

    monkeypatch.setenv("CHROMOSIGHT_TPU_WARM", "force")
    cfg = dict(ck.loops_small)
    cfg["tsvd"] = None
    g = HicGenome(example_cool, kernel_config=cfg)
    g.kernel_config = cfg
    g.normalize("auto", 5)
    g.compute_max_dist()
    g.make_sub_matrices()
    err = _io.StringIO()
    old = _sys.stderr
    _sys.stderr = err
    try:
        t = cid.warm_band_programs(
            g,
            cfg,
            cfg["kernels"],
            None,
            cid.fuse_kernels_eligible(
                [np.asarray(k) for k in cfg["kernels"]]
            ),
        )
        assert t is not None
        t.join(180)
        assert not t.is_alive()
    finally:
        _sys.stderr = old
    assert "warmup skipped" not in err.getvalue()


def test_band_conv_separable_matches_reconstruction():
    """The tSVD factor-pair conv (rank Toeplitz blocks + weighted
    anti-diagonal FMAs) must reproduce the reconstructed-kernel sheared
    conv to float tolerance — same math as the reference's factorised
    xcorr2 (reference detection.py:648-665)."""
    import jax.numpy as jnp

    import chromosight_tpu.kernels as ck
    import chromosight_tpu.preprocessing as preproc
    from chromosight_tpu.ops.band import (
        _band_conv_valid,
        _band_conv_valid_sep,
        shear_kernel,
    )

    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.random((160, 96)), jnp.float32)
    for K in (
        np.asarray(ck.loops["kernels"][0]),
        rng.random((9, 5)),  # rectangular
    ):
        lk, rk = preproc.factorise_kernel(K, prop_info=0.999)
        assert lk.shape[1] < K.shape[0], "fixture kernel must truncate"
        rec = _band_conv_valid(
            x, jnp.asarray(shear_kernel(lk @ rk), jnp.float32)
        )
        sep = _band_conv_valid_sep(
            x, jnp.asarray(lk, jnp.float32), jnp.asarray(rk, jnp.float32)
        )
        assert rec.shape == sep.shape
        scale = max(float(np.abs(np.asarray(rec)).max()), 1.0)
        assert np.abs(np.asarray(rec) - np.asarray(sep)).max() < 1e-5 * scale


def test_band_normxcorr_tsvd_pack_matches_reconstruction():
    """band_normxcorr dispatched with (lk, rk) factor pairs (the --tsvd
    fast path) returns the same correlation map as the reconstructed
    sheared kernels, and the same candidate set."""
    import jax.numpy as jnp

    import chromosight_tpu.kernels as ck
    import chromosight_tpu.preprocessing as preproc
    from chromosight_tpu.ops.band import band_normxcorr, shear_kernel

    K = np.asarray(ck.loops["kernels"][0])
    lk, rk = preproc.factorise_kernel(K, prop_info=0.999)
    lk2, rk2 = preproc.factorise_kernel(K**2, prop_info=0.999)
    rng = np.random.default_rng(11)
    n, width = 256, 64
    band = jnp.asarray(rng.random((n, width)), jnp.float32)
    missing = np.zeros(n, bool)
    missing[40:45] = True
    missing = jnp.asarray(missing)
    common = ((17, 17), n, width - 1, 0.5, 0.3)
    rec = band_normxcorr(
        band,
        missing,
        jnp.asarray(K, jnp.float32),
        jnp.asarray(shear_kernel(lk @ rk), jnp.float32),
        jnp.asarray(shear_kernel(lk2 @ rk2), jnp.float32),
        *common,
    )
    sep = band_normxcorr(
        band,
        missing,
        jnp.asarray(K, jnp.float32),
        (jnp.asarray(lk, jnp.float32), jnp.asarray(rk, jnp.float32)),
        (jnp.asarray(lk2, jnp.float32), jnp.asarray(rk2, jnp.float32)),
        *common,
    )
    corr_r, _, cand_r = (np.asarray(a) for a in rec)
    corr_s, _, cand_s = (np.asarray(a) for a in sep)
    assert np.abs(corr_r - corr_s).max() < 2e-5
    assert (cand_r == cand_s).mean() > 0.999


def test_extract_topk_matches_nonzero():
    """Two-stage top_k extraction returns the exact candidate set of the
    nonzero formulation (order differs; callers sort)."""
    import jax.numpy as jnp

    from chromosight_tpu.ops.band import (
        extract_candidates_packed,
        extract_candidates_topk_packed,
    )

    rng = np.random.RandomState(1)
    n, w = 256, 40
    corr = rng.normal(0, 0.05, (n, w)).astype(np.float32)
    hot = rng.choice(n * w, 90, replace=False)
    corr.ravel()[hot] = rng.uniform(0.5, 0.9, 90).astype(np.float32)
    cand = corr >= 0.5
    cap = 1 << 10
    assert cap <= n * 32

    a = np.asarray(extract_candidates_packed(jnp.asarray(corr), jnp.asarray(cand), cap))
    b = np.asarray(
        extract_candidates_topk_packed(jnp.asarray(corr), jnp.asarray(cand), cap, 32)
    )
    na, nb = int(a[3, 0]), int(b[3, 0])
    assert nb >= 0, "no row overflow expected"
    assert na == nb == int(cand.sum())
    sa = {(int(r), int(d), round(float(v), 5)) for r, d, v in zip(a[0, :na], a[1, :na], a[2, :na])}
    sb = {(int(r), int(d), round(float(v), 5)) for r, d, v in zip(b[0, :nb], b[1, :nb], b[2, :nb])}
    assert sa == sb


def test_extract_topk_signals_row_overflow():
    """When a row holds more than row_k candidates the payload goes
    negative (encoding -(count+1)) so the caller falls back to the
    exact nonzero path."""
    import jax.numpy as jnp

    from chromosight_tpu.ops.band import extract_candidates_topk_packed

    n, w = 64, 24
    corr = np.zeros((n, w), np.float32)
    corr[5, :20] = 0.8  # 20 candidates in one row > row_k=8
    cand = corr >= 0.5
    out = np.asarray(
        extract_candidates_topk_packed(jnp.asarray(corr), jnp.asarray(cand), 256, 8)
    )
    payload = float(out[3, 0])
    assert payload < 0
    assert int(-payload - 1) == 20
