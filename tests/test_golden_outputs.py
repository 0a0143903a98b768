"""Coordinate-level golden-output parity against the reference.

``tests/data/golden_*.tsv`` were produced by running the REFERENCE
implementation's own ``cmd_detect`` / ``cmd_quantify`` (reference
``cli/chromosight.py:625-896, 295-496``) on ``data_test/example.cool``
via ``tools/gen_reference_golden.py``.  These tests assert that this
package's CLI reproduces the reference's calls exactly at the coordinate
level (bin1/bin2/kernel/iteration) with fp32-tolerance scores/p-values —
the BASELINE.json north-star ("calls identical to CPU chromosight"),
asserted rather than claimed."""

import pathlib

import numpy as np
import pandas as pd
import pytest
# Full CLI / end-to-end runs: minutes on one core. `pytest -m "not slow"` is the fast tier.
pytestmark = pytest.mark.slow


from chromosight_tpu.cli.main import main

DATA = pathlib.Path(__file__).parent / "data"


@pytest.fixture(scope="module")
def detect_out(tmp_path_factory, example_cool_session):
    prefix = str(tmp_path_factory.mktemp("golden") / "detect")
    rc = main(["detect", "--no-plotting", example_cool_session, prefix])
    assert rc in (0, None)
    return pd.read_csv(prefix + ".tsv", sep="\t")


@pytest.fixture(scope="module")
def example_cool_session(tmp_path_factory):
    import shutil

    src = pathlib.Path(__file__).parents[1] / "data_test" / "example.cool"
    dst = tmp_path_factory.mktemp("cool") / "example.cool"
    shutil.copy(src, dst)
    return str(dst)


def test_detect_matches_reference_coordinates(detect_out):
    """Every one of the 89 golden loop calls at the exact (bin1, bin2),
    same kernel and iteration, no extras."""
    golden = pd.read_csv(DATA / "golden_detect_loops.tsv", sep="\t")
    ours = detect_out
    assert len(ours) == len(golden) == 89
    key = ["bin1", "bin2", "kernel_id", "iteration"]
    g = golden.sort_values(key).reset_index(drop=True)
    o = ours.sort_values(key).reset_index(drop=True)
    for col in key + ["chrom1", "start1", "end1", "chrom2", "start2", "end2"]:
        assert (g[col] == o[col]).all(), f"column {col} differs"


def test_detect_matches_reference_scores(detect_out):
    """Scores and p-values match the reference's fp64 values within fp32
    tolerance (the tsv prints 10 decimals)."""
    golden = pd.read_csv(DATA / "golden_detect_loops.tsv", sep="\t")
    m = golden.merge(
        detect_out, on=["bin1", "bin2"], suffixes=("_ref", "_ours")
    )
    assert len(m) == 89
    assert np.abs(m.score_ref - m.score_ours).max() < 5e-5
    assert np.abs(m.pvalue_ref - m.pvalue_ours).max() < 1e-6
    assert np.abs(m.qvalue_ref - m.qvalue_ours).max() < 1e-6


@pytest.mark.parametrize(
    "golden,flags",
    [
        ("golden_detect_loops_iter2", ["--iterations", "2"]),
        ("golden_detect_loops_win21", ["--win-size", "21"]),
        ("golden_detect_loops_smooth", ["--smooth-trend"]),
        ("golden_detect_loops_inter", ["--inter"]),
        ("golden_detect_borders", ["--pattern", "borders"]),
        ("golden_detect_loops_small", ["--pattern", "loops_small"]),
        ("golden_detect_hairpins", ["--pattern", "hairpins"]),
        ("golden_detect_stripes_left", ["--pattern", "stripes_left"]),
        ("golden_detect_stripes_right", ["--pattern", "stripes_right"]),
        ("golden_detect_loops_tsvd", ["--tsvd"]),
        ("golden_detect_loops_raw", ["--norm", "raw"]),
        ("golden_detect_loops_maxdist", ["--max-dist", "100000"]),
        ("golden_detect_loops_mindist", ["--min-dist", "40000"]),
        ("golden_detect_loops_perczero", ["--perc-zero", "5"]),
        ("golden_detect_loops_percundetected", ["--perc-undetected", "20"]),
    ],
    ids=[
        "iterations2", "win_size21", "smooth_trend", "inter", "borders",
        "loops_small", "hairpins", "stripes_left", "stripes_right",
        "tsvd", "raw_norm",
        "max_dist", "min_dist", "perc_zero", "perc_undetected",
    ],
)
def test_detect_flag_configs_match_reference(
    tmp_path, example_cool_session, golden, flags
):
    """Previously-untested CLI paths (iterative pileup refinement,
    detect-time kernel resize, isotonic trend smoothing, inter-chromosomal
    scan, multi-kernel diagonal patterns) against reference-generated
    goldens: exact (bin1, bin2, kernel, iteration) coordinates and
    fp32-tolerance scores."""
    g = pd.read_csv(DATA / f"{golden}.tsv", sep="\t")
    prefix = str(tmp_path / "out")
    rc = main(
        ["detect", "--no-plotting", *flags, example_cool_session, prefix]
    )
    assert rc in (0, None)
    o = pd.read_csv(prefix + ".tsv", sep="\t")
    key = ["bin1", "bin2", "kernel_id", "iteration"]
    assert len(o) == len(g)
    assert set(map(tuple, o[key].values)) == set(map(tuple, g[key].values))
    m = g.merge(o, on=key, suffixes=("_ref", "_ours"))
    assert len(m) == len(g)
    assert np.abs(m.score_ref - m.score_ours).max() < 5e-5
    assert np.abs(m.pvalue_ref - m.pvalue_ours).max() < 1e-5
    if golden == "golden_detect_loops_iter2":
        # the pileup-refined second iteration must actually run and add
        # its own calls (reference finds 12 extra patterns at iteration 1)
        assert (o.iteration == 1).sum() > 0


def test_quantify_matches_reference(tmp_path, example_cool_session):
    golden = pd.read_csv(DATA / "golden_quantify_loops.tsv", sep="\t")
    bed2 = str(pathlib.Path(__file__).parents[1] / "data_test" / "example.bed2")
    prefix = str(tmp_path / "quant")
    rc = main(
        ["quantify", "--no-plotting", bed2, example_cool_session, prefix]
    )
    assert rc in (0, None)
    ours = pd.read_csv(prefix + ".tsv", sep="\t")
    assert len(ours) == len(golden) == 53
    m = golden.merge(ours, on=["bin1", "bin2"], suffixes=("_ref", "_ours"))
    assert len(m) == 53
    # same validation outcome per coordinate (NaN = rejected window)
    assert (m.score_ref.isna() == m.score_ours.isna()).all()
    ok = m.score_ref.notna()
    assert np.abs(m.score_ref[ok] - m.score_ours[ok]).max() < 5e-5
    okp = m.pvalue_ref.notna()
    assert (m.pvalue_ref.isna() == m.pvalue_ours.isna()).all()
    assert np.abs(m.pvalue_ref[okp] - m.pvalue_ours[okp]).max() < 1e-6
    # reference propagates NaN into every qvalue when any pvalue is NaN
    assert golden.qvalue.isna().all() and ours.qvalue.isna().all()


def test_quantify_borders_matches_reference(tmp_path, example_cool_session):
    """Multi-kernel quantify (borders ships 3 kernels; the fused
    single-dispatch path is the default): the reference keeps the best
    score per coordinate across kernels (ref cli/chromosight.py:431-439)
    — coordinates, validation outcomes and scores must match."""
    golden = pd.read_csv(DATA / "golden_quantify_borders.tsv", sep="\t")
    bed2 = str(pathlib.Path(__file__).parents[1] / "data_test" / "example.bed2")
    prefix = str(tmp_path / "quantb")
    rc = main(
        [
            "quantify", "--no-plotting", "--pattern", "borders",
            bed2, example_cool_session, prefix,
        ]
    )
    assert rc in (0, None)
    ours = pd.read_csv(prefix + ".tsv", sep="\t")
    assert len(ours) == len(golden)
    m = golden.merge(ours, on=["bin1", "bin2"], suffixes=("_ref", "_ours"))
    assert len(m) == len(golden)
    assert (m.score_ref.isna() == m.score_ours.isna()).all()
    ok = m.score_ref.notna()
    assert np.abs(m.score_ref[ok] - m.score_ours[ok]).max() < 5e-5
    okp = m.pvalue_ref.notna() & m.pvalue_ours.notna()
    assert (m.pvalue_ref.isna() == m.pvalue_ours.isna()).all()
    # borders' weak correlations (pearson .15) sit where the Fisher
    # transform amplifies f32-vs-f64 rounding; observed max 1.7e-5
    assert np.abs(m.pvalue_ref[okp] - m.pvalue_ours[okp]).max() < 5e-5


def test_detect_inter_sparse_path_matches_reference(
    tmp_path, example_cool_session, monkeypatch
):
    """Forcing the sparse-resident inter path (ContactMap keeps trans maps
    as CSR and the detector scans them through the halo-tiled engine, as
    at genome scale where densifying a trans pair is infeasible) must
    reproduce the reference --inter golden exactly."""
    monkeypatch.setenv("CHROMOSIGHT_TPU_DENSE_LIMIT", "50")
    g = pd.read_csv(DATA / "golden_detect_loops_inter.tsv", sep="\t")
    prefix = str(tmp_path / "out")
    rc = main(
        ["detect", "--no-plotting", "--inter", example_cool_session, prefix]
    )
    assert rc in (0, None)
    o = pd.read_csv(prefix + ".tsv", sep="\t")
    key = ["bin1", "bin2", "kernel_id", "iteration"]
    assert len(o) == len(g)
    assert set(map(tuple, o[key].values)) == set(map(tuple, g[key].values))
    m = g.merge(o, on=key, suffixes=("_ref", "_ours"))
    assert np.abs(m.score_ref - m.score_ours).max() < 5e-5
    assert np.abs(m.pvalue_ref - m.pvalue_ours).max() < 1e-5


def test_quantify_inter_sparse_path_matches_dense(
    tmp_path, example_cool_session, monkeypatch
):
    """Quantify with trans (inter-chromosomal) coordinate pairs through
    the sparse-resident inter path must score identically to the dense
    path (NaN validation outcomes included)."""
    bed = tmp_path / "pairs.bed2"
    bed.write_text(
        "chr1\t63000\t64000\tchr1\t74000\t75000\n"
        "chr1\t50000\t51000\tchr2\t80000\t81000\n"
        "chr1\t100000\t101000\tchr2\t200000\t201000\n"
        "chr2\t130000\t131000\tchr3\t139000\t140000\n"
    )

    def run(prefix):
        rc = main(
            [
                "quantify", "--no-plotting", "--inter",
                str(bed), example_cool_session, prefix,
            ]
        )
        assert rc in (0, None)
        return pd.read_csv(prefix + ".tsv", sep="\t")

    dense = run(str(tmp_path / "dense"))
    monkeypatch.setenv("CHROMOSIGHT_TPU_DENSE_LIMIT", "50")
    monkeypatch.setenv("CHROMOSIGHT_TPU_TILE", "128")
    sparse = run(str(tmp_path / "sparse"))
    assert len(dense) == len(sparse) == 4
    for col in ["chrom1", "start1", "chrom2", "start2", "bin1", "bin2"]:
        assert (dense[col].fillna(-1) == sparse[col].fillna(-1)).all()
    assert np.array_equal(np.isnan(dense.score), np.isnan(sparse.score))
    ok = ~np.isnan(dense.score)
    assert np.allclose(dense.score[ok], sparse.score[ok], atol=5e-5)


def test_detect_windows_match_reference(tmp_path, example_cool_session):
    """The saved per-pattern windows (--win-fmt json, reference
    ``io.py:229-256``) hold the raw detrended matrix content around each
    call — vendored golden from the reference's own run.  Windows are
    matched by (bin1, bin2) since row order inside the table is not part
    of the contract, then compared elementwise (NaN = missing bins)."""
    import json

    golden_tsv = pd.read_csv(DATA / "golden_detect_loops.tsv", sep="\t")
    with open(DATA / "golden_detect_loops.json") as fh:
        golden_wins = json.load(fh)
    prefix = str(tmp_path / "out")
    rc = main(["detect", "--no-plotting", example_cool_session, prefix])
    assert rc in (0, None)
    ours_tsv = pd.read_csv(prefix + ".tsv", sep="\t")
    with open(prefix + ".json") as fh:
        ours_wins = json.load(fh)
    assert len(ours_wins) == len(golden_wins) == 89
    ours_idx = {
        (r.bin1, r.bin2): i for i, r in enumerate(ours_tsv.itertuples())
    }
    for gi, grow in enumerate(golden_tsv.itertuples()):
        oi = ours_idx[(grow.bin1, grow.bin2)]
        g = np.asarray(golden_wins[str(gi)], dtype=np.float64)
        o = np.asarray(ours_wins[str(oi)], dtype=np.float64)
        assert g.shape == o.shape == (17, 17)
        assert np.array_equal(np.isnan(g), np.isnan(o)), (gi, oi)
        assert np.allclose(g, o, rtol=1e-5, atol=1e-6, equal_nan=True), (
            gi,
            oi,
        )


def test_dump_stage_snapshots_match_reference(tmp_path, example_cool_session):
    """Every --dump stage snapshot numerically matches the reference's own
    npz dumps (vendored under tests/data/golden_dump by
    tools/gen_reference_golden.py; reference ``DumpMatrix``
    ``contacts_map.py:23-76`` + detection dumps ``detection.py:264-285``).

    The band engine fuses diagonal trimming into the correlation program,
    so this package's 03 snapshot is already trimmed — 03 is asserted
    identical to its own 04 (documenting that fusion), and the reference
    comparison for the correlation stage runs against 04, where both
    implementations have trimmed to max_dist.
    """
    import scipy.sparse as sp

    golden_dir = DATA / "golden_dump"
    dumpdir = tmp_path / "dumps"
    dumpdir.mkdir()
    prefix = str(tmp_path / "out")
    rc = main(
        [
            "detect", "--no-plotting", "--iterations", "1",
            "--dump", str(dumpdir), example_cool_session, prefix,
        ]
    )
    assert rc in (0, None)
    names = sorted(p.name for p in golden_dir.glob("*.npz"))
    assert names, "golden dump snapshots missing — run gen_reference_golden"
    for name in names:
        ref = sp.load_npz(golden_dir / name).toarray()
        ours_p = dumpdir / name
        assert ours_p.exists(), f"missing dump {name}"
        ours = sp.load_npz(ours_p).toarray()
        assert ours.shape == ref.shape, name
        if "_05_foci" in name:
            # labelled foci: integer label ids (connected-component order
            # and the filter_foci gap-preserving numbering) must be exact
            assert np.array_equal(ours, ref), name
        elif "_01_detrended" in name or "_02_remove_diags" in name:
            # host/f32 device preprocessing vs the reference's f64.
            # NaN marks balanced-out (undetectable) bins in both.  At the
            # 01 stage the reference dumps the full symmetric matrix; the
            # band representation stores the upper triangle only (lower =
            # mirror), so compare triu.
            o_t, r_t = np.triu(ours), np.triu(ref)
            assert np.array_equal(np.isnan(o_t), np.isnan(r_t)), name
            o_t, r_t = np.nan_to_num(o_t), np.nan_to_num(r_t)
            assert np.allclose(o_t, r_t, rtol=1e-5, atol=1e-6), name
            if "_02_" in name:  # trimmed stage is upper-only in both
                assert not np.nan_to_num(np.tril(ref, -1)).any(), name
        elif "_03_normxcorr2" in name:
            ours04 = sp.load_npz(
                dumpdir / name.replace("_03_normxcorr2", "_04_diag_trim")
            ).toarray()
            assert np.array_equal(ours, ours04), name
        else:  # _04_diag_trim: f32 engine + the 1e-4 snap-to-zero edge
            assert np.array_equal(np.isnan(ours), np.isnan(ref)), name
            assert (
                np.max(np.abs(np.nan_to_num(ours) - np.nan_to_num(ref)))
                < 2e-4
            ), name


def test_detect_inter_sparse_dump(tmp_path, example_cool_session, monkeypatch):
    """--dump through the sparse inter path writes the stage snapshots."""
    monkeypatch.setenv("CHROMOSIGHT_TPU_DENSE_LIMIT", "50")
    dumpdir = tmp_path / "dumps"
    dumpdir.mkdir()
    rc = main(
        [
            "detect", "--no-plotting", "--inter", "--dump", str(dumpdir),
            example_cool_session, str(tmp_path / "out"),
        ]
    )
    assert rc in (0, None)
    names = {p.name for p in dumpdir.iterdir()}
    # trans pairs dump the correlation stage through the sparse detector
    assert any("chr1-chr2" in n and "03_normxcorr2" in n for n in names), names
