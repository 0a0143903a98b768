"""IO tests: cool reader/writer roundtrips, kernel config validation,
pattern/window writers, bed2d parsing (mirrors reference tests/test_io.py)."""

import json

import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp

import chromosight_tpu.io as cio
from chromosight_tpu.io.cool import CoolFile, create_cool


@pytest.fixture()
def tiny_cool(tmp_path):
    bins = pd.DataFrame(
        {
            "chrom": ["c1"] * 4 + ["c2"] * 3,
            "start": [0, 10, 20, 30, 0, 10, 20],
            "end": [10, 20, 30, 40, 10, 20, 30],
        }
    )
    pixels = pd.DataFrame(
        {
            "bin1_id": [0, 0, 1, 2, 4, 4, 5],
            "bin2_id": [0, 1, 2, 3, 4, 5, 6],
            "count": [10, 5, 3, 2, 8, 4, 6],
        }
    )
    path = str(tmp_path / "tiny.cool")
    create_cool(path, bins, pixels)
    return path


def test_cool_roundtrip(tiny_cool):
    clr = CoolFile(tiny_cool)
    assert clr.chromnames == ["c1", "c2"]
    assert clr.binsize == 10
    assert clr.shape == (7, 7)
    assert clr.extent("c1") == (0, 4)
    assert clr.extent("c2") == (4, 7)
    rows, cols, vals = clr.pixels_coo((0, 4), (0, 4))
    dense = np.zeros((4, 4))
    dense[rows, cols] = vals
    # symmetric fetch
    assert dense[1, 0] == dense[0, 1] == 5
    assert dense[0, 0] == 10


def test_cool_balanced_fetch(tiny_cool):
    clr = CoolFile(tiny_cool)
    w = np.array([1.0, 2.0, np.nan, 1.0, 1.0, 0.5, 1.0])
    clr.store_weights(w)
    clr2 = CoolFile(tiny_cool)
    rows, cols, vals = clr2.pixels_coo((0, 4), (0, 4), balance=True)
    dense = np.full((4, 4), 0.0)
    dense[rows, cols] = vals
    assert dense[0, 1] == 5 * 1.0 * 2.0
    # NaN weight propagates
    r, c, v = clr2.pixels_coo((0, 4), (0, 4), balance=True)
    nan_vals = v[np.isnan(v)]
    assert len(nan_vals) > 0


def test_load_cool(example_cool):
    mat, chroms, bins, binsize = cio.load_cool(example_cool)
    assert sp.issparse(mat) and mat.format == "coo"
    assert binsize == 1000
    assert mat.shape == (720, 720)
    assert np.all(mat.col >= mat.row)  # upper triangle
    assert chroms.loc[0, "start_bin"] == 0
    assert list(chroms.columns[:2]) == ["name", "length"]
    assert len(bins) == 720


def test_kernel_config_valid(tmp_path):
    k = np.random.rand(5, 5)
    np.savetxt(tmp_path / "k.1.txt", k)
    cfg = {
        "name": "custom",
        "kernels": ["k.1.txt"],
        "min_dist": 0,
        "max_dist": 100000,
        "max_iterations": 1,
        "min_separation": 5000,
        "max_perc_zero": 10.0,
        "max_perc_undetected": 50.0,
        "pearson": 0.3,
        "resolution": 5000,
    }
    with open(tmp_path / "custom.json", "w") as fh:
        json.dump(cfg, fh)
    loaded = cio.load_kernel_config(str(tmp_path / "custom.json"), custom=True)
    assert np.allclose(loaded["kernels"][0], k)


def test_kernel_config_inline_matrices(tmp_path):
    cfg = {
        "name": "inline",
        "kernels": [[[0.1, 0.2], [0.3, 0.4]]],
        "min_dist": 0,
        "max_dist": 0,
        "max_iterations": 1,
        "min_separation": 5000,
        "pearson": 0.3,
        "resolution": 5000,
    }
    with open(tmp_path / "inline.json", "w") as fh:
        json.dump(cfg, fh)
    loaded = cio.load_kernel_config(str(tmp_path / "inline.json"), custom=True)
    assert loaded["kernels"][0].shape == (2, 2)


def test_kernel_config_invalid_rejected(tmp_path):
    from jsonschema import ValidationError

    # negative max_dist
    bad = {
        "name": "bad",
        "kernels": [[[1.0]]],
        "min_dist": 0,
        "max_dist": -5,
        "max_iterations": 1,
        "min_separation": 5000,
        "pearson": 0.3,
        "resolution": 5000,
    }
    with open(tmp_path / "bad.json", "w") as fh:
        json.dump(bad, fh)
    with pytest.raises(ValidationError):
        cio.load_kernel_config(str(tmp_path / "bad.json"), custom=True)
    # missing required key
    del bad["max_dist"]
    del bad["pearson"]
    with open(tmp_path / "bad2.json", "w") as fh:
        json.dump(bad, fh)
    with pytest.raises(ValidationError):
        cio.load_kernel_config(str(tmp_path / "bad2.json"), custom=True)


def test_kernel_config_missing_file():
    with pytest.raises(FileNotFoundError):
        cio.load_kernel_config("no_such_pattern_xyz", custom=False)


def test_write_patterns_rounding(tmp_path):
    coords = pd.DataFrame(
        {"bin1": [1], "bin2": [2], "score": [0.123456789012345]}
    )
    prefix = str(tmp_path / "out")
    cio.write_patterns(coords, prefix)
    content = open(prefix + ".tsv").read()
    assert "0.1234567890" in content


def test_save_windows_roundtrip(tmp_path):
    wins = np.random.rand(3, 5, 5)
    prefix = str(tmp_path / "w")
    cio.save_windows(wins, prefix, fmt="npy")
    assert np.allclose(np.load(prefix + ".npy"), wins)
    cio.save_windows(wins, prefix, fmt="json")
    with open(prefix + ".json") as fh:
        loaded = json.load(fh)
    assert np.allclose(np.array(loaded["0"]), wins[0])
    with pytest.raises(ValueError):
        cio.save_windows(wins, prefix, fmt="bogus")


def test_load_bed2d_swaps_inverted_anchors(tmp_path):
    path = tmp_path / "pairs.bed2"
    with open(path, "w") as fh:
        fh.write("c1\t500\t600\tc1\t100\t200\n")
        fh.write("c1\t100\t200\tc2\t500\t600\n")
    bed = cio.load_bed2d(str(path))
    # intra pair swapped so start1 <= start2
    assert bed.loc[0, "start1"] == 100 and bed.loc[0, "start2"] == 500
    # inter pair untouched
    assert bed.loc[1, "start1"] == 100 and bed.loc[1, "start2"] == 500


def test_load_bed2d_with_header(tmp_path):
    path = tmp_path / "pairs.tsv"
    with open(path, "w") as fh:
        fh.write("chrom1\tstart1\tend1\tchrom2\tstart2\tend2\n")
        fh.write("c1\t100\t200\tc1\t500\t600\n")
    bed = cio.load_bed2d(str(path))
    assert len(bed) == 1


def test_check_prefix_dir(tmp_path):
    cio.check_prefix_dir(str(tmp_path / "prefix"))
    with pytest.raises(OSError):
        cio.check_prefix_dir(str(tmp_path / "nodir" / "prefix"))


def test_pixels_upper_matches_pixels_coo(example_cool):
    import numpy as np

    from chromosight_tpu.io.cool import CoolFile

    clr = CoolFile(example_cool)
    ext = clr.extent("chr2")
    n = ext[1] - ext[0]
    r, c, v = clr.pixels_coo(ext, ext, balance=True)
    dense = np.zeros((n, n))
    dense[r, c] = np.nan_to_num(v)
    ru, cu, vu = clr.pixels_upper(ext, balance=True)
    upper = np.zeros((n, n))
    upper[ru, cu] = np.nan_to_num(vu)
    i, j = np.indices((n, n))
    assert np.allclose(upper[j >= i], dense[j >= i], atol=1e-5)
    assert not upper[j < i].any()


def test_cool_group_uri(example_cool):
    from chromosight_tpu.io.cool import CoolFile

    clr = CoolFile(example_cool + "::/")
    assert clr.binsize == 1000
    assert clr.chromnames == ["chr1", "chr2", "chr3"]


def test_mcool_resolution_uri(example_mcool, example_cool):
    """Opening file.mcool::/resolutions/N reads that resolution's tables,
    matching the single-res file bit-for-bit; weight storage targets the
    selected group only."""
    flat = CoolFile(example_cool)
    for uri in (
        example_mcool + "::/resolutions/1000",
        example_mcool + "::resolutions/1000",  # cooler also accepts no "/"
    ):
        clr = CoolFile(uri)
        assert clr.binsize == 1000
        assert clr.chromnames == flat.chromnames
        assert clr.n_bins == flat.n_bins
        r0, c0, v0 = flat.pixels_coo((0, 200), (0, 200))
        r1, c1, v1 = clr.pixels_coo((0, 200), (0, 200))
        assert np.array_equal(r0, r1)
        assert np.array_equal(c0, c1)
        assert np.array_equal(v0, v1)
    other = CoolFile(example_mcool + "::/resolutions/4000")
    assert other.binsize == 4000
    # writing weights into one resolution group leaves the sibling alone
    clr = CoolFile(example_mcool + "::/resolutions/1000")
    w = np.linspace(0.5, 1.5, clr.n_bins)
    clr.store_weights(w)
    assert np.allclose(
        CoolFile(example_mcool + "::/resolutions/1000").weights, w
    )
    w4 = CoolFile(example_mcool + "::/resolutions/4000").weights
    assert w4 is None or not np.allclose(np.nan_to_num(w4), w)


def test_mcool_detect_cli(example_mcool, tmp_path):
    """End-to-end: the detect subcommand accepts an .mcool resolution URI
    and produces the same calls as the flat example.cool golden config."""
    from chromosight_tpu.cli.main import main

    prefix = str(tmp_path / "out")
    main(
        [
            "detect",
            "--no-plotting",
            "--pattern",
            "loops_small",
            example_mcool + "::/resolutions/1000",
            prefix,
        ]
    )
    got = pd.read_csv(prefix + ".tsv", sep="\t")
    import pathlib

    golden = (
        pathlib.Path(__file__).parent / "data" / "golden_detect_loops_small.tsv"
    )
    want = pd.read_csv(golden, sep="\t")
    assert got[["bin1", "bin2"]].values.tolist() == want[
        ["bin1", "bin2"]
    ].values.tolist()
