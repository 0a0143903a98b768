"""The numpy + zlib HDF5 layer against h5py, the reference implementation
of the format: what h5py writes we read identically, and what we write
h5py reads identically."""

import pathlib
import subprocess
import sys

import h5py
import numpy as np
import pytest

from chromosight_tpu.io import hdf5

REPO = pathlib.Path(__file__).parents[1]


def read_tree(group):
    """Every dataset and attribute under ``group`` as an ``hdf5.Tree``."""
    tree = hdf5.Tree(attrs=group.attrs)
    for name in group:
        child = group[name]
        if isinstance(child, hdf5.Group):
            tree[name] = read_tree(child)
        else:
            tree[name] = (child[()], child.attrs) if child.attrs else child[()]
    return tree


def _h5py_file(path, libver, compression):
    """A cooler-like file: root attributes of every kind, an enum bin
    table, chunked (optionally gzip + shuffle) 1-D and 2-D datasets,
    big-endian data, an empty and a scalar dataset, nested groups."""
    rng = np.random.default_rng(0)
    opts = {}
    if compression:
        opts = dict(
            compression="gzip", shuffle=True, chunks=(1000,), maxshape=(None,)
        )
    with h5py.File(path, "w", libver=libver) as f:
        f.attrs["format"] = "HDF5::Cooler"
        f.attrs["bin-size"] = 5000
        f.attrs["sum"] = 3.5
        f.attrs["arr"] = np.arange(4)
        f.attrs["fixed"] = np.bytes_(b"abc")
        f.attrs["metadata"] = '{"x": "é"}'
        f.create_group("chroms").create_dataset(
            "name", data=np.array([b"chr1", b"chr22"], dtype="S32")
        )
        b = f.create_group("bins")
        enum = h5py.enum_dtype({"chr1": 0, "chr22": 1}, basetype=np.int32)
        b.create_dataset(
            "chrom", data=rng.integers(0, 2, 2500).astype(np.int32),
            dtype=enum, **opts,
        )
        w = b.create_dataset("weight", data=rng.random(2500), **opts)
        w.attrs["converged"] = True
        w.attrs["var"] = 0.5
        px = f.create_group("pixels")
        px.create_dataset("bin1_id", data=rng.integers(0, 1 << 40, 12345), **opts)
        px.create_dataset(
            "count", data=rng.integers(0, 100, 12345).astype(np.int32), **opts
        )
        px.create_dataset("f32be", data=rng.random(12345).astype(">f4"), **opts)
        px.create_dataset("empty", data=np.zeros(0, np.int64))
        px.create_dataset("scalar", data=np.float64(2.5))
        two_d = dict(compression="gzip", chunks=(8, 2)) if compression else {}
        px.create_dataset("two_d", data=rng.random((37, 5)), **two_d)
        f.create_group("a/b/c").create_dataset("x", data=np.arange(3))


def _same_attrs(ref, ours, where):
    assert set(ref) == set(ours), where
    for k, x in ref.items():
        if isinstance(x, bytes):
            x = x.decode()
        assert np.array_equal(np.asarray(x), np.asarray(ours[k])), (where, k)


def _assert_reads_like_h5py(path):
    with h5py.File(path, "r") as ref, hdf5.File(path) as ours:
        _same_attrs(ref.attrs, ours.attrs, "/")
        names = []
        ref.visit(names.append)
        for name in names:
            r, o = ref[name], ours[name]
            _same_attrs(r.attrs, o.attrs, name)
            if isinstance(r, h5py.Group):
                assert set(r.keys()) == set(o.keys()), name
                continue
            assert o.shape == r.shape, name
            assert o.dtype == r.dtype.newbyteorder("="), name
            full = r[()]
            nan = np.asarray(full).dtype.kind == "f"
            assert np.array_equal(o[()], full, equal_nan=nan), name
            if r.shape and r.shape[0] > 10:
                n = r.shape[0]
                for lo, hi in [(0, 1), (3, n // 2), (n // 3, n), (n - 1, n), (5, 5)]:
                    assert np.array_equal(o[lo:hi], r[lo:hi], equal_nan=nan)
                assert np.array_equal(o[::7], r[::7], equal_nan=nan)


@pytest.mark.parametrize(
    "libver,compression",
    [("earliest", False), ("earliest", True), ("latest", False)],
)
def test_reads_what_h5py_writes(tmp_path, libver, compression):
    path = tmp_path / "f.h5"
    _h5py_file(path, libver, compression)
    _assert_reads_like_h5py(path)


def test_reads_the_example_cool(example_cool):
    _assert_reads_like_h5py(example_cool)


def test_latest_chunk_index_is_refused_by_name(tmp_path):
    path = tmp_path / "f.h5"
    _h5py_file(path, "latest", True)
    with hdf5.File(path) as f:
        with pytest.raises(NotImplementedError, match="layout message v4"):
            f["pixels/count"]


@pytest.mark.parametrize("source", ["example", "h5py"])
def test_h5py_reads_what_we_write(tmp_path, example_cool, source):
    src = example_cool
    if source == "h5py":
        src = tmp_path / "src.h5"
        _h5py_file(src, "earliest", True)
    with hdf5.File(src) as f:
        tree = read_tree(f.root)
    out = tmp_path / "out.h5"
    hdf5.write_file(out, tree)
    with h5py.File(src, "r") as a, h5py.File(out, "r") as b:
        _same_attrs(a.attrs, b.attrs, "/")
        names = []
        a.visit(names.append)
        for name in names:
            if isinstance(a[name], h5py.Dataset):
                x, y = a[name][()], b[name][()]
                nan = np.asarray(x).dtype.kind == "f"
                assert np.shape(x) == np.shape(y), name
                assert np.array_equal(x, y, equal_nan=nan), name
                for k, v in a[name].attrs.items():
                    assert np.asarray(b[name].attrs[k]) == np.asarray(v), (name, k)
    # and our reader agrees with h5py on our own file
    _assert_reads_like_h5py(out)


def test_generator_writes_a_readable_cool_without_jax(tmp_path):
    """tools/make_synthetic_cool.py runs beside a process that holds the
    card, so it must not import JAX; its output reads the same through
    h5py and the package reader, weights included."""
    out = tmp_path / "g.cool"
    code = (
        "import runpy, sys; "
        f"sys.argv = ['x', {str(out)!r}, '--bins', '600', '--chroms', '2']; "
        "runpy.run_path('tools/make_synthetic_cool.py', run_name='__main__'); "
        "print('jax imported:', 'jax' in sys.modules)"
    )
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        env={"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin"}, timeout=300,
    )
    assert r.returncode == 0, r.stderr
    assert "jax imported: False" in r.stdout
    _assert_reads_like_h5py(out)
    from chromosight_tpu.io.cool import CoolFile

    clr = CoolFile(str(out))
    assert clr.n_bins == 1200 and clr.weights is not None


def _snapshot(path):
    """{name: (value, attrs, compression, chunks)} of every dataset, by h5py."""
    out = {}
    with h5py.File(path, "r") as f:
        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                out[name] = (obj[()], dict(obj.attrs), obj.compression, obj.chunks)
        f.visititems(visit)
    return out


def _same_snapshot(a, b):
    assert set(a) == set(b)
    for name, (va, aa, ca, ka) in a.items():
        vb, ab, cb, kb = b[name]
        nan = np.asarray(va).dtype.kind == "f"
        assert np.array_equal(va, vb, equal_nan=nan), name
        assert set(aa) == set(ab), name
        assert (ca, ka) == (cb, kb), name


def test_store_dataset_appends_and_keeps_compression(tmp_path):
    """A new member is linked in place: every other dataset keeps its
    values, gzip filter and chunking, and the file grows by little more
    than the new data."""
    path = tmp_path / "f.h5"
    _h5py_file(path, "earliest", True)
    before = _snapshot(path)
    size = path.stat().st_size
    w = np.linspace(0.0, 1.0, 2500)
    hdf5.store_dataset(path, "/bins", "KR", (w, {"tol": 1e-5, "note": "é"}))
    after = _snapshot(path)
    new = after.pop("bins/KR")
    _same_snapshot(before, after)
    assert np.array_equal(new[0], w) and new[1]["tol"] == 1e-5
    assert new[1]["note"] == "é"
    assert after["pixels/count"][2:] == ("gzip", (1000,))
    assert path.stat().st_size - size < w.nbytes + 8192
    _assert_reads_like_h5py(path)


def test_store_dataset_replaces_a_member(tmp_path):
    path = tmp_path / "f.h5"
    _h5py_file(path, "earliest", True)
    w = np.arange(2500, dtype=np.float64)
    hdf5.store_dataset(path, "bins", "weight", (w, {"min_nnz": 10}))
    with h5py.File(path, "r") as f:
        assert sorted(f["bins"]) == ["chrom", "weight"]
        assert np.array_equal(f["bins/weight"][()], w)
        assert dict(f["bins/weight"].attrs) == {"min_nnz": 10}
    _assert_reads_like_h5py(path)


@pytest.mark.parametrize("names", [["a0", "a1"], ["zz", "zy"], ["m", "c5", "c55"]])
def test_store_dataset_splits_a_full_symbol_node(tmp_path, names):
    """h5py's symbol-table nodes hold 8 members: adding past that splits
    the node, whatever the new names sort before, between or after, and
    a member of a split group can still be replaced ("c5")."""
    path = tmp_path / "f.h5"
    with h5py.File(path, "w", libver="earliest") as f:
        g = f.create_group("g")
        for k in range(8):
            g.create_dataset(f"c{k}", data=np.full(3, k))
    for j, name in enumerate(names):
        hdf5.store_dataset(path, "g", name, np.full(4, 100 + j))
    with h5py.File(path, "r") as f, hdf5.File(path) as ours:
        want = sorted({f"c{k}" for k in range(8)} | set(names))
        assert sorted(f["g"]) == want == sorted(ours["g"].keys())
        for j, name in enumerate(names):
            assert np.array_equal(f["g"][name][()], np.full(4, 100 + j))
            assert np.array_equal(ours[f"g/{name}"][()], np.full(4, 100 + j))
        assert np.array_equal(f["g/c7"][()], np.full(3, 7))
    _assert_reads_like_h5py(path)


def test_store_dataset_refuses_what_it_cannot_edit(tmp_path):
    path = tmp_path / "f.h5"
    _h5py_file(path, "latest", False)
    with pytest.raises(NotImplementedError, match="superblock"):
        hdf5.store_dataset(path, "bins", "x", np.zeros(3))


def test_store_weights_reads_no_data(tmp_path, example_mcool, monkeypatch):
    """Balancing one resolution of an .mcool decodes no dataset (the
    siblings least of all) and grows the file by about the weights."""
    import shutil

    from chromosight_tpu.io.cool import CoolFile

    path = tmp_path / "m.mcool"
    shutil.copy(example_mcool, path)
    before = _snapshot(path)
    clr = CoolFile(f"{path}::/resolutions/1000")
    w = np.linspace(0.5, 1.5, clr.n_bins)
    size = path.stat().st_size

    def refuse(*_a, **_k):
        raise AssertionError("dataset decoded")

    monkeypatch.setattr(hdf5.Dataset, "_read", refuse)
    clr.store_weights(w, stats={"converged": True})
    monkeypatch.undo()
    assert path.stat().st_size - size < w.nbytes + 8192
    after = _snapshot(path)
    assert np.array_equal(after["resolutions/1000/bins/weight"][0], w)
    for name in before:
        if name != "resolutions/1000/bins/weight":
            assert name in after
    _same_snapshot(
        {k: v for k, v in before.items() if k != "resolutions/1000/bins/weight"},
        {k: v for k, v in after.items() if k != "resolutions/1000/bins/weight"},
    )
