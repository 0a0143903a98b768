"""Generate coordinate-level golden outputs from the REFERENCE implementation.

Runs the actual reference CLI code (/root/reference, koszullab/chromosight
v1.6.3) on ``data_test/example.cool`` and vendors the resulting detect and
quantify tsv tables under ``tests/data/``.  The reference's cooler and
docopt dependencies are not installed in this environment, so minimal shims
are injected: docopt is import-stubbed (we call ``cmd_detect``/
``cmd_quantify`` directly with the docopt-style dict), and cooler.Cooler is
backed by this package's own CoolFile reader with cooler's matrix-selector
semantics (symmetric slice, weights applied as w[i]*w[j], NaN propagated
for undetectable bins).

Usage: python tools/gen_reference_golden.py [outdir]

The vendored outputs are diffed against this package's CLI in
tests/test_golden_outputs.py (bin1/bin2 equality + score/p-value closeness).
"""

import pathlib
import sys
import types

import numpy as np
import pandas as pd
import scipy.sparse as sp

REPO = pathlib.Path(__file__).resolve().parents[1]
REFERENCE = "/root/reference"


# --------------------------------------------------------------------- #
# cooler shim backed by chromosight_tpu.io.cool.CoolFile
# --------------------------------------------------------------------- #
class _TableSelector:
    """Mimics cooler's lazy table selector: sel[:] -> DataFrame,
    sel['weight'] -> Series."""

    def __init__(self, df):
        self._df = df

    def __getitem__(self, key):
        if isinstance(key, str):
            return self._df[key]
        return self._df.iloc[key]

    def __contains__(self, key):
        return key in self._df.columns


class _MatrixSelector:
    """Mimics clr.matrix(sparse=True, balance=...): slicing returns the
    symmetric submatrix as COO with weights applied (NaN where a bin's
    weight is NaN), or raw integer counts when balance is False."""

    def __init__(self, sym_csr, weights, balance):
        self._csr = sym_csr
        self._weights = weights
        self._balance = balance

    def __getitem__(self, key):
        rs, cs = key
        sub = self._csr[rs, cs].tocoo()
        if not self._balance:
            return sub
        w = self._weights
        if w is None:
            raise ValueError("no weights stored; balance requested")
        wr = w[np.arange(self._csr.shape[0])[rs]]
        wc = w[np.arange(self._csr.shape[1])[cs]]
        data = sub.data * wr[sub.row] * wc[sub.col]
        return sp.coo_matrix(
            (data, (sub.row, sub.col)), shape=sub.shape
        )


class _CoolerShim:
    def __init__(self, path):
        from chromosight_tpu.io.cool import CoolFile

        self._cf = CoolFile(path)
        self.binsize = self._cf.binsize
        self.shape = self._cf.shape
        self.chromnames = self._cf.chromnames
        b1s, b2s, cts = [], [], []
        for b1, b2, ct in self._cf.pixel_chunks(50_000_000):
            b1s.append(b1), b2s.append(b2), cts.append(ct)
        b1 = np.concatenate(b1s)
        b2 = np.concatenate(b2s)
        ct = np.concatenate(cts).astype(np.float64)
        n = self._cf.n_bins
        upper = sp.coo_matrix((ct, (b1, b2)), shape=(n, n)).tocsr()
        diag = sp.diags(upper.diagonal())
        self._sym = (upper + upper.T - diag).tocsr()
        self.info = {"sum": int(ct.sum())}

    def bins(self):
        return _TableSelector(self._cf.bins())

    def chroms(self):
        return _TableSelector(self._cf.chroms())

    def extent(self, chrom):
        return self._cf.extent(chrom)

    def matrix(self, sparse=True, balance=True):
        assert sparse, "shim supports sparse selectors only"
        w = self._cf.weights if balance else None
        return _MatrixSelector(self._sym, w, bool(balance))


def install_shims():
    cooler_mod = types.ModuleType("cooler")
    cooler_mod.Cooler = _CoolerShim

    def balance_cooler(*a, **k):
        raise NotImplementedError(
            "shim: balancing not supported; use a pre-balanced cool"
        )

    cooler_mod.balance_cooler = balance_cooler
    sys.modules["cooler"] = cooler_mod

    docopt_mod = types.ModuleType("docopt")

    def _docopt(*a, **k):
        raise NotImplementedError("shim: call cmd_* directly")

    docopt_mod.docopt = _docopt
    docopt_mod.DocoptExit = SystemExit
    sys.modules["docopt"] = docopt_mod


# The reference targets pandas<2; under pandas 3 Copy-on-Write its chained
# assignments are silent no-ops that would corrupt the golden outputs.
# Each entry rewrites one such line to the equivalent .loc form in a
# PATCHED COPY of the reference tree (never the read-only original).
# (file, old, new, count)
_PANDAS3_EDITS = [
    (
        "chromosight/utils/detection.py",
        "validated_coords.score[i] = conv_mat[p1, p2]",
        'validated_coords.loc[i, "score"] = conv_mat[p1, p2]',
        1,
    ),
    (
        "chromosight/utils/contacts_map.py",
        "sub_mats.contact_map[sub_mat_idx] = ContactMap(",
        'sub_mats.loc[sub_mat_idx, "contact_map"] = ContactMap(',
        2,
    ),
    (
        "chromosight/utils/contacts_map.py",
        "sub_mats.chr1[sub_mat_idx] = chr1",
        'sub_mats.loc[sub_mat_idx, "chr1"] = chr1',
        1,
    ),
    (
        "chromosight/utils/contacts_map.py",
        "sub_mats.chr2[sub_mat_idx] = chr2",
        'sub_mats.loc[sub_mat_idx, "chr2"] = chr2',
        1,
    ),
    (
        "chromosight/cli/chromosight.py",
        "bed2d_out[kernel_id]['score'][sub_pat_idx] = r['coords'].score.values",
        "bed2d_out[kernel_id].loc[sub_pat_idx, 'score'] = r['coords'].score.values",
        1,
    ),
    (
        "chromosight/cli/chromosight.py",
        'bed2d_out[kernel_id]["pvalue"][sub_pat_idx] = r["coords"].pvalue.values',
        'bed2d_out[kernel_id].loc[sub_pat_idx, "pvalue"] = r["coords"].pvalue.values',
        1,
    ),
    (
        "chromosight/utils/io.py",
        """    bed2d.start1[inverted], bed2d.start2[inverted] = (
        bed2d.start2[inverted],
        bed2d.start1[inverted],
    )
    bed2d.end1[inverted], bed2d.end2[inverted] = (
        bed2d.end2[inverted],
        bed2d.end1[inverted],
    )""",
        """    bed2d.loc[inverted, ["start1", "start2"]] = bed2d.loc[
        inverted, ["start2", "start1"]
    ].values
    bed2d.loc[inverted, ["end1", "end2"]] = bed2d.loc[
        inverted, ["end2", "end1"]
    ].values""",
        1,
    ),
]


def make_patched_reference(tmpdir):
    """Copy the reference package into tmpdir and apply the pandas-3
    compatibility edits, failing loudly if any expected line is absent."""
    import shutil

    dst = pathlib.Path(tmpdir) / "refsrc"
    shutil.copytree(
        pathlib.Path(REFERENCE) / "chromosight", dst / "chromosight"
    )
    for rel, old, new, count in _PANDAS3_EDITS:
        p = dst / rel
        text = p.read_text()
        found = text.count(old)
        if found != count:
            raise RuntimeError(
                f"patch target not found ({found} != {count}): {rel}: {old}"
            )
        p.write_text(text.replace(old, new))
    return str(dst)


BASE_ARGS = {
    "detect": False,
    "quantify": False,
    "generate-config": False,
    "list-kernels": False,
    "test": False,
    "<contact_map>": None,
    "<prefix>": None,
    "<bed2d>": None,
    "--pattern": "loops",
    "--kernel-config": None,
    "--pearson": "auto",
    "--win-size": "auto",
    "--iterations": "auto",
    "--win-fmt": "json",
    "--norm": "auto",
    "--subsample": None,
    "--inter": False,
    "--tsvd": False,
    "--smooth-trend": False,
    "--n-mads": "5",
    "--min-dist": "auto",
    "--max-dist": "auto",
    "--no-plotting": True,
    "--min-separation": "auto",
    "--dump": None,
    "--threads": "1",
    "--perc-zero": "auto",
    "--perc-undetected": "auto",
}


def main():
    outdir = pathlib.Path(
        sys.argv[1] if len(sys.argv) > 1 else REPO / "tests" / "data"
    )
    outdir.mkdir(parents=True, exist_ok=True)
    import os
    import warnings

    os.environ.setdefault("MPLBACKEND", "Agg")
    # The reference targets pandas<2: restore object-dtype inference for
    # its str-typed frames.
    pd.set_option("future.infer_string", False)
    install_shims()
    import tempfile as _tf

    _patched_dir = _tf.mkdtemp(prefix="refsrc_")
    sys.path.insert(0, make_patched_reference(_patched_dir))
    import chromosight.cli.chromosight as refcli

    # detection.py wipes warning filters at import; re-escalate so any
    # REMAINING Copy-on-Write chained assignment fails the run instead of
    # silently corrupting the goldens.
    warnings.simplefilter("error", pd.errors.ChainedAssignmentError)

    cool = str(REPO / "data_test" / "example.cool")
    bed2 = str(REPO / "data_test" / "example.bed2")

    import tempfile

    # (name, extra detect args) — each produces golden_detect_<name>.tsv
    DETECT_CONFIGS = [
        ("loops", {}),
        ("loops_iter2", {"--iterations": "2"}),
        ("loops_win21", {"--win-size": "21"}),
        ("loops_smooth", {"--smooth-trend": True}),
        ("loops_inter", {"--inter": True}),
        ("borders", {"--pattern": "borders"}),
        ("loops_small", {"--pattern": "loops_small"}),
        ("hairpins", {"--pattern": "hairpins"}),
        ("stripes_left", {"--pattern": "stripes_left"}),
        ("stripes_right", {"--pattern": "stripes_right"}),
        # centromeres (81x81 kernel, pearson .5) finds nothing on the
        # yeast fixture: the reference prints "No pattern detected !
        # Exiting." and sys.exits 0 without writing a tsv (cli:795-797).
        # That outcome is asserted directly in
        # tests/test_chromosight.py::test_detect_centromeres_no_patterns.
        ("centromeres", {"--pattern": "centromeres"}),
        ("loops_tsvd", {"--tsvd": True}),
        ("loops_raw", {"--norm": "raw"}),
        ("loops_maxdist", {"--max-dist": "100000"}),
        ("loops_mindist", {"--min-dist": "40000"}),
        ("loops_perczero", {"--perc-zero": "5"}),
        ("loops_percundetected", {"--perc-undetected": "20"}),
    ]
    with tempfile.TemporaryDirectory() as td:
        for name, extra in DETECT_CONFIGS:
            prefix = str(pathlib.Path(td) / f"golden_detect_{name}")
            args = dict(BASE_ARGS)
            args.update(
                {"detect": True, "<contact_map>": cool, "<prefix>": prefix}
            )
            args.update(extra)
            try:
                refcli.cmd_detect(args)
            except SystemExit as exc:
                # "No pattern detected ! Exiting." path — nothing to vendor.
                print(f"detect[{name}] exited {exc.code} without patterns")
                continue
            for ext in ("tsv",) + (("json",) if name == "loops" else ()):
                src = pathlib.Path(f"{prefix}.{ext}")
                (outdir / f"golden_detect_{name}.{ext}").write_bytes(
                    src.read_bytes()
                )
            print(f"detect[{name}] done")

        # --dump stage snapshots (reference detection.py:227-231,264-285 and
        # contacts_map.py DumpMatrix stages): vendor the npz files so the
        # package's per-stage matrices can be diffed, not just the
        # final coordinate tables.  --iterations 1 keeps one deterministic
        # snapshot per stage (later iterations overwrite with
        # refined-kernel outputs in both implementations).
        ref_dump = pathlib.Path(td) / "refdump"
        ref_dump.mkdir()
        args = dict(BASE_ARGS)
        args.update(
            {
                "detect": True,
                "<contact_map>": cool,
                "<prefix>": str(pathlib.Path(td) / "golden_dump"),
                "--dump": str(ref_dump),
                "--iterations": "1",
            }
        )
        refcli.cmd_detect(args)
        dump_out = outdir / "golden_dump"
        dump_out.mkdir(exist_ok=True)
        n_dumped = 0
        for f in sorted(ref_dump.glob("*.npz")):
            (dump_out / f.name).write_bytes(f.read_bytes())
            n_dumped += 1
        print(f"dump[loops] vendored {n_dumped} stage snapshots")

        QUANTIFY_CONFIGS = [
            ("loops", {}),
            # 3-kernel config: pins the multi-kernel quantify merge
            # (best score per coordinate across kernels, ref cli:431-439)
            ("borders", {"--pattern": "borders"}),
        ]
        for name, extra in QUANTIFY_CONFIGS:
            prefix = str(pathlib.Path(td) / f"golden_quantify_{name}")
            args = dict(BASE_ARGS)
            args.update(
                {
                    "quantify": True,
                    "<contact_map>": cool,
                    "<prefix>": prefix,
                    "<bed2d>": bed2,
                }
            )
            args.update(extra)
            refcli.cmd_quantify(args)
            (outdir / f"golden_quantify_{name}.tsv").write_bytes(
                pathlib.Path(f"{prefix}.tsv").read_bytes()
            )
            print(f"quantify[{name}] done")
    print(f"golden outputs written to {outdir}")


if __name__ == "__main__":
    main()
