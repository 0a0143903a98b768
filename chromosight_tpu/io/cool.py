"""Minimal, fast .cool (HDF5::Cooler) reader/writer built on ``io.hdf5``.

The reference implementation delegates all cool access to the ``cooler``
package (reference ``utils/contacts_map.py:129``, ``utils/io.py:51``).  This
framework reads the HDF5 layout directly: the pixel table is CSR-indexed by
``indexes/bin1_offset``, which lets us slice row ranges without scanning the
whole file, and rectangle queries return COO triplets that are scattered
straight into dense device tensors.

Cool layout (format-version 3):
    chroms/{name,length}
    bins/{chrom,start,end[,weight]}
    pixels/{bin1_id,bin2_id,count}
    indexes/{chrom_offset,bin1_offset}
with ``storage-mode: symmetric-upper`` - only the upper triangle is stored.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pandas as pd

from chromosight_tpu.io import hdf5


class CoolFile:
    """Handle to a single-resolution .cool file.

    API loosely mirrors ``cooler.Cooler`` for the subset the framework needs:
    ``binsize``, ``chromnames``, ``shape``, ``info``, ``bins()``, ``chroms()``,
    ``extent(chrom)``, plus rectangle pixel queries and weight storage.
    """

    def __init__(self, path):
        self.path = str(path)
        # Group prefix support for "file.cool::/path" URIs (single-res files
        # use the root group).
        if "::" in self.path:
            self.path, self.group = self.path.split("::", 1)
        else:
            self.group = "/"
        with hdf5.File(self.path) as f:
            g = f[self.group]
            attrs = dict(g.attrs)
            self._chrom_names = [
                n.decode() if isinstance(n, bytes) else str(n)
                for n in g["chroms/name"][:]
            ]
            self._chrom_lengths = g["chroms/length"][:].astype(np.int64)
            self._chrom_offset = g["indexes/chrom_offset"][:].astype(np.int64)
            self._bin1_offset = g["indexes/bin1_offset"][:].astype(np.int64)
            self._bin_chrom_ids = g["bins/chrom"][:].astype(np.int64)
            self._bin_start = g["bins/start"][:].astype(np.int64)
            self._bin_end = g["bins/end"][:].astype(np.int64)
            self._has_weight = "weight" in g["bins"]
            self._weight = (
                g["bins/weight"][:].astype(np.float64)
                if self._has_weight
                else None
            )
            self._nnz = int(g["pixels/count"].shape[0])
        self.info = attrs
        binsize = attrs.get("bin-size", None)
        self.binsize = int(binsize) if binsize is not None else None
        self.n_bins = int(self._bin1_offset.shape[0] - 1)

    # ------------------------------------------------------------------ #
    # Metadata accessors
    # ------------------------------------------------------------------ #
    @property
    def chromnames(self):
        return list(self._chrom_names)

    @property
    def shape(self):
        return (self.n_bins, self.n_bins)

    @property
    def nnz(self):
        return self._nnz

    def chroms(self):
        """Chromosome table as a DataFrame (name, length)."""
        return pd.DataFrame(
            {"name": self._chrom_names, "length": self._chrom_lengths}
        )

    def bins(self):
        """Bin table as a DataFrame (chrom, start, end[, weight])."""
        chrom = pd.Categorical.from_codes(
            self._bin_chrom_ids, categories=self._chrom_names
        )
        table = {"chrom": chrom, "start": self._bin_start, "end": self._bin_end}
        if self._has_weight:
            table["weight"] = self._weight
        return pd.DataFrame(table)

    def extent(self, chrom):
        """(first_bin, last_bin_exclusive) of a chromosome."""
        cid = self._chrom_names.index(chrom)
        return int(self._chrom_offset[cid]), int(self._chrom_offset[cid + 1])

    @property
    def weights(self):
        return self._weight

    # ------------------------------------------------------------------ #
    # Pixel queries
    # ------------------------------------------------------------------ #
    def _raw_bbox(self, s1, e1, s2, e2):
        """COO triplets of stored (upper-triangle) pixels with
        bin1 in [s1, e1) and bin2 in [s2, e2).  No mirroring."""
        with hdf5.File(self.path) as f:
            g = f[self.group]
            lo = int(self._bin1_offset[s1])
            hi = int(self._bin1_offset[e1])
            if hi <= lo:
                z = np.zeros(0, dtype=np.int64)
                return z, z, np.zeros(0, dtype=np.float64)
            b1 = g["pixels/bin1_id"][lo:hi].astype(np.int64)
            b2 = g["pixels/bin2_id"][lo:hi].astype(np.int64)
            ct = g["pixels/count"][lo:hi].astype(np.float64)
        keep = (b2 >= s2) & (b2 < e2)
        return b1[keep], b2[keep], ct[keep]

    def pixels_coo(self, extent1, extent2, balance=False):
        """Fetch a rectangle of the symmetric contact matrix as COO triplets
        in *local* submatrix coordinates.

        Replicates cooler's matrix selector semantics
        (reference ``utils/contacts_map.py:529``): the stored upper triangle
        is mirrored so the returned rectangle is dense-symmetric; when
        ``balance`` is True, counts are multiplied by the weight of both
        bins (NaN weights propagate to NaN values).

        Returns (rows, cols, values) with rows in [0, e1-s1), cols in
        [0, e2-s2).
        """
        s1, e1 = extent1
        s2, e2 = extent2
        r1, c1, v1 = self._raw_bbox(s1, e1, s2, e2)
        # Mirrored contributions: stored (i, j) with i<j also represents
        # (j, i). Query the transposed bbox and swap.
        r2, c2, v2 = self._raw_bbox(s2, e2, s1, e1)
        off_diag = r2 != c2
        rows = np.concatenate([r1, c2[off_diag]])
        cols = np.concatenate([c1, r2[off_diag]])
        vals = np.concatenate([v1, v2[off_diag]])
        # Drop duplicate diagonal entries when the two bbox queries overlap
        # (intra rectangle): keep a single copy of each (i, i) pixel coming
        # from the first query; the mirrored query excluded the diagonal, but
        # overlapping off-diagonal pixels (i<j and j>i both inside the
        # rectangle) are distinct matrix cells, so no dedup needed there.
        if balance:
            if self._weight is None:
                raise ValueError(
                    "No 'weight' column in cool file; balance it first "
                    "(norm=force) or use raw values."
                )
            vals = vals * self._weight[rows] * self._weight[cols]
        return rows - s1, cols - s2, vals

    def pixels_upper(self, extent, balance=False, dtype=np.float32,
                     max_diag=None):
        """Upper-triangle-only intra fetch in *local* coordinates.

        Fast path feeding the diagonal-band engine, which never reads the
        mirrored lower triangle: skips the transpose query, the mirror
        concatenation, and half the balancing gathers of
        :meth:`pixels_coo`.  Values are returned in ``dtype`` (float32 by
        default - the device compute precision).
        """
        s, e = extent
        with hdf5.File(self.path) as f:
            g = f[self.group]
            lo = int(self._bin1_offset[s])
            hi = int(self._bin1_offset[e])
            if hi <= lo:
                z = np.zeros(0, dtype=np.int64)
                return z, z, np.zeros(0, dtype=dtype)
            b1 = g["pixels/bin1_id"][lo:hi]
            b2 = g["pixels/bin2_id"][lo:hi]
            ct = g["pixels/count"][lo:hi]
        keep = b2 < e
        if max_diag is not None:
            # scan-band filter: drop pixels the band engine would discard
            keep &= (b2 - b1) < max_diag
        if not keep.all():
            b1, b2, ct = b1[keep], b2[keep], ct[keep]
        vals = ct.astype(dtype)
        if balance:
            if self._weight is None:
                raise ValueError(
                    "No 'weight' column in cool file; balance it first "
                    "(norm=force) or use raw values."
                )
            w = self._weight.astype(dtype)
            vals = vals * w[b1] * w[b2]
        return b1 - s, b2 - s, vals

    def band_upper(self, extent, width, balance=False, n_rows=None):
        """Upper-band tensor B[i, d] = M[s+i, s+i+d], d in [0, width).

        The fused fast path feeding the diagonal-band engine: the raw
        pixel-table slice is filtered to the scan band, balanced, and
        scattered into the float32 band in a single native pass — no
        intermediate COO copies, boolean-mask filters, or dtype casts
        (each of which is a full per-pixel sweep at genome scale).

        ``n_rows`` >= e-s allocates extra zero rows so the returned band
        is already padded to its device shape bucket.
        """
        s, e = extent
        n = e - s
        if n_rows is None:
            n_rows = n
        if balance and self._weight is None:
            raise ValueError(
                "No 'weight' column in cool file; balance it first "
                "(norm=force) or use raw values."
            )
        with hdf5.File(self.path) as f:
            g = f[self.group]
            lo = int(self._bin1_offset[s])
            hi = int(self._bin1_offset[e])
            if hi <= lo:
                return np.zeros((n_rows, width), dtype=np.float32)
            b1 = g["pixels/bin1_id"][lo:hi]
            b2 = g["pixels/bin2_id"][lo:hi]
            ct = g["pixels/count"][lo:hi]
        from chromosight_tpu import native

        band = native.band_scatter_fused(
            b1, b2, ct, self._weight if balance else None, s, e, width,
            n_rows=n_rows,
        )
        if band is not None:
            return band
        # numpy fallback (no native toolchain): the staged equivalent
        d = b2.astype(np.int64) - b1.astype(np.int64)
        keep = (d >= 0) & (d < width) & (b2 < e)
        b1, d, ct = b1[keep], d[keep], ct[keep]
        vals = ct.astype(np.float32)
        if balance:
            w = self._weight
            vals = (
                ct.astype(np.float64) * w[b1] * w[b1 + d]
            ).astype(np.float32)
        band = np.zeros((n_rows, width), dtype=np.float32)
        band[b1 - s, d] = vals
        return band

    def band_upper_counts(self, extent, width, n_rows=None):
        """Upper-band tensor of RAW counts as uint16 — the half-byte-width
        upload path: the device multiplies in the balancing weights and
        casts to f32 (``ops.band.band_weighted_finalize``), so values stay
        exact while the host ships (and memsets) half the bytes of
        :meth:`band_upper`.

        Returns None when the native tier is unavailable, the stored
        count dtype is not integral, or a count overflows uint16 —
        callers fall back to :meth:`band_upper`.

        bin1 ids are implied by the file's CSR ``bin1_offset`` index, so
        the ``pixels/bin1_id`` dataset is never read at all — one third
        of the pixel-table bytes skipped on the fetch path.
        """
        out = self.band_upper_counts_auto(
            extent, width, n_rows=n_rows, allow_u8=False
        )
        return None if out is None else out[1]

    def band_upper_counts_auto(
        self, extent, width, n_rows=None, allow_u8=True, allow_u4=True
    ):
        """Count-band fetch picking the narrowest exact representation:
        ``("u4", head_u8, tail_packed, exc_idx, exc_val)`` for wide
        bands whose far-diagonal counts (minus a short exception list
        for values > 15) fit one nibble, else ``("u8", band_u8,
        exc_idx, exc_val)`` when the counts (minus exceptions > 255)
        fit one byte, else ``("u16", band_u16)``, else None (caller
        ships the f32 band).  The pixel table is read ONCE —
        eligibility is checked before the read, and the u4 -> u8 ->
        u16 fallbacks re-scatter the in-memory slices instead of
        re-fetching."""
        from chromosight_tpu import native

        # Check eligibility BEFORE touching the pixel table: a fallback
        # after the read would make the caller re-fetch the same slices
        # through band_upper — double the chromosome's pixel IO.
        if native.get_lib() is None:
            return None
        s, e = extent
        n = e - s
        if n_rows is None:
            n_rows = n
        supported = tuple(
            np.dtype(t) for t in (np.int32, np.int64, np.float32, np.float64)
        )
        with hdf5.File(self.path) as f:
            g = f[self.group]
            if g["pixels/count"].dtype not in supported:
                return None
            lo = int(self._bin1_offset[s])
            hi = int(self._bin1_offset[e])
            if hi <= lo:
                return ("u16", np.zeros((n_rows, width), dtype=np.uint16))
            b2 = g["pixels/bin2_id"][lo:hi]
            ct = g["pixels/count"][lo:hi]

        indptr = self._bin1_offset[s : e + 1]
        if allow_u4 and allow_u8:
            # Split u8-head / nibble-packed-tail: only worth a distinct
            # finalize program when the tail is a sizable share of the
            # band (wide genome-scale scan bands).
            d0 = int(os.environ.get("CHROMOSIGHT_TPU_U4_HEAD", "64"))
            if 0 < d0 <= width // 2:
                out = native.band_scatter_counts_u4_indptr(
                    indptr, b2, ct, s, e, width, d0, n_rows=n_rows
                )
                if out is not None:
                    return ("u4",) + out
        if allow_u8:
            out = native.band_scatter_counts_u8_indptr(
                indptr, b2, ct, s, e, width, n_rows=n_rows
            )
            if out is not None:
                return ("u8",) + out
        band = native.band_scatter_counts_indptr(
            indptr, b2, ct, s, e, width, n_rows=n_rows
        )
        return None if band is None else ("u16", band)

    def row_slice_raw(self, s, e):
        """Raw pixel-table slice for rows [s, e): ``(indptr, b2, ct)`` in
        the file's STORED dtypes (no casts — int32-id cool files stream
        cast-free into the native kernels).  ``indptr`` is the absolute
        ``bin1_offset[s : e+1]`` slice; bin1 ids are implied by it and
        never read."""
        with hdf5.File(self.path) as f:
            g = f[self.group]
            lo = int(self._bin1_offset[s])
            hi = int(self._bin1_offset[e])
            b2 = g["pixels/bin2_id"][lo:hi]
            ct = g["pixels/count"][lo:hi]
        return self._bin1_offset[s : e + 1], b2, ct

    def trans_coo_raw(self, extent1, extent2, balance=False):
        """Stored-dtype trans (inter) rectangle fetch in local coordinates.

        Fast path replacing :meth:`pixels_coo` for chromosome pairs whose
        row range lies strictly below the column range (every trans pair
        of an upper-triangle cool): the stored triangle holds the whole
        rectangle, so the mirror query is provably empty — its full-slab
        read of the column chromosome's pixel rows is skipped, along
        with the int64/f64 cast sweeps.  Filtering and the balancing
        weight product run in one parallel native pass
        (``native.trans_coo_balanced``); values return as float32 (the
        device compute precision, same as the cis band path).

        Returns (rows_i32, cols_i32, vals_f32), or None when the ranges
        overlap or the native library is unavailable (callers fall back
        to :meth:`pixels_coo`).
        """
        s1, e1 = extent1
        s2, e2 = extent2
        if e1 > s2:
            return None
        if balance and self._weight is None:
            raise ValueError(
                "No 'weight' column in cool file; balance it first "
                "(norm=force) or use raw values."
            )
        from chromosight_tpu import native

        if native.get_lib() is None:
            return None
        with hdf5.File(self.path) as f:
            g = f[self.group]
            lo = int(self._bin1_offset[s1])
            hi = int(self._bin1_offset[e1])
            if hi <= lo:
                z = np.zeros(0, dtype=np.int32)
                return z, z, np.zeros(0, dtype=np.float32)
            b2 = g["pixels/bin2_id"][lo:hi]
            ct = g["pixels/count"][lo:hi]
        w1 = w2 = None
        if balance:
            w1 = self._weight[s1:e1]
            w2 = self._weight[s2:e2]
        return native.trans_coo_balanced(
            self._bin1_offset[s1 : e1 + 1], b2, ct, s2, e2, w1, w2
        )

    def pixel_chunks(self, chunksize=10_000_000):
        """Iterate over the whole pixel table in chunks of COO triplets."""
        with hdf5.File(self.path) as f:
            g = f[self.group]
            n = self._nnz
            for lo in range(0, n, int(chunksize)):
                hi = min(lo + int(chunksize), n)
                # asarray: no copy when the stored dtype already matches
                yield (
                    np.asarray(g["pixels/bin1_id"][lo:hi], dtype=np.int64),
                    np.asarray(g["pixels/bin2_id"][lo:hi], dtype=np.int64),
                    np.asarray(g["pixels/count"][lo:hi], dtype=np.float64),
                )

    # ------------------------------------------------------------------ #
    # Weight storage (ICE balancing writes back into the file, mirroring
    # cooler.balance_cooler(store=True) - reference contacts_map.py:209-219)
    # ------------------------------------------------------------------ #
    def store_weights(self, weights, name="weight", stats=None):
        """Store ``weights`` as ``bins/<name>`` (with ``stats`` as its
        attributes), replacing an earlier one.  The file is edited in
        place (:func:`hdf5.store_dataset`): the weights are appended and
        linked into the bins group; no other data is read or rewritten."""
        weights = np.asarray(weights, dtype=np.float64)
        if weights.shape[0] != self.n_bins:
            raise ValueError("weights length must equal number of bins")
        hdf5.store_dataset(
            self.path, f"{self.group.rstrip('/')}/bins", name,
            (weights, dict(stats or {})),
        )
        self._weight = weights
        self._has_weight = True


def load_cool(cool_path):
    """Read a cool file into a whole-genome COO matrix plus metadata tables.

    Mirrors the reference ``utils/io.py:20-78``: returns the upper-triangle
    matrix as a ``scipy.sparse.coo_matrix`` (like the reference, so user
    code doing ``mat.tocsr()`` etc. is portable), a chromosome table with
    start_bin/end_bin columns, the bin table, and the resolution.

    Returns
    -------
    mat : scipy.sparse.coo_matrix
        Upper-triangle whole genome contact matrix.
    chroms : pandas.DataFrame with name, length, start_bin, end_bin.
    bins : pandas.DataFrame with chrom, start, end.
    bin_size : int
    """
    import scipy.sparse as sp

    clr = CoolFile(cool_path)
    if clr.binsize is None:
        raise ValueError("The cool file must have equally sized bins")
    rows_l, cols_l, vals_l = [], [], []
    for b1, b2, ct in clr.pixel_chunks():
        rows_l.append(b1)
        cols_l.append(b2)
        vals_l.append(ct)
    rows = np.concatenate(rows_l) if rows_l else np.zeros(0, np.int64)
    cols = np.concatenate(cols_l) if cols_l else np.zeros(0, np.int64)
    vals = np.concatenate(vals_l) if vals_l else np.zeros(0, np.float64)
    # Keep the upper triangle only (files are symmetric-upper already, but a
    # square file written by other tools may include both triangles).
    keep = cols >= rows
    rows, cols, vals = rows[keep], cols[keep], vals[keep]
    n = clr.n_bins
    chroms = clr.chroms()
    chroms["start_bin"] = clr._chrom_offset[:-1]
    chroms["end_bin"] = clr._chrom_offset[1:]
    bins = clr.bins()[["chrom", "start", "end"]]
    mat = sp.coo_matrix((vals, (rows, cols)), shape=(n, n))
    return mat, chroms, bins, clr.binsize


def create_cool(
    path, bins, pixels, assembly="unknown", metadata=None, minimal_dtypes=True
):
    """Write a minimal single-resolution .cool file (used by tests and the
    synthetic-data tooling; the reference relies on ``cooler.create_cooler``).

    Parameters
    ----------
    path : str
    bins : pandas.DataFrame with columns chrom, start, end (and optionally
        weight).
    pixels : pandas.DataFrame with columns bin1_id, bin2_id, count
        (upper triangle).
    minimal_dtypes : bool
        When True (default), pixel id/count columns are stored in the
        narrowest lossless integer dtype (int32 when they fit) — half
        the bytes the IO-bound genome scan streams.  Dtype-agnostic
        readers (ours, cooler's) read these fine; pass False to
        emit the canonical int64 columns ``cooler.create_cooler``
        writes, for strict cooler-schema consumers.
    """
    bins = bins.reset_index(drop=True)
    chrom_names = list(pd.unique(bins["chrom"].astype(str)))
    name_to_id = {n: i for i, n in enumerate(chrom_names)}
    chrom_ids = bins["chrom"].astype(str).map(name_to_id).to_numpy(np.int32)
    lengths = (
        bins.groupby(bins["chrom"].astype(str), sort=False)["end"]
        .max()
        .reindex(chrom_names)
        .to_numpy(np.int64)
    )
    n_bins = len(bins)
    # chrom_offset / bin1_offset CSR indexes
    chrom_offset = np.zeros(len(chrom_names) + 1, dtype=np.int64)
    for cid in chrom_ids:
        chrom_offset[cid + 1] += 1
    chrom_offset = np.cumsum(chrom_offset)

    pixels = pixels.sort_values(["bin1_id", "bin2_id"]).reset_index(drop=True)
    b1 = pixels["bin1_id"].to_numpy(np.int64)
    b2 = pixels["bin2_id"].to_numpy(np.int64)
    ct = pixels["count"].to_numpy()
    bin1_offset = np.zeros(n_bins + 1, dtype=np.int64)
    np.add.at(bin1_offset, b1 + 1, 1)
    bin1_offset = np.cumsum(bin1_offset)

    sizes = bins["end"].to_numpy(np.int64) - bins["start"].to_numpy(np.int64)
    binsize = int(np.bincount(sizes).argmax()) if len(sizes) else 0

    # Minimal storage dtypes: readers (ours and cooler's) are
    # dtype-agnostic, and the pixel table dominates both the file size
    # and every fetch — int32 ids halve the bytes the IO-bound genome
    # scan streams vs int64 (real genomes have << 2^31 bins).
    id_dtype = (
        np.int32
        if minimal_dtypes and n_bins <= np.iinfo(np.int32).max
        else np.int64
    )
    if (
        minimal_dtypes
        and np.issubdtype(ct.dtype, np.integer)
        and ct.size
        and ct.max() <= np.iinfo(np.int32).max
        and ct.min() >= 0
    ):
        ct = ct.astype(np.int32)
    bins_tree = hdf5.Tree(
        chrom=chrom_ids,
        start=bins["start"].to_numpy(np.int32),
        end=bins["end"].to_numpy(np.int32),
    )
    if "weight" in bins.columns:
        bins_tree["weight"] = bins["weight"].to_numpy(np.float64)
    tree = hdf5.Tree(
        chroms=hdf5.Tree(
            name=np.array(chrom_names, dtype="S32"),
            length=lengths.astype(np.int32),
        ),
        bins=bins_tree,
        pixels=hdf5.Tree(
            bin1_id=b1.astype(id_dtype),
            bin2_id=b2.astype(id_dtype),
            count=ct,
        ),
        indexes=hdf5.Tree(chrom_offset=chrom_offset, bin1_offset=bin1_offset),
        attrs={
            "format": "HDF5::Cooler",
            "format-version": "3",
            "format-url": "https://github.com/mirnylab/cooler",
            "bin-type": "fixed",
            "bin-size": binsize,
            "storage-mode": "symmetric-upper",
            "nbins": n_bins,
            "nchroms": len(chrom_names),
            "nnz": len(b1),
            "sum": float(ct.sum()),
            "genome-assembly": assembly,
            "generated-by": "chromosight-tpu",
            "metadata": json.dumps(metadata or {}),
        },
    )
    hdf5.write_file(path, tree)
    return path
