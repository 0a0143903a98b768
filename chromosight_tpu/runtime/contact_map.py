"""Per-chromosome-pair contact map with on-device preprocessing.

Mirrors the reference ``ContactMap`` (``contacts_map.py:453-638``) but the
matrix lives as a dense float tensor: intra maps are detrended by the
distance law and trimmed to the scanning band on device (XLA), inter maps
are median-scaled.  The scipy-sparse ``matrix`` attribute is kept available
lazily for API compatibility and the --dump subsystem.
"""

from __future__ import annotations

import os

import numpy as np
import scipy.sparse as sp

import chromosight_tpu.observability as observability
import chromosight_tpu.preprocessing as preproc
from chromosight_tpu.ops import pow2
from chromosight_tpu.runtime.dump import DumpMatrix

# Intra maps larger than this switch from the dense engine to the
# diagonal-band engine (ops/band.py). The band engine is the default for
# every intra map with a bounded scan distance (threshold 0); raise the
# threshold to force the dense engine on small matrices.
BAND_THRESHOLD = int(os.environ.get("CHROMOSIGHT_TPU_BAND_THRESHOLD", 0))

# Band tensors are padded to bucketed shapes so chromosomes of similar
# size share one compiled program. Buckets are powers of two up to 8192,
# then multiples of 8192 (bounded waste at genome scale).
ROW_BUCKET = 512
COL_BUCKET = 128


def bucket_size(x, minimum=128):
    """Round up to the shape bucket: next power of two below 8192, then
    the next multiple of 8192."""
    x = max(int(x), minimum)
    if x <= 8192:
        return 1 << (x - 1).bit_length()
    return ((x + 8191) // 8192) * 8192


def _big_map(n_pad):
    """Big-map gate shared by the narrow and count upload paths: both
    add one device program per shape bucket, worth it only when the map
    is large enough that genome-scale chromosomes share the bucket
    (tiny maps have per-length widths and negligible uploads)."""
    min_rows = int(os.environ.get("CHROMOSIGHT_TPU_NARROW_MIN_ROWS", 8192))
    return n_pad >= min_rows


def _upload_shape(w_logical, w_bucket, n_pad):
    """(upload_width, upload_dtype | None): how many band columns to ship
    to the device and in what dtype, before the on-device
    ``band_finalize_upload`` pads/casts to the (w_bucket, f32) compute
    shape.

    Narrow upload ships only the logical ``keep_distance + 1`` columns
    (the bucket tail is all zeros) — ~18% fewer bytes for the human-5kb
    loops config.  Gated on big maps (genome-scale chromosomes all share
    one keep_distance, so the finalize program compiles once per row
    bucket; tiny maps have per-length widths and negligible uploads).
    bf16 upload halves bytes again but costs ~2^-9 relative rounding on
    the raw counts — beyond the 5e-5 score parity budget, so it is
    opt-in (CHROMOSIGHT_TPU_UPLOAD_DTYPE=bf16).
    """
    narrow = (
        os.environ.get("CHROMOSIGHT_TPU_NARROW_UPLOAD", "1") != "0"
        and _big_map(n_pad)
        and w_logical < w_bucket
    )
    w_up = w_logical if narrow else w_bucket
    dtype = None
    if os.environ.get("CHROMOSIGHT_TPU_UPLOAD_DTYPE", "f32") == "bf16":
        import ml_dtypes

        dtype = ml_dtypes.bfloat16
    return w_up, dtype


class ContactMap:
    """One intra- or inter-chromosomal contact map.

    Attributes mirror the reference: ``clr`` (CoolFile), ``extent``,
    ``detectable_bins`` (local row/col index arrays), ``inter``,
    ``max_dist`` (bins), ``largest_kernel``, ``dump``, ``name``,
    ``smooth``, ``sample``, ``use_norm``.
    """

    def __init__(
        self,
        clr,
        extent,
        name="",
        detectable_bins=None,
        inter=False,
        max_dist=None,
        largest_kernel=0,
        dump=None,
        smooth=False,
        sample=None,
        use_norm=True,
    ):
        self.clr = clr
        self.extent = extent
        self.smooth = smooth
        self.inter = inter
        self.max_dist = max_dist
        self.name = name
        self.largest_kernel = largest_kernel
        self.dump = dump
        self.use_norm = use_norm
        self.sample = sample
        self._dense = None
        self._band = None  # (n, W) upper-band tensor for large intra maps
        self._sparse = None  # CSR for genome-scale inter (trans) maps
        self._structure = None  # bool array of explicitly stored pixels
        if detectable_bins is None and self._dense is not None:
            detectable_bins = preproc.get_detectable_bins(
                self.matrix, inter=self.inter
            )
        self.detectable_bins = detectable_bins

    @property
    def is_banded(self):
        """Whether this map uses the diagonal-band engine (large intra maps
        with a bounded scanning distance)."""
        return (
            not self.inter
            and self.max_dist is not None
            and self.shape[0] > BAND_THRESHOLD
        )

    # -------------------------------------------------------------- #
    # Shape / representation
    # -------------------------------------------------------------- #
    @property
    def shape(self):
        (s1, e1), (s2, e2) = self.extent
        return (e1 - s1, e2 - s2)

    @property
    def dense(self):
        """Dense float ndarray of the preprocessed map (None before
        create_mat; expanded from the band for banded maps; None for
        sparse-resident inter maps — use ``sparse``)."""
        if self._dense is None and self._band is not None:
            from chromosight_tpu.ops.band import band_to_dense

            return band_to_dense(self.band, self.shape[0])
        return self._dense

    @property
    def sparse(self):
        """CSR matrix for genome-scale inter maps that are never
        densified (the detector routes them through the tiled engine);
        None for dense/banded maps."""
        return self._sparse

    @property
    def band(self):
        """(n, W) upper-band tensor as a host numpy array (banded maps
        only).  The authoritative copy lives on device (``band_dev``);
        this fetches it on demand for debugging / sparse views.  The
        device copy is row-padded to its shape bucket; the host view is
        sliced back to the logical length."""
        if self._band is None:
            return None
        return np.asarray(self._band, dtype=np.float64)[: self.shape[0]]

    @property
    def band_dev(self):
        """Device-resident band tensor, row-padded to the shape bucket
        (``bucket_size(shape[0], ROW_BUCKET)`` rows) so every kernel
        compiles once per bucket, not once per chromosome length."""
        return self._band

    @property
    def matrix(self):
        """scipy sparse view for API compatibility with the reference."""
        if self._sparse is not None:
            return self._sparse
        if self._band is not None:
            band = self.band
            n, width = band.shape
            i, d = np.nonzero(band)
            j = i + d
            ok = j < n
            return sp.coo_matrix(
                (band[i[ok], d[ok]], (i[ok], j[ok])), shape=(n, n)
            ).tocsr()
        if self._dense is None:
            return None
        return sp.csr_matrix(self._dense)

    @matrix.setter
    def matrix(self, value):
        self._band = None
        self._sparse = None
        if value is None:
            self._dense = None
        elif sp.issparse(value):
            self._dense = np.asarray(value.todense(), dtype=np.float64)
        else:
            self._dense = np.asarray(value, dtype=np.float64)

    # -------------------------------------------------------------- #
    # Lifecycle
    # -------------------------------------------------------------- #
    def create_mat(self):
        """Fetch, subsample, and preprocess the matrix.

        Reference: ``contacts_map.py:527-548``.
        """
        (s1, e1), (s2, e2) = self.extent
        n1, n2 = e1 - s1, e2 - s2
        if self.sample is not None:
            self.subsample(self.sample, balance=self.use_norm)
        elif self.is_banded:
            # The band engine only reads the upper triangle within the
            # scan band: the fused native path filters, balances and
            # scatters the raw pixel slice straight into the (bucketed)
            # band tensor in one pass, skipping the mirror query and all
            # intermediate per-pixel numpy sweeps.
            import jax.numpy as jnp

            from chromosight_tpu.observability import add_bytes, stage
            from chromosight_tpu.ops.band import band_finalize_upload

            width = bucket_size(self.keep_distance + 1, COL_BUCKET)
            n_pad = bucket_size(n1, ROW_BUCKET)
            w_up, up_dtype = _upload_shape(
                self.keep_distance + 1, width, n_pad
            )
            # Exact-uint16 count upload: ship raw 2-byte counts (+ one
            # f32 weight vector) and let the device apply the balancing
            # product — half the link bytes and half the host
            # scatter/memset traffic of the f32 band, with values exact.
            # Same big-map gate as the narrow upload so the finalize
            # program count stays one per shape bucket.
            counts_pack = None
            if (
                os.environ.get("CHROMOSIGHT_TPU_COUNT_UPLOAD", "1") != "0"
                and _big_map(n_pad)
                and (not self.use_norm or self.clr.weights is not None)
            ):
                with stage("io: fetch+scatter"):
                    counts_pack = self.clr.band_upper_counts_auto(
                        (s1, e1),
                        w_up,
                        n_rows=n_pad,
                        allow_u8=os.environ.get(
                            "CHROMOSIGHT_TPU_COUNT_U8", "1"
                        )
                        != "0",
                        allow_u4=os.environ.get(
                            "CHROMOSIGHT_TPU_COUNT_U4", "1"
                        )
                        != "0",
                    )
            if counts_pack is not None:
                from chromosight_tpu.ops.band import (
                    band_counts_finalize_u4,
                    band_counts_finalize_u8,
                    band_weighted_finalize,
                    band_weighted_finalize_u4,
                    band_weighted_finalize_u8,
                )

                mode = counts_pack[0]
                counts_host = counts_pack[1]
                up_bytes = counts_host.nbytes
                if mode == "u4":
                    up_bytes += counts_pack[2].nbytes  # packed tail
                if mode in ("u4", "u8"):
                    # Exceptions (head counts > 255, u4 tail counts
                    # > 15) pad to a power-of-two capacity with dropped
                    # out-of-range indices: one finalize program per
                    # (shape, capacity) bucket.
                    exc_idx, exc_val = counts_pack[-2], counts_pack[-1]
                    cap = pow2(len(exc_idx), 512)
                    idx_up = np.full(cap, n_pad * w_up, np.int32)
                    val_up = np.zeros(cap, np.float32)
                    idx_up[: len(exc_idx)] = exc_idx
                    val_up[: len(exc_idx)] = exc_val
                    up_bytes += idx_up.nbytes + val_up.nbytes
                with stage("io: upload enqueue"):
                    if self.use_norm:
                        w_host = np.zeros(n_pad, np.float32)
                        w_host[:n1] = self.clr.weights[s1:e1]
                        up_bytes += w_host.nbytes
                        if mode == "u4":
                            self._band = band_weighted_finalize_u4(
                                counts_host,
                                counts_pack[2],
                                jnp.asarray(idx_up),
                                jnp.asarray(val_up),
                                jnp.asarray(w_host),
                                width,
                                w_up,
                            )
                        elif mode == "u8":
                            self._band = band_weighted_finalize_u8(
                                counts_host,
                                jnp.asarray(idx_up),
                                jnp.asarray(val_up),
                                jnp.asarray(w_host),
                                width,
                            )
                        else:
                            self._band = band_weighted_finalize(
                                counts_host, jnp.asarray(w_host), width
                            )
                    elif mode == "u4":
                        self._band = band_counts_finalize_u4(
                            counts_host,
                            counts_pack[2],
                            jnp.asarray(idx_up),
                            jnp.asarray(val_up),
                            width,
                            w_up,
                        )
                    elif mode == "u8":
                        self._band = band_counts_finalize_u8(
                            counts_host,
                            jnp.asarray(idx_up),
                            jnp.asarray(val_up),
                            width,
                        )
                    else:
                        self._band = band_finalize_upload(
                            counts_host, width
                        )
                add_bytes("upload", up_bytes)
            else:
                with stage("io: fetch+scatter"):
                    band_host = self.clr.band_upper(
                        (s1, e1),
                        w_up,
                        balance=self.use_norm,
                        n_rows=n_pad,
                    )
                if up_dtype is not None:
                    band_host = band_host.astype(up_dtype)
                with stage("io: upload enqueue"):
                    if w_up == width and up_dtype is None:
                        self._band = jnp.asarray(band_host, jnp.float32)
                    else:
                        self._band = band_finalize_upload(band_host, width)
                add_bytes("upload", band_host.nbytes)
            self._dense = None
            self._structure = None
        else:
            out = None
            if self.inter and os.environ.get(
                "CHROMOSIGHT_TPU_TRANS_RAW", "1"
            ) != "0":
                # Stored-dtype trans fetch: one native pass, no mirror
                # query, no cast sweeps (None -> generic fallback).
                from chromosight_tpu.observability import stage

                with stage("io: fetch+scatter"):
                    out = self.clr.trans_coo_raw(
                        (s1, e1), (s2, e2), balance=self.use_norm
                    )
            if out is not None:
                rows, cols, vals = out
            else:
                rows, cols, vals = self.clr.pixels_coo(
                    (s1, e1), (s2, e2), balance=self.use_norm
                )
            self._materialize(rows, cols, vals)
        if self.inter:
            self.preprocess_inter_matrix()
        else:
            self.preprocess_intra_matrix()
        if getattr(self, "_fused_preprocessed", False):
            # The fused device pipeline already handled NaN zeroing
            self._fused_preprocessed = False
            if not self.use_norm:
                self._zero_missing_band(n1, n2)
            return
        if self.use_norm:
            if self._band is not None:
                import jax.numpy as jnp

                self._band = jnp.where(
                    jnp.isnan(self._band), 0.0, self._band
                )
            elif self._sparse is not None:
                self._sparse.data[np.isnan(self._sparse.data)] = 0
                self._sparse.eliminate_zeros()
            else:
                self._dense[np.isnan(self._dense)] = 0
        else:
            # Raw matrices carry no NaNs; deduce missing bins from weights
            miss_r = preproc.valid_to_missing(self.detectable_bins[0], n1)
            miss_c = preproc.valid_to_missing(self.detectable_bins[1], n2)
            if self._band is not None:
                self._zero_missing_band(n1, n2)
            elif self._sparse is not None:
                coo = self._sparse.tocoo()
                mr = preproc.missing_flags(self.detectable_bins[0], n1)
                mc = preproc.missing_flags(self.detectable_bins[1], n2)
                coo.data[mr[coo.row] | mc[coo.col]] = 0
                coo.eliminate_zeros()
                self._sparse = coo.tocsr()
            else:
                self._dense[miss_r, :] = 0
                self._dense[:, miss_c] = 0

    def _zero_missing_band(self, n1, n2):
        import jax.numpy as jnp

        from chromosight_tpu.ops.band import sliding_vector

        n_pad, width = self._band.shape
        flags_host = np.ones(n_pad, dtype=bool)  # bucket padding = missing
        flags_host[:n2] = preproc.missing_flags(
            self.detectable_bins[1], n2
        )
        miss_flags = jnp.asarray(flags_host)
        miss_pad = jnp.concatenate([miss_flags, jnp.zeros((width,), bool)])
        miss_j = sliding_vector(miss_pad, n_pad, width)
        drop = miss_flags[:, None] | miss_j
        self._band = jnp.where(drop, 0.0, self._band)

    def _materialize(self, rows, cols, vals):
        """Store fetched COO triplets in the dense or band representation."""
        n1, n2 = self.shape
        if self.is_banded:
            import jax.numpy as jnp

            from chromosight_tpu.ops.band import coo_to_band

            # Bucket the band width so similarly-sized chromosomes share a
            # compiled program; columns beyond keep_distance stay zero.
            width = bucket_size(self.keep_distance + 1, COL_BUCKET)
            band_host = coo_to_band(
                rows, cols, vals, n1, width, dtype=np.float32
            )
            n_pad = bucket_size(n1, ROW_BUCKET)
            if n_pad > n1:
                band_host = np.pad(band_host, ((0, n_pad - n1), (0, 0)))
            # Upload once; all further preprocessing happens on device.
            self._band = jnp.asarray(band_host, jnp.float32)
            self._dense = None
            self._structure = None
        elif max(n1, n2) > int(
            os.environ.get("CHROMOSIGHT_TPU_DENSE_LIMIT", 8192)
        ):
            # Genome-scale inter (trans) map: stay sparse end to end — the
            # detector scans it with the halo-tiled engine (ops/tiled.py),
            # matching the reference's sparse memory profile
            # (contacts_map.py:529 keeps CSR).
            self._sparse = sp.coo_matrix(
                (vals, (rows, cols)), shape=(n1, n2)
            ).tocsr()
            self._dense = None
            self._band = None
            self._structure = None
        else:
            self._dense = np.zeros((n1, n2), dtype=np.float64)
            self._dense[rows, cols] = vals
            self._structure = np.zeros((n1, n2), dtype=bool)
            self._structure[rows, cols] = True
            self._band = None
            self._sparse = None

    def destroy_mat(self):
        """Free the matrix memory."""
        self._dense = None
        self._band = None
        self._sparse = None
        self._structure = None

    @DumpMatrix("01_subsampled")
    def subsample(self, sub, balance=True):
        """Bootstrap-subsample raw contacts, then re-balance with the
        stored weights.

        Reference: ``contacts_map.py:555-596``.
        """
        (s1, e1), (s2, e2) = self.extent
        n1, n2 = e1 - s1, e2 - s2
        rows, cols, vals = self.clr.pixels_coo((s1, e1), (s2, e2), balance=False)
        subsample = float(sub)
        if subsample < 0:
            raise ValueError("Subsample must be strictly positive.")
        elif subsample <= 1:
            subsample *= vals.sum()
        else:
            raise ValueError("Subsample cannot be above 1")
        subsample = int(subsample)
        if subsample < vals.sum():
            coo = sp.coo_matrix((vals, (rows, cols)), shape=(n1, n2))
            coo = preproc.subsample_contacts(coo, subsample)
            rows, cols, vals = coo.row, coo.col, coo.data
        if balance:
            w = self.clr.weights
            vals = vals * w[rows + s1] * w[cols + s2]
        self._materialize(rows, cols, vals)

    @DumpMatrix("01_process_inter")
    def preprocess_inter_matrix(self):
        """Scale an inter matrix by the median of its stored values.

        Reference: ``contacts_map.py:598-601``: NaNs among stored entries
        are zeroed first, then the median is over all stored entries.
        """
        if self._sparse is not None:
            self._sparse.data[np.isnan(self._sparse.data)] = 0.0
            # in-place divide in the stored dtype: `csr / scalar` upcasts
            # f32 maps to f64 (scipy multiplies by the f64 reciprocal),
            # doubling the map's memory and every downstream sweep
            med = self._sparse.data.dtype.type(
                np.nanmedian(self._sparse.data)
            )
            self._sparse.data /= med
            return
        self._dense[np.isnan(self._dense)] = 0.0
        stored = self._dense[self._structure]
        self._dense = self._dense / np.nanmedian(stored)

    def preprocess_intra_matrix(self):
        # Fast path: the whole law/detrend/trim/NaN pipeline fused in a
        # single device dispatch (no host round trip). The staged path is
        # kept for --dump snapshots and isotonic smoothing.
        if (
            self._band is not None
            and not self.smooth
            and self.dump is None
        ):
            import jax.numpy as jnp

            from chromosight_tpu.ops.band import band_preprocess

            n = self.shape[0]
            detect = np.zeros(self._band.shape[0], dtype=bool)
            detect[
                np.asarray(self.detectable_bins[0], dtype=np.int64)
            ] = True
            pre_args = (
                self._band,
                jnp.asarray(detect),
                10 if self.use_norm else None,
                self.keep_distance,
                min(self.keep_distance + 1, n),
            )
            observability.account_dispatch(
                "band_preprocess",
                band_preprocess,
                *pre_args,
                zero_nan=self.use_norm,
            )
            self._band = band_preprocess(*pre_args, zero_nan=self.use_norm)
            self._fused_preprocessed = True
            return
        self.detrend()
        self.remove_diags()

    @DumpMatrix("01_detrended")
    def detrend(self):
        """Detrend by the distance law, computed and applied on device.

        Reference: ``contacts_map.py:607-616``.
        """
        import jax.numpy as jnp

        n = self.shape[0]
        rows = n if self._band is None else self._band.shape[0]
        detect = np.zeros(rows, dtype=bool)
        detect[np.asarray(self.detectable_bins[0], dtype=np.int64)] = True
        max_val = 10 if self.use_norm else None
        if self._band is not None:
            from chromosight_tpu.ops.band import (
                band_detrend_trim,
                band_diag_stats,
            )

            n_diags = min(self.keep_distance + 1, n)
            sums, counts = band_diag_stats(self._band, jnp.asarray(detect))
            sums = np.asarray(sums, np.float64)[:n_diags]
            counts = np.asarray(counts, np.float64)[:n_diags]
            law = np.zeros(self._band.shape[1])
            with np.errstate(invalid="ignore", divide="ignore"):
                law[:n_diags] = sums / counts
            if self.smooth and n > 2:
                law[~np.isfinite(law)] = 0
                law = preproc.pava_decreasing(law)
            law[np.isnan(law)] = 0.0
            # detrend only here; trimming happens in remove_diags;
            # the result stays on device
            self._band = band_detrend_trim(
                self._band,
                jnp.asarray(law, jnp.float32),
                max_val,
                self._band.shape[1],
            )
        else:
            from chromosight_tpu.ops.preprocess import (
                detrend_dense,
                distance_law_dense,
            )

            law = distance_law_dense(
                self._dense,
                detect,
                n_diags=min(self.keep_distance + 1, n),
                smooth=self.smooth,
            )
            law[np.isnan(law)] = 0.0
            self._dense = np.asarray(
                detrend_dense(self._dense, jnp.asarray(law), max_val),
                dtype=np.float64,
            )

    @DumpMatrix("02_remove_diags")
    def remove_diags(self):
        """Keep only the upper diagonals within scanning distance.

        Reference: ``contacts_map.py:618-627``.
        """
        if self._band is not None:
            import jax.numpy as jnp

            d = jnp.arange(self._band.shape[1])
            self._band = jnp.where(
                (d <= self.keep_distance)[None, :], self._band, 0.0
            )
            return
        from chromosight_tpu.ops.preprocess import diag_trim_dense

        self._dense = np.asarray(
            diag_trim_dense(self._dense, self.keep_distance),
            dtype=np.float64,
        )

    @property
    def keep_distance(self):
        """Scanning distance plus kernel margin (contacts_map.py:629-638)."""
        n = self.shape[0]
        if self.max_dist is None:
            mat_max_dist = n
        else:
            mat_max_dist = min(self.max_dist, n)
        return mat_max_dist + self.largest_kernel
