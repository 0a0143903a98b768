"""Tiled sparse convolution engine: bounded-memory scans of huge matrices.

The reference computes sparse cross-correlations through chains of sparse
Toeplitz matrix products (reference ``utils/detection.py:627-723`` for
``xcorr2`` and ``917-1131`` for ``normxcorr2``) — a CPU cache-friendly
formulation that never densifies the signal.  The device equivalent is
block decomposition: the sparse matrix is cut into a grid of fixed-size
tiles, each tile is extended by a kernel-sized halo and densified
(memory bounded by the tile size, never O(n^2)), the fused engines in
``ops.convolve`` / ``ops.normxcorr`` scan the dense block, and the
per-tile results are reassembled into one sparse matrix.

Why this shape:
* every block has the same static shape, so XLA compiles the fused Pearson
  program exactly once regardless of the input size;
* tiles whose extended block contains no signal are skipped before any
  transfer — sliding-window Pearson of an all-zero window is identically 0
  (zero numerator), which is also what the reference's implicit-zero sparse
  algebra produces — so a banded genome-scale matrix costs O(band tiles)
  device dispatches, not O(grid);
* per-window results depend only on the window contents, so a halo of
  (kernel-1) pixels makes tiling exact: every kept output pixel sees the
  same window bytes the whole-matrix dense engine would.

Transfer-frugal execution:
* sparse tiles ship COO triplets and scatter on device; dense-ish tiles
  ship the dense block (`_tile_to_device` picks per tile);
* crossing masks (missing rows | cols, the inter-map case) ship as two
  boolean vectors and the mask block is built on device;
* tile outputs are extracted on device into one packed (4, cap) array —
  indices+values+log-p in a single download, with an airtight capacity
  bound of nnz * kernel_size nonzero correlations per tile;
* tiles flow through a bounded-depth async pipeline so uploads, compute
  and downloads of consecutive tiles overlap.

The public entry points mirror the sparse branches of the reference
``xcorr2`` / ``normxcorr2`` (same framing, triu, clamping, crop and
p-value semantics) and are dispatched from
``chromosight_tpu.detection`` when a sparse input is too large to densify.
"""

from __future__ import annotations

import itertools as _it
import os

import numpy as np
import scipy.sparse as sp

import chromosight_tpu.observability as _obs
from chromosight_tpu.ops import pow2


DEFAULT_TILE = 2048
# Tiles batched per device dispatch in the Pearson scan: one fused
# scatter->correlate->extract program runs B tiles per call, amortising
# the per-dispatch cost over B tiles.
DEFAULT_TILE_BATCH = 32


def _batch_size():
    b = int(os.environ.get("CHROMOSIGHT_TPU_TILE_BATCH", DEFAULT_TILE_BATCH))
    return max(1, b)


def _tile_size(tile):
    if tile is None:
        tile = os.environ.get("CHROMOSIGHT_TPU_TILE", DEFAULT_TILE)
    tile = int(tile)
    # Packed extraction encodes tile-local indices as float32
    # (_extract_nonzero_tile), exact only below 2^24.
    if not 0 < tile < (1 << 24):
        raise ValueError(
            f"tile size must be in [1, 2^24) for exact f32 index packing, "
            f"got {tile}"
        )
    return tile


# jit-wrapped helpers are built once and cached: re-wrapping per call
# would retrace on every tile (jax caches per jit object).  The build is
# locked: dispatches run on thread pools (_pipeline, detect_on_mesh's
# fallback), and two racing first calls would otherwise each build a
# distinct jit object — distinct objects don't share tracing caches, so
# every raced build pays its own compile/program load.
_JITTED = {}

import threading as _threading

_JITTED_LOCK = _threading.Lock()


def _jitted(name, build):
    fn = _JITTED.get(name)
    if fn is None:
        with _JITTED_LOCK:
            fn = _JITTED.get(name)
            if fn is None:
                fn = _JITTED[name] = build()
    return fn


def _scatter_block(i, j, v, shape):
    """Device-side scatter of padded COO triplets into a dense block
    (padding entries carry out-of-range row indices and are dropped)."""

    def build():
        import jax
        import jax.numpy as jnp
        from functools import partial

        @partial(jax.jit, static_argnames=("shape",))
        def _impl(i, j, v, shape):
            blk = jnp.zeros(shape, v.dtype)
            return blk.at[i, j].set(v, mode="drop")

        return _impl

    return _jitted("scatter", build)(i, j, v, shape)


def _extract_nonzero_tile(
    corr_b, logp_b, T, hm0, hn0, cap, with_pval, keep_min=None
):
    """Device-side sparse extraction of a tile's output: indices/values of
    the nonzero correlations (and their log-p values), padded to ``cap``
    with row index T.  Downloads O(cap) instead of the T x T block.  ``keep_min`` restricts extraction to
    coefficients >= keep_min (the detect candidate filter).

    Returns ONE (4, cap) float32 array [rows, cols, corr, logp]: a
    single packed download instead of four
    (indices are exact in f32: tiles are < 2^24 wide)."""

    def build():
        import jax
        import jax.numpy as jnp
        from functools import partial

        @partial(
            jax.jit,
            static_argnames=("T", "hm0", "hn0", "cap", "with_pval", "has_keep"),
        )
        def _impl(corr_b, logp_b, T, hm0, hn0, cap, with_pval, has_keep, keep):
            sub = jax.lax.slice(corr_b, (hm0, hn0), (hm0 + T, hn0 + T))
            nz = (sub >= keep) if has_keep else (sub != 0)
            ii, jj = jnp.nonzero(nz, size=cap, fill_value=T)
            iic = jnp.clip(ii, 0, T - 1)
            jjc = jnp.clip(jj, 0, T - 1)
            vals = sub[iic, jjc]
            if with_pval:
                lsub = jax.lax.slice(
                    logp_b, (hm0, hn0), (hm0 + T, hn0 + T)
                )
                lp = lsub[iic, jjc]
            else:
                lp = vals
            return jnp.stack(
                [
                    ii.astype(jnp.float32),
                    jj.astype(jnp.float32),
                    vals,
                    lp,
                ]
            )

        return _impl

    return _jitted("extract", build)(
        corr_b,
        logp_b,
        T,
        hm0,
        hn0,
        cap,
        with_pval,
        keep_min is not None,
        np.float32(0.0 if keep_min is None else keep_min),
    )


def _extract_cap(nnz_src, mk, nk, T):
    """Power-of-two capacity bounding a tile's nonzero correlations: each
    signal nonzero can light up at most mk*nk window positions, so the
    bound is airtight.  Returns None when a dense download is cheaper."""
    bound = max(int(nnz_src) * mk * nk, 1)
    cap = pow2(bound, 1024)
    if cap >= (T * T) // 4:
        return None
    return cap


def _crossing_block(rv, cv):
    """Device-built crossing mask block (rows | cols outer-OR): uploads
    two boolean vectors instead of a dense (BM, BN) mask."""
    import jax.numpy as jnp

    def build():
        import jax

        @jax.jit
        def _impl(r, c):
            return r[:, None] | c[None, :]

        return _impl

    return _jitted("crossing", build)(jnp.asarray(rv), jnp.asarray(cv))


def _slice_pad(vec, lo, size):
    """vec[lo : lo+size] with False padding outside [0, len(vec))."""
    out = np.zeros(size, dtype=bool)
    a, b = max(lo, 0), min(lo + size, len(vec))
    if b > a:
        out[a - lo : b - lo] = vec[a:b]
    return out


def _iter_tiles_host(framed, fmask, T, mk, nk, mask_vectors=None):
    """Yield host-side tile descriptors (no device work):
    ``(r0, c0, ii, jj, vv, mask_payload, nnz)`` for every tile whose
    extended (halo-included) block contains at least one signal nonzero.
    ``ii``/``jj`` are block-local int32 indices into the zero-padded
    (T + mk - 1, T + nk - 1) block; tiles at the matrix boundary are
    zero-padded so every dispatch reuses one compiled program.  Kept
    output pixels are later filtered to windows fully inside the matrix,
    so padding never reaches a reported coefficient.

    ``mask_payload`` is ("vec", row_bool(BM,), col_bool(BN,)) when
    ``mask_vectors`` is given (crossing masks built on device), or
    ("coo", mi, mj) block-local mask indices from ``fmask``, or None.
    """
    Ms, Ns = framed.shape
    hm0, hn0 = (mk - 1) // 2, (nk - 1) // 2
    BM, BN = T + mk - 1, T + nk - 1
    for r0 in range(0, Ms, T):
        br0 = r0 - hm0
        rlo, rhi = max(br0, 0), min(br0 + BM, Ms)
        with _obs.stage("host: tile slices"):
            row_slice = framed[rlo:rhi]
            if row_slice.nnz == 0:
                continue
            # CSC once per row slab: each tile's entries then come from
            # a contiguous indptr range (O(tile nnz)) instead of a CSR
            # column slice that rescans the whole slab per tile
            # (O(slab nnz * n_col_tiles) across the row block).
            row_csc = row_slice.tocsc()
            mrow_csc = (
                fmask[rlo:rhi].tocsc() if fmask is not None else None
            )
        for c0 in range(0, Ns, T):
            bc0 = c0 - hn0
            clo, chi = max(bc0, 0), min(bc0 + BN, Ns)
            with _obs.stage("host: tile slices"):
                src = row_csc[:, clo:chi].tocoo()
                if src.nnz == 0:
                    continue
                ii = src.row.astype(np.int32) + np.int32(rlo - br0)
                jj = src.col.astype(np.int32) + np.int32(clo - bc0)
                vv = src.data.astype(np.float32)
                if mask_vectors is not None:
                    mp = (
                        "vec",
                        _slice_pad(mask_vectors[0], br0, BM),
                        _slice_pad(mask_vectors[1], bc0, BN),
                    )
                elif mrow_csc is not None:
                    msrc = mrow_csc[:, clo:chi].tocoo()
                    mp = (
                        "coo",
                        msrc.row.astype(np.int32) + np.int32(rlo - br0),
                        msrc.col.astype(np.int32) + np.int32(clo - bc0),
                    )
                else:
                    mp = None
            yield r0, c0, ii, jj, vv, mp, src.nnz


def _iter_tile_counts(framed, fmask, T, mk, nk, with_mask_counts):
    """Mirror of ``_iter_tiles_host``'s tile enumeration yielding only
    ``(nnz, mask_nnz)`` per tile — no triplet arrays are materialised.
    Per row block one column-count prefix sum gives every tile's nonzero
    count in O(1), so the whole pass is O(nnz + n_tiles): the batched
    engine sizes its global capacities from this instead of holding every
    tile's COO copy of the matrix in host memory for the whole scan."""
    Ms, Ns = framed.shape
    hm0, hn0 = (mk - 1) // 2, (nk - 1) // 2
    BM, BN = T + mk - 1, T + nk - 1
    framed = framed.tocsr()
    fm = fmask.tocsr() if (with_mask_counts and fmask is not None) else None
    for r0 in range(0, Ms, T):
        br0 = r0 - hm0
        rlo, rhi = max(br0, 0), min(br0 + BM, Ms)
        lo, hi = framed.indptr[rlo], framed.indptr[rhi]
        if hi == lo:
            continue
        cum = np.zeros(Ns + 1, np.int64)
        np.cumsum(
            np.bincount(framed.indices[lo:hi], minlength=Ns),
            out=cum[1:],
        )
        if fm is not None:
            mlo, mhi = fm.indptr[rlo], fm.indptr[rhi]
            mcum = np.zeros(Ns + 1, np.int64)
            np.cumsum(
                np.bincount(fm.indices[mlo:mhi], minlength=Ns),
                out=mcum[1:],
            )
        for c0 in range(0, Ns, T):
            bc0 = c0 - hn0
            clo, chi = max(bc0, 0), min(bc0 + BN, Ns)
            nnz = int(cum[chi] - cum[clo])
            if nnz == 0:
                continue
            mnnz = int(mcum[chi] - mcum[clo]) if fm is not None else 0
            yield nnz, mnnz


def _tile_to_device(ii, jj, vv, mp, shape):
    """Per-tile device upload from a host descriptor: returns
    (block, mask_block).  Well-filled tiles ship the dense block; sparse
    tiles ship COO triplets (padded to power-of-two capacities so the
    scatter program compiles once per bucket) and scatter on device — a
    genome-scale trans pair is ~10 GB of dense blocks but only MBs of
    triplets."""
    import jax.numpy as jnp

    BM, BN = shape
    nnz = len(vv)
    if nnz * 24 >= 4 * BM * BN:
        block_h = np.zeros(shape, np.float32)
        block_h[ii, jj] = vv
        block = jnp.asarray(block_h)
    else:
        cap = pow2(nnz, 256)
        i = np.full(cap, BM, np.int32)  # out-of-range -> dropped
        j = np.zeros(cap, np.int32)
        v = np.zeros(cap, np.float32)
        i[:nnz], j[:nnz], v[:nnz] = ii, jj, vv
        block = _scatter_block(
            jnp.asarray(i), jnp.asarray(j), jnp.asarray(v), shape
        )
    if mp is None:
        mblock = None
    elif mp[0] == "vec":
        mblock = _crossing_block(mp[1], mp[2])
    else:
        # Same dense-vs-COO choice as the signal block: a sparse missing
        # mask ships as padded triplets (9 B/entry) and scatters on
        # device rather than as a BM*BN bool image.
        mnnz = len(mp[1])
        if mnnz * 9 >= BM * BN:
            mblock_h = np.zeros(shape, bool)
            mblock_h[mp[1], mp[2]] = True
            mblock = jnp.asarray(mblock_h)
        else:
            mcap = pow2(mnnz, 256)
            mi = np.full(mcap, BM, np.int32)  # out-of-range -> dropped
            mj = np.zeros(mcap, np.int32)
            mi[:mnnz], mj[:mnnz] = mp[1], mp[2]
            mblock = _scatter_block(
                jnp.asarray(mi),
                jnp.asarray(mj),
                jnp.ones(mcap, bool),
                shape,
            )
    return block, mblock


def _iter_blocks(framed, fmask, T, mk, nk, mask_vectors=None):
    """Yield (r0, c0, block, mask_block, nnz_src) with device-resident
    float32 blocks of constant shape (T + mk - 1, T + nk - 1): the
    per-tile upload path over ``_iter_tiles_host``."""
    BM, BN = T + mk - 1, T + nk - 1
    for r0, c0, ii, jj, vv, mp, nnz in _iter_tiles_host(
        framed, fmask, T, mk, nk, mask_vectors=mask_vectors
    ):
        block, mblock = _tile_to_device(ii, jj, vv, mp, (BM, BN))
        yield r0, c0, block, mblock, nnz


def _batched_pearson_program():
    """One fused device program for a whole batch of tiles: flat-scatter
    the concatenated COO triplets into (B, BM, BN) blocks, build the mask
    blocks, run the fused Pearson over the batch axis (vmap), and extract
    each tile's packed (4, cap) nonzero output — a single dispatch and a
    single (B, 4, cap) download where the per-tile path pays B
    dispatches."""

    def build():
        import jax
        import jax.numpy as jnp
        from functools import partial

        from chromosight_tpu.ops.normxcorr import (
            _normxcorr_impl,
            normxcorr_crossing_valid,
        )

        def lax_bitcast(f32_arr):
            return jax.lax.bitcast_convert_type(f32_arr, jnp.int32)

        ROW_K = 32  # stage-1 per-row selection width (two-stage top_k)

        def extract_topk(sub, lsub, T, cap_ex, keep_min):
            """Packed (4, cap) extraction via top_k: selection runs as an
            optimised partial sort instead of nonzero's cumsum +
            searchsorted + two random gathers.
            Invalid slots carry row index T (the collector's fill
            convention).

            keep_min mode runs TWO-STAGE: per-row top-ROW_K, then a
            global top_k over the T*ROW_K survivors, in place of one
            flat T*T top_k whose sort cost is nearly k-independent.  Correctness guard: a row holding more than
            ROW_K candidates would silently truncate, so the kernel
            checks max per-row candidate count and signals the overflow
            by writing row sentinel T+1 into slot 0 — the collector
            reroutes that tile to the airtight per-tile path."""
            if keep_min is not None and cap_ex <= T * ROW_K:
                s = jnp.where(sub >= keep_min, sub, -jnp.inf)
                row_over = (
                    jnp.max(jnp.sum(s > -jnp.inf, axis=1)) > ROW_K
                )
                rtop, ridx = jax.lax.top_k(s, ROW_K)  # (T, ROW_K)
                flat = rtop.reshape(-1)
                top, idx2 = jax.lax.top_k(flat, cap_ex)
                valid = jnp.isfinite(top)
                rows = idx2 // ROW_K
                cols = ridx.reshape(-1)[idx2]
                lp = lsub[
                    jnp.clip(rows, 0, T - 1), jnp.clip(cols, 0, T - 1)
                ]
                ii = jnp.where(valid, rows, T)
                ii = ii.at[0].set(jnp.where(row_over, T + 1, ii[0]))
                return jnp.stack(
                    [
                        ii.astype(jnp.float32),
                        jnp.where(valid, cols, 0).astype(jnp.float32),
                        jnp.where(valid, top, 0.0),
                        jnp.where(valid, lp, 0.0),
                    ]
                )
            flat = sub.reshape(-1)
            if keep_min is None:
                # any nonzero (sign included): rank by nonzero-ness;
                # the airtight capacity guarantees all are selected
                score = jnp.where(
                    flat != 0, jnp.ones((), flat.dtype), -jnp.inf
                )
            else:
                score = jnp.where(flat >= keep_min, flat, -jnp.inf)
            top, idx = jax.lax.top_k(score, cap_ex)
            valid = jnp.isfinite(top)
            vals = flat[idx]
            lp = lsub.reshape(-1)[idx]
            ii = jnp.where(valid, idx // T, T)
            jj = idx % T
            return jnp.stack(
                [
                    ii.astype(jnp.float32),
                    jj.astype(jnp.float32),
                    jnp.where(valid, vals, 0.0),
                    jnp.where(valid, lp, 0.0),
                ]
            )

        @partial(
            jax.jit,
            static_argnames=(
                "B", "BM", "BN", "T", "hm0", "hn0", "cap_ex", "cap_up",
                "cap_m", "kernel_shape", "mask_mode", "missing_tol",
                "pval", "threshold", "with_tsvd", "force_window_nobs",
                "keep_min",
            ),
        )
        def _impl(
            hostbuf, kernel, tsvd_pack,
            B, BM, BN, T, hm0, hn0, cap_ex, cap_up, cap_m, kernel_shape,
            mask_mode, missing_tol, pval, threshold, with_tsvd,
            force_window_nobs, keep_min,
        ):
            # All host inputs arrive as ONE packed f32 buffer (indices
            # bitcast through f32): one device_put per batch.
            sflat = lax_bitcast(hostbuf[0:cap_up])
            sval = hostbuf[cap_up : 2 * cap_up]
            off = 2 * cap_up
            total = B * BM * BN
            blocks = (
                jnp.zeros((total,), jnp.float32)
                .at[sflat]
                .set(sval, mode="drop")
                .reshape(B, BM, BN)
            )
            mk, nk = kernel_shape
            if mask_mode == "vec" and not with_tsvd and force_window_nobs:
                # Crossing masks: the three mask convolutions collapse to
                # rank-mk outer products (normxcorr_crossing_valid) —
                # no (B, BM, BN) mask blocks, half the dense reductions.
                rv = hostbuf[off : off + B * BM].reshape(B, BM) > 0
                cv = (
                    hostbuf[off + B * BM : off + B * BM + B * BN].reshape(
                        B, BN
                    )
                    > 0
                )

                def one_crossing(blk, r, c):
                    corr, pv = normxcorr_crossing_valid(
                        blk,
                        r,
                        c,
                        kernel,
                        kernel_shape,
                        missing_tol,
                        pval,
                        threshold,
                    )
                    # valid-shape output: [0:T, 0:T] equals the padded
                    # output's [hm0:hm0+T, hn0:hn0+T]
                    sub = jax.lax.slice(corr, (0, 0), (T, T))
                    lsub = (
                        jax.lax.slice(pv, (0, 0), (T, T)) if pval else sub
                    )
                    return extract_topk(sub, lsub, T, cap_ex, keep_min)

                return jax.vmap(one_crossing)(blocks, rv, cv)
            if mask_mode == "vec":
                rv = hostbuf[off : off + B * BM].reshape(B, BM) > 0
                cv = (
                    hostbuf[off + B * BM : off + B * BM + B * BN].reshape(
                        B, BN
                    )
                    > 0
                )
                mblocks = rv[:, :, None] | cv[:, None, :]
            elif mask_mode == "coo":
                mflat = lax_bitcast(hostbuf[off : off + cap_m])
                mblocks = (
                    jnp.zeros((total,), jnp.bool_)
                    .at[mflat]
                    .set(True, mode="drop")
                    .reshape(B, BM, BN)
                )
            else:
                mblocks = jnp.zeros((B, 1, 1), jnp.bool_)

            def one(blk, mblk):
                corr, pv = _normxcorr_impl(
                    blk,
                    kernel,
                    mblk,
                    tsvd_pack,
                    kernel_shape,
                    False,  # framing applied globally by the caller
                    False,  # triu applied in global framed coordinates
                    mask_mode != "none",
                    missing_tol,
                    pval,
                    threshold,
                    with_tsvd,
                    force_window_nobs=force_window_nobs,
                )
                sub = jax.lax.slice(corr, (hm0, hn0), (hm0 + T, hn0 + T))
                lsub = (
                    jax.lax.slice(pv, (hm0, hn0), (hm0 + T, hn0 + T))
                    if pval
                    else sub
                )
                return extract_topk(sub, lsub, T, cap_ex, keep_min)

            return jax.vmap(one)(blocks, mblocks)

        return _impl

    return _jitted("batch", build)


def _pow2(x, minimum=1024):
    return pow2(x, minimum)


def _batched_pearson_entries(
    tiles,
    kernel_dev,
    tsvd_pack,
    T,
    mk,
    nk,
    mask_mode,
    missing_tol,
    pval,
    with_tsvd,
    force_window_nobs,
    threshold,
    keep_min=None,
    overflow_out=None,
    counts=None,
):
    """Run the batched fused program over ``tiles`` (host descriptors from
    ``_iter_tiles_host`` whose extraction cap fits), yielding per-tile
    entries (r0, c0, packed (4, cap) ndarray, None) compatible with the
    per-tile collector.  Capacities are computed globally (one power-of-two
    bucket each) so the whole scan compiles exactly one batch program.

    ``tiles`` may be a lazy iterable when ``counts`` — a list of
    (nnz, mask_nnz) pairs in the same order, e.g. from
    ``_iter_tile_counts`` — is supplied: descriptors then stream through
    the bounded pipeline and at most pipeline-depth batches of COO
    triplets are alive at once (a genome-scale trans scan never holds an
    O(nnz) host copy of the whole matrix).

    ``keep_min`` keeps only output pixels >= keep_min, with a small
    starting capacity (CHROMOSIGHT_TPU_TILE_CAP0): tiles whose true
    candidate count overflows it are appended to ``overflow_out`` (a
    list) for the caller's airtight per-tile path instead of being
    silently truncated."""
    import jax.numpy as jnp

    import jax

    if counts is None:
        tiles = list(tiles)
        counts = [
            (t[6], len(t[5][1]) if mask_mode == "coo" else 0) for t in tiles
        ]
    if not counts:
        return
    B = _batch_size()
    hm0, hn0 = (mk - 1) // 2, (nk - 1) // 2
    BM, BN = T + mk - 1, T + nk - 1
    total_cells = B * BM * BN
    if total_cells >= 1 << 31:
        raise ValueError(
            "tile batch too large for int32 flat indexing; lower "
            "CHROMOSIGHT_TPU_TILE or CHROMOSIGHT_TPU_TILE_BATCH"
        )
    count_chunks = [counts[i : i + B] for i in range(0, len(counts), B)]

    def batches():
        it = iter(tiles)
        while True:
            chunk = list(_it.islice(it, B))
            if not chunk:
                return
            yield chunk

    # A tile has T*T output pixels, so no capacity (and no top_k k) may
    # exceed that — _pow2's floor and rounding can otherwise push past it
    # for small or non-power-of-two tile sizes.
    airtight = min(
        _pow2(max(min(n * mk * nk, T * T) for n, _ in counts)), T * T
    )
    if keep_min is not None:
        cap_ex = min(
            airtight,
            _pow2(int(os.environ.get("CHROMOSIGHT_TPU_TILE_CAP0", 4096))),
            T * T,
        )
    else:
        cap_ex = airtight
    # Multi-device: independent tile batches round-robin across every
    # visible device (pure data parallelism, no collectives) — trans
    # maps are the one workload the (dp, sp) band mesh cannot cover, and
    # their tiles are embarrassingly parallel.
    devices = jax.devices()
    if len(devices) > 1 and os.environ.get(
        "CHROMOSIGHT_TPU_TILE_MULTIDEV", "1"
    ) != "0":
        _const_cache = {}
        _const_lock = _threading.Lock()

        def _dev_consts(d):
            # dispatch pool threads race here; without the lock both
            # would miss and upload the constants twice per device
            if d not in _const_cache:
                with _const_lock:
                    if d not in _const_cache:
                        _const_cache[d] = (
                            jax.device_put(kernel_dev, d),
                            jax.tree_util.tree_map(
                                lambda a: jax.device_put(a, d), tsvd_pack
                            ),
                        )
            return _const_cache[d]

    else:
        devices = None
    cap_up = _pow2(max(sum(n for n, _ in ch) for ch in count_chunks))
    cap_m = 1
    if mask_mode == "coo":
        cap_m = _pow2(max(sum(m for _, m in ch) for ch in count_chunks))
    program = _batched_pearson_program()

    cap_m = max(cap_m, 1)
    buf_len = 2 * cap_up
    if mask_mode == "vec":
        buf_len += B * BM + B * BN
    elif mask_mode == "coo":
        buf_len += cap_m

    def dispatch(item):
        idx, batch = item
        # ONE packed f32 host buffer (indices bitcast): a single upload
        # round-trip per batch instead of five.  (Stage runs on the
        # dispatch pool, concurrent with the consumer's device waits —
        # its seconds overlap other stages, they don't add.)
        with _obs.stage("host: batch pack"):
            return _dispatch_packed(idx, batch)

    def _dispatch_packed(idx, batch):
        buf = np.zeros(buf_len, np.float32)
        sflat = np.full(cap_up, total_cells, np.int32)
        sval = buf[cap_up : 2 * cap_up]
        if mask_mode == "coo":
            mflat = np.full(cap_m, total_cells, np.int32)
        elif mask_mode == "vec":
            # padding tiles: fully-missing crossings (their signal is
            # zero, so every window has zero variance and Pearson is 0)
            rv = np.ones((B, BM), np.float32)
            cv = np.ones((B, BN), np.float32)
        off = moff = 0
        metas = []
        for b, (r0, c0, ii, jj, vv, mp, nnz) in enumerate(batch):
            base = np.int64(b) * BM * BN
            sflat[off : off + nnz] = (
                base + ii.astype(np.int64) * BN + jj
            ).astype(np.int32)
            sval[off : off + nnz] = vv
            off += nnz
            if mask_mode == "vec":
                rv[b], cv[b] = mp[1], mp[2]
            elif mask_mode == "coo":
                mn = len(mp[1])
                mflat[moff : moff + mn] = (
                    base + mp[1].astype(np.int64) * BN + mp[2]
                ).astype(np.int32)
                moff += mn
            metas.append((r0, c0))
        buf[0:cap_up] = sflat.view(np.float32)
        if mask_mode == "vec":
            buf[2 * cap_up : 2 * cap_up + B * BM] = rv.ravel()
            buf[2 * cap_up + B * BM :] = cv.ravel()
        elif mask_mode == "coo":
            buf[2 * cap_up :] = mflat.view(np.float32)
        if devices is not None:
            import jax as _jax

            dev = devices[idx % len(devices)]
            kern_d, tsvd_d = _dev_consts(dev)
            buf_d = _jax.device_put(buf, dev)
        else:
            kern_d, tsvd_d = kernel_dev, tsvd_pack
            buf_d = jnp.asarray(buf)
        statics = dict(
            B=B,
            BM=BM,
            BN=BN,
            T=T,
            hm0=hm0,
            hn0=hn0,
            cap_ex=cap_ex,
            cap_up=cap_up,
            cap_m=cap_m,
            kernel_shape=(mk, nk),
            mask_mode=mask_mode,
            missing_tol=float(missing_tol),
            pval=bool(pval),
            threshold=threshold,
            with_tsvd=bool(with_tsvd),
            force_window_nobs=bool(force_window_nobs),
            keep_min=keep_min,
        )
        _obs.account_dispatch(
            "tiled_batch", program, buf_d, kern_d, tsvd_d, **statics
        )
        out = program(buf_d, kern_d, tsvd_d, **statics)
        return batch, metas, out

    depth = None
    if devices is not None:
        # keep every device busy: pipeline depth >= device count
        depth = max(
            len(devices) + 2,
            int(os.environ.get("CHROMOSIGHT_TPU_TILE_PIPELINE", 8)),
        )
    from chromosight_tpu.observability import add_bytes, stage

    for batch, metas, packed in _pipeline(
        dispatch, enumerate(batches()), depth=depth
    ):
        with stage("device wait: tile batches"):
            arr = np.asarray(packed)  # one (B, 4, cap_ex) download
        add_bytes("download", arr.nbytes)
        for b, (r0, c0) in enumerate(metas):
            if keep_min is not None:
                if arr[b, 0, 0] == T + 1:
                    # two-stage row sentinel: some row held more than
                    # ROW_K candidates and was truncated — reroute to
                    # the airtight per-tile path
                    overflow_out.append(batch[b])
                    continue
                if cap_ex < airtight and not (arr[b, 0] >= T).any():
                    # every capacity slot holds a real candidate (no
                    # fill_value left): the true count may exceed
                    # cap_ex — reroute this tile to the airtight
                    # per-tile path
                    overflow_out.append(batch[b])
                    continue
            yield r0, c0, arr[b], None


def _pipeline(dispatch, items, depth=None):
    """Bounded-depth async pipeline: dispatch() enqueues device work and
    returns a token holding device arrays; tokens are yielded back (for
    host materialisation) ``depth`` items behind the dispatch front, so
    uploads, compute and downloads of consecutive tiles overlap.

    Dispatches run on a small thread pool (CHROMOSIGHT_TPU_DISPATCH_THREADS,
    default 2), so enqueues (device_puts + program call) do not
    serialize against the main thread's download waits."""
    from collections import deque

    if depth is None:
        depth = int(os.environ.get("CHROMOSIGHT_TPU_TILE_PIPELINE", 8))
    threads = int(os.environ.get("CHROMOSIGHT_TPU_DISPATCH_THREADS", 2))
    if threads > 1:
        from concurrent.futures import ThreadPoolExecutor

        def _await(fut):
            # enqueue latency (device_puts + program call on the
            # dispatch pool) surfaces here when the pool falls behind
            with _obs.stage("device wait: dispatch"):
                return fut.result()

        with ThreadPoolExecutor(threads) as pool:
            pending = deque()
            for item in items:
                pending.append(pool.submit(dispatch, item))
                if len(pending) >= depth:
                    yield _await(pending.popleft())
            while pending:
                yield _await(pending.popleft())
        return
    pending = deque()
    for item in items:
        pending.append(dispatch(item))
        if len(pending) >= depth:
            yield pending.popleft()
    while pending:
        yield pending.popleft()


def _assemble(rows, cols, vals, shape, dtype=np.float32):
    if rows:
        r = np.concatenate(rows)
        c = np.concatenate(cols)
        v = np.concatenate(vals).astype(dtype)
    else:
        r = c = np.zeros(0, np.int64)
        v = np.zeros(0, dtype)
    out = sp.coo_matrix((v, (r, c)), shape=shape, dtype=dtype)
    out.eliminate_zeros()
    return out.tocsr()


def xcorr2_sparse_tiled(signal, kernel, threshold=1e-4, tile=None):
    """Sparse cross-correlation via halo-tiled dense convolutions.

    Behavioural equivalent of the reference sparse ``_xcorr2_sparse``
    (``detection.py:627-723``): output has the signal's shape, margins
    where the kernel overlaps the edge are zero, sub-threshold magnitudes
    are dropped.  ``kernel`` may be a 2D array or a factorised
    (left, right) tuple from ``preprocessing.factorise_kernel``.
    """
    from chromosight_tpu.ops.convolve import xcorr2 as xcorr2_dense

    if isinstance(kernel, tuple):
        mk, nk = kernel[0].shape[0], kernel[1].shape[1]
    else:
        kernel = np.asarray(kernel, np.float32)
        mk, nk = kernel.shape
    framed = signal.tocsr()
    Ms, Ns = framed.shape
    hm0, hn0 = (mk - 1) // 2, (nk - 1) // 2
    hm1, hn1 = mk - 1 - hm0, nk - 1 - hn0
    T = _tile_size(tile)
    rows, cols, vals = [], [], []

    def dispatch(item):
        r0, c0, block, _, nnz_src = item
        out_b = xcorr2_dense(block, kernel, threshold=threshold)
        cap = _extract_cap(nnz_src, mk, nk, T)
        if cap is not None:
            return r0, c0, _extract_nonzero_tile(
                out_b, out_b, T, hm0, hn0, cap, False
            ), None
        return r0, c0, None, out_b

    def collect(entry):
        r0, c0, packed, out_b = entry
        if packed is not None:
            arr = np.asarray(packed)  # one packed (4, cap) download
            keepnz = arr[0] < T
            ii = arr[0, keepnz].astype(np.int64)
            jj = arr[1, keepnz].astype(np.int64)
            vv = arr[2, keepnz]
        else:
            sub = np.asarray(out_b)[hm0 : hm0 + T, hn0 : hn0 + T]
            ii, jj = np.nonzero(sub)
            vv = sub[ii, jj]
        if len(ii) == 0:
            return
        gi, gj = ii + r0, jj + c0
        # Keep only windows fully inside the matrix: the whole-matrix
        # engine zeroes these margins, and boundary tiles are zero-padded.
        keep = (gi >= hm0) & (gi < Ms - hm1) & (gj >= hn0) & (gj < Ns - hn1)
        rows.append(gi[keep])
        cols.append(gj[keep])
        vals.append(vv[keep])

    for entry in _pipeline(
        dispatch, _iter_blocks(framed, None, T, mk, nk)
    ):
        collect(entry)
    return _assemble(rows, cols, vals, (Ms, Ns))


def normxcorr2_sparse_tiled(
    signal,
    kernel,
    max_dist=None,
    sym_upper=False,
    full=False,
    missing_mask=None,
    missing_tol=0.75,
    tsvd=None,
    pval=False,
    tile=None,
    missing_vectors=None,
    keep_min=None,
):
    """Sliding-window Pearson over a sparse matrix without densifying it.

    Matches the reference sparse engine (``detection.py:917-1131``)
    semantically: global kernel-sized framing in ``full`` mode, per-window
    observation counts for p-values only in full+mask mode, triu applied in
    framed coordinates when ``sym_upper``, coefficients clamped to [-1, 1],
    frame cropped from the output.  Returns ``(corr, log10_pvals | None)``
    as CSR matrices shaped like ``signal``.

    ``keep_min`` (detect-mode fast path) keeps only coefficients
    >= keep_min in the returned matrices: everything detection consumes
    downstream (foci, per-focus scores, p-value gathers) reads candidate
    pixels only, and the full-map download would dominate the scan.  Leave None for the reference-parity full map.
    """
    import jax.numpy as jnp

    from chromosight_tpu import preprocessing as preproc
    from chromosight_tpu.ops.convolve import DEFAULT_THRESHOLD
    from chromosight_tpu.ops.normxcorr import _normxcorr_impl, build_tsvd_pack

    kernel = np.asarray(kernel, np.float32)
    mk, nk = kernel.shape
    if missing_vectors is not None:
        # Crossing masks (missing rows | missing cols) described by two
        # boolean vectors: mask blocks are built on device, nothing mask-
        # shaped ever crosses the link.  In full mode the frame margins
        # are themselves a crossing (all-margin rows | all-margin cols),
        # so framing is exact vector padding — valid for the non-banded
        # case only (the banded frame rules are not a crossing).
        if sym_upper:
            raise ValueError(
                "missing_vectors only supports sym_upper=False maps"
            )
        if missing_mask is not None:
            raise ValueError("pass missing_mask or missing_vectors, not both")
    with _obs.stage("host: frame"):
        if full:
            framed = preproc.zero_pad_sparse(
                signal, margin_h=nk - 1, margin_v=mk - 1, fmt="csr"
            ).astype(np.float32)
            fmask = (
                preproc.frame_missing_mask(
                    missing_mask,
                    (mk, nk),
                    sym_upper=sym_upper,
                    max_dist=max_dist,
                ).tocsr()
                if missing_mask is not None
                else None
            )
        else:
            framed = signal.tocsr().astype(np.float32)
            fmask = (
                missing_mask.tocsr() if missing_mask is not None else None
            )

    Ms, Ns = framed.shape
    mask_vectors = None
    if missing_vectors is not None:
        mr = np.asarray(missing_vectors[0], dtype=bool)
        mc = np.asarray(missing_vectors[1], dtype=bool)
        if full:
            rv = np.ones(Ms, dtype=bool)
            rv[mk - 1 : mk - 1 + len(mr)] = mr
            cv = np.ones(Ns, dtype=bool)
            cv[nk - 1 : nk - 1 + len(mc)] = mc
        else:
            rv, cv = mr, mc
        mask_vectors = (rv, cv)
    hm0, hn0 = (mk - 1) // 2, (nk - 1) // 2
    hm1, hn1 = mk - 1 - hm0, nk - 1 - hn0
    T = _tile_size(tile)
    with_mask = fmask is not None or mask_vectors is not None
    with_tsvd = tsvd is not None
    kernel_dev = jnp.asarray(kernel)
    mask_dummy = jnp.zeros((1, 1), bool)
    _dummy = (jnp.zeros((1, 1)), jnp.zeros((1, 1)))
    tsvd_pack = (
        build_tsvd_pack(kernel, tsvd, jnp.float32)
        if with_tsvd
        else (_dummy, _dummy, _dummy)
    )

    rows, cols, vals, pvs = [], [], [], []

    def dispatch(item):
        r0, c0, block, mblock, nnz_src = item
        corr_b, pvals_b = _normxcorr_impl(
            block,
            kernel_dev,
            mblock if with_mask else mask_dummy,
            tsvd_pack,
            (mk, nk),
            False,  # framing already applied globally above
            False,  # triu applied below in global framed coordinates
            with_mask,
            float(missing_tol),
            bool(pval),
            DEFAULT_THRESHOLD,
            with_tsvd,
            force_window_nobs=bool(full and with_mask),
        )
        cap = _extract_cap(nnz_src, mk, nk, T)
        if cap is not None:
            return r0, c0, _extract_nonzero_tile(
                corr_b,
                pvals_b if pval else corr_b,
                T,
                hm0,
                hn0,
                cap,
                bool(pval),
            ), None
        if keep_min is not None:
            # Dense-ish tile in detect mode (typically an overflow
            # reroute from the batched engine): extract candidates only,
            # escalating the cap until the sentinel shows the extraction
            # was complete.  A dense (T, T) download — 16 MB through the
            # link per tile — is the last resort, not the default.
            cap2 = 1 << 14
            while cap2 < (T * T) // 4:
                arr = np.asarray(
                    _extract_nonzero_tile(
                        corr_b,
                        pvals_b if pval else corr_b,
                        T,
                        hm0,
                        hn0,
                        cap2,
                        bool(pval),
                        keep_min=keep_min,
                    )
                )
                if (arr[0] >= T).any():
                    return r0, c0, arr, None
                cap2 *= 4
        return r0, c0, None, (corr_b, pvals_b)

    def collect(entry):
        with _obs.stage("host: collect"):
            _collect_impl(entry)

    def _collect_impl(entry):
        r0, c0, packed, blocks = entry
        if packed is not None:
            arr = np.asarray(packed)  # one packed (4, cap) download
            keepnz = arr[0] < T
            ii = arr[0, keepnz].astype(np.int64)
            jj = arr[1, keepnz].astype(np.int64)
            vv = arr[2, keepnz]
            lp = arr[3, keepnz]
        else:
            corr_b, pvals_b = blocks
            sub = np.asarray(corr_b)[hm0 : hm0 + T, hn0 : hn0 + T]
            ii, jj = np.nonzero(sub)
            vv = sub[ii, jj]
            if pval:
                psub = np.asarray(pvals_b)[hm0 : hm0 + T, hn0 : hn0 + T]
                lp = psub[ii, jj]
        if len(ii) == 0:
            return
        gi, gj = ii + r0, jj + c0
        keep = (gi >= hm0) & (gi < Ms - hm1) & (gj >= hn0) & (gj < Ns - hn1)
        if sym_upper:
            # Reference applies sp.triu before cropping the frame
            # (detection.py:1098-1099): framed coordinates.
            keep &= gj >= gi
        gi, gj = gi[keep], gj[keep]
        rows.append(gi)
        cols.append(gj)
        vals.append(vv[keep])
        if pval:
            pvs.append(lp[keep])

    if _batch_size() > 1:
        # Batched engine: tiles whose packed extraction fits run B at a
        # time through one fused scatter->Pearson->extract program; the
        # few dense-ish tiles (packed download larger than the dense
        # block) keep the per-tile dense-download path.  A counting
        # prepass (no triplets) sizes the global capacities so the
        # descriptors can stream — only pipeline-depth batches of COO
        # copies are ever alive on host.
        mask_mode = (
            "vec"
            if mask_vectors is not None
            else ("coo" if fmask is not None else "none")
        )

        def _is_batched(nnz):
            return keep_min is not None or _extract_cap(
                nnz, mk, nk, T
            ) is not None

        with _obs.stage("host: tile counts"):
            batched_counts = [
                (n, m)
                for n, m in _iter_tile_counts(
                    framed, fmask, T, mk, nk, mask_mode == "coo"
                )
                if _is_batched(n)
            ]
        per_tile = []

        def _batched_stream():
            for t in _iter_tiles_host(
                framed, fmask, T, mk, nk, mask_vectors=mask_vectors
            ):
                if _is_batched(t[6]):
                    yield t
                else:
                    per_tile.append(t)

        overflow = []
        stream = _batched_stream()
        for entry in _batched_pearson_entries(
            stream,
            kernel_dev,
            tsvd_pack,
            T,
            mk,
            nk,
            mask_mode,
            missing_tol,
            pval,
            with_tsvd,
            bool(full and with_mask),
            DEFAULT_THRESHOLD,
            keep_min=keep_min,
            overflow_out=overflow,
            counts=batched_counts,
        ):
            collect(entry)
        for _ in stream:
            # drain: when every tile routed per-tile (batched_counts
            # empty) the entries generator never consumed the stream,
            # and per_tile is filled here.
            pass
        per_tile.extend(overflow)

        def _dense_tile_blocks():
            BM, BN = T + mk - 1, T + nk - 1
            for r0, c0, ii, jj, vv, mp, nnz in per_tile:
                block, mblock = _tile_to_device(ii, jj, vv, mp, (BM, BN))
                yield r0, c0, block, mblock, nnz

        for entry in _pipeline(dispatch, _dense_tile_blocks()):
            collect(entry)
    else:
        for entry in _pipeline(
            dispatch,
            _iter_blocks(framed, fmask, T, mk, nk, mask_vectors=mask_vectors),
        ):
            collect(entry)

    with _obs.stage("host: assemble"):
        corr = _assemble(rows, cols, vals, (Ms, Ns))
    if pval:
        # p-values share the correlation sparsity pattern
        # (reference detection.py:1108-1125: pvals = out.copy()).
        pmat = sp.coo_matrix(
            (
                np.concatenate(pvs) if pvs else np.zeros(0, np.float32),
                (
                    np.concatenate(rows) if rows else np.zeros(0, np.int64),
                    np.concatenate(cols) if cols else np.zeros(0, np.int64),
                ),
            ),
            shape=(Ms, Ns),
            dtype=np.float32,
        ).tocsr()
    else:
        pmat = None
    if full:
        corr = corr[mk - 1 : Ms - (mk - 1), nk - 1 : Ns - (nk - 1)]
        if pmat is not None:
            pmat = pmat[mk - 1 : Ms - (mk - 1), nk - 1 : Ns - (nk - 1)]
    return corr, pmat
