"""Explicit-collective band detection: shard_map + ppermute halo exchange.

The GSPMD path (``parallel/mesh.py::sharded_band_detect``) lets XLA
partition the fused band program over the ``sp`` (genomic-row) axis; the
HLO audit shows it emits O(kernel-halo) collective-permutes for the
convolutions, but also one shard-sized permute relaying the
``sliding_vector`` skew of the missing-flags vector (GSPMD cannot see
that the skewed matrix is a view of a small vector; NOTES.md round-3
findings).

This module formulates the same computation with ``jax.shard_map``:

* each device holds a contiguous row slab of the band tensor and the
  FULL missing-flags vector (replicated — it is n_pad bools, ~48 KB for
  a human chromosome, vs the O(n_pad * width / n_dev) skew permute);
* the only communication is TWO ``lax.ppermute`` halo exchanges of
  ``mk - 1`` band rows with the neighbouring shards (the rows a
  height-``mk`` convolution reads across the shard boundary) — devices
  at the genome edges receive zeros, which is exactly the frame padding
  the global engine applies;
* every shard then runs the SAME framing rules and Pearson core as the
  single-device engine (``ops.band._frame_mask_rules`` /
  ``_pearson_core`` — shared code, so the engines cannot drift), with
  global row coordinates reconstructed from ``lax.axis_index``.

Because the convolutions (shifted multiply-adds) reduce only over the
kernel's taps, row-sharding reorders no reduction mathematically; in
practice XLA may fuse the float32 arithmetic differently for slab vs
full-row shapes, so scores agree with the single-device
``band_normxcorr`` to ~1e-6 with IDENTICAL candidate maps (asserted in
tests/test_parallel.py), the same fp32-scheduling equivalence class as
the GSPMD path.

Role parity: the reference parallelises over whole submatrices with a
process pool (``cli/chromosight.py:748-750``); this shards WITHIN one
chromosome's scan, the axis the reference cannot split.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import NamedSharding, PartitionSpec as P


def shard_map_band_detect(
    bands,
    missing,
    kernel,
    sheared,
    sheared_sq,
    kernel_shape,
    n,
    max_dist,
    missing_tol,
    pearson_min,
    mesh,
):
    """Drop-in replacement for ``sharded_band_detect`` with explicit
    halo exchange.  Same contract: ``bands`` (b, n_pad, W) with batch
    over ``dp`` and rows over ``sp``, ``missing`` (b, n_pad) bool,
    ``n`` / ``max_dist`` scalars or (b,) arrays; returns
    (corr, log10_pvals, candidates), each (b, n_pad, W) and bitwise
    equal to ``jax.vmap(band_normxcorr)``.

    Falls back to the GSPMD engine when the row shard is shorter than
    the kernel halo (tiny maps on large meshes).
    """
    from chromosight_tpu.ops.band import (
        DEFAULT_THRESHOLD,
        _frame_mask_rules,
        _iota2,
        _pearson_core,
        sliding_vector,
    )

    b, n_pad, width = bands.shape
    mk, nk = kernel_shape
    halo = mk - 1
    sp = mesh.shape["sp"]
    dp = mesh.shape["dp"]
    rows_loc = n_pad // sp
    if n_pad % sp or rows_loc < max(halo, 1) or b % dp:
        from chromosight_tpu.parallel.mesh import sharded_band_detect

        return sharded_band_detect(
            bands,
            missing,
            kernel,
            sheared,
            sheared_sq,
            kernel_shape,
            n,
            max_dist,
            missing_tol,
            pearson_min,
            mesh,
        )

    n = jnp.broadcast_to(jnp.asarray(n, jnp.int32), (b,))
    max_dist = jnp.broadcast_to(jnp.asarray(max_dist, jnp.int32), (b,))
    kh = (mk - 1) // 2
    kw = (nk - 1) // 2
    reach = kh + kw
    dt = jnp.float32

    def one_map(slab, miss_full, n_i, md_i, row0):
        """Score one map's local row slab.

        slab: (rows_loc + 2*halo, W) — matrix rows
        [row0 - halo, row0 + rows_loc + halo); rows outside the tensor
        are zero (edge shards), exactly the global engine's row pad.
        miss_full: (n_pad,) bool, replicated.
        """
        R = rows_loc + 2 * halo
        i0 = row0 - halo  # global matrix row of slab row 0
        i = _iota2((R, width), 0) + i0
        d = _iota2((R, width), 1)
        j = i + d
        in_matrix = (i >= 0) & (i < n_i) & (j < n_i)
        sig = jnp.where(in_matrix, slab, jnp.zeros((), dt))

        # Missing flags for slab rows and their +d reach, all from the
        # replicated vector: pad halo zeros in front (i < 0) and
        # width + halo zeros behind (i >= n_pad), then slice locally.
        miss_pad = jnp.concatenate(
            [
                jnp.zeros((halo,), miss_full.dtype),
                miss_full,
                jnp.zeros((width + halo,), miss_full.dtype),
            ]
        )
        vec = lax.dynamic_slice(miss_pad, (row0,), (R + width,))
        miss_i = vec[:R]
        miss_j = sliding_vector(vec, R, width)
        mask = (miss_i[:, None] | miss_j) & (d <= md_i) & in_matrix

        # Column pad only — the slab already carries its row halo.
        sig_p = jnp.pad(sig, ((0, 0), (reach, reach)))
        mask_p = jnp.pad(mask, ((0, 0), (reach, reach))).astype(dt)
        pi = _iota2(sig_p.shape, 0) + i0
        pd = _iota2(sig_p.shape, 1) - reach
        frame = _frame_mask_rules(pi, pd, n_i, md_i, kernel_shape)
        mask_p = jnp.where(frame, jnp.asarray(1, dt), mask_p)

        out, logp = _pearson_core(
            sig_p,
            mask_p,
            kernel,
            sheared,
            sheared_sq,
            kernel_shape,
            missing_tol,
            DEFAULT_THRESHOLD,
        )
        # Valid conv rows t read slab rows [t, t + mk - 1]; the global
        # engine keeps conv rows [kh, kh + n_out) — locally that is
        # [kh, kh + rows_loc) (slab row halo == global row pad).
        out = lax.slice_in_dim(out, kh, kh + rows_loc, axis=0)
        logp = lax.slice_in_dim(logp, kh, kh + rows_loc, axis=0)

        oi = _iota2(out.shape, 0) + row0
        od = _iota2(out.shape, 1)
        keep = (od <= md_i) & (oi < n_i) & ((oi + od) < n_i)
        out = jnp.where(keep, out, jnp.zeros((), dt))
        cand = (out >= pearson_min) & (out != 0)
        return out, logp, cand

    def local_fn(band_loc, miss_loc, n_loc, md_loc):
        # band_loc: (b/dp, rows_loc, W); miss_loc: (b/dp, n_pad);
        # n_loc / md_loc: (b/dp,)
        row0 = lax.axis_index("sp") * rows_loc
        # Halo exchange: shard k receives the last `halo` rows of shard
        # k-1 (from above) and the first `halo` rows of shard k+1 (from
        # below).  Edge shards receive zeros — the global row pad.
        up = lax.ppermute(
            band_loc[:, rows_loc - halo :, :],
            "sp",
            [(k, k + 1) for k in range(sp - 1)],
        )
        down = lax.ppermute(
            band_loc[:, :halo, :],
            "sp",
            [(k + 1, k) for k in range(sp - 1)],
        )
        slab = jnp.concatenate([up, band_loc, down], axis=1)
        return jax.vmap(
            lambda s, m, ni, mdi: one_map(s, m, ni, mdi, row0)
        )(slab, miss_loc, n_loc, md_loc)

    fn = jax.shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(
            P("dp", "sp", None),
            P("dp", None),
            P("dp"),
            P("dp"),
        ),
        out_specs=(
            P("dp", "sp", None),
            P("dp", "sp", None),
            P("dp", "sp", None),
        ),
    )

    bands = jax.device_put(
        bands, NamedSharding(mesh, P("dp", "sp", None))
    )
    missing = jax.device_put(missing, NamedSharding(mesh, P("dp", None)))
    return jax.jit(fn)(bands, missing, n, max_dist)
