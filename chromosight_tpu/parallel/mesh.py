"""Device-mesh helpers and the sharded band-detection step."""

from __future__ import annotations

import os
import threading

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices=None, dp=1):
    """Build a (dp, sp) mesh over the first ``n_devices`` devices.

    ``dp`` chromosome-batch shards x ``sp`` genomic-row shards.
    """
    devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    if n_devices % dp:
        raise ValueError("dp must divide n_devices")
    arr = np.array(devices[:n_devices]).reshape(dp, n_devices // dp)
    return Mesh(arr, ("dp", "sp"))


def shard_band(band, missing, mesh):
    """Place a batched band tensor (b, n, W) and missing flags (b, n) on the
    mesh: batch over dp, rows over sp, diagonals replicated."""
    band_sharding = NamedSharding(mesh, P("dp", "sp", None))
    miss_sharding = NamedSharding(mesh, P("dp", None))
    return (
        jax.device_put(band, band_sharding),
        jax.device_put(missing, miss_sharding),
    )


def auto_mesh(batch=1):
    """A (dp, sp) mesh over every visible device, with dp the largest
    divisor of the device count not exceeding the batch size; None on a
    single device (the caller should use the unsharded path)."""
    n_dev = len(jax.devices())
    if n_dev < 2:
        return None
    dp = 1
    for cand in range(min(int(batch), n_dev), 0, -1):
        if n_dev % cand == 0:
            dp = cand
            break
    return make_mesh(n_dev, dp=dp)


import functools


@functools.lru_cache(maxsize=None)
def _sharded_detect_fn(mesh, multi):
    """Cached jitted sharded detection step for a mesh.

    A fresh ``jax.jit(jax.vmap(closure))`` per call would retrace (and
    re-look-up the executable) once per chromosome batch; caching on
    (mesh, multi) keeps one stable jit wrapper whose own signature cache
    then serves every shape bucket.
    """
    spec = (
        P("dp", None, "sp", None) if multi else P("dp", "sp", None)
    )
    out_shardings = tuple(NamedSharding(mesh, spec) for _ in range(3))

    def run(
        bands,
        missing,
        kernel,
        sheared,
        sheared_sq,
        n,
        max_dist,
        pearson_min,
        kernel_shape,
        missing_tol,
    ):
        from chromosight_tpu.ops.band import (
            band_normxcorr,
            band_normxcorr_multi,
        )

        fn = band_normxcorr_multi if multi else band_normxcorr

        def one(band, miss, n_i, md_i):
            return fn(
                band,
                miss,
                kernel,
                sheared,
                sheared_sq,
                kernel_shape,
                n_i,
                md_i,
                missing_tol,
                pearson_min,
            )

        return jax.vmap(one)(bands, missing, n, max_dist)

    return jax.jit(
        run,
        static_argnames=("kernel_shape", "missing_tol"),
        out_shardings=out_shardings,
    )


def sharded_band_detect(
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
    """One fused detection step over a batch of band tensors on a mesh.

    vmaps the fused band normxcorr over the chromosome batch; inputs are
    sharded (dp over batch, sp over band rows), so XLA partitions the
    convolutions spatially and inserts halo exchange on the sp axis.
    ``n`` and ``max_dist`` may be scalars or per-chromosome (b,) arrays
    (chromosomes in one batch share a shape bucket, not a length).

    Returns (corr, log10_pvals, candidates), each (b, n_pad, W).
    """
    import jax.numpy as jnp

    b = bands.shape[0]
    n = jnp.broadcast_to(jnp.asarray(n, jnp.int32), (b,))
    max_dist = jnp.broadcast_to(jnp.asarray(max_dist, jnp.int32), (b,))
    bands, missing = shard_band(bands, missing, mesh)
    return _sharded_detect_fn(mesh, False)(
        bands,
        missing,
        kernel,
        sheared,
        sheared_sq,
        n,
        max_dist,
        pearson_min,
        kernel_shape=kernel_shape,
        missing_tol=missing_tol,
    )


def sharded_band_detect_multi(
    bands,
    missing,
    kernels,
    sheareds,
    sheareds_sq,
    kernel_shape,
    n,
    max_dist,
    missing_tol,
    pearson_min,
    mesh,
):
    """``sharded_band_detect`` with K same-shape kernels fused into the
    one sharded dispatch (multi-kernel configs like borders; quantify's
    per-kernel scoring loop).  Returns (corr, logp, cand), each
    (b, K, n_pad, W) sharded dp over batch / sp over rows."""
    import jax.numpy as jnp

    b = bands.shape[0]
    n = jnp.broadcast_to(jnp.asarray(n, jnp.int32), (b,))
    max_dist = jnp.broadcast_to(jnp.asarray(max_dist, jnp.int32), (b,))
    bands, missing = shard_band(bands, missing, mesh)
    return _sharded_detect_fn(mesh, True)(
        bands,
        missing,
        kernels,
        sheareds,
        sheareds_sq,
        n,
        max_dist,
        pearson_min,
        kernel_shape=kernel_shape,
        missing_tol=missing_tol,
    )


def detect_on_mesh(
    sub_rows,
    kernel_config,
    kernel_matrix,
    dump,
    tsvd,
    mesh,
    progress=None,
    destroy=True,
    coords_by_pos=None,
    threads=1,
):
    """Batched detection (or quantification) of every submatrix across
    the device mesh.

    Replaces the reference's per-submatrix process pool
    (cli/chromosight.py:748-750 for detect, 407-408 for quantify):
    band-eligible intra maps sharing a shape bucket are stacked into one
    (b, n_pad, W) tensor and correlated in a single sharded dispatch
    (dp over chromosomes, sp over genomic rows); the host tail (foci
    labeling or coordinate scoring, validation) then runs per chromosome.
    Dense/inter maps fall back to the per-map detector.

    ``sub_rows`` is ``list(genome.sub_mats.iterrows())``; returns result
    dicts in order, same shape as the single-device scan.
    ``coords_by_pos`` switches to quantify mode: a dict mapping each
    position in ``sub_rows`` to the (n, 2) array of submatrix bin
    coordinates to score there (maps with no coordinates are skipped
    without being materialised, like the reference worker, cli:229-260).
    ``threads`` > 1 runs the per-chromosome host tails (candidate
    extraction, foci labeling, validation — numpy/native work that
    releases the GIL) in a thread pool, the analog of the reference's
    N-process pool for everything the sharded dispatch doesn't cover.

    ``kernel_matrix`` may be a LIST of same-shape kernels: all of them
    then ride ONE fused sharded dispatch per shape bucket
    (``sharded_band_detect_multi``) — the multi-kernel analog of the
    reference's kernel loop (cli/chromosight.py:730-792) — and the
    return value becomes a list of per-kernel result lists.
    """
    import jax.numpy as jnp

    import chromosight_tpu.detection as cid
    from chromosight_tpu.ops.band import shear_kernel
    from chromosight_tpu.runtime.contact_map import ROW_BUCKET, bucket_size

    multi = isinstance(kernel_matrix, (list, tuple))
    kernels = (
        [np.asarray(k) for k in kernel_matrix]
        if multi
        else [np.asarray(kernel_matrix)]
    )
    if multi and len({k.shape for k in kernels}) != 1:
        raise ValueError("fused multi-kernel scan needs same-shape kernels")
    results = [[None] * len(sub_rows) for _ in kernels]

    def finish(pos, per_kernel):
        sub = sub_rows[pos][1]
        for k, (patterns, windows) in enumerate(per_kernel):
            results[k][pos] = {
                "coords": patterns,
                "windows": windows,
                "chr1": sub.chr1,
                "chr2": sub.chr2,
            }
        if progress is not None:
            progress(results[0][pos])

    def coords_for(pos):
        return None if coords_by_pos is None else coords_by_pos[pos]

    # materialize all maps (threaded: h5py reads, the native scatter and
    # device uploads all release the GIL), split band-eligible from
    # fallback
    active = []
    for pos, (_, sub) in enumerate(sub_rows):
        if coords_by_pos is not None and len(coords_by_pos.get(pos, ())) == 0:
            finish(pos, [(None, None)] * len(kernels))
            continue
        active.append(pos)

    def create(pos):
        cm = sub_rows[pos][1].contact_map
        if cm.band_dev is None and cm.dense is None and cm.sparse is None:
            cm.create_mat()

    if int(threads) > 1 and len(active) > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(int(threads)) as pool:
            list(pool.map(create, active))
    else:
        for pos in active:
            create(pos)

    groups = {}
    fallback = []
    for pos in active:
        cm = sub_rows[pos][1].contact_map
        if cm.band_dev is not None and not cid._band_guards(
            cm, kernels[0]
        ):
            rows, width = cm.band_dev.shape
            key = (bucket_size(rows, ROW_BUCKET), width)
            groups.setdefault(key, []).append(pos)
        else:
            fallback.append(pos)

    km, kn = kernels[0].shape
    shs, sh2s = [], []
    for k in kernels:
        conv_k, conv_k2 = cid._band_conv_kernels(k, tsvd)
        shs.append(shear_kernel(conv_k))
        sh2s.append(shear_kernel(conv_k2))
    if multi:
        kern = jnp.asarray(np.stack(kernels), jnp.float32)
        sh = jnp.asarray(np.stack(shs), jnp.float32)
        sh2 = jnp.asarray(np.stack(sh2s), jnp.float32)
    else:
        kern = jnp.asarray(kernels[0], jnp.float32)
        sh = jnp.asarray(shs[0], jnp.float32)
        sh2 = jnp.asarray(sh2s[0], jnp.float32)
    missing_tol = kernel_config["max_perc_undetected"] / 100
    pearson_min = float(kernel_config["pearson"])

    import chromosight_tpu.preprocessing as preproc

    for (n_pad, width), members in sorted(groups.items()):
        dp = mesh.shape["dp"]
        slots = members + [None] * (-len(members) % dp)
        bands, miss, ns, mds = [], [], [], []
        for pos in slots:
            if pos is None:  # batch padding: an empty chromosome (n=0)
                bands.append(jnp.zeros((n_pad, width), jnp.float32))
                miss.append(np.zeros(n_pad, bool))
                ns.append(0)
                mds.append(0)
                continue
            cm = sub_rows[pos][1].contact_map
            n = cm.shape[0]  # logical rows; band_dev is bucket-padded
            rows = cm.band_dev.shape[0]
            bands.append(
                jnp.pad(
                    cm.band_dev.astype(jnp.float32),
                    ((0, n_pad - rows), (0, 0)),
                )
            )
            flags = np.zeros(n_pad, bool)
            flags[:n] = preproc.missing_flags(cm.detectable_bins[0], n)
            miss.append(flags)
            ns.append(n)
            mds.append(int(cm.max_dist))
        if multi:
            detect_fn = sharded_band_detect_multi
        elif os.environ.get("CHROMOSIGHT_TPU_SHARD_MAP", "0") == "1":
            # Explicit-ppermute halo engine (single-kernel dispatches):
            # two kernel-halo slab sends instead of GSPMD's inferred
            # collectives; falls back internally on tiny shards.
            from chromosight_tpu.parallel.shard_map_band import (
                shard_map_band_detect,
            )

            detect_fn = shard_map_band_detect
        else:
            detect_fn = sharded_band_detect
        corr, logp, cand = detect_fn(
            jnp.stack(bands),
            jnp.asarray(np.stack(miss)),
            kern,
            sh,
            sh2,
            (km, kn),
            np.asarray(ns),
            np.asarray(mds),
            missing_tol,
            pearson_min,
            mesh,
        )
        # On the forced-host CPU platform (the 8-virtual-device test /
        # dryrun environment) overlapping multi-device programs race:
        # dispatching the cross-device slot gathers below while the
        # sharded detect (with its halo collective-permutes) is still
        # executing aborts the process intermittently (silent SIGABRT
        # inside the gather's first execution; see NOTES.md).  Fence the
        # producer — and each gather — before the next multi-device
        # dispatch.  GPU meshes run the gathers behind the sharded
        # program in stream order and skip the fence.
        cpu_fence = next(iter(np.asarray(mesh.devices).flat)).platform == "cpu"
        if cpu_fence:
            jax.block_until_ready((corr, logp, cand))
        gather_lock = threading.Lock() if cpu_fence else None

        def slot_slices(slot, k):
            if gather_lock is None:
                return (
                    (corr[slot, k], logp[slot, k], cand[slot, k])
                    if multi
                    else (corr[slot], logp[slot], cand[slot])
                )
            # serialize gather dispatches across threaded tails too
            with gather_lock:
                parts = (
                    (corr[slot, k], logp[slot, k], cand[slot, k])
                    if multi
                    else (corr[slot], logp[slot], cand[slot])
                )
                return jax.block_until_ready(parts)

        def tail(slot_pos):
            slot, pos = slot_pos
            cm = sub_rows[pos][1].contact_map
            res = [
                cid._band_tail(
                    cm,
                    kernel_config,
                    kernels[k],
                    coords_for(pos),
                    dump,
                    *slot_slices(slot, k),
                )
                for k in range(len(kernels))
            ]
            if destroy:
                cm.destroy_mat()
            return pos, res

        n_threads = max(1, int(threads))
        if n_threads > 1 and len(members) > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(n_threads) as pool:
                for pos, res in pool.map(tail, enumerate(members)):
                    finish(pos, res)
        else:
            for slot_pos in enumerate(members):
                pos, res = tail(slot_pos)
                finish(pos, res)

    # Non-banded maps (dense/sparse trans pairs, kernel-too-big intra):
    # round-robin whole maps across the mesh's devices — the analog of the
    # reference pool iterating trans submatrices (cli/chromosight.py:
    # 748-750).  jax.default_device is thread-local, so each worker's
    # dispatches (the fused dense normxcorr, or the tiled engine's own
    # per-tile round-robin) land on its assigned device.
    mesh_devices = list(np.asarray(mesh.devices).ravel())

    def run_fallback(slot_pos):
        slot, pos = slot_pos
        cm = sub_rows[pos][1].contact_map
        with jax.default_device(mesh_devices[slot % len(mesh_devices)]):
            res = [
                cid.pattern_detector(
                    cm, kernel_config, k, coords=coords_for(pos),
                    dump=dump, full=True, tsvd=tsvd,
                )
                for k in kernels
            ]
        if destroy:
            cm.destroy_mat()
        return pos, res

    n_threads = max(1, int(threads))
    if n_threads > 1 and len(fallback) > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(min(n_threads, len(fallback))) as pool:
            for pos, res in pool.map(run_fallback, enumerate(fallback)):
                finish(pos, res)
    else:
        for slot_pos in enumerate(fallback):
            pos, res = run_fallback(slot_pos)
            finish(pos, res)

    return results if multi else results[0]
