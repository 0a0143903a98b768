"""Probe: how much of a band_normxcorr dispatch is the log-p epilogue?

Times three jitted programs on a genome-bucket-shaped synthetic band
(49152 x 417, the human-5kb shape bench.py scans 13 times):

  a) the production band_normxcorr (out, logp, cand)
  b) the same program returning only (out, cand) -- XLA dead-code
     eliminates the arctanh/log_ndtr epilogue and the logp output
  c) b) plus a (n_pres) output -- what the deferred-logp refactor would
     ship (logp recomputed later at gathered candidates only)

All timings fence through a scalar readback.
"""

import sys
import time

import numpy as np

sys.path.insert(0, ".")

import jax
import jax.numpy as jnp

from chromosight_tpu import config as _cfg

_cfg.init_compilation_cache()

from chromosight_tpu.ops import band as B

N_PAD, WIDTH = 49152, 417
N = 48000
MAXD = 400
MK = NK = 17

rng = np.random.default_rng(0)
band = jnp.asarray(rng.gamma(2.0, 1.0, (N_PAD, WIDTH)).astype(np.float32))
missing = np.zeros(N_PAD, bool)
missing[rng.choice(N, 900, replace=False)] = True
missing = jnp.asarray(missing)
kernel = rng.gamma(2.0, 1.0, (MK, NK)).astype(np.float32)
sheared = jnp.asarray(B.shear_kernel(kernel))
sheared_sq = jnp.asarray(B.shear_kernel(kernel**2))
kern_d = jnp.asarray(kernel)


def fence(*arrs):
    return float(sum(jnp.sum(a[0]) for a in arrs))


full = B.band_normxcorr


@jax.jit
def no_logp(band, missing, kernel, sheared, sheared_sq, n, max_dist):
    out, logp, cand = B.band_normxcorr(
        band, missing, kernel, sheared, sheared_sq,
        (MK, NK), n, max_dist, 0.3, 0.5,
    )
    return out, cand


@jax.jit
def with_npres(band, missing, kernel, sheared, sheared_sq, n, max_dist):
    sig_p, mask_p = B._band_frame(band, missing, (MK, NK), n, max_dist)
    kh = (MK - 1) // 2
    out, logp = B._pearson_core(
        sig_p, mask_p, kernel, sheared, sheared_sq, (MK, NK), 0.3, 1e-4
    )
    # n_pres recomputed cheaply (window sum of the mask)
    n_miss = B._band_window_sum(mask_p, MK, NK)
    npres = MK * NK - n_miss
    out = jax.lax.dynamic_slice_in_dim(out, kh, N_PAD, axis=0)
    npres = jax.lax.dynamic_slice_in_dim(npres, kh, N_PAD, axis=0)
    oi = B._iota2(out.shape, 0)
    od = B._iota2(out.shape, 1)
    keep = (od <= max_dist) & (oi < n) & ((oi + od) < n)
    out = jnp.where(keep, out, 0.0)
    cand = (out >= 0.5) & (out != 0)
    return out, npres, cand


def timeit(name, fn, nrep=3):
    args = (band, missing, kern_d, sheared, sheared_sq,
            jnp.asarray(N), jnp.asarray(MAXD))
    if fn is full:
        args = (band, missing, kern_d, sheared, sheared_sq,
                (MK, NK), jnp.asarray(N), jnp.asarray(MAXD), 0.3, 0.5)
    t0 = time.perf_counter()
    outs = fn(*args)
    fence(*[o for o in outs])
    warm = time.perf_counter() - t0
    ts = []
    for _ in range(nrep):
        t0 = time.perf_counter()
        outs = fn(*args)
        fence(*[o for o in outs])
        ts.append(time.perf_counter() - t0)
    print(f"{name}: warm {warm:.2f}s, steady {min(ts)*1e3:.1f} ms "
          f"(all {[round(t*1e3,1) for t in ts]})", flush=True)
    return min(ts)


t_full = timeit("full (out, logp, cand)", full)
t_nologp = timeit("DCE'd logp (out, cand)", no_logp)
t_npres = timeit("deferred (out, npres, cand)", with_npres)
print(f"logp epilogue share: {(t_full - t_nologp) / t_full * 100:.1f}%")
print(f"deferred vs full: {t_full / t_npres:.2f}x")
