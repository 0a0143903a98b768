"""Probe: per-op cost of the band detect tail on the device.

Times each tail op in isolation on the genome bucket shape (49152 x 417),
to place bench.py's "device wait: extract" and "device wait: gathers"
stage counters:

  a) extract_candidates_packed (jnp.nonzero formulation, cap 65536)
  b) a two-stage top_k extraction (per-row top-K then global top_k, as
     the tiled engine's extraction does)
  c) gather_scores_logp (64-coordinate pad bucket)
  d) gather_windows_dev (64 patterns, 17x17)

Every timing fences through a host readback.
"""

import sys
import time
from functools import partial

import numpy as np

sys.path.insert(0, ".")

import jax
import jax.numpy as jnp

from chromosight_tpu import config as _cfg

_cfg.init_compilation_cache()

from chromosight_tpu.ops import band as B

N_PAD, WIDTH = 49152, 417
rng = np.random.default_rng(0)
corr = rng.normal(0, 0.05, (N_PAD, WIDTH)).astype(np.float32)
# ~120 candidate pixels clustered like real loci
hot = rng.choice(N_PAD * WIDTH, 120, replace=False)
corr.ravel()[hot] = 0.6
corr_d = jnp.asarray(corr)
cand_d = jnp.asarray(corr >= 0.5)

CAP = 1 << 16
ROW_K = 32


@partial(jax.jit, static_argnames=("cap",))
def extract_two_stage(corr, cand, cap):
    n, w = corr.shape
    s = jnp.where(cand, corr, -jnp.inf)
    rowcnt = jnp.sum(cand, axis=1)
    row_over = jnp.max(rowcnt) > ROW_K
    rtop, ridx = jax.lax.top_k(s, ROW_K)          # (n, ROW_K)
    flat = rtop.reshape(-1)
    top, idx2 = jax.lax.top_k(flat, cap)
    valid = jnp.isfinite(top)
    rows = idx2 // ROW_K
    cols = ridx.reshape(-1)[idx2]
    count = jnp.sum(cand)
    ii = jnp.where(valid, rows, -1)
    payload = jnp.where(row_over, jnp.float32(-1), count.astype(jnp.float32))
    return jnp.stack(
        [
            ii.astype(jnp.float32),
            jnp.where(valid, cols, 0).astype(jnp.float32),
            jnp.where(valid, top, 0.0),
            jnp.full((cap,), payload, jnp.float32),
        ]
    )


def timeit(name, fn, *args, nrep=3):
    t0 = time.perf_counter()
    r = np.asarray(fn(*args))
    warm = time.perf_counter() - t0
    ts = []
    for _ in range(nrep):
        t0 = time.perf_counter()
        r = np.asarray(fn(*args))
        ts.append(time.perf_counter() - t0)
    print(
        f"{name}: warm {warm:.2f}s, steady {min(ts)*1e3:.1f} ms "
        f"(all {[round(t*1e3,1) for t in ts]})",
        flush=True,
    )
    return r


a = timeit("extract_packed nonzero cap=64k",
           B.extract_candidates_packed, corr_d, cand_d, CAP)
b = timeit("extract two-stage topk cap=64k",
           extract_two_stage, corr_d, cand_d, CAP)
b4k = timeit("extract two-stage topk cap=4k",
             extract_two_stage, corr_d, cand_d, 1 << 12)

# parity: same candidate set (order may differ)
na = int(a[3, 0])
sa = set(zip(a[0, :na].astype(int), a[1, :na].astype(int)))
nb = int(b[3, 0])
sb = set(zip(b[0, :nb].astype(int), b[1, :nb].astype(int)))
print(f"parity: counts {na}/{nb}, sets equal: {sa == sb}")

p1 = np.zeros(64, np.int32)
dsc = np.zeros(64, np.int32)
p1[:10] = np.arange(10) * 100
dsc[:10] = 5
logp_d = corr_d * 0.5
timeit("gather_scores_logp (64 pad)",
       B.gather_scores_logp, corr_d, logp_d, jnp.asarray(p1), jnp.asarray(dsc))
p2 = p1 + dsc
timeit("gather_windows_dev (64 x 17x17)",
       lambda *a: B.gather_windows_dev(*a, 17, 17),
       corr_d, jnp.asarray(p1), jnp.asarray(p2))
