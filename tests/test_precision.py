"""Every matmul of the device programs runs at ``Precision.HIGHEST``.

On a GPU a float32 product without a stated precision may run in TF32,
which keeps about three decimal digits — far outside the 5e-5 score
budget the goldens hold the engine to.  These tests walk the jaxprs of
the sweep programs and fail on any ``dot_general`` or
``conv_general_dilated`` at another precision.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax

import chromosight_tpu.kernels as ck
from chromosight_tpu.ops.band import (
    band_normxcorr,
    band_normxcorr_at_packed,
    band_normxcorr_multi,
    shear_kernel,
)
from chromosight_tpu.ops.oracle import matmul_precisions

N, WIDTH, MAX_DIST = 256, 64, 40
K = np.asarray(ck.loops["kernels"][0], np.float32)
SH = jnp.asarray(shear_kernel(K))
SH2 = jnp.asarray(shear_kernel(K**2))
BAND = jnp.ones((N, WIDTH), jnp.float32)
MISS = jnp.zeros((N,), bool)


def _assert_highest(found, some=False):
    """All matmuls at HIGHEST; ``some``: the program has matmuls."""
    assert set(found) <= {lax.Precision.HIGHEST}, found
    assert found or not some


def test_band_normxcorr_matmuls_highest():
    found = matmul_precisions(
        lambda b, m: band_normxcorr(
            b, m, jnp.asarray(K), SH, SH2, K.shape, N, MAX_DIST, 0.5, 0.3
        ),
        BAND,
        MISS,
    )
    _assert_highest(found)


def test_band_normxcorr_multi_matmuls_highest():
    ks = np.stack([np.asarray(k, np.float32) for k in ck.borders["kernels"]])
    found = matmul_precisions(
        lambda b, m: band_normxcorr_multi(
            b,
            m,
            jnp.asarray(ks),
            jnp.asarray(np.stack([shear_kernel(k) for k in ks])),
            jnp.asarray(np.stack([shear_kernel(k**2) for k in ks])),
            ks.shape[1:],
            N,
            MAX_DIST,
            0.5,
            0.15,
        ),
        BAND,
        MISS,
    )
    _assert_highest(found)


def test_band_normxcorr_at_packed_matmuls_highest():
    rows = jnp.arange(8, dtype=jnp.int32) * 20
    diags = jnp.full((8,), 10, jnp.int32)
    found = matmul_precisions(
        lambda b, m: band_normxcorr_at_packed(
            b,
            m,
            rows,
            diags,
            jnp.asarray(K)[None],
            SH[None],
            SH2[None],
            K.shape,
            N,
            MAX_DIST,
            0.5,
        ),
        BAND,
        MISS,
    )
    _assert_highest(found, some=True)


@pytest.mark.parametrize("mask_mode", ["vec", "coo"])
def test_tiled_batch_program_matmuls_highest(mask_mode):
    from chromosight_tpu.ops import tiled

    mk, nk = K.shape
    T, B = 64, 2
    BM, BN = T + mk - 1, T + nk - 1
    cap_up = cap_m = 128
    buf_len = 2 * cap_up + (B * BM + B * BN if mask_mode == "vec" else cap_m)
    dummy = (jnp.zeros((1, 1)), jnp.zeros((1, 1)))
    statics = dict(
        B=B, BM=BM, BN=BN, T=T, hm0=(mk - 1) // 2, hn0=(nk - 1) // 2,
        cap_ex=256, cap_up=cap_up, cap_m=cap_m, kernel_shape=(mk, nk),
        mask_mode=mask_mode, missing_tol=0.5, pval=True, threshold=1e-4,
        with_tsvd=False, force_window_nobs=mask_mode == "vec", keep_min=0.3,
    )
    program = tiled._batched_pearson_program()
    found = matmul_precisions(
        lambda buf: program(buf, jnp.asarray(K), (dummy,) * 3, **statics),
        jnp.zeros((buf_len,), jnp.float32),
    )
    _assert_highest(found, some=mask_mode == "vec")


def test_matmul_precisions_sees_nested_and_default_precisions():
    def f(a, b):
        x = jnp.dot(a, b, precision=lax.Precision.HIGHEST)
        return jax.jit(lambda u: u @ b)(x)

    a = jnp.ones((4, 4))
    found = matmul_precisions(f, a, a)
    assert found == [lax.Precision.HIGHEST, lax.Precision.DEFAULT]
