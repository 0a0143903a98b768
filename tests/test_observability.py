"""Compute accounting (MFU / roofline bookkeeping) unit tests.

The reference ships no profiling (SURVEY §5); this subsystem is new in
this package: per-dispatch logical FLOPs and HBM byte bounds from the
traced jaxpr, loop trip counts included (no lowering or compile).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chromosight_tpu.observability as obs


def setup_function(_fn):
    obs.reset()


def test_account_dispatch_matmul_flops_and_io_bounds():
    m, k, n = 64, 128, 32
    f = jax.jit(lambda a, b: a @ b)
    a = jnp.zeros((m, k), jnp.float32)
    b = jnp.zeros((k, n), jnp.float32)
    obs.account_dispatch("mm", f, a, b)
    obs.account_dispatch("mm", f, a, b)
    snap = obs.compute_snapshot()
    assert set(snap) == {"mm"}
    rec = snap["mm"]
    assert rec["dispatches"] == 2
    # logical matmul flops = 2*m*k*n per dispatch
    assert rec["flops"] == 2 * (2 * m * k * n)
    io_min = 4 * (m * k + k * n + m * n)
    assert rec["hbm_min_bytes"] == 2 * io_min
    assert rec["hbm_unfused_bytes"] >= rec["hbm_min_bytes"]


def test_cost_cache_ignores_traced_scalar_values():
    """Traced scalars (row counts, max_dist) must not fragment the cost
    cache — one trace per shape bucket, not one per chromosome."""
    f = jax.jit(lambda a, n: a * n)
    a = jnp.zeros((8, 8), jnp.float32)
    obs.account_dispatch("scaled", f, a, 3)
    before = len(obs._COST_CACHE)
    obs.account_dispatch("scaled", f, a, 7)  # same shapes, new scalar
    assert len(obs._COST_CACHE) == before
    assert obs.compute_snapshot()["scaled"]["dispatches"] == 2


def test_account_dispatch_never_raises_on_bad_args():
    obs.account_dispatch("broken", jax.jit(lambda a: a), object())
    assert obs.compute_snapshot()["broken"]["flops"] == 0.0


def test_reset_clears_compute_totals():
    f = jax.jit(lambda a: a + 1)
    obs.account_dispatch("x", f, jnp.zeros(4))
    obs.reset()
    assert obs.compute_snapshot() == {}


def test_device_peaks_cpu_is_none(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
    assert obs.device_peaks() is None


class _FakeDevice:
    def __init__(self, kind):
        self.device_kind = kind


@pytest.mark.parametrize(
    "kind,expect",
    [
        (
            "NVIDIA H100 80GB HBM3",
            {
                "bf16_flops": 989e12,
                "tf32_flops": 495e12,
                "fp32_flops": 67e12,
                "hbm_bytes": 3.35e12,
            },
        ),
        ("NVIDIA A100-SXM4-80GB", KeyError),
        ("NVIDIA H200", KeyError),
    ],
)
def test_device_peaks_by_device_kind(monkeypatch, kind, expect):
    """Peaks come from the published table by exact device kind; an
    accelerator missing from it raises instead of borrowing a rate."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(jax, "devices", lambda *a: [_FakeDevice(kind)])
    if expect is KeyError:
        with pytest.raises(KeyError):
            obs.device_peaks()
    else:
        assert obs.device_peaks() == dict(expect, kind=kind)


def test_band_cost_scales_with_kernel_taps():
    """The band sweep's accounted FLOPs must track the sheared-stencil
    tap count (the analytic roofline NOTES.md reasons from)."""
    from chromosight_tpu.ops.band import band_normxcorr, shear_kernel

    n_pad, width = 256, 64
    band = jnp.zeros((n_pad, width), jnp.float32)
    miss = jnp.zeros((n_pad,), bool)

    def run(km, kn, name):
        k = np.ones((km, kn), np.float32)
        sh = jnp.asarray(shear_kernel(k))
        obs.account_dispatch(
            name,
            band_normxcorr,
            band,
            miss,
            jnp.asarray(k),
            sh,
            sh,
            (km, kn),
            n_pad,
            width - 1,
            0.5,
            0.3,
        )
        return obs.compute_snapshot()[name]["flops"]

    small = run(3, 3, "band3")
    big = run(7, 7, "band7")
    assert big > 2 * small


def test_jaxpr_cost_counts_loop_trips_and_convs():
    """A static fori_loop body counts once per trip (XLA's cost analysis
    counts it once); a loop of unknown trip count counts once; a conv
    counts 2 x output x window x input features."""
    from jax import lax

    x = jnp.zeros((8, 8), jnp.float32)

    def fixed(a):
        return lax.fori_loop(0, 10, lambda i, v: v * 2.0 + 1.0, a)

    # each trip: the body's two ops on 64 elements and the counter's add;
    # bytes: their f32[8, 8] operands and results, scalar literals, and
    # the int32 counter's operands and result
    flops, traffic = obs.jaxpr_cost(jax.make_jaxpr(fixed)(x).jaxpr)
    assert flops == 10 * (2 * 64 + 1)
    assert traffic == 10 * (2 * (256 + 4 + 256) + 3 * 4)

    def dynamic(a, n):
        return lax.fori_loop(0, n, lambda i, v: v * 2.0, a)

    assert obs.jaxpr_cost(jax.make_jaxpr(dynamic)(x, 3).jaxpr)[0] == 64 + 1

    img = jnp.zeros((1, 3, 10, 12), jnp.float32)
    ker = jnp.zeros((4, 3, 5, 5), jnp.float32)

    def conv(a, k):
        return lax.conv_general_dilated(a, k, (1, 1), "VALID")

    assert obs.jaxpr_cost(jax.make_jaxpr(conv)(img, ker).jaxpr)[0] == (
        2 * (1 * 4 * 6 * 8) * (3 * 5 * 5)
    )
