"""Fused multi-kernel dispatch parity.

Multi-kernel configs (the borders preset ships three same-shape kernels,
reference ``kernels/borders.json``) and quantify's per-kernel scoring
loop (reference ``cli/chromosight.py:407-439``) correlate the SAME
preprocessed band with each kernel.  ``band_normxcorr_multi`` fuses the
K sweeps into one device program; these tests pin it to the single-kernel
program and the two CLI paths (single-device and mesh) to the
reference-generated goldens / the unfused path.
"""

import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
# Full CLI / end-to-end runs: minutes on one core. `pytest -m "not slow"` is the fast tier.
pytestmark = pytest.mark.slow


DATA = pathlib.Path(__file__).parent / "data"


def test_band_normxcorr_multi_matches_single():
    """Each slice of the fused K-kernel program equals the single-kernel
    program run on that kernel alone (bitwise candidate parity)."""
    import jax.numpy as jnp

    from chromosight_tpu.ops.band import (
        band_normxcorr,
        band_normxcorr_multi,
        coo_to_band,
        shear_kernel,
    )

    rng = np.random.RandomState(7)
    n, max_dist = 150, 40
    kernels = [rng.rand(5, 9) + 0.1 for _ in range(3)]
    mk, nk = kernels[0].shape
    keep = max_dist + max(mk, nk)
    dense = rng.rand(n, n)
    i, j = np.indices((n, n))
    dense[(j - i < 0) | (j - i > keep)] = 0
    miss = np.zeros(n, bool)
    miss[[0, 1, 30, 77]] = True
    dense[miss, :] = 0
    dense[:, miss] = 0

    width = keep + 1
    r, c = np.nonzero(dense)
    band = coo_to_band(r, c, dense[r, c], n, width)
    n_pad = 256
    band_p = np.zeros((n_pad, width), np.float32)
    band_p[:n] = band
    miss_p = np.zeros(n_pad, bool)
    miss_p[:n] = miss

    singles = [
        band_normxcorr(
            jnp.asarray(band_p),
            jnp.asarray(miss_p),
            jnp.asarray(K, jnp.float32),
            jnp.asarray(shear_kernel(K), jnp.float32),
            jnp.asarray(shear_kernel(K**2), jnp.float32),
            (mk, nk),
            n,
            max_dist,
            0.5,
            0.3,
        )
        for K in kernels
    ]
    corr_m, logp_m, cand_m = band_normxcorr_multi(
        jnp.asarray(band_p),
        jnp.asarray(miss_p),
        jnp.asarray(np.stack(kernels), jnp.float32),
        jnp.asarray(np.stack([shear_kernel(K) for K in kernels]), jnp.float32),
        jnp.asarray(
            np.stack([shear_kernel(K**2) for K in kernels]), jnp.float32
        ),
        (mk, nk),
        n,
        max_dist,
        0.5,
        0.3,
    )
    for k, (corr_s, logp_s, cand_s) in enumerate(singles):
        dc = np.abs(np.asarray(corr_m[k]) - np.asarray(corr_s)).max()
        assert dc < 5e-6, f"kernel {k}: corr diff {dc}"
        ls, lm = np.asarray(logp_s), np.asarray(logp_m[k])
        fin = np.isfinite(ls) & np.isfinite(lm)
        assert (np.isfinite(ls) == np.isfinite(lm)).all()
        assert np.abs(ls[fin] - lm[fin]).max() < 1e-3
        assert (np.asarray(cand_m[k]) == np.asarray(cand_s)).all()


def _run_cli(argv, env, tmp_path, name):
    prefix = str(tmp_path / name)
    r = subprocess.run(
        [sys.executable, "-m", "chromosight_tpu.cli.main", *argv, prefix],
        env=env,
        capture_output=True,
        text=True,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    return pd.read_csv(prefix + ".tsv", sep="\t")


@pytest.fixture()
def cpu_env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    return env


def test_cli_detect_borders_fused_single_device_matches_golden(
    tmp_path, example_cool, cpu_env
):
    """The fused multi-kernel path with the mesh disabled (single-device
    ``detect_banded_multi``) reproduces the reference's borders calls."""
    cool = str(tmp_path / "example.cool")
    shutil.copy(example_cool, cool)
    cpu_env["CHROMOSIGHT_TPU_MESH"] = "0"
    cpu_env["CHROMOSIGHT_TPU_FUSE_KERNELS"] = "1"
    o = _run_cli(
        ["detect", "--no-plotting", "--pattern", "borders", cool],
        cpu_env,
        tmp_path,
        "fused",
    )
    g = pd.read_csv(DATA / "golden_detect_borders.tsv", sep="\t")
    key = ["bin1", "bin2", "kernel_id", "iteration"]
    assert len(o) == len(g)
    assert set(map(tuple, o[key].values)) == set(map(tuple, g[key].values))
    m = g.merge(o, on=key, suffixes=("_ref", "_ours"))
    assert np.abs(m.score_ref - m.score_ours).max() < 5e-5


def test_cli_quantify_borders_fused_matches_unfused(
    tmp_path, example_cool, example_bed2, cpu_env
):
    """Quantify with a 3-kernel config: the fused single-dispatch path
    equals the per-kernel loop coordinate for coordinate.  Mesh disabled:
    8 virtual devices time-slicing one vCPU can blow XLA's 40 s collective
    rendezvous timeout under pytest load (the mesh+fused path is covered
    in-process by the golden borders test)."""
    cool = str(tmp_path / "example.cool")
    shutil.copy(example_cool, cool)
    outs = {}
    for name, fuse in [("fused", "1"), ("unfused", "0")]:
        cpu_env["CHROMOSIGHT_TPU_FUSE_KERNELS"] = fuse
        cpu_env["CHROMOSIGHT_TPU_MESH"] = "0"
        outs[name] = _run_cli(
            [
                "quantify",
                "--no-plotting",
                "--pattern",
                "borders",
                example_bed2,
                cool,
            ],
            cpu_env,
            tmp_path,
            name,
        )
    f, u = outs["fused"], outs["unfused"]
    assert len(f) == len(u)
    m = f.merge(u, on=["bin1", "bin2"], suffixes=("_f", "_u"))
    assert len(m) == len(f)
    fs, us = m.score_f.to_numpy(), m.score_u.to_numpy()
    assert (np.isfinite(fs) == np.isfinite(us)).all()
    ok = np.isfinite(fs)
    assert np.abs(fs[ok] - us[ok]).max() < 1e-5
    fp, up = m.pvalue_f.to_numpy(), m.pvalue_u.to_numpy()
    okp = np.isfinite(fp) & np.isfinite(up)
    assert (np.isfinite(fp) == np.isfinite(up)).all()
    # ~2e-6 f32 score noise between the K=3 and K=1 stencil matmuls
    # amplifies by d(pval)/d(score) ~ sqrt(nobs) ~ 17 near p=0.5
    assert np.abs(fp[okp] - up[okp]).max() < 5e-5
