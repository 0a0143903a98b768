"""Multi-device sharding tests on the virtual 8-device CPU mesh:
the sharded band detection step must equal the single-device result."""

import os

import numpy as np
import pytest
# Full CLI / end-to-end runs: minutes on one core. `pytest -m "not slow"` is the fast tier.
pytestmark = pytest.mark.slow


import jax
import jax.numpy as jnp

import chromosight_tpu.kernels as ck
from chromosight_tpu.ops.band import band_normxcorr, shear_kernel
from chromosight_tpu.parallel import make_mesh, sharded_band_detect


@pytest.fixture(scope="module")
def eight_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    return jax.devices()[:8]


def _inputs(dp, n, width, seed=0):
    rng = np.random.RandomState(seed)
    bands = (rng.rand(dp, n, width) * (rng.rand(dp, n, width) < 0.4)).astype(
        np.float32
    )
    missing = np.zeros((dp, n), dtype=bool)
    missing[:, 5] = True
    bands[missing] = 0
    return jnp.asarray(bands), jnp.asarray(missing)


def test_sharded_band_detect_matches_single_device(eight_devices):
    K = np.asarray(ck.loops_small["kernels"][0], np.float32)
    max_dist = 16
    width = max_dist + K.shape[0] + 1
    n = 128
    bands, missing = _inputs(2, n, width)
    mesh = make_mesh(8, dp=2)
    kern = jnp.asarray(K)
    sh = jnp.asarray(shear_kernel(K), jnp.float32)
    sh2 = jnp.asarray(shear_kernel(K**2), jnp.float32)
    corr_s, logp_s, cand_s = sharded_band_detect(
        bands, missing, kern, sh, sh2, K.shape, n, max_dist, 0.5, 0.3, mesh
    )
    # single-device reference
    corr_r, logp_r, cand_r = jax.vmap(
        lambda b, m: band_normxcorr(
            b, m, kern, sh, sh2, K.shape, n, max_dist, 0.5, 0.3
        )
    )(bands, missing)
    np.testing.assert_allclose(
        np.asarray(corr_s), np.asarray(corr_r), atol=1e-5
    )
    assert np.array_equal(np.asarray(cand_s), np.asarray(cand_r))


def test_mesh_shapes(eight_devices):
    mesh = make_mesh(8, dp=2)
    assert mesh.devices.shape == (2, 4)
    assert mesh.axis_names == ("dp", "sp")
    with pytest.raises(ValueError):
        make_mesh(8, dp=3)


def test_auto_mesh_sizes(eight_devices):
    from chromosight_tpu.parallel import auto_mesh

    assert dict(auto_mesh(batch=3).shape) == {"dp": 2, "sp": 4}
    assert dict(auto_mesh(batch=1).shape) == {"dp": 1, "sp": 8}
    assert dict(auto_mesh(batch=24).shape) == {"dp": 8, "sp": 1}


def test_sharded_band_detect_hlo_halo_comms_only(eight_devices):
    """The sp-axis sharding must cost O(kernel halo) communication: the
    compiled HLO of the sharded band step may contain only halo-sized
    collective-permutes — any all-gather of the row dimension means
    GSPMD failed to partition the convolutions spatially and the mesh
    buys nothing (probe recorded in NOTES.md)."""
    import re

    from jax.sharding import NamedSharding, PartitionSpec as P

    from chromosight_tpu.parallel import shard_band

    K = np.asarray(ck.loops["kernels"][0], np.float32)
    n, width = 2048, 512
    mesh = make_mesh(8, dp=1)
    kern = jnp.asarray(K)
    sh = jnp.asarray(shear_kernel(K), jnp.float32)
    sh2 = jnp.asarray(shear_kernel(K**2), jnp.float32)
    bands = jnp.zeros((1, n, width), jnp.float32)
    missing = jnp.zeros((1, n), bool)

    def one(band, miss, n_i, md_i):
        return band_normxcorr(
            band, miss, kern, sh, sh2, K.shape, n_i, md_i, 0.5, 0.3
        )

    bands_s, missing_s = shard_band(bands, missing, mesh)
    outsh = tuple(NamedSharding(mesh, P("dp", "sp", None)) for _ in range(3))
    fn = jax.jit(jax.vmap(one), out_shardings=outsh)
    hlo = (
        fn.lower(
            bands_s,
            missing_s,
            jnp.full((1,), n, jnp.int32),
            jnp.full((1,), 400, jnp.int32),
        )
        .compile()
        .as_text()
    )
    assert "all-gather" not in hlo
    assert "all-to-all" not in hlo
    permutes = re.findall(
        r"= \S+?\[(\d+),(\d+),(\d+)\]\S* collective-permute\(", hlo
    )
    assert permutes, "expected halo collective-permutes on the sp axis"
    # Convolution halo exchanges are O(kernel) rows; the sliding_vector
    # skew of the missing flags additionally costs one shard-sized
    # permute (O(tensor/8), recorded in NOTES.md).  Nothing may move the
    # full row dimension.
    shard_bytes = (n // 8) * (width + 2 * (K.shape[0] - 1)) * 4
    for b, rows, cols in permutes:
        nbytes = int(b) * int(rows) * int(cols) * 4
        assert nbytes <= 2 * shard_bytes, (b, rows, cols)


def test_cli_detect_mesh_matches_single_device(
    eight_devices, tmp_path, example_cool, monkeypatch
):
    """The production pipeline on the 8-device mesh must call the exact
    same 89 golden coordinates as the single-device path, with scores
    equal up to sharded-reduction fp32 reordering."""
    import pandas as pd

    from chromosight_tpu.cli.main import main

    outputs = {}
    for mode in ("0", "1"):
        monkeypatch.setenv("CHROMOSIGHT_TPU_MESH", mode)
        prefix = str(tmp_path / f"mesh{mode}")
        # --threads 2 on the mesh run also covers the threaded host-tail
        # path of detect_on_mesh
        rc = main(
            ["detect", "--no-plotting", "--threads", "2", example_cool,
             prefix]
        )
        assert rc in (0, None)
        outputs[mode] = pd.read_csv(prefix + ".tsv", sep="\t")
    single, mesh = outputs["0"], outputs["1"]
    key = ["bin1", "bin2", "kernel_id", "iteration"]
    assert len(mesh) == len(single) == 89
    pd.testing.assert_frame_equal(
        mesh[key].sort_values(key).reset_index(drop=True),
        single[key].sort_values(key).reset_index(drop=True),
    )
    m = mesh.merge(single, on=["bin1", "bin2"], suffixes=("_m", "_s"))
    assert np.abs(m.score_m - m.score_s).max() < 5e-5
    assert np.abs(m.pvalue_m - m.pvalue_s).max() < 1e-6


def test_cli_detect_inter_mesh_round_robins_dense_maps(
    eight_devices, tmp_path, example_cool, monkeypatch
):
    """--inter runs' dense trans maps must ride the mesh too: the
    fallback loop round-robins whole maps across devices (the analog of
    the reference pool iterating trans submatrices, cli:748-750), and
    its calls must match the single-device path exactly."""
    import pandas as pd

    import chromosight_tpu.parallel.mesh as pm
    from chromosight_tpu.cli.main import main

    seen_devices = set()
    orig = jax.default_device

    def spy(dev):
        seen_devices.add(dev)
        return orig(dev)

    outputs = {}
    for mode in ("0", "1"):
        monkeypatch.setenv("CHROMOSIGHT_TPU_MESH", mode)
        if mode == "1":
            monkeypatch.setattr(pm.jax, "default_device", spy)
        prefix = str(tmp_path / f"imesh{mode}")
        rc = main(
            ["detect", "--no-plotting", "--inter", "--threads", "2",
             example_cool, prefix]
        )
        assert rc in (0, None)
        outputs[mode] = pd.read_csv(prefix + ".tsv", sep="\t")
    single, mesh = outputs["0"], outputs["1"]
    key = ["chrom1", "bin1", "chrom2", "bin2", "kernel_id", "iteration"]
    assert len(mesh) == len(single) > 0
    pd.testing.assert_frame_equal(
        mesh[key].sort_values(key).reset_index(drop=True),
        single[key].sort_values(key).reset_index(drop=True),
    )
    # the three trans maps of the fixture must have been spread over
    # more than one device
    assert len(seen_devices) > 1


def test_cli_quantify_mesh_matches_single_device(
    eight_devices, tmp_path, example_cool, example_bed2, monkeypatch
):
    """Quantify on the 8-device mesh must score the exact same
    coordinates as the single-device path (the reference parallelises
    quantify over submatrices exactly like detect, cli:407-408)."""
    import pandas as pd

    from chromosight_tpu.cli.main import main

    outputs = {}
    for mode in ("0", "1"):
        monkeypatch.setenv("CHROMOSIGHT_TPU_MESH", mode)
        prefix = str(tmp_path / f"qmesh{mode}")
        rc = main(
            [
                "quantify",
                "--no-plotting",
                example_bed2,
                example_cool,
                prefix,
            ]
        )
        assert rc in (0, None)
        outputs[mode] = pd.read_csv(prefix + ".tsv", sep="\t")
    single, mesh = outputs["0"], outputs["1"]
    assert len(mesh) == len(single)
    pd.testing.assert_frame_equal(
        mesh[["bin1", "bin2"]].reset_index(drop=True),
        single[["bin1", "bin2"]].reset_index(drop=True),
    )
    assert np.array_equal(
        np.isnan(mesh.score.to_numpy()), np.isnan(single.score.to_numpy())
    )
    ok = ~np.isnan(single.score.to_numpy())
    assert (
        np.abs(mesh.score.to_numpy()[ok] - single.score.to_numpy()[ok]).max()
        < 5e-5
    )


def test_graft_entry_single_chip():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "graft_entry_test", "__graft_entry__.py"
    )
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    fn, args = m.entry()
    out = jax.jit(fn)(*args)
    assert out[0].shape == out[1].shape == out[2].shape


def test_graft_dryrun_multichip(eight_devices):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "graft_entry_test2", "__graft_entry__.py"
    )
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    m.dryrun_multichip(8)


def test_graft_dryrun_fresh_process():
    """dryrun_multichip must work in a FRESH interpreter, where no
    conftest has chosen the CPU platform and an accelerator may claim the
    backend.  Regression: importing the graft module used to call
    init_compilation_cache(), whose jax.default_backend() query
    initialized the (1-device) accelerator backend before dryrun could
    switch to the virtual CPU mesh."""
    import pathlib
    import subprocess
    import sys

    repo = pathlib.Path(__file__).parents[1]
    env = dict(os.environ)
    # a plain environment, not the test harness's: drop the conftest's
    # platform choice
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run(
        [
            sys.executable,
            "-c",
            "import __graft_entry__ as g; g.dryrun_multichip(8); "
            "print('dryrun-ok')",
        ],
        cwd=repo,
        env=env,
        capture_output=True,
        text=True,
        timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "dryrun-ok" in proc.stdout


@pytest.mark.parametrize("kshape", [None, (5, 9)])
def test_shard_map_band_detect_matches_single_device(eight_devices, kshape):
    """The explicit-halo shard_map engine must reproduce the
    single-device band engine for square and rectangular kernels:
    identical candidate maps, scores within fp32 shape-dependent
    scheduling noise (XLA may fuse the arithmetic differently for slab
    vs full row counts, ~1e-6)."""
    from chromosight_tpu.parallel import shard_map_band_detect

    if kshape is None:
        K = np.asarray(ck.loops_small["kernels"][0], np.float32)
    else:
        rng = np.random.RandomState(3)
        K = rng.rand(*kshape).astype(np.float32)
    max_dist = 16
    width = max_dist + K.shape[0] + 1
    n = 128
    bands, missing = _inputs(2, n, width)
    mesh = make_mesh(8, dp=2)
    kern = jnp.asarray(K)
    sh = jnp.asarray(shear_kernel(K), jnp.float32)
    sh2 = jnp.asarray(shear_kernel(K**2), jnp.float32)
    corr_s, logp_s, cand_s = shard_map_band_detect(
        bands, missing, kern, sh, sh2, K.shape, n, max_dist, 0.5, 0.3, mesh
    )
    corr_r, logp_r, cand_r = jax.vmap(
        lambda b, m: band_normxcorr(
            b, m, kern, sh, sh2, K.shape, n, max_dist, 0.5, 0.3
        )
    )(bands, missing)
    np.testing.assert_allclose(
        np.asarray(corr_s), np.asarray(corr_r), atol=1e-5
    )
    assert np.array_equal(np.asarray(cand_s), np.asarray(cand_r))
    fin = np.isfinite(np.asarray(logp_r))
    np.testing.assert_allclose(
        np.asarray(logp_s)[fin], np.asarray(logp_r)[fin], atol=1e-4
    )


def test_shard_map_band_detect_shift_fma_matches_single_device(eight_devices):
    """The shard_map engine traces the shift-FMA conv inside shard_map
    on a narrow band (its loop carry must keep the sharded type) and
    reproduces the single-device band engine."""
    from chromosight_tpu.parallel import shard_map_band_detect

    K = np.asarray(ck.loops_small["kernels"][0], np.float32)
    max_dist = 16
    width = max_dist + K.shape[0] + 1
    n = 128
    bands, missing = _inputs(2, n, width)
    mesh = make_mesh(8, dp=2)
    kern = jnp.asarray(K)
    sh = jnp.asarray(shear_kernel(K), jnp.float32)
    sh2 = jnp.asarray(shear_kernel(K**2), jnp.float32)
    corr_s, _logp_s, cand_s = shard_map_band_detect(
        bands, missing, kern, sh, sh2, K.shape, n, max_dist, 0.5, 0.3, mesh
    )
    corr_r, _logp_r, cand_r = jax.vmap(
        lambda b, m: band_normxcorr(
            b, m, kern, sh, sh2, K.shape, n, max_dist, 0.5, 0.3
        )
    )(bands, missing)
    np.testing.assert_allclose(
        np.asarray(corr_s), np.asarray(corr_r), atol=1e-5
    )
    assert np.array_equal(np.asarray(cand_s), np.asarray(cand_r))


def test_shard_map_band_detect_hlo_two_halo_permutes(eight_devices):
    """The explicit engine's compiled HLO must contain exactly the two
    kernel-halo ppermutes (up + down slabs) and NO other collectives —
    in particular not the shard-sized sliding_vector relay the GSPMD
    engine pays (NOTES.md round-3 findings)."""
    import re

    from chromosight_tpu.parallel import shard_map_band_detect

    K = np.asarray(ck.loops["kernels"][0], np.float32)
    n, width = 2048, 512
    mesh = make_mesh(8, dp=1)
    kern = jnp.asarray(K)
    sh = jnp.asarray(shear_kernel(K), jnp.float32)
    sh2 = jnp.asarray(shear_kernel(K**2), jnp.float32)
    bands = jnp.zeros((1, n, width), jnp.float32)
    missing = jnp.zeros((1, n), bool)

    max_dist = 400
    # exercise the real path once, then lower the same computation and
    # audit the compiled collectives
    shard_map_band_detect(
        bands, missing, kern, sh, sh2, K.shape, n, max_dist, 0.5, 0.3, mesh
    )

    def entry(b, m):
        return shard_map_band_detect(
            b, m, kern, sh, sh2, K.shape, n, max_dist, 0.5, 0.3, mesh
        )

    hlo = jax.jit(entry).lower(bands, missing).compile().as_text()
    assert "all-gather" not in hlo
    assert "all-to-all" not in hlo
    assert "all-reduce" not in hlo.replace("all-reduce-id", "")
    permutes = re.findall(
        r"= \S+?\[(\d+),(\d+),(\d+)\]\S* collective-permute\(", hlo
    )
    assert permutes, "expected the halo ppermutes"
    halo = K.shape[0] - 1
    for b, rows, cols in permutes:
        assert int(rows) <= halo, (b, rows, cols)


def test_cli_detect_shard_map_engine_matches_single_device(
    eight_devices, tmp_path, example_cool, monkeypatch
):
    """CHROMOSIGHT_TPU_SHARD_MAP=1 routes the mesh's single-kernel band
    dispatches through the explicit-ppermute halo engine; the production
    pipeline must still call the exact 89 golden coordinates."""
    import pandas as pd

    from chromosight_tpu.cli.main import main

    outputs = {}
    for mode in ("0", "1"):
        monkeypatch.setenv("CHROMOSIGHT_TPU_MESH", "1")
        monkeypatch.setenv("CHROMOSIGHT_TPU_SHARD_MAP", mode)
        prefix = str(tmp_path / f"sm{mode}")
        rc = main(
            ["detect", "--no-plotting", "--threads", "2", example_cool,
             prefix]
        )
        assert rc in (0, None)
        outputs[mode] = pd.read_csv(prefix + ".tsv", sep="\t")
    gspmd, sm = outputs["0"], outputs["1"]
    key = ["bin1", "bin2", "kernel_id", "iteration"]
    assert len(sm) == len(gspmd) == 89
    pd.testing.assert_frame_equal(
        sm[key].sort_values(key).reset_index(drop=True),
        gspmd[key].sort_values(key).reset_index(drop=True),
    )
    m = sm.merge(gspmd, on=["bin1", "bin2"], suffixes=("_a", "_b"))
    assert np.abs(m.score_a - m.score_b).max() < 5e-5
