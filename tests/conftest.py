"""Test harness configuration.

Tests run on the CPU (``JAX_PLATFORMS=cpu`` unless the environment says
otherwise) with 8 virtual devices, which exercises the multi-device
sharding paths without a multi-card host.  Both settings have to be in
the environment before JAX initializes its backends.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import pathlib

import pytest

from chromosight_tpu.config import init_compilation_cache

init_compilation_cache()

DATA_DIR = pathlib.Path(__file__).parents[1] / "data_test"


@pytest.fixture(scope="session")
def example_cool():
    return str(DATA_DIR / "example.cool")


@pytest.fixture(scope="session")
def example_bed2():
    return str(DATA_DIR / "example.bed2")


@pytest.fixture()
def example_mcool(example_cool, tmp_path):
    """Multi-resolution .mcool built from the example fixture: the cooler
    layout lives under /resolutions/<binsize> groups (the URI scheme the
    reference accepts through cooler, reference utils/io.py:51,
    contacts_map.py:129)."""
    import h5py

    path = str(tmp_path / "example.mcool")
    with h5py.File(example_cool, "r") as src, h5py.File(path, "w") as dst:
        res = dst.create_group("resolutions")
        grp = res.create_group("1000")
        for key in src:
            src.copy(src[key], grp, name=key)
        for k, v in src.attrs.items():
            grp.attrs[k] = v
        # a second (fake) resolution group so the group path genuinely
        # selects between siblings
        grp2 = res.create_group("4000")
        for key in src:
            src.copy(src[key], grp2, name=key)
        for k, v in src.attrs.items():
            grp2.attrs[k] = v
        grp2.attrs["bin-size"] = 4000
    return path
