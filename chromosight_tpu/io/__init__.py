"""IO layer: .cool reading/writing (numpy + zlib HDF5, no h5py or cooler),
kernel-config loading, bed2d parsing, pattern/window writers and the
terminal progress bar.

Mirrors the public surface of the reference ``chromosight/utils/io.py``.
"""

from chromosight_tpu.io.cool import CoolFile, load_cool, create_cool
from chromosight_tpu.io.config import load_kernel_config, KERNEL_SCHEMA
from chromosight_tpu.io.bed2d import load_bed2d
from chromosight_tpu.io.writers import (
    write_patterns,
    save_windows,
    check_prefix_dir,
    download_file,
)
from chromosight_tpu.io.progress import progress

__all__ = [
    "CoolFile",
    "load_cool",
    "create_cool",
    "load_kernel_config",
    "KERNEL_SCHEMA",
    "load_bed2d",
    "write_patterns",
    "save_windows",
    "check_prefix_dir",
    "download_file",
    "progress",
]
