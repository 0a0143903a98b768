"""chromosight-tpu: a JAX Hi-C pattern-detection framework.

Re-implements the full capability surface of koszullab/chromosight
(template-matching detection of chromatin loops, TAD borders, hairpins,
centromeres and stripes in Hi-C contact maps) with a JAX/XLA compute
core that runs on a GPU:

* contact maps live on device as dense (or diagonal-banded) tensors instead
  of scipy sparse matrices;
* the normalized cross-correlation engine fuses the six sparse convolutions
  of the reference (`utils/detection.py:917-1131` in the reference) into a
  couple of batched XLA convolutions plus separable window sums;
* preprocessing (balancing, distance-law detrending, MAD bin filtering)
  runs as XLA ops on the same tensors;
* multi-chip scaling uses `jax.sharding.Mesh` + row-sharded band tensors
  (XLA inserts the halo collectives), replacing the reference's
  multiprocessing pool (`cli/chromosight.py:748-750`).

Public API mirrors the reference package layout:

* ``chromosight_tpu.kernels`` - preset pattern configurations
* ``chromosight_tpu.detection`` - normxcorr2 / xcorr2 / pick_foci / ...
* ``chromosight_tpu.preprocessing`` - detrend / distance_law / ...
* ``chromosight_tpu.io`` - cool reader, config loader, writers
* ``chromosight_tpu.runtime`` - HicGenome / ContactMap runtime classes
"""

from chromosight_tpu.version import __version__

__all__ = ["__version__"]
