"""Device mesh construction for bronko-tpu.

Two logical axes:
  * 'data'   — read k-mer batches are sharded across this axis (the
    reference's rayon chunk fan-out, call.rs:1279-1281, becomes SPMD).
  * 'genome' — the posting/pileup space is range-partitioned across this
    axis, scaling the strain database beyond one device's memory.

Cross-axis collectives: pileup count planes psum over 'data', depth planes
pmax over 'data' (the thread-local-then-merge pattern of call.rs:1420-1431
becomes XLA collectives); per-(kmer, genome) hit counts psum over
'genome' before the perfect/variant/unique classification.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(n_data: int | None = None, n_genome: int = 1, devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    if n_data is None:
        n_data = len(devices) // n_genome
    n = n_data * n_genome
    if n > len(devices) or n < 1:  # n<1: genome axis wider than the devices
        raise ValueError(f"requested {n} devices, have {len(devices)}")
    dev_array = np.asarray(devices[:n]).reshape(n_data, n_genome)
    return Mesh(dev_array, ("data", "genome"))
