"""Device mesh + sharding helpers.

The reference has NO distributed layer (single process, single GPU —
SURVEY.md §2.9/§5); this is a new, first-class capability.  Parallelism
forms that exist for this workload:

* ``data`` axis — data-parallel flow sampling / NQS evaluation (batch);
* ``basis`` axis — the workload's analog of sequence parallelism: the
  determinant-connection axis and Krylov state vectors are sharded, with
  partial sums reduced across devices (``psum``-style, inserted by XLA
  from sharding annotations and carried by NCCL).  The GPUs of one host
  are joined all to all, so the mesh shape follows the algorithm, not a
  torus.

TP/PP/EP/ring-attention have no counterpart here (tiny MLPs, no sequence
models) and are intentionally N/A rather than faked (SURVEY.md §7.4).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "data_sharding", "replicated", "P", "NamedSharding"]


def make_mesh(n_devices: Optional[int] = None,
              basis_parallel: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """Create a ('data', 'basis') mesh.

    ``basis_parallel`` defaults to 2 when the device count is an even
    number > 2, else 1.  A single device yields a 1x1 mesh — the same
    code path as a pod slice (SURVEY.md §7.1 item 5).
    """
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    if basis_parallel is None:
        basis_parallel = 2 if (n > 2 and n % 2 == 0) else 1
    if n % basis_parallel != 0:
        raise ValueError(f"{n} devices not divisible by "
                         f"basis_parallel={basis_parallel}")
    arr = np.asarray(devices).reshape(n // basis_parallel, basis_parallel)
    return Mesh(arr, axis_names=("data", "basis"))


def data_sharding(mesh: Mesh, *axes: Optional[str]) -> NamedSharding:
    return NamedSharding(mesh, P(*axes))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
