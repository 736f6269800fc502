"""Device mesh construction.

The reference is single-process/single-device (SURVEY.md §2: no DP/TP/PP/
SP/EP, no comm backend). The rebuild's scale axes are:

- ``data``: DP for indexing throughput and row-sharding the embedding matrix
  for search (the index, not sequence length, is what grows — SURVEY.md §5).
- ``model``: optional TP for the towers (SO400M fits on one GPU, so TP is
  exercised for validation, not necessity).

The mesh is flat: the GPUs of a host are joined all to all by NVLink, so the
mesh follows the algorithm alone. Communication is XLA collectives (NCCL)
inside jit/shard_map; multi-host bootstraps via ``jax.distributed.initialize``.
No custom transport.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(
    devices: Optional[Sequence] = None,
    model_parallelism: int = 1,
) -> Mesh:
    """Mesh of shape (data, model) over the given (default: all) devices."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if n % model_parallelism != 0:
        raise ValueError(f"{n} devices not divisible by model_parallelism={model_parallelism}")
    arr = np.array(devices).reshape(n // model_parallelism, model_parallelism)
    return Mesh(arr, (DATA_AXIS, MODEL_AXIS))


def single_device_mesh() -> Mesh:
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), (DATA_AXIS, MODEL_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def data_sharded(mesh: Mesh, rank: int = 1, axis: int = 0) -> NamedSharding:
    spec = [None] * rank
    spec[axis] = DATA_AXIS
    return NamedSharding(mesh, P(*spec))


def maybe_distributed_init() -> None:
    """Multi-host bootstrap: no-op on a single host.

    With TPUCLIP_MULTIHOST=1, initializes the JAX distributed runtime. On a
    manual launch (and in CPU multi-process tests)
    jax.distributed.initialize() has no cluster detector and raises, so the
    coordinator is passed explicitly when the standard env vars are set
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID)."""
    import os

    if os.environ.get("TPUCLIP_MULTIHOST", "") in ("1", "true"):
        addr = os.environ.get("JAX_COORDINATOR_ADDRESS")
        nproc = os.environ.get("JAX_NUM_PROCESSES")
        pid = os.environ.get("JAX_PROCESS_ID")
        # truthiness, not `is not None`: exported-but-empty vars (common in
        # launcher scripts) must fall through to auto-detection, and pid="0"
        # is a non-empty string so process 0 still takes the explicit path.
        if addr and nproc and pid:
            jax.distributed.initialize(
                coordinator_address=addr,
                num_processes=int(nproc),
                process_id=int(pid),
            )
        else:
            jax.distributed.initialize()
