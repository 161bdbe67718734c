"""Multi-host runtime entry (SURVEY.md §2.4/§5 "distributed backend").

The reference has no distributed backend at all (single process + fork);
this module provides the multi-host equivalent: `jax.distributed.initialize`
bootstrapping, a global data mesh spanning hosts, and host-local sharding
of big sequence datasets so a 1M-sequence corpus (BASELINE config 5) never
materializes on one host.
"""

from __future__ import annotations

import os

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    initialization_timeout: int | None = None,
) -> None:
    """Initialize the multi-host runtime. No-ops on a single process.

    Under a cluster manager JAX detects the three arguments from the
    environment; elsewhere (one machine with several GPUs, CPU tests) pass
    them explicitly, e.g. coordinator_address="localhost:<port>".
    ``initialization_timeout`` (seconds) bounds the coordinator handshake.
    """
    if num_processes is not None and num_processes <= 1:
        return
    if coordinator_address is None and "COORDINATOR_ADDRESS" in os.environ:
        coordinator_address = os.environ["COORDINATOR_ADDRESS"]
    explicit = num_processes is not None and num_processes > 1
    kwargs = {}
    if initialization_timeout is not None:
        kwargs["initialization_timeout"] = initialization_timeout
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
            **kwargs,
        )
    except RuntimeError as e:
        # idempotence: re-initialization of an already-running runtime is
        # fine; anything else on an EXPLICITLY multi-process request must
        # fail loudly — proceeding single-process would silently compute
        # un-psummed (wrong) global stats.
        if "already initialized" in str(e).lower():
            return
        if explicit:
            raise
    except ValueError:
        # auto-detection found no cluster environment; only acceptable when
        # the caller did not explicitly request a multi-process setup
        if explicit:
            raise
    if explicit and jax.process_count() != num_processes:
        raise RuntimeError(
            f"requested {num_processes} processes but the runtime reports "
            f"{jax.process_count()} — multi-host bootstrap failed"
        )


def global_data_mesh(axis: str = "data") -> Mesh:
    """1-D mesh over every chip in the job, in process-major order so each
    host's addressable chips are contiguous along the data axis (host-local
    batch shards stay host-local)."""
    return Mesh(np.array(jax.devices()), (axis,))


def host_local_batch_to_global(obs_local, mesh: Mesh):
    """Assemble a globally-sharded batch from per-host local shards.

    Each process passes its own (B_local, ...) array; the result is a global
    (num_processes * B_local, ...) array sharded over the data axis without
    any cross-host transfer (jax.make_array_from_process_local_data).
    """
    sharding = NamedSharding(mesh, P("data"))
    return jax.make_array_from_process_local_data(sharding, np.asarray(obs_local))
