"""Multi-host runtime glue.

The reference is a single process (SURVEY.md §2.12); this framework's
multi-host story is standard JAX: every host calls
``jax.distributed.initialize`` then builds the same global mesh; pjit/
shard_map handle cross-host collectives.
This module keeps that glue in one place and degrades gracefully to
single-process mode (no coordinator) so the same entry points run everywhere.
"""

from __future__ import annotations

import os

import jax


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Initialize the multi-host runtime if configured; no-op otherwise.

    Configuration comes from explicit args or the standard env vars
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID), matching
    how cluster launchers inject them.
    """
    coordinator_address = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if coordinator_address is None:
        return  # single-process run
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=int(num_processes or os.environ.get("JAX_NUM_PROCESSES", 1)),
        process_id=int(process_id or os.environ.get("JAX_PROCESS_ID", 0)),
    )


def is_primary() -> bool:
    return jax.process_index() == 0


def global_device_count() -> int:
    return jax.device_count()
