"""Multi-host runtime glue (greenfield; the reference is single-process,
SURVEY section 2 row 20).

Usage on a multi-host GPU cluster (one process per host)::

    import loraine_tpu as lt
    from loraine_tpu.parallel import distributed, auto_mesh, shard_problem

    distributed.initialize()               # jax.distributed runtime
    problem = lt.problem_from_sdpa(path)   # every host parses the same file
    mesh = auto_mesh(problem)              # global mesh over all devices
    res = lt.solve(shard_problem(problem, mesh), options)

Everything inside the jitted step is sharding-annotated data + XLA
collectives (psum over block contributions, all-gathers of Schur rows), so
the same program spans hosts over NVLink/the network; the host loop's scalar stats are
replicated and identical on every process.
"""
from __future__ import annotations

from typing import Optional

import jax

__all__ = ["initialize", "is_initialized"]

_initialized = False


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize the multi-host runtime (idempotent). With no arguments,
    relies on the cluster environment (scheduler env vars) the way
    jax.distributed.initialize does; where nothing describes the cluster,
    pass ``coordinator_address`` (e.g. 'localhost:<port>'),
    ``num_processes`` and ``process_id``."""
    global _initialized
    if _initialized:
        return
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)
    _initialized = True


def is_initialized() -> bool:
    return _initialized
