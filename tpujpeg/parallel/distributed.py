"""Multi-host decode: jax.distributed + per-host work sharding.

The reference is single-GPU single-process (SURVEY §2.7: no NCCL/MPI
anywhere).  Across hosts the decode problem is embarrassingly
data-parallel: each host parses and entropy-decodes its share of the file
list and feeds its local devices; the only cross-host communication is
the final metrics reduction (an allgather) and, in stripe mode, the
all_gather inside `parallel.sharding`.

Typical use (same script on every host):

    from tpujpeg.parallel import distributed as dist
    dist.initialize()                       # jax.distributed.initialize()
    mine = dist.shard_list(all_paths)       # this host's files
    dec = BatchDecoder(...)                 # local devices only
    ... decode(mine) ...
    totals = dist.allreduce_metrics({"images": len(mine), "bytes": n})

Initialization semantics (fixed after round-1 review): when a coordinator
IS configured — explicit kwargs, or any of the environment variables JAX
itself auto-detects (JAX_COORDINATOR_ADDRESS, COORDINATOR_ADDRESS, or a
SLURM/OMPI cluster environment) — a failure to connect is a hard
error.  Silent standalone fallback only happens when nothing at all is
configured; otherwise every host would quietly decode the FULL work list
(duplicate work, wrong totals).
"""

from __future__ import annotations

import os

import jax
import numpy as np

_COORDINATOR_ENV_VARS = (
    "JAX_COORDINATOR_ADDRESS",
    "COORDINATOR_ADDRESS",
    "MEGASCALE_COORDINATOR_ADDRESS",
    "SLURM_JOB_ID",
    "OMPI_MCA_orte_hnp_uri",
)

_initialized_here = False


def coordinator_configured(**kwargs) -> bool:
    """True when an explicit or environment coordinator config exists."""
    if kwargs.get("coordinator_address"):
        return True
    return any(os.environ.get(v) for v in _COORDINATOR_ENV_VARS)


def initialize(**kwargs) -> None:
    """jax.distributed.initialize with explicit failure semantics.

    - already initialized (by a launcher or a prior call): no-op;
    - coordinator configured (kwargs or env): initialize, and RAISE on
      failure — never fall back to standalone with a configured cluster;
    - nothing configured: run standalone (single process).
    """
    global _initialized_here
    if _initialized_here:
        return
    if not coordinator_configured(**kwargs):
        return  # standalone by construction, not by accident
    # NB: no jax.process_count() probe here — touching the backend before
    # jax.distributed.initialize() would make initialization impossible.
    try:
        jax.distributed.initialize(**kwargs)  # raises on misconfiguration
    except RuntimeError as e:
        if "once" in str(e) or "already" in str(e).lower():
            return  # a launcher initialized the cluster before us: fine
        raise
    _initialized_here = True


def process_info() -> tuple[int, int]:
    return jax.process_index(), jax.process_count()


def shard_list(items: list, index: int | None = None, count: int | None = None):
    """Deterministic round-robin shard of a work list for this host.

    Round-robin (not contiguous) so size-sorted datasets spread evenly —
    the host-level analog of the reference's batch kernel mapping
    blockIdx.x -> image (parser.cu:663-682)."""
    idx = jax.process_index() if index is None else index
    cnt = jax.process_count() if count is None else count
    return items[idx::cnt]


def allreduce_metrics(metrics: dict[str, float]) -> dict[str, float]:
    """Sum scalar metrics across hosts (DCN collective via allgather)."""
    if jax.process_count() == 1:
        return dict(metrics)
    from jax.experimental import multihost_utils

    keys = sorted(metrics)
    local = np.array([float(metrics[k]) for k in keys], np.float64)
    total = multihost_utils.process_allgather(local).sum(axis=0)
    return {k: float(v) for k, v in zip(keys, total)}


def barrier(name: str = "tpujpeg") -> None:
    """Cross-host sync point (no-op standalone)."""
    if jax.process_count() == 1:
        return
    from jax.experimental import multihost_utils

    multihost_utils.sync_global_devices(name)
