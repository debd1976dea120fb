"""Device mesh construction helpers.

The reference is strictly single-core (SURVEY.md section 2 rows 9-10: no
threads, no processes, no devices — its only parallelism is SIMD lanes).
Multi-device scaling is therefore new surface: a 1-D or 2-D
`jax.sharding.Mesh` whose axes shard DSP channels and stream time-blocks,
with XLA collectives (NCCL between GPUs) doing the communication. The
cards of one host are joined all to all (NVLink), so every pair of
devices talks at the same rate and a mesh's shape follows the algorithm
alone: a 1-D axis for the time-sharded and distributed-FFT paths, a
(chan, time) grid where both are sharded.
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = [
    "P",
    "Mesh",
    "NamedSharding",
    "dsp_mesh",
    "channel_time_mesh",
    "init_multihost",
    "multihost_mesh",
]

CHANNEL_AXIS = "chan"
TIME_AXIS = "time"
HOST_AXIS = "host"


def dsp_mesh(n_devices: int | None = None, axis: str = TIME_AXIS) -> Mesh:
    """1-D mesh over the first n_devices (default: all local devices).
    Raises if fewer devices exist — silently returning a smaller mesh
    would leave the caller believing work is split n_devices ways."""
    devs = jax.devices()
    n = n_devices or len(devs)
    if len(devs) < n:
        raise ValueError(f"need {n} devices, have {len(devs)}")
    return Mesh(np.asarray(devs[:n]), (axis,))


def init_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    **kwargs,
) -> None:
    """Join this process to a multi-process JAX run.

    Thin wrapper over ``jax.distributed.initialize``. Nothing tells JAX of
    a GPU cluster, so a real multi-process run passes all three arguments
    (``coordinator_address`` such as ``"localhost:<port>"``,
    ``num_processes``, ``process_id``). After it returns, ``jax.devices()``
    lists every device of every process and the mesh constructors below (and
    everything in this package built on ``shard_map``) operate globally.
    Idempotent: a second call is a no-op.

    This is new multi-device surface the reference does not have (it never
    leaves one core — SURVEY.md section 2 rows 9-10); the entry point is
    the analog of its process-wide ``cpu_supports_avx`` capability probe:
    run once up front, everything downstream just works.
    """
    if jax._src.distributed.global_state.client is not None:  # already up
        return
    from jax._src import xla_bridge

    if xla_bridge.backends_are_initialized():
        # initialize() must run before any backend use. A single-process
        # run needs no distributed client, so late calls are harmless
        # no-ops there; a true multi-process run misconfigured this way
        # must fail loudly.
        if num_processes in (None, 1):
            return
        raise RuntimeError(
            "init_multihost() must be called before any JAX computation "
            "or device query (the XLA backend is already initialized)"
        )
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
            **kwargs,
        )
    except ValueError:
        # No cluster was given or found. A single-process run needs no
        # distributed client; a declared multi-process run must fail.
        if num_processes not in (None, 1):
            raise


def multihost_mesh(
    time_parallel: int | None = None,
    axis: str = TIME_AXIS,
    devices: list | None = None,
) -> Mesh:
    """Build a (host, time) mesh over the GLOBAL device list so collectives
    along ``axis`` stay within each host (NVLink) and only the host axis
    crosses the network. ``time_parallel`` defaults to the per-host device
    count; the total device count must equal
    hosts * time_parallel. ``devices`` overrides ``jax.devices()`` for
    testing (device-list injection — real multi-host cannot run in CI)."""
    devs = list(devices if devices is not None else jax.devices())
    by_host: dict[int, list] = {}
    for d in devs:
        by_host.setdefault(d.process_index, []).append(d)
    hosts = sorted(by_host)
    per_host = len(by_host[hosts[0]])
    if any(len(by_host[h]) != per_host for h in hosts):
        raise ValueError(
            f"uneven devices per host: {[len(by_host[h]) for h in hosts]}"
        )
    tp = time_parallel or per_host
    if tp != per_host:
        if (per_host * len(hosts)) % tp:
            raise ValueError(
                f"time_parallel={tp} does not divide {per_host * len(hosts)} devices"
            )
    # host-major ordering: each mesh row is one host's devices, so the
    # time axis stays inside a host and only the host axis crosses hosts.
    ordered = [d for h in hosts for d in by_host[h]]
    arr = np.asarray(ordered).reshape(-1, tp)
    return Mesh(arr, (HOST_AXIS, axis))


def channel_time_mesh(channel_parallel: int, time_parallel: int) -> Mesh:
    """2-D (chan, time) mesh: channels data-parallel across one axis,
    stream time-blocks sequence-parallel across the other (the DSP analog
    of a dp x sp mesh)."""
    devs = jax.devices()
    need = channel_parallel * time_parallel
    if len(devs) < need:
        raise ValueError(f"need {need} devices, have {len(devs)}")
    arr = np.asarray(devs[:need]).reshape(channel_parallel, time_parallel)
    return Mesh(arr, (CHANNEL_AXIS, TIME_AXIS))
