"""Multi-host execution over jax.distributed (SURVEY.md §5 distributed plan).

The reference is single-host shared memory (rayon + DashMap); the scale-out
here is multi-controller SPMD: every host runs the same program,
`jax.distributed.initialize` wires the processes into one runtime, and the
('data','genome') mesh spans the global device set. The engine's sharded
steps (parallel/pipeline.py) are written against named mesh axes, so the
SAME jitted code runs one-chip, one-host-many-chip, and many-host; only the
array placement differs — host-local numpy becomes a global array via
`make_array_from_callback` (each process serves its addressable shards from
its own full copy, so no cross-host data movement happens at placement
time).

Under SLURM or Open MPI, `initialize()` with no arguments auto-detects the
cluster and gives each process the GPU of its local rank. For manual
clusters and CPU simulation, pass coordinator/num_processes/process_id
(CLI: --coordinator/--num-processes/--process-id); each process then
opens only GPU `process_id % <GPUs on its host>` (local_gpu_ids), so
ranks that share a host must be numbered consecutively.

File outputs are written by process 0 only; every process computes the same
replicated results (tallies, pileups are psum/pmax-merged to all replicas),
so this is purely about not writing the same bytes twice.
"""

from __future__ import annotations

import logging

log = logging.getLogger("bronko")

_initialized = False

# environment variables of the cluster launchers whose topology
# jax.distributed.initialize() detects without arguments
CLUSTER_MARKERS = ("JAX_COORDINATOR_ADDRESS", "SLURM_JOB_NUM_NODES",
                   "OMPI_COMM_WORLD_SIZE")


def _local_gpu_count() -> int:
    """GPUs this process may open, counted without initializing a JAX
    backend (which must not happen before jax.distributed.initialize)."""
    import os

    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if visible is not None:
        return len([d for d in visible.split(",") if d.strip()])
    try:
        return len(os.listdir("/proc/driver/nvidia/gpus"))
    except OSError:
        return 0


def local_gpu_ids(process_id: int) -> list[int] | None:
    """One GPU per process: GPU `process_id % local count`. A JAX process
    reserves most of every card it opens, so processes sharing a host must
    not all open all of its cards. None (JAX's default) when the host has
    no GPU or JAX_LOCAL_DEVICE_IDS already says which cards to open."""
    import os

    n = _local_gpu_count()
    if n == 0 or os.environ.get("JAX_LOCAL_DEVICE_IDS"):
        return None
    return [process_id % n]


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> bool:
    """Initialize the multi-process runtime.

    Returns True when a multi-process runtime is active after the call.
    With all-None arguments this only auto-initializes on environments
    JAX can detect (cluster env vars); on a plain host it stays
    single-process."""
    global _initialized
    import jax

    if _initialized:
        return jax.process_count() > 1
    if coordinator is None and num_processes is None and process_id is None:
        # auto-initialize only when a cluster environment is detectable —
        # initialize() with no args on a plain host raises/hangs, and
        # silently skipping on a real pod would leave every host computing
        # alone AND writing outputs (all think they are process 0)
        import os

        if not any(os.environ.get(m) for m in CLUSTER_MARKERS):
            return False  # plain single-process run; nothing to do
        jax.distributed.initialize()  # cluster env auto-detection
    else:
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=num_processes,
            process_id=process_id,
            local_device_ids=local_gpu_ids(process_id),
        )
    _initialized = True
    log.info("jax.distributed: process %d/%d, %d local + %d global devices",
             jax.process_index(), jax.process_count(),
             jax.local_device_count(), jax.device_count())
    return jax.process_count() > 1


def is_primary() -> bool:
    """True on the process that owns file outputs (always true single-host)."""
    import jax

    return jax.process_index() == 0


def allgather_bytes(data: bytes) -> list[bytes]:
    """Gather one byte payload from every process; returns them in process
    order (single-process: [data]). Two rounds over the collective
    runtime: lengths first (so every process can pad to the common max),
    then the padded buffers. Used by the sample-sharded cohort mode to
    assemble the global overview/alignment inputs on every process."""
    import jax

    if jax.process_count() == 1:
        return [data]
    import numpy as np
    from jax.experimental import multihost_utils as mhu

    lens = np.asarray(mhu.process_allgather(np.int64(len(data)))).reshape(-1)
    m = int(lens.max())
    buf = np.zeros(max(m, 1), np.uint8)
    buf[:len(data)] = np.frombuffer(data, np.uint8)
    gathered = np.asarray(mhu.process_allgather(buf))
    return [gathered[i, :int(lens[i])].tobytes() for i in range(len(lens))]


def globalize(arr, mesh, spec):
    """Turn a host-local numpy/jnp array (identical on every process) into a
    global jax.Array sharded per `spec` over `mesh`.

    Single-process: a plain device_put with the NamedSharding (same code
    path the tests exercise). Multi-process: make_array_from_callback —
    each process materializes only its addressable shards by slicing its
    local copy, so placement is pure host->local-device traffic."""
    import jax
    import numpy as np
    from jax.sharding import NamedSharding

    sharding = NamedSharding(mesh, spec)
    if jax.process_count() == 1:
        return jax.device_put(arr, sharding)
    host = np.asarray(arr)
    return jax.make_array_from_callback(host.shape, sharding,
                                        lambda idx: host[idx])
