"""Host-level collectives: the port's :mod:`lddl_tpu.comm`."""
from .backend import (
    CommBackend,
    FileBackend,
    FileLeaseStore,
    HeartbeatPump,
    LeaseStaleness,
    LeaseStore,
    NullBackend,
    StoreLeaseStore,
    TorchDistBackend,
    backoff_delay,
    comm_heartbeat_interval,
    comm_timeout,
    cuda_backend_default,
    ensure_torch_distributed,
    get_backend,
    jitter_source,
)
