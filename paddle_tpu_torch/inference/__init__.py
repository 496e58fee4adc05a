"""Inference of the port: the ``Config``/``Predictor`` surface with
weight-only int8 (``predictor.py``, re-exported here), the paged
continuous-batching ``ServingEngine`` (``serving.py``), its failpoint
registry (``faults.py``), and the serving control plane over it: the
``ServingFrontend`` (``control_plane.py``), ``ServingMetrics``
(``metrics.py``), tracing (``tracing.py``), tenancy (``tenancy.py``), the
request journal (``journal.py``), leases and fencing (``ha.py``), the
KV fabric's directory and data plane (``kv_fabric.py``, ``blockwire.py``),
and the serving fleet of worker processes over RPC (``fleet.py``).
The host-side modules are copied from paddle_tpu's, so this package never
imports the JAX one."""
from .control_plane import (  # noqa: F401
    BrownoutPolicy,
    HandedOff,
    Priority,
    RequestResult,
    RequestStatus,
    ServingFrontend,
)
from .faults import (  # noqa: F401
    FaultInjector,
    FaultSpec,
    RespawnCircuitBreaker,
)
from .fleet import (  # noqa: F401
    AutoscalePolicy,
    FleetAutoscaler,
    RemoteReplica,
    ServingFleet,
    WarmPool,
)
from .ha import (  # noqa: F401
    EpochFence,
    FencedEngine,
    FrontendLease,
    StaleEpoch,
    StandbyFrontend,
)
from .journal import (  # noqa: F401
    JournalCorruption,
    JournalSuperseded,
    RequestJournal,
)
from .metrics import ServingMetrics  # noqa: F401
from .predictor import (  # noqa: F401
    Config,
    Int8Linear,
    Predictor,
    PredictorPool,
    create_predictor,
)
from .serving import (  # noqa: F401
    BlockManager,
    SamplingParams,
    ServingEngine,
    ServingRequest,
)
from .tenancy import (  # noqa: F401
    TenantRegistry,
    TenantSpec,
)
from .tracing import (  # noqa: F401
    FlightRecorder,
    TraceContext,
    Tracer,
)
