"""Core of the PyTorch/CUDA port: tensor-based execution paths for
high-dimensional relational operations, with execution-time path selection
(the paper's contribution), plus the faithful linear (spilling) baseline it
is measured against.  Tensor-path work runs on a CUDA device unless the
caller passes ``device="cpu"``.

Layered, front to back:

  * **Front-end** — :class:`Session` / :class:`Query` (fluent builder),
    the typed expression language (:func:`col`, :func:`lit`,
    :class:`Expr`), and the logical IR (``LScan``/``LFilter``/``LProject``/
    ``LJoin``/``LSort``/``LAggregate``/``LGroupBy``) with
    :func:`from_physical` as the legacy lowering shim.
  * **Planner** — :func:`plan_program` rewrites (filter pushdown, projection
    pruning, multi-key packing) and splits multi-join plans into chained
    ``Join→[Filter]→[Sort]→[Aggregate]`` fragments.
  * **Execution** — :class:`Executor` over physical nodes
    (:class:`Scan`…\\ :class:`Project`), the fused device-resident pipeline
    (:mod:`~repro_torch.core.fused`), per-operator tensor/linear engines, and the
    single-materialization :class:`DeviceRelation` layer.
  * **Decision layer** — :class:`CostModel` (fragment-level regime-shift
    costing), :class:`PathSelector` (execution-time path choice, with a
    per-decision ``work_mem`` override carrying the governor's pressure
    signal), and the :class:`RuntimeProfile` feedback loop.
  * **Residency** — :mod:`~repro_torch.core.table_cache`: device base-table column
    cache and key-cardinality sketches, both content-token keyed and safe
    to share across concurrent sessions.
  * **Resources** — :class:`ResourceBroker` (typed :class:`MemoryLease`
    / :class:`DeviceLease` acquisition and the pressure quotes that make
    ``auto`` queue-aware) over one :class:`MemoryGovernor` budget.
  * **Serving** — :class:`QueryServer` runs closed-loop (``serve``) and
    open-loop SLO (``serve_open``, :class:`ArrivalProcess`,
    :class:`TenantClass`) query streams over one shared session on one
    device.  The sharded fragment path is not ported yet.

See ``docs/ARCHITECTURE.md`` for the full layer map, ``docs/query-api.md``
for the front-end (including the ``explain()`` stage-chain notation), and
``docs/costing.md`` for the decision layer.
"""

from .cost_model import CostConstants, CostModel, FragmentEstimate
from .aggregate import (group_aggregate_device, group_aggregate_linear,
                        group_aggregate_tensor)
from .device_relation import DeviceColumn, DeviceRelation
from .executor import (PHYSICAL_NODES, Aggregate, Executor, Filter, GroupBy,
                       Join, Project, QueryResult, Scan, Sort)
from .expr import Expr, col, lit
from .faults import (DeadlineExceeded, DeviceDispatchError, FaultInjector,
                     GrantTimeout, PreemptedError, QueryRejected, RetryPolicy,
                     SimulatedCrash, SpillCorruptionError, SpillIOError,
                     TransientError)
from .fused import (FusedSpec, PredicateError, match_fragment,
                    pipeline_cache_clear, pipeline_cache_info, run_fused)
from .interop import cost_constants_from_dict, tables_from_numpy
from .linear_engine import (HashTable, hash_join_linear, sort_linear,
                            table_bytes_estimate)
from .logical import (LAggregate, LFilter, LGroupBy, LJoin, LProject, LScan,
                      LSort, from_physical, schema)
from .memory_governor import (BrokerInvariantViolation, FloorGrantPolicy,
                              GovernorStats, GrantPolicy, MemoryGovernor,
                              MemoryGrant, MemoryHold,
                              ProportionalShareGrantPolicy, TieredGrant)
from .metrics import (BLOCK_BYTES, LatencyStats, OpMetrics, SpillAccount,
                      latency_stats)
from .path_selector import Decision, PathSelector
from .planner import Program, plan_program, prune_columns, push_filters
from .relation import Relation, column_token
from .resource_broker import (BrokerStats, DeviceLease, DeviceQueue,
                              MemoryLease, PreemptToken, PressureQuote,
                              Reservation, ResourceBroker, ResourceRequest,
                              default_broker)
from .runtime_profile import DEFAULT_PROFILE, RuntimeProfile, size_bucket
from .server import (FailedQuery, QueryServer, ServeReport, ServedQuery,
                     ShedQuery)
from .session import Query, Session
from .slo import ArrivalProcess, TenantClass
from .spill import SpillManager
from .tier import (TierConfig, TierLedger, TierManager, TierStats,
                   decode_column, encode_column)
from .table_cache import (KeyStats, get_device_columns, get_device_layouts,
                          key_stats, pending_upload_bytes, table_cache_clear,
                          table_cache_info)
from .tensor_engine import (
    aligned_join_indices,
    capacity_bucket,
    join_capacity,
    tensor_join,
    tensor_join_aggregate,
    tensor_join_device,
    tensor_sort,
    tensor_sort_device,
)

__all__ = [
    "Aggregate", "ArrivalProcess", "FailedQuery", "QueryServer",
    "ServeReport", "ServedQuery", "ShedQuery", "TenantClass", "BLOCK_BYTES", "BrokerInvariantViolation",
    "BrokerStats", "CostConstants", "CostModel",
    "DEFAULT_PROFILE", "DeadlineExceeded", "Decision", "DeviceColumn",
    "DeviceDispatchError", "DeviceLease",
    "DeviceQueue", "DeviceRelation",
    "Executor", "Expr", "FaultInjector", "Filter",
    "FloorGrantPolicy", "FragmentEstimate",
    "FusedSpec", "GovernorStats", "GrantPolicy", "GrantTimeout", "GroupBy",
    "HashTable", "Join", "KeyStats", "LAggregate", "LFilter", "LGroupBy",
    "LJoin", "LProject", "LScan", "LSort", "LatencyStats",
    "MemoryGovernor", "MemoryGrant", "MemoryHold", "MemoryLease",
    "OpMetrics",
    "PHYSICAL_NODES", "PathSelector", "PredicateError", "PreemptToken",
    "PreemptedError", "PressureQuote", "Program", "Project",
    "ProportionalShareGrantPolicy", "Query", "QueryRejected",
    "QueryResult", "Relation", "Reservation",
    "ResourceBroker",
    "ResourceRequest", "RetryPolicy",
    "RuntimeProfile", "Scan", "Session", "SimulatedCrash",
    "Sort", "SpillAccount", "SpillCorruptionError", "SpillIOError",
    "TierConfig", "TierLedger", "TierManager", "TierStats",
    "TieredGrant", "TransientError",
    "SpillManager", "aligned_join_indices", "capacity_bucket", "col",
    "column_token", "cost_constants_from_dict", "default_broker",
    "from_physical", "get_device_columns", "get_device_layouts",
    "hash_join_linear", "join_capacity", "key_stats",
    "group_aggregate_device", "group_aggregate_linear", "group_aggregate_tensor",
    "latency_stats", "lit", "match_fragment", "pending_upload_bytes",
    "pipeline_cache_clear", "pipeline_cache_info", "plan_program",
    "decode_column", "encode_column",
    "prune_columns", "push_filters", "run_fused", "schema", "size_bucket",
    "sort_linear", "table_bytes_estimate", "table_cache_clear",
    "table_cache_info", "tables_from_numpy", "tensor_join",
    "tensor_join_aggregate", "tensor_join_device", "tensor_sort",
    "tensor_sort_device",
]
