"""REMOP over simulated remote-memory tiers, plus the torch execution backend.

A single tier is a :class:`RemoteMemory`; an ordered stack of tiers with
capacities, per-tier ledgers, and migration rounds is a
:class:`MemoryHierarchy` (the runtime of the paper's Table I read as a
DRAM -> RDMA -> SSD waterfall).  :class:`TorchExecutionBackend` is the same
hierarchy with device copies of its pages and CUDA kernels behind the
operators' compute hooks.
"""

from repro_torch.remote.simulator import (
    MemoryHierarchy,
    RemoteMemory,
    Relation,
    load_pages,
    make_hierarchy,
    make_relation,
)
from repro_torch.remote.bnlj import bnlj, bnlj_oracle, JoinResult
from repro_torch.remote.ems import ems_sort, ems_oracle, SortResult
from repro_torch.remote.ehj import ehj, ehj_oracle, HashJoinResult
from repro_torch.remote.eagg import eagg, eagg_oracle, AggResult

__all__ = [
    "MemoryHierarchy", "RemoteMemory", "Relation",
    "load_pages", "make_hierarchy", "make_relation",
    "bnlj", "bnlj_oracle", "JoinResult",
    "ems_sort", "ems_oracle", "SortResult",
    "ehj", "ehj_oracle", "HashJoinResult",
    "eagg", "eagg_oracle", "AggResult",
    "TorchExecutionBackend", "TorchBackendTier", "WallClock", "make_backend",
]

_BACKEND_NAMES = {"TorchExecutionBackend", "TorchBackendTier", "WallClock",
                  "make_backend"}


def __getattr__(name):
    # The execution backend imports torch and the kernel wrappers; load it
    # lazily so simulator-only consumers never pay for the kernel stack.
    if name in _BACKEND_NAMES:
        from repro_torch.remote import backend

        return getattr(backend, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
