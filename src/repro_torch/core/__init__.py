"""REMOP core: cost model, buffer policies, memory arbiter."""

from repro_torch.core.cost_model import (
    TABLE_I,
    TESTBED,
    HierarchySnapshot,
    HierarchySpec,
    LedgerSnapshot,
    TierLevel,
    TierSpec,
    TransferLedger,
    alpha,
    beta,
    hierarchy_spec,
    latency_cost,
)
from repro_torch.core import arbiter, policies
from repro_torch.core.arbiter import (
    ArbiterItem,
    HierarchyItem,
    arbitrate,
    arbitrate_hierarchy,
)

__all__ = [
    "TABLE_I", "TESTBED",
    "HierarchySnapshot", "HierarchySpec", "LedgerSnapshot",
    "TierLevel", "TierSpec", "TransferLedger",
    "alpha", "beta", "hierarchy_spec", "latency_cost",
    "ArbiterItem", "HierarchyItem", "arbitrate", "arbitrate_hierarchy",
    "arbiter", "policies",
]
