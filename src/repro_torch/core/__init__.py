"""REMOP core: cost model, buffer policies, memory arbiter, planner."""

from repro_torch.core.cost_model import (
    H100,
    H100_TIERS,
    TABLE_I,
    TESTBED,
    H100Spec,
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
from repro_torch.core import arbiter, planner, policies
from repro_torch.core.arbiter import (
    ArbiterItem,
    HierarchyItem,
    arbitrate,
    arbitrate_hierarchy,
)

__all__ = [
    "H100", "H100_TIERS", "H100Spec", "TABLE_I", "TESTBED",
    "HierarchySnapshot", "HierarchySpec", "LedgerSnapshot",
    "TierLevel", "TierSpec", "TransferLedger",
    "alpha", "beta", "hierarchy_spec", "latency_cost",
    "ArbiterItem", "HierarchyItem", "arbitrate", "arbitrate_hierarchy",
    "arbiter", "planner", "policies",
]
