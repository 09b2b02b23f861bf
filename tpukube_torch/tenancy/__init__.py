"""Multi-tenant serving plane: per-tenant quotas, DRF fairness, and
SLO-aware admission over fractional vGPUs (``core.py``)."""

from tpukube_torch.tenancy.core import (
    BurnMonitor,
    TenantLedger,
    TenantPlane,
    TenantQuota,
    TenantUsage,
    parse_quotas,
)

__all__ = [
    "BurnMonitor",
    "TenantLedger",
    "TenantPlane",
    "TenantQuota",
    "TenantUsage",
    "parse_quotas",
]
