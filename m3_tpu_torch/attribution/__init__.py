"""Workload attribution: per-tenant cost accounting, heavy-hitter
sketches, and the observe-only admission fairness report.

See :mod:`m3_tpu_torch.attribution.accountant` for the accounting model and
docs/observability.md "Workload attribution" for operator docs.
"""

from m3_tpu_torch.attribution.accountant import (  # noqa: F401
    BATCH_TENANT, DEFAULT_TENANT, TENANT_HEADER, Accountant, account_query,
    account_read, account_write, accountant, configure, current_tenant,
    enabled, inflight_add, inflight_sub, merge_attribution_dumps,
    note_label_keys, safe_tenant)
from m3_tpu_torch.attribution.sketch import (  # noqa: F401
    SpaceSaving, merge_dumps)
