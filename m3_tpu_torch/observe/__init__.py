"""m3_tpu_torch.observe — the task ledger of the flight recorder.

Port of the part of ``m3_tpu/observe/__init__.py`` that storage needs:
:func:`task_ledger`, the process-global ledger of live daemons and
in-flight queries (``tasks.TaskLedger``), where the index compactor
registers its daemon.  The device-memory ledger and the profile
recorder wait for ROADMAP.md's queue 1 item 4; this module does not
import them.
"""

from __future__ import annotations

from .tasks import QueryCancelled, TaskLedger, Watchdog

__all__ = ["QueryCancelled", "TaskLedger", "Watchdog", "task_ledger"]

_tasks = TaskLedger()


def task_ledger() -> TaskLedger:
    return _tasks
