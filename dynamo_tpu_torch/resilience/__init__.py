"""Request-lifecycle reliability, a copy of ``dynamo_tpu.resilience``'s
parts the port serves:

  * :mod:`.migration` — :class:`MigratingEngine`, the frontend stream
    wrapper that re-dispatches a broken stream as ``prompt +
    tokens-so-far`` with the ``resume`` annotation;
  * :mod:`.policy` — :class:`MigrationPolicy` and the disconnect
    classifier;
  * :mod:`.drain` — :class:`DrainCoordinator`, the SIGTERM sequence: stop
    admitting, finish or hand off in-flight work, revoke the lease last;
  * :mod:`.faultpoints` — the deterministic fault-injection harness.

Live resharding (the reference's ``reshard.py``) is ROADMAP A.9.
"""

from . import faultpoints
from .drain import DrainCoordinator
from .faultpoints import FaultInjected
from .migration import MigratingEngine, ROUTED_WORKER_KEY
from .policy import (
    MIGRATION_SIGNAL,
    WORKER_LOST_SIGNATURES,
    FailureKind,
    MigrationPolicy,
    classify_failure,
)

__all__ = [
    "DrainCoordinator",
    "FailureKind",
    "FaultInjected",
    "MIGRATION_SIGNAL",
    "MigratingEngine",
    "MigrationPolicy",
    "ROUTED_WORKER_KEY",
    "WORKER_LOST_SIGNATURES",
    "classify_failure",
    "faultpoints",
]
