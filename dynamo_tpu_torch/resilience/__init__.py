"""Request-lifecycle reliability: the deterministic fault-injection
harness (:mod:`.faultpoints`), a copy of ``dynamo_tpu.resilience``'s.
The transfer plane and the prefill worker call it. The drain coordinator,
migration and live resharding are ROADMAP A.4."""

from . import faultpoints
from .faultpoints import FaultInjected

__all__ = ["FaultInjected", "faultpoints"]
