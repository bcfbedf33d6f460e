"""The stdlib pieces of `paddle_tpu/resilience/` that the serving tier
needs, as the port's own copies: deterministic fault injection
(`faults.py`), the circuit breaker, retry/backoff and the preemption
handler (`preempt.py`), and the data-stream wire format of a snapshot
(`snapshot.py`, which the KV handoff reuses). Checkpointing
(`CheckpointManager`, the snapshot engine), the NaN guard and the trainer
fleet are ROADMAP Queue 1 item 8.

Counters: `preemptions_observed` (PreemptionHandler), and a
`retry_call(counter=...)` name bumped per retry."""

from . import faults
from .faults import FaultPlan, fault_bytes, fault_point
from .preempt import CircuitBreaker, PreemptionHandler, backoff_delays, retry_call
from .snapshot import FORMAT_VERSION, pack_stream

__all__ = [
    "CircuitBreaker",
    "FORMAT_VERSION",
    "FaultPlan",
    "PreemptionHandler",
    "backoff_delays",
    "fault_bytes",
    "fault_point",
    "faults",
    "pack_stream",
    "retry_call",
]
