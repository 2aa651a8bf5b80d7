"""Event-driven network & queueing simulation for the offloading runtime.

The paper's device→edge link, made explicit: :mod:`repro_torch.netsim.link`
prices size-dependent transmission (constant-rate, trace-driven, or a seeded
Gilbert–Elliott fading channel), :mod:`repro_torch.netsim.queue` is the
bounded FIFO uplink in front of it (per-frame sojourn accounting,
deterministic schedules, manually clocked), and
:mod:`repro_torch.netsim.policy` holds the queue-aware decision policies —
the congestion-discounted ``queue_aware`` threshold and the
``value_iteration`` MDP controller over (queue depth × channel state),
solved as float32 tensor sweeps on the engine's device.

Plugs into the serving stack via ``EdgeWorker(link=...)`` (uplink-fronted
edges), ``simulate()`` (per-step queue/transmit/service breakdowns on the
trace), and the ``repro_torch.api`` policy registry (both policies
constructible through ``OffloadEngine``).  The port of ``repro.netsim``.
"""
from repro_torch.netsim.link import (
    CHANNEL_BAD,
    CHANNEL_GOOD,
    ConstantRateLink,
    GilbertElliottLink,
    NetworkLink,
    TraceBandwidthLink,
)
from repro_torch.netsim.policy import (
    QueueAwarePolicy,
    ValueIterationPolicy,
    quantile_threshold,
    solve_value_iteration,
    value_iteration_ref,
    value_iteration_sweep,
)
from repro_torch.netsim.queue import DownlinkQueue, TransmittedFrame, UplinkQueue

__all__ = [
    "NetworkLink",
    "ConstantRateLink",
    "TraceBandwidthLink",
    "GilbertElliottLink",
    "CHANNEL_GOOD",
    "CHANNEL_BAD",
    "UplinkQueue",
    "DownlinkQueue",
    "TransmittedFrame",
    "QueueAwarePolicy",
    "ValueIterationPolicy",
    "quantile_threshold",
    "solve_value_iteration",
    "value_iteration_ref",
    "value_iteration_sweep",
]
