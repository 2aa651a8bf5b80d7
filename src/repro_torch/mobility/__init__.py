"""Moving clients, coverage-dependent links, and mid-stream edge handover.

The paper's deployment story — embedded devices *in motion* offloading
detection to a fixed edge fleet — as a subsystem on the four documented
seams: seeded mobility traces rolled out as float32 tensor ops on the device
(:mod:`repro_torch.mobility.motion`), base-station placements with log-distance
path loss mapped onto the existing netsim links plus a priced downlink
(:mod:`repro_torch.mobility.coverage`), hysteresis-triggered migration with
configurable in-flight semantics (:mod:`repro_torch.mobility.handover`), the
``mobility_aware`` policy (registered in the ``repro_torch.api`` registry), and
the :class:`MobileRuntime` runtime tying them to the shared manual clock
(:mod:`repro_torch.mobility.runtime`).  See docs/API.md "Mobility & handover".

The port of ``repro.mobility``.
"""
from repro_torch.mobility.coverage import (
    NO_SIGNAL_DBM,
    BaseStation,
    CoverageMap,
    default_stations,
    station_fleet,
)
from repro_torch.mobility.handover import (
    IN_FLIGHT,
    HandoverController,
    HandoverEvent,
    PendingResult,
    apply_in_flight,
)
from repro_torch.mobility.motion import MODELS, MotionConfig, rollout, rollout_ref
from repro_torch.mobility.policy import MobilityAwarePolicy
from repro_torch.mobility.runtime import (
    MODES,
    MobileRuntime,
    MobileScenario,
    MobileStepRecord,
    MobileTrace,
    default_mobile_scenario,
    run_mobile_scenario,
)

__all__ = [
    "MODELS",
    "MotionConfig",
    "rollout",
    "rollout_ref",
    "NO_SIGNAL_DBM",
    "BaseStation",
    "CoverageMap",
    "default_stations",
    "station_fleet",
    "IN_FLIGHT",
    "HandoverController",
    "HandoverEvent",
    "PendingResult",
    "apply_in_flight",
    "MobilityAwarePolicy",
    "MODES",
    "MobileRuntime",
    "MobileScenario",
    "MobileStepRecord",
    "MobileTrace",
    "default_mobile_scenario",
    "run_mobile_scenario",
]
