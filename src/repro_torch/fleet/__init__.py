"""repro_torch.fleet — city-scale sharded serving.

The offload data plane on a device mesh (:class:`FleetPlane`, bit-identical
to single-device), thousands of streams partitioned into logical shards
each owning a private edge fleet (:class:`FleetRuntime` /
:func:`simulate_fleet`), and fleet-wide token-budget coordination with
reward-driven redistribution (:class:`FleetBudget`, the ``fleet_fair``
policy).  ``repro_torch.fleet.experiment`` holds the city-scale headline:
coordinated redistribution beats the static equal split at equal total
offload budget.

The port of ``repro.fleet``; the plane runs the port's CUDA kernels on the
card (``estimator_mlp``, ``score_pipeline``, the IoU family's ``match``
route) with each shard launched on the global batch's plan.
"""
from repro_torch.fleet.budget import FleetBudget, FleetFairPolicy
from repro_torch.fleet.experiment import (
    CityRunResult,
    CityScenario,
    default_city_scenario,
    run_city_scenario,
)
from repro_torch.fleet.plane import FleetPlane
from repro_torch.fleet.runtime import (
    FleetRuntime,
    FleetStep,
    FleetTelemetry,
    FleetTrace,
    reduce_telemetry,
    simulate_fleet,
)

__all__ = [
    "CityRunResult",
    "CityScenario",
    "FleetBudget",
    "FleetFairPolicy",
    "FleetPlane",
    "FleetRuntime",
    "FleetStep",
    "FleetTelemetry",
    "FleetTrace",
    "default_city_scenario",
    "reduce_telemetry",
    "run_city_scenario",
    "simulate_fleet",
]
