"""City-scale sharded serving walkthrough.

1. the sharded data plane: scoring a big stream batch over four shards,
   bit-identical to the single-device engine path;
2. the headline: 1024 streams in 4 districts of increasing offload
   hardness, served coordinated (reward-driven budget redistribution)
   vs static equal split at the same global token budget
   (``examples/fleet_scale.py``).

Run:  python -m repro_torch.examples.fleet_scale [--device cpu]

The plane's four shards are four views of the one device
(``make_fleet_mesh(devices=[device] * 4)``), as the JAX script's forced
host devices are four views of the CPU; that script's ``XLA_FLAGS`` line
has no counterpart here.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch.api import MLPRewardModel, OffloadEngine
from repro_torch.core import EstimatorConfig
from repro_torch.examples import parser
from repro_torch.fleet import FleetPlane, default_city_scenario, run_city_scenario
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.launch.mesh import make_fleet_mesh

SHARDS = 4


def sharded_plane_demo(device="cuda", n: int = 1024) -> dict:
    """An engine fitted on ``n`` seeded rows scores ``n - 24`` of them
    (ragged over the shards) through the plane and through the engine:
    ``{"devices", "bit_identical"}``."""
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (n, 64)).astype(np.float32)
    eng = OffloadEngine(
        reward_model=MLPRewardModel(
            config=EstimatorConfig(hidden=(32,), epochs=3), device=device
        )
    )
    eng.fit(features=x, rewards=rng.normal(0, 1, n))
    plane = FleetPlane(make_fleet_mesh(devices=[device] * SHARDS))
    # 1000 of 1024 streams is ragged over 4 shards (250 each): padding included
    ref = np.asarray(eng.score(features=x[: n - 24]))
    out = np.asarray(plane.score(eng, x[: n - 24]))
    return {"devices": plane.n_devices, "bit_identical": bool(np.array_equal(ref, out))}


def city_demo(device="cuda", n_streams: int = 1024, n_ticks: int = 48) -> dict:
    """Both arms of ``default_city_scenario(n_streams, n_ticks)``."""
    scenario = default_city_scenario(n_streams=n_streams, n_ticks=n_ticks, device=device)
    static = run_city_scenario(scenario, coordinated=False)
    coord = run_city_scenario(scenario, coordinated=True)
    return {
        "n_streams": n_streams, "hardness": list(scenario.hardness),
        "static": static.summary(), "coordinated": coord.summary(),
        "gain": coord.mean_effective() - static.mean_effective(),
        "ratio_delta": coord.realized_ratio() - static.realized_ratio(),
    }


def run(device="cuda", *, n_rows: int = 1024, n_streams: int = 1024,
        n_ticks: int = 48) -> dict:
    """``{"plane": sharded_plane_demo(...), "city": city_demo(...)}``."""
    dev = resolve_device(device)
    return {"plane": sharded_plane_demo(dev, n_rows),
            "city": city_demo(dev, n_streams, n_ticks)}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parser(__doc__).parse_args(argv)
    out = run(args.device)
    p, c = out["plane"], out["city"]
    print("== sharded data plane: bit-identity over four shards of one device ==")
    print(f"  devices: {p['devices']}")
    print(f"  sharded == single-device, bit-for-bit: {p['bit_identical']}")
    print()
    print(f"== city headline: coordinated vs static budget, {c['n_streams']} streams ==")
    print(f"  districts (hardness): {tuple(c['hardness'])}")
    for name in ("static", "coordinated"):
        s = c[name]
        shares = ", ".join(f"{v:.2f}" for v in s["shard_shares"])
        ratios = ", ".join(f"{v:.2f}" for v in s["shard_ratios"])
        print(
            f"  {name:>11}: effective={s['mean_effective']:.4f}"
            f"  realized={s['realized_ratio']:.3f}"
            f"  shares=[{shares}]  shard_ratios=[{ratios}]"
            f"  redistributions={s['redistributions']}"
        )
    print(f"  coordination gain: {c['gain']:+.4f} effective AP at "
          f"{c['ratio_delta']:+.3f} realized-ratio delta")
    return out


if __name__ == "__main__":
    main()
