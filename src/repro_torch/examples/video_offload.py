"""Temporal offloading walkthrough: video streams, tracked reward
propagation, and stale-edge-result reuse.

The paper decides offloading per image; ``repro_torch.video`` turns the
decision stack stream-level, which is what its deployment setting (a
camera feeding an edge over a constrained uplink) actually is:

- a seeded synthetic *video* scene (moving shapes, entries/exits/occlusions
  and scene cuts) with temporally-correlated weak/strong detections,
- a device-resident tracker (greedy IoU association, one ``iou_matrix_batch``
  launch a frame on the card) whose ``propagate`` snaps a stale edge result
  onto the current frame,
- two temporal policies in the engine registry: ``temporal_hysteresis``
  (stale-result credit) and ``keyframe`` (offload on scene changes,
  refractory-spaced),
- ``VideoRuntime.serve_clip``: netsim links age edge results in flight;
  every frame's *effective accuracy* (what was actually served, scored by
  the AP engine) lands on the trace (``examples/video_offload.py``).

Run:  python -m repro_torch.examples.video_offload [--device cpu]
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch.examples import parser
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.video import (
    STRONG_PROFILE,
    WEAK_PROFILE,
    TrackerConfig,
    VideoTracker,
    default_video_scenario,
    generate_clip,
    run_video_scenario,
    synthesize_detections,
    track_clip,
)

POLICIES = ("threshold", "temporal_hysteresis", "keyframe")


def run(device="cuda", *, n_streams: int = 8, n_frames: int = 96) -> dict:
    """``{"cuts", "n_active" (stream 0 of the 2 x 24 clip), "propagated",
    "decay", "policies": {policy: {"realized_ratio", "effective_acc",
    "covered", "mean_staleness"}}}`` for ``default_video_scenario(n_streams,
    n_frames)``."""
    dev = resolve_device(device)
    clip = generate_clip(2, 24, seed=4)
    weak = synthesize_detections(clip, WEAK_PROFILE, seed=5)
    hist = track_clip(weak, device=dev)  # the whole clip in one call on the device
    out = {"n_frames": clip.n_frames, "n_streams": clip.n_streams,
           "cuts": np.flatnonzero(clip.cuts[:, 0]).tolist(),
           "n_active": hist.n_active[:, 0].tolist()}

    vt = VideoTracker(2, TrackerConfig(), device=dev)
    for t in range(24):
        vt.update(weak.frame(t, device=dev))
    strong = synthesize_detections(clip, STRONG_PROFILE, seed=6)
    edge = strong.det(20, 0)
    vt.propagate(edge, 20, 23, stream=0)
    out["propagated"] = len(edge)
    out["decay"] = vt.config.stale_decay ** 3

    scenario = default_video_scenario(n_streams, n_frames, seed=0, device=dev)
    out["policies"] = {}
    for policy in POLICIES:
        trace = run_video_scenario(scenario, policy, ratio=0.3)
        s = trace.staleness_profile()
        out["policies"][policy] = {
            "realized_ratio": trace.realized_ratio(),
            "effective_acc": trace.mean_effective_accuracy(),
            "covered": s["covered_fraction"], "mean_staleness": s["mean_staleness"],
        }
    return out


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parser(__doc__).parse_args(argv)
    out = run(args.device)
    print("== the raw pieces: a clip and its device-resident tracker ==")
    print(f"  clip: {out['n_frames']} frames x {out['n_streams']} streams,"
          f" cuts at {out['cuts']} (stream 0)")
    print(f"  tracks alive per frame (stream 0): {out['n_active']}")
    print("\n== stale-result reuse: propagate an old edge answer forward ==")
    print(f"  edge result from t=20 propagated to t=23: {out['propagated']} dets,"
          f" scores decayed x{out['decay']:.2f}")
    print("\n== the seeded 8-stream congested scenario, three policies ==")
    for policy, p in out["policies"].items():
        print(
            f"  {policy:20s} realized_ratio={p['realized_ratio']:.3f}"
            f"  effective_acc={p['effective_acc']:.4f}"
            f"  covered={p['covered']:.2f}"
            f" (mean staleness {p['mean_staleness']:.1f} frames)"
        )
    print("  -> the per-frame trace (r.source / r.staleness / r.effective_accuracy)")
    print("     shows where the accuracy went.")
    return out


if __name__ == "__main__":
    main()
