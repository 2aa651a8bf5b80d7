"""Runnable counterparts of the JAX package's ``examples/`` scripts, one
module each under the script's own name:

    python -m repro_torch.examples.quickstart            # on the card
    python -m repro_torch.examples.quickstart --device cpu

Each module takes its script's flags and defaults plus ``--device``
(``cuda`` unless ``cpu`` is asked for; on a host without a GPU a run
without ``--device cpu`` raises, as every entry point of the port does).
Each has ``run(device, **sizes) -> dict``, whose keyword defaults are the
script's constants and which returns the numbers the script prints, and
``main(argv=None)``, which parses the flags, calls ``run``, prints and
returns ``run``'s dict.  The numpy seeds are the script's own; torch draws
come from an explicit ``torch.Generator``.

Artifacts go where the scripts put them, in their formats, so that either
package reads what the other wrote: :data:`ARTIFACTS` (``artifacts/`` at
the repository root, or ``$REPRO_ARTIFACTS`` as for
``experiments.detection_repro``) holds ``lm_100m.npz`` (``save_pytree``'s
key layout), ``lm_cascade_engine.npz`` and ``offload_engine.npz``
(``save_flat``); ``observability`` writes ``obs_trace.json`` /
``obs_metrics.json`` to the working directory.
"""
from __future__ import annotations

import argparse
import os

ARTIFACTS = os.environ.get(
    "REPRO_ARTIFACTS", os.path.join(os.path.dirname(__file__), "../../../artifacts")
)

MODULES = (
    "quickstart",
    "offload_detection",
    "stream_offload",
    "train_lm",
    "serve_cascade",
    "observability",
    "netsim_congestion",
    "video_offload",
    "online_adaptation",
    "fleet_scale",
    "mobility_handover",
)


def artifact(name: str) -> str:
    """The path of ``name`` under :data:`ARTIFACTS` (read at call time)."""
    return os.path.join(ARTIFACTS, name)


def parser(doc: str) -> argparse.ArgumentParser:
    """An argument parser with the ``--device`` flag every module takes."""
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap
