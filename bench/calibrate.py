"""The readings that a cell's limits for ``correct`` are set from, on the
card, in one process (set-up is long; the benchmark's own runs never run
this):

    python bench/calibrate.py --workload <name> --seeds 101,102,... \
        --control-seeds 101,102,103 --seconds 4 [--floors 0,0.001] [--out FILE]

For each seed: the cell's set-up, a short window at the cell's own load,
the program's state freed, then the numbers ``harness.check`` compares,
for the program against the float32 reference.  For each control seed
also the control's: the reference computed in float8 (e4m3, per-tensor
scales) put in the program's place, against the same reference.  Then, on
the same sampled requests, the planted faults that the decision numbers
must see: a decision altered after the estimate (``decision_altered``),
and the program's head run without its standardisation
(``no_standardisation``: an artifact with mu 0 and sigma 1 beside the same
calibration scores).  With ``--floors``, the program's decisions (a fresh
engine's ``decide`` on the sampled batches' weak logits), the reference's
and the control's are read again under each standardisation floor, with
every margin, so that a floor and a band can be chosen from them.  One
JSON line a seed on stdout (and appended to ``--out``).
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for _p in (str(ROOT / "src"), str(ROOT / "bench")):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def program_decisions(drv, idx, floor, standardize=True):
    """The program's decisions for the sampled batches through a fresh
    engine written with ``floor`` (and, with ``standardize=False``, its
    standardisation left out)."""
    import numpy as np
    import torch

    from reference import common as ref
    from repro_torch.models.lm import forward
    from repro_torch.serving.cascade_serving import truncate_params, truncated_config

    cascade, scores = drv.load_engine(floor, standardize)
    wparams = truncate_params(drv.params, drv.cfg, drv.exit_layer)
    wcfg = truncated_config(drv.cfg, drv.exit_layer)
    est, off = [], []
    with torch.no_grad():
        for j in idx:
            b = drv.served[j]
            logits, _ = forward(wparams, wcfg, {"tokens": b["tokens"], "labels": b["labels"]})
            d = cascade.engine.decide((logits, b["labels"]))
            est.append(d.estimates)
            off.append(d.offload)
            del logits
    del cascade
    return {"estimates": np.concatenate(est), "offload": np.concatenate(off),
            "threshold": ref.threshold(scores, drv.mix.ratio)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--floors", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    from harness import check
    from harness.manifest import driver, load_cell

    if not torch.cuda.is_available():
        print("calibrate.py reads the card; none is visible", file=sys.stderr)
        return 2
    cell = load_cell(ROOT, args.workload)
    dev = torch.device("cuda", 0)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    floors = [float(f) for f in args.floors.split(",") if f]
    band = cell.limits["flip_band_logit"]
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        drv = driver(cell)(cell, seed, dev)
        drv.setup()
        drv.window(args.seconds)
        drv.free()
        idx = drv.sample()
        refr = drv.reference_answers(idx)
        prog = drv.program_answers(idx)
        line = {"workload": cell.name, "seed": seed, "std_floor": drv.std_floor,
                "program": check.readings(prog, refr, band)}
        if seed in controls:
            line["control_fp8"] = check.readings(drv.reference_answers(idx, "fp8"), refr, band)
        altered = dict(prog, offload=np.array(prog["offload"], bool))
        k = int(np.random.default_rng([seed, 9]).integers(len(altered["offload"])))
        altered["offload"][k] = not altered["offload"][k]
        line["decision_altered"] = check.readings(altered, refr, band)
        faulty = dict(prog, **program_decisions(drv, idx, drv.std_floor, standardize=False))
        faulty["nll_final"] = np.where(faulty["offload"], prog["nll_strong"], prog["nll_weak"])
        line["no_standardisation"] = check.readings(faulty, refr, band)
        line["no_standardisation_margins"] = check.margins(faulty).tolist()
        line["floors"] = {}
        for floor in floors:
            r = drv.reference_answers(idx, std_floor=floor)
            p = dict(prog, **program_decisions(drv, idx, floor))
            p["nll_final"] = np.where(p["offload"], prog["nll_strong"], prog["nll_weak"])
            entry = {"program": check.readings(p, r, band),
                     "margins_reference": check.margins(r).tolist(),
                     "margins_program": check.margins(p).tolist(),
                     "offload_reference": np.asarray(r["offload"], bool).tolist(),
                     "offload_program": np.asarray(p["offload"], bool).tolist()}
            if seed in controls:
                c = drv.reference_answers(idx, "fp8", std_floor=floor)
                entry["control_fp8"] = check.readings(c, r, band)
                entry["margins_control"] = check.margins(c).tolist()
                entry["offload_control"] = np.asarray(c["offload"], bool).tolist()
            line["floors"][repr(floor)] = entry
        line["realized_ratio"] = float(np.mean(np.concatenate([o["offload"] for o in drv.outs])))
        line["calibration_requests"] = sum(len(b["lengths"]) for b in drv.cal)
        line["sampled_requests"] = len(prog["offload"])
        line["seconds"] = time.perf_counter() - t0
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")
        del drv
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
