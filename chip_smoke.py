#!/usr/bin/env python3
"""Drive the PyTorch port's detection serve path once on one NVIDIA H100.

    python3 chip_smoke.py

Run from the root of a checkout; it builds the port's CUDA kernels from
``src/repro_torch/kernels/csrc`` (into the directory ``.gitignore`` lists) on
first use.  Phases, each printing one line of its own:

1. ``probe``   versions, the device (capability must be 9.0), nvidia-smi's
               name and power limit, the TF32 flags (both set False).
2. ``build``   nvcc for every kernel source, all at once, and its seconds.
3. ``check``   every kernel against its plain PyTorch version on the card at
               main-path and edge shapes, with the tolerance stated; the
               kernel's and the plain version's time at the main-path shape.
4. ``serve``   the serve path with every launch count set to 0 first:
               1024 seeded shapes images; the WEAK detector + NMS and the
               reward model calibrate on the first 512; an engine artifact
               goes through ``save_flat`` -> ``OffloadEngine.load``; the other
               512 are served as 8 requests of 64 (weak detector + NMS ->
               ``engine.decide`` -> STRONG detector on the offloaded frames),
               then matched against the ground truth for the cascade mAP.
               The first frame of each request is also served alone, as a
               camera sends one frame at a time.  The first request is also
               decided through ``features=``; it and the single frames are
               held against the same detections decided on the CPU.
5. ``{"kernels": [...]}`` each kernel's launches on that run, its error
               against the plain version, its times and its bound.

The last line is ``{"ok": true, "device": {...}}``.  Without a GPU, or outside
a checkout, it exits non-zero and prints no result.  Weights are seeded, not
trained, so the mAPs check the plumbing, not accuracy.
"""
from __future__ import annotations

import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM data-sheet peaks (dense): HBM bytes/s and float32 CUDA-core FLOP/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12

NUM_CLASSES, TOP_K, IMAGE_SIZE, HIDDEN = 8, 25, 64.0, 128
N_IMAGES, N_CAL, REQUEST = 1024, 512, 64


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def emit(tag: str, payload) -> None:
    print(f"{tag} {json.dumps(payload, sort_keys=False)}", flush=True)


def nvidia_smi_line() -> str:
    exe = shutil.which("nvidia-smi")
    if exe is None:
        fail("nvidia-smi not found")
    out = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------- timing


class Timer:
    """Median per-call device time of ``fn`` over windows of ``reps`` calls,
    from CUDA events.  Before each window the stream is held busy with
    ``torch.cuda._sleep`` long enough for the host to queue the whole
    window, so the events see back-to-back device work and not the host's
    launch gaps (where the host is slower than the window, they see both)."""

    def __init__(self, torch):
        self.torch = torch
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        torch.cuda._sleep(10_000_000)
        e.record()
        e.synchronize()
        self.cycles_per_ms = 10_000_000 / max(s.elapsed_time(e), 1e-3)

    def __call__(self, fn, reps: int = 20, windows: int = 21) -> float:
        torch = self.torch
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        sleep = int(min(2.0 * host_ms + 0.05, 200.0) * self.cycles_per_ms)
        times = []
        for _ in range(windows):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(sleep)
            s.record()
            for _ in range(reps):
                fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e) / reps)
        return statistics.median(times)


def bound(bytes_moved: float, ops: float):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    float32 operations over the CUDA-core rate."""
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------- inputs


def seeded_boxes(rng, shape, scale=50.0):
    xy = rng.uniform(0, scale, shape + (2,))
    return np.concatenate([xy, xy + rng.uniform(1, 20, shape + (2,))], -1).astype(np.float32)


def seeded_block(torch, rng, B, K, dev, empty_rows=0, tie_levels=None):
    """A padded detection block (B, K): prefix masks of random length, the
    first ``empty_rows`` rows all masked, scores optionally quantized."""
    boxes = torch.tensor(seeded_boxes(rng, (B, K), IMAGE_SIZE), device=dev)
    scores = rng.uniform(0, 1, (B, K))
    if tie_levels:
        scores = np.round(scores * tie_levels) / tie_levels
    counts = rng.integers(1, K + 1, B)
    counts[:empty_rows] = 0
    mask = np.arange(K)[None, :] < counts[:, None]
    classes = np.where(mask, rng.integers(0, NUM_CLASSES, (B, K)), -1)
    return (
        boxes,
        torch.tensor(scores.astype(np.float32), device=dev),
        torch.tensor(classes.astype(np.int32), device=dev),
        torch.tensor(mask, device=dev),
    )


def seeded_mlp(torch, rng, F, H, dev):
    return [
        torch.tensor(v, device=dev)
        for v in (
            (rng.standard_normal((F, H)) * np.sqrt(2.0 / F)).astype(np.float32),
            rng.normal(0, 0.1, H).astype(np.float32),
            (rng.standard_normal(H) * np.sqrt(2.0 / H)).astype(np.float32),
            np.float32(0.05),
        )
    ]


def seeded_detector_params(cfg, seed, objectness_bias=3.0, class_scale=8.0):
    """Detector weights in the JAX package's layout (HWIO), He-normal from
    numpy, with the objectness bias raised and the class logits sharpened so
    that an untrained detector clears the score threshold on some cells."""
    rng = np.random.default_rng(seed)

    def conv(k, cin, cout):
        w = rng.standard_normal((k, k, cin, cout)) * np.sqrt(2.0 / (k * k * cin))
        return {"w": w.astype(np.float32), "b": np.zeros(cout, np.float32)}

    tree, cin = {}, 3
    for i, w in enumerate(cfg.widths):
        tree[f"stage{i}_a"] = conv(3, cin, w)
        tree[f"stage{i}_b"] = conv(3, w, w)
        cin = w
    tree["head_hidden"] = conv(1, cin, cfg.head_width)
    tree["head_out"] = conv(1, cfg.head_width, 1 + cfg.num_classes + 4)
    tree["head_out"]["b"][0] = objectness_bias
    tree["head_out"]["w"][..., 1 : 1 + cfg.num_classes] *= class_scale
    return tree


# --------------------------------------------------------------- phases


def _sync(torch, dev):
    return torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)


def probe(torch):
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    from repro_torch.kernels import _build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        nvcc_version = subprocess.run(
            [_build.nvcc(), "--version"], capture_output=True, text=True, timeout=60
        ).stdout.strip().splitlines()[-1]
    except RuntimeError as err:
        fail(str(err))
    try:
        import triton

        triton_version = triton.__version__
    except ImportError:
        triton_version = None
    cap = torch.cuda.get_device_capability(0)
    smi = nvidia_smi_line()
    info = {
        "python": sys.version.split()[0],
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "nvcc": nvcc_version,
        "triton": triton_version,
        "device": torch.cuda.get_device_name(0),
        "capability": list(cap),
        "device_count": torch.cuda.device_count(),
        "nvidia_smi": smi,
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
        "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
    }
    emit("probe", info)
    if tuple(cap) != (9, 0):
        fail(f"{info['device']} has capability {cap}; the kernels need sm_90a")
    return smi


def build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    logs = _build.build_all()
    seconds = time.perf_counter() - t0
    ptxas = {
        name: [ln.strip() for ln in log.splitlines() if "registers" in ln]
        for name, log in logs.items()
    }
    emit("build", {"seconds": round(seconds, 3), "built": sorted(logs), "ptxas": ptxas})


def check_kernels(torch, timer, dev):
    """Every kernel against its plain version on the card.  Returns per-kernel
    records with max error, times and bound at the main-path shape."""
    from repro_torch.kernels.estimator_mlp import estimator_mlp, estimator_mlp_ref
    from repro_torch.kernels.iou_matrix import (
        iou_matrix, iou_matrix_batch, iou_matrix_batch_ref, iou_matrix_ref,
    )
    from repro_torch.kernels.score_pipeline import score_pipeline, score_pipeline_ref

    sync = _sync(torch, dev)
    rng = np.random.default_rng(1234)
    cases, err = [], {}

    def hold(kernel, case, got, want, tol):
        sync()
        e = float((got.float() - want.float()).abs().max()) if got.numel() else 0.0
        if got.shape != want.shape or not np.isfinite(e) or e > tol:
            fail(f"{kernel} {case}: max abs error {e} against tolerance {tol}")
        err[kernel] = max(err.get(kernel, 0.0), e)
        cases.append({"kernel": kernel, "case": case, "max_abs_err": e, "tol": tol})

    for dtype, tol in ((torch.float32, 1e-6), (torch.bfloat16, 2e-2)):
        tname = str(dtype).split(".")[-1]
        for B in (1, 512):
            for K in (8, 64):
                a = torch.tensor(seeded_boxes(rng, (B, K)), device=dev).to(dtype)
                g = torch.tensor(seeded_boxes(rng, (B, 8)), device=dev).to(dtype)
                hold("iou_matrix_batch", f"B={B} K={K} M=8 {tname}",
                     iou_matrix_batch(a, g), iou_matrix_batch_ref(a, g), tol)
        for B in (64, 256):  # NMS: a request's / a calibration chunk's 64 grid slots
            a = torch.tensor(seeded_boxes(rng, (B, 64), IMAGE_SIZE), device=dev).to(dtype)
            hold("iou_matrix_batch", f"B={B} K=M=64 self {tname}",
                 iou_matrix_batch(a, a), iou_matrix_batch_ref(a, a), tol)
        for N, M in ((1, 1), (511, 130)):
            a = torch.tensor(seeded_boxes(rng, (N,)), device=dev).to(dtype)
            g = torch.tensor(seeded_boxes(rng, (M,)), device=dev).to(dtype)
            hold("iou_matrix", f"N={N} M={M} {tname}", iou_matrix(a, g), iou_matrix_ref(a, g), tol)
        a = torch.tensor(seeded_boxes(rng, (64,), IMAGE_SIZE), device=dev).to(dtype)
        hold("iou_matrix", f"N=M=64 self {tname}", iou_matrix(a, a), iou_matrix_ref(a, a), tol)

    F = TOP_K * (7 + NUM_CLASSES) + 4 + NUM_CLASSES
    for B, f, h in ((1, F, HIDDEN), (37, F, HIDDEN), (512, F, HIDDEN), (4096, F, HIDDEN), (37, 33, 17)):
        x = torch.tensor(rng.normal(0, 1, (B, f)).astype(np.float32), device=dev)
        w = seeded_mlp(torch, rng, f, h, dev)
        hold("estimator_mlp", f"B={B} F={f} H={h}", estimator_mlp(x, *w), estimator_mlp_ref(x, *w), 1e-5)

    w1, b1, w2, b2 = seeded_mlp(torch, rng, F, HIDDEN, dev)
    mu = torch.tensor(rng.normal(0, 0.1, F).astype(np.float32), device=dev)
    sigma = torch.tensor(rng.uniform(0.5, 2.0, F).astype(np.float32), device=dev)
    params = dict(w1=w1, b1=b1, w2=w2, b2=b2, mu=mu, sigma=sigma)
    kw = dict(num_classes=NUM_CLASSES, top_k=TOP_K, image_size=IMAGE_SIZE)

    def ref(block):
        return score_pipeline_ref(*block, *params.values(), IMAGE_SIZE, NUM_CLASSES, TOP_K)

    for B in (1, 512):
        for K in (8, 24, 64):
            for ties in (None, 4):
                block = seeded_block(torch, rng, B, K, dev, empty_rows=B // 8, tie_levels=ties)
                hold("score_pipeline", f"B={B} K={K} ties={ties} empty_rows={B // 8}",
                     score_pipeline(block, params, **kw), ref(block), 2e-6)
    block = seeded_block(torch, rng, 16, 64, dev, empty_rows=16)
    hold("score_pipeline", "B=16 K=64 all rows masked", score_pipeline(block, params, **kw), ref(block), 2e-6)

    # times and bounds at the main-path shapes
    records = {}
    extra = {}  # a second main-path shape, timed but not in the kernels line
    f32 = 4

    def iou_cost(B, K, M):  # each box read once, each IoU written once; 14 ops a pair, 5 a box
        return dict(bytes=B * ((K + M) * 4 * f32 + K * M * f32), ops=B * (14 * K * M + 5 * (K + M)))

    a = torch.tensor(seeded_boxes(rng, (64,), IMAGE_SIZE), device=dev)
    records["iou_matrix"] = dict(  # a single frame's NMS: 64 grid slots against themselves
        shape="N=M=64 float32 (single-frame NMS)",
        ms=timer(lambda: iou_matrix(a, a)), plain_ms=timer(lambda: iou_matrix_ref(a, a)),
        **iou_cost(1, 64, 64),
    )
    a = torch.tensor(seeded_boxes(rng, (REQUEST, 64), IMAGE_SIZE), device=dev)
    records["iou_matrix_batch"] = dict(  # a request's NMS, the most launches on the serve path
        shape=f"B={REQUEST} K=M=64 float32 (NMS of a request)",
        ms=timer(lambda: iou_matrix_batch(a, a)), plain_ms=timer(lambda: iou_matrix_batch_ref(a, a)),
        **iou_cost(REQUEST, 64, 64),
    )
    B, K, M = 512, 64, 8  # matching the 512 served images against their ground truth
    a = torch.tensor(seeded_boxes(rng, (B, K)), device=dev)
    g = torch.tensor(seeded_boxes(rng, (B, M)), device=dev)
    extra["iou_matrix_batch (match)"] = dict(
        shape=f"B={B} K={K} M={M} float32 (match_batch)",
        ms=timer(lambda: iou_matrix_batch(a, g)), plain_ms=timer(lambda: iou_matrix_batch_ref(a, g)),
        **iou_cost(B, K, M),
    )
    B = N_CAL  # the calibration estimates
    x = torch.tensor(rng.normal(0, 1, (B, F)).astype(np.float32), device=dev)
    records["estimator_mlp"] = dict(
        shape=f"B={B} F={F} H={HIDDEN}",
        ms=timer(lambda: estimator_mlp(x, w1, b1, w2, b2)),
        plain_ms=timer(lambda: estimator_mlp_ref(x, w1, b1, w2, b2)),
        bytes=f32 * (B * F + F * HIDDEN + 2 * HIDDEN + 1 + B),
        ops=2 * B * F * HIDDEN + 12 * B * HIDDEN + 4 * B,
    )
    B, K = REQUEST, 64  # one served request
    block = seeded_block(torch, rng, B, K, dev, empty_rows=4)
    records["score_pipeline"] = dict(
        shape=f"B={B} K={K} top_k={TOP_K} F={F} H={HIDDEN}",
        ms=timer(lambda: score_pipeline(block, params, **kw)), plain_ms=timer(lambda: ref(block)),
        bytes=B * K * (16 + 4 + 4 + 1) + f32 * (F * HIDDEN + 2 * HIDDEN + 1 + 2 * F + B),
        # per image: a comparison sort's K log2 K for the stable top-k, the
        # feature row, the standardize step, the MLP, gelu and sigmoid
        ops=B * (K * int(np.ceil(np.log2(K))) + 30 * TOP_K + 3 * F + 2 * F * HIDDEN
                 + 12 * HIDDEN + 4),
    )
    for name, r in {**records, **extra}.items():
        r["bound_ms"], r["bound_by"] = bound(r.pop("bytes"), r.pop("ops"))
        r["max_abs_err"] = err[name.split()[0]]
    times = {k: {kk: r[kk] for kk in ("shape", "ms", "plain_ms", "bound_ms")}
             for k, r in {**records, **extra}.items()}
    emit("check", {"cases": len(cases), "max_abs_err": err, "times": times, "detail": cases})
    return records


def serve(torch, smi, dev):
    """The serve path, counted.  Returns the launch counts of the run."""
    from repro_torch.api import OffloadEngine
    from repro_torch.api.reward_model import MLPRewardModel
    from repro_torch.convert import detector_params_from_jax
    from repro_torch.core.estimator import EstimatorConfig
    from repro_torch.core.features import extract_features_batch
    from repro_torch.core.reward import cascade_map, match_pairs_batched
    from repro_torch.data.shapes import ShapesDataset
    from repro_torch.detection.batch import DetectionsBatch, GroundTruthBatch, match_batch
    from repro_torch.kernels.estimator_mlp import estimator_mlp
    from repro_torch.kernels.iou_matrix import iou_matrix, iou_matrix_batch
    from repro_torch.kernels.score_pipeline import score_pipeline
    from repro_torch.models.detector import (
        STRONG, WEAK, Detector, decode_batch, decode_detections, detector_apply,
    )
    from repro_torch.train.checkpoint import save_flat
    import dataclasses

    sync = _sync(torch, dev)
    stage = {}

    def timed(name, fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        stage[name] = stage.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
        return out

    ds = timed("data_ms", lambda: ShapesDataset.generate(N_IMAGES, seed=0))
    trees = {"weak": seeded_detector_params(WEAK, 1, class_scale=10.0),
             "strong": seeded_detector_params(STRONG, 2)}
    detectors = {}
    for name, cfg in (("weak", WEAK), ("strong", STRONG)):
        detectors[name] = Detector(cfg, device=dev)
        detectors[name].load_state_dict(detector_params_from_jax(trees[name]))
    weak, strong = detectors["weak"], detectors["strong"]
    cal_images, srv_images = ds.images[:N_CAL], ds.images[N_CAL:]
    srv_gts = ds.gts[N_CAL:]
    # warm cuDNN's algorithm choice outside the counted, timed run
    detector_apply(weak, cal_images[:REQUEST])
    detector_apply(strong, cal_images[:REQUEST])

    for wrapper in (iou_matrix, iou_matrix_batch, estimator_mlp, score_pipeline):
        wrapper.launches = 0

    # -- calibration: weak detector + batched NMS, features, estimates
    cal_dets = timed("cal_weak_detect_ms", lambda: decode_detections(weak, cal_images))
    x_cal = timed("cal_features_ms", lambda: extract_features_batch(
        cal_dets, NUM_CLASSES, TOP_K, IMAGE_SIZE, device=dev))
    mu = x_cal.mean(dim=0).cpu().numpy()
    sigma = (x_cal.std(dim=0, unbiased=False) + 1e-6).cpu().numpy()
    rng = np.random.default_rng(3)
    F = x_cal.shape[1]
    model_arrays = {
        "params": {
            "layer0": {"w": (rng.standard_normal((F, HIDDEN)) * np.sqrt(2.0 / F)).astype(np.float32),
                       "b": np.zeros(HIDDEN, np.float32)},
            "layer1": {"w": (rng.standard_normal((HIDDEN, 1)) * np.sqrt(2.0 / HIDDEN)).astype(np.float32),
                       "b": np.zeros(1, np.float32)},
        },
        "mu": mu.astype(np.float32),
        "sigma": sigma.astype(np.float32),
    }
    model_meta = {"kind": "mlp", "in_dim": F, "use_fused": True,
                  "config": dataclasses.asdict(EstimatorConfig(hidden=(HIDDEN,)))}
    model = MLPRewardModel.from_state(model_arrays, model_meta, device=dev)
    cal_scores = timed("cal_estimates_ms", lambda: model.predict(x_cal))

    # -- the engine artifact: save_flat -> OffloadEngine.load
    meta = {
        "kind": "offload_engine", "version": 1, "ratio": 0.2, "transform": "cdf",
        "policy": {"name": "threshold", "kwargs": {}},
        "feature_extractor": {"name": "detection_boxes", "spec": {
            "num_classes": NUM_CLASSES, "top_k": TOP_K, "image_size": IMAGE_SIZE}},
        "reward_model": model_meta, "extra": {},
    }
    arrays = {"model": model_arrays, "calibration": cal_scores.astype(np.float64),
              "transform_sorted": np.sort(rng.uniform(0, 1, N_CAL))}
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "engine.npz")
        save_flat(path, arrays, meta)
        engine = timed("engine_load_ms", lambda: OffloadEngine.load(path, device=dev))
        cpu_engine = OffloadEngine.load(path, device="cpu")

    # -- serve: 8 requests of 64
    weak_batches, offload, estimates, strong_rows, singles = [], [], [], {}, []
    first = None
    for r in range(0, len(srv_images), REQUEST):
        imgs = srv_images[r : r + REQUEST]
        wb = timed("serve_weak_detect_ms", lambda: decode_batch(weak, imgs))
        dec = timed("serve_decide_ms", lambda: engine.decide(wb))
        if r == 0:
            first = (wb, dec, timed("serve_decide_features_ms",
                                    lambda: engine.decide(features=engine.features(wb))))
        # the request's first frame, served alone
        wb1 = timed("serve_single_frame_ms", lambda: decode_batch(weak, imgs[:1]))
        singles.append((wb1, timed("serve_single_frame_ms", lambda: engine.decide(wb1)),
                        float(dec.estimates[0])))
        idx = np.flatnonzero(dec.offload)
        if idx.size:
            sb = timed("serve_strong_detect_ms", lambda: decode_batch(strong, imgs[idx]))
            for j, i in enumerate(idx):
                strong_rows[r + int(i)] = (sb, j)
        weak_batches.append(wb)
        offload.append(dec.offload)
        estimates.append(dec.estimates)
    offload = np.concatenate(offload)
    estimates = np.concatenate(estimates)

    # -- evaluation: batched matching (kernel) -> cascade mAP
    fields = ("boxes", "scores", "classes", "mask")
    weak_all = DetectionsBatch(**{f: torch.cat([getattr(b, f) for b in weak_batches]) for f in fields})
    # the strong result where a frame was offloaded, else the weak one (unused
    # by cascade_map for frames that were not offloaded)
    rows = [strong_rows.get(i, (weak_all, i)) for i in range(len(srv_images))]
    served_strong = DetectionsBatch(**{
        f: torch.cat([getattr(src, f)[j : j + 1] for src, j in rows]) for f in fields
    })
    gt = GroundTruthBatch.from_list(srv_gts, device=dev)
    matched = timed("eval_match_ms", lambda: match_pairs_batched(weak_all, served_strong, gt, (0.5,)))
    served_map = timed("eval_map_ms", lambda: cascade_map(matched, offload, (0.5,)))
    strong_all = timed("eval_strong_all_ms", lambda: decode_batch(strong, srv_images))
    matched_all = timed("eval_match_ms", lambda: match_pairs_batched(weak_all, strong_all, gt, (0.5,)))
    weak_map = cascade_map(matched_all, np.zeros_like(offload), (0.5,))
    strong_map = cascade_map(matched_all, np.ones_like(offload), (0.5,))
    sync()
    launches = {w.__name__: w.launches for w in (iou_matrix, iou_matrix_batch, estimator_mlp, score_pipeline)}

    # -- checks by the repo's own means
    if estimates.shape != (len(srv_images),) or not np.isfinite(estimates).all():
        fail("served estimates are not finite of shape (512,)")
    if not ((estimates >= 0) & (estimates <= 1)).all():
        fail("served estimates fall outside [0, 1]")
    for name, v in (("weak", weak_map), ("strong", strong_map), ("served", served_map)):
        if not (np.isfinite(v) and 0.0 <= v <= 1.0):
            fail(f"{name} mAP {v} is not in [0, 1]")
    wb, dec, dec_f = first
    if not np.array_equal(dec.offload, dec_f.offload):
        fail("decide(features=...) (estimator_mlp) disagrees with decide(batch) (score_pipeline)")
    route_err = float(np.abs(dec.estimates - dec_f.estimates).max())
    if route_err > 2e-6:
        fail(f"estimator_mlp route differs from score_pipeline route by {route_err} > 2e-6")
    cpu_err = 0.0
    for what, (b, d) in [("request 0", (wb, dec))] + [
        (f"single frame {i}", (b1, d1)) for i, (b1, d1, _) in enumerate(singles)
    ]:
        cpu_d = cpu_engine.decide(b.to("cpu"))
        e = float(np.abs(cpu_d.estimates - d.estimates).max())
        if not np.array_equal(cpu_d.offload, d.offload) or e > 2e-6:
            fail(f"{what} on the card vs on the CPU: masks equal "
                 f"{np.array_equal(cpu_d.offload, d.offload)}, estimates differ by {e}")
        cpu_err = max(cpu_err, e)
    # the same frame alone and in its request: detector float order may differ
    single_vs_request = max(abs(float(d1.estimates[0]) - e0) for _, d1, e0 in singles)
    gt0 = GroundTruthBatch.from_list(srv_gts[:REQUEST], device=dev)
    m_card, m_cpu = match_batch(wb, gt0, (0.5, 0.75)), match_batch(wb.to("cpu"), gt0.to("cpu"), (0.5, 0.75))
    if not (np.array_equal(m_card.tp, m_cpu.tp) and np.array_equal(m_card.match_gt, m_cpu.match_gt)):
        fail("match_batch on the card disagrees with the CPU on request 0")
    cpu_weak = Detector(WEAK, device="cpu")
    cpu_weak.load_state_dict(weak.state_dict())
    head_card = detector_apply(weak, srv_images[:16])[0].cpu()
    head_cpu = detector_apply(cpu_weak, srv_images[:16])[0]
    head_err = float((head_card - head_cpu).abs().max())
    if head_err > 1e-4:
        fail(f"WEAK head on the card vs the CPU differs by {head_err} > 1e-4")

    emit("serve", {
        "images": N_IMAGES, "calibration_images": N_CAL, "served_images": len(srv_images),
        "requests": len(srv_images) // REQUEST, "request_size": REQUEST,
        "weak_boxes_per_image": float(weak_all.counts.float().mean()),
        "realized_ratio": float(offload.mean()), "target_ratio": 0.2,
        "map50_weak_only": weak_map, "map50_strong_only": strong_map, "map50_served": served_map,
        "single_frames": len(singles),
        "checks": {"route_max_abs_err": route_err, "cpu_max_abs_err": cpu_err,
                   "weak_head_card_vs_cpu": head_err,
                   "single_vs_request_estimate_diff": single_vs_request},
        "stage_ms": stage, "launches": launches, "card": smi,
    })
    return launches


KERNELS = {
    "iou_matrix": ("src/repro_torch/kernels/csrc/iou_matrix.cu", "src/repro/kernels/iou_matrix/kernel.py:27"),
    "iou_matrix_batch": ("src/repro_torch/kernels/csrc/iou_matrix.cu", "src/repro/kernels/iou_matrix/kernel.py:46"),
    "estimator_mlp": ("src/repro_torch/kernels/csrc/estimator_mlp.cu", "src/repro/kernels/estimator_mlp/kernel.py:19"),
    "score_pipeline": ("src/repro_torch/kernels/csrc/score_pipeline.cu", "src/repro/kernels/score_pipeline/kernel.py:32"),
}


def main() -> None:
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run chip_smoke.py from a checkout of the repo")
    sys.path.insert(0, str(SRC))
    import torch

    smi = probe(torch)
    build()
    dev = torch.device("cuda")
    records = check_kernels(torch, Timer(torch), dev)
    launches = serve(torch, smi, dev)
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        r = records[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    missing = [k["name"] for k in kernels if k["launches"] == 0]
    if missing:
        fail(f"kernels never launched on the serve path: {missing}")
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
