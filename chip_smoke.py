#!/usr/bin/env python3
"""Drive the PyTorch port's paths once on one NVIDIA H100: the detection
serve path, the training slice (both detectors trained, the engine fitted),
the streaming runtime over the trained engine (also behind netsim uplinks),
the paper's experiments (``run_all``), the temporal layer (video streams
through the tracker, closed-loop adaptation), the city-scale fleet (the
sharded plane, 1024 streams in four districts) and client mobility (moving
clients, handover), the LM early-exit cascade (qwen2-7b, rwkv6-1.6b,
deepseek-moe-16b, deepseek-v2-lite-16b and qwen2-vl-2b at full width, in
batches and as streams, with the ring and int8 decode caches), the hybrid
zamba2-2.7b and the encoder-decoder whisper-base through ``generate`` at
full width, LM training (six families at full width), the single-card
dry run of every architecture x assigned shape, the multi-device half:
qwen2-7b's prefill, decode and train steps sharded over the visible cards
(``DTensor`` placements by the sharding rules) and the dry run on the
production mesh of a fake process group, and the user surface: the eleven
``repro_torch.examples`` scripts through their ``main``.

    python3 chip_smoke.py

Run from the root of a checkout; it builds the port's CUDA kernels from
``src/repro_torch/kernels/csrc`` (into the directory ``.gitignore`` lists) on
first use.  Phases, each printing one line of its own:

1. ``probe``   versions, the device (capability must be 9.0), nvidia-smi's
               name and power limit, the TF32 flags (both set False).
2. ``build``   nvcc for every kernel source, all at once, and its seconds;
               ptxas's registers and spills of every kernel; the reward
               head's SASS opcodes (bulk copies, mbarriers, cluster
               barriers, distributed shared memory).
3. ``check``, ``check_iou``, ``check_lm``   every kernel against its plain PyTorch
               version on the card at main-path and edge shapes, with the
               tolerance stated (the IoU family's ``nms`` and ``match``
               routes exactly, its ``matrix`` route at 1e-6 / 2e-2 in
               float32 / bf16, boxes with a NaN coordinate exactly on every
               route and as NaN estimates in score_pipeline; each route timed at the path's shapes, also
               right after an op that writes its input, with the host's
               microseconds a call; nms_batch and match_batch must dispatch
               no sort, gather or scatter; flash_sdpa's tensor-core route, which
               rounds P to bf16, at 2^-8 max |v| + 2^-7 of each output); the kernel's,
               the plain version's and (for flash_sdpa)
               ``scaled_dot_product_attention``'s time at the main-path
               prefill and decode shapes, and the bound; ``estimator_mlp``
               and ``score_pipeline`` at each shape the main
               paths launch them (``time_head``), back to back and right
               after the PyTorch op that precedes them on the path, with
               the host's microseconds a call and the launch plan (cluster
               size, tile, grid, shared memory); ``FleetPlane``'s shard
               launches (``plan=``, the whole batch's plan) at the fleet's
               shapes, against the plain version and bit for bit the whole
               batch's launch.  ``check_lm`` also holds flash_sdpa's and
               wkv6's autograd Functions (the kernel forward, the plain
               version's backward) against plain autograd on the card
               (flash_sdpa on the ``wgmma`` route, bf16 D 128 GQA 7, and the
               ``simt`` route, float32 D 32, causal, with and without a
               window; wkv6 in float32 and bf16, gradients of out and sT) at
               1e-6 of the largest |g|, times their forward and backward at
               the training shapes (B 2 x S 512), and checks that
               estimator_mlp, score_pipeline and iou_matrix(_batch) raise on
               a CUDA input that requires grad.  Fails if
               flash_sdpa's qwen2-7b (G = 7), deepseek-moe-16b (G = 1),
               qwen2-vl-2b (G = 6) or zamba2-2.7b (D = 80) prefill / decode
               shapes miss the ``wgmma`` / ``decode`` routes, or D = 80 in
               float32 the ``simt`` route, or whisper-base's encoder (S = T
               = 1500), cross prefill (512 x 1500) and decoder prefill
               (causal 512) the ``wgmma`` route and its cross decode step
               (1 x 1500) the ``decode`` route, non-causal where there is no
               mask; each of those shapes is held and timed too, beside its
               bound and scaled_dot_product_attention (``is_causal=False``
               where the call is non-causal).  The Functions' check also
               holds one non-causal wgmma case (512 x 1500).
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
               held against the same detections decided on the CPU.  Fails
               unless every NMS (calibration chunk, request, frame, strong
               batch) was one launch of the IoU family's ``nms`` route and
               every ``match_batch`` one of its ``match`` route.
5. ``train``   the training slice with every launch count set to 0 first:
               ``build_pipeline`` at its defaults (3000 / 2000 / 1200
               images, WEAK 500 and STRONG 900 AdamW steps of 64 at full
               width, NMS over val and pool, matching), ``build_engine``
               (ORIC rewards, the estimator fitted on the card), the val
               split served as requests of 64 through the trained cascade
               and matched for its mAP.  Fails unless each loss falls
               (last 50 steps' mean below the first 50's) and every NMS and
               match was one launch of its route.  Then: 5 STRONG steps on
               the card against 5 on the CPU from one start; the calibration
               estimates against ``mlp_apply`` (1e-5); the engine artifact's
               decisions after ``OffloadEngine.load``; a 5-epoch fit on the
               card against the CPU (estimates within ``SHORT_FIT_TOL``,
               decisions equal away from the threshold); ``build_engine``'s
               40-epoch fit repeated bit for bit on the card, and its gaps
               to the CPU's fit within ``FIT_SPREAD_MULTIPLE`` times those
               a one-ulp move of the features makes on one device; 20 steps of each
               detector under ``torch.profiler`` for a step's device time.
               Prints steps/s, losses, stage seconds and the weak-only,
               strong-only and served cascade mAPs.
6. ``stream``  the streaming runtime over the train phase's engine, every
               launch count set to 0 first: the val split's 2000 frames
               through WEAK + NMS a request of 64 at a time, each request
               through ``OffloadSession.submit_batch`` (the fast path, one
               ``score_pipeline`` launch), the frames' features through
               ``simulate`` (``OffloadRuntime`` over
               ``default_edge_fleet(3, seed=0)``, ``least_loaded``,
               ``degrade``, micro-batches of 8, re-budgeted 0.2 -> 0.1 at
               frame 1000, one frame a time unit, under ``Obs``; the
               buffered path, ``estimator_mlp`` a drain), then 64 frames
               one at a time through WEAK + NMS and
               ``OffloadSession.submit``, then the same features through
               ``simulate`` on ``default_linked_fleet(3, seed=0)`` (netsim
               uplinks) once with ``queue_aware`` and once with
               ``value_iteration``.  Fails unless the fast path equals
               the train phase's ``engine.decide`` bit for bit, the buffered
               path and the single frames hold within 1e-5 with decisions
               equal away from the threshold (flips near it counted), a
               second ``simulate`` on the card repeats the trace record for
               record, the same ``simulate`` on the CPU (the engine artifact
               loaded there) repeats it up to the first decision that
               flipped near the threshold, the realized ratio is within 0.02
               of 0.2 before and of 0.1 after the re-budget, and ``Obs``
               counts 2000 frames, a ``session.flush`` span a drain and the
               wrappers' launches; each linked run on the CPU (the artifact)
               holds its estimates within 1e-5 and its records equal up to
               the first decision that flipped, and the card's
               value-iteration tables are within 1e-4 of
               ``value_iteration_ref``.  Prints frames/s through
               ``simulate``, the host ms a drain (``session.score`` /
               ``session.decide``), the dispatcher's outcomes, the linked
               runs' realized ratios and latency decomposition, and the
               host ms of one value-iteration solve on the card and on the
               CPU.
7. ``repro``   the paper's experiments, every launch count set to 0 first:
               ``run_all(quick=True, force=True)`` into a temporary cache
               dir (1200 / 400 / 500 images, WEAK 250 and STRONG 400 steps
               at full width, context 400: Figs. 5, 6, 8, Table II, the
               estimators, Figs. 9/10 with the baselines, the streaming
               study), then on its state ``figure7_input_study``,
               ``train_estimators`` again and ``token_bucket_study``, and
               64 val frames one at a time through ``Cascade.from_engine``
               (WEAK + NMS, one ``score_pipeline`` launch a frame, STRONG
               when offloaded).  Fails unless the matching on the card
               equals the CPU's exactly, the Adaptive Feeding SVM and a
               2-epoch ``train_estimators`` agree with the CPU within 1e-4
               (its two unbounded heads also within 128 float32 ulps of
               the size of their last layer's summands), the repeated estimators give run_all's curves, every curve
               at ratio 1.0 is the strong detector's mAP, ``oracle_ORIC``
               is at least ``random`` below it, and the cascade decides as
               ``engine.decide`` (estimates within 1e-5).  Prints the
               curves, the figures and each stage's seconds.
8. ``video``   the temporal layer, every launch count set to 0 first:
               ``default_video_scenario(8, 96)`` (calibration 4 x 48, the
               estimator fitted on the card), ``temporal_hysteresis`` at
               0.3 through ``VideoRuntime.serve_clip`` under ``Obs`` and
               again through ``run_video_scenario``, ``keyframe``,
               ``threshold`` at the five target ratios of ``repro``'s
               headline, then ``default_shift_scenario()`` (4 x 160, shift
               at 64) and its frozen and adaptive arms.  Fails unless the
               tracker launched the IoU family's ``matrix`` route, the
               tracker on the card equals the CPU's and ``track_clip_ref``
               (the association fields exactly, boxes / vel / conf within
               1e-6), the two card runs of ``temporal_hysteresis`` are bit
               identical, a CPU serve of the card-fitted engine (its
               artifact) gives equal records up to the first flipped
               decision with estimates within 1e-5, the serve semantics of
               ``tests/test_video.py`` hold (staleness exactly on the frames
               served from an edge, over a fifth of the frames covered), and
               the adaptive arm made incremental updates and refits and its
               checkpoint, loaded on the card, replays 30 more observation
               blocks bit for bit.  Prints each policy's realized ratio,
               mean effective accuracy and covered fraction, each arm's
               pre- and post-shift accuracy (reported, not asserted: the
               card fits its own engines), ``serve_clip`` seconds and
               frames/s, the host ms of one tracker step, the ``video.*``
               and ``session.*`` profiler spans and the launches by route
               and shape.
9. ``fleet``   the city-scale fleet, every launch count set to 0 first:
               ``FleetPlane`` over four logical shards of the card
               (``[cuda:0] * 4``) with a fused engine at F 387, H 128 fitted
               on the card on seeded features: ``score`` at B 7, 64, 250 and
               2000 (one ``estimator_mlp`` launch a shard, on the global
               batch's plan), ``score_detections`` at B 13 and 250 (one
               ``score_pipeline`` launch a shard), ``match`` at (0.5, 0.75)
               and B 13, 150 and 2000 (one ``match`` launch a shard) and
               ``extract_features``; then ``default_city_scenario()`` at its
               defaults (1024 streams, 48 ticks, 4096 calibration frames, 40
               epochs, fitted on the card), ``run_city_scenario`` coordinated
               and static on the default plane (one card: one shard), the
               coordinated arm over the four-shard plane and once more under
               ``Obs``.  Fails unless every plane result is bit for bit its
               single-device call (and ``score``, ``score_detections`` and
               ``match`` within 1e-5, 2e-6 and exactly of the plain
               versions), the four-shard and the repeated
               coordinated traces equal the first record for record, and a
               CPU run of the card-fitted engine's artifact gives equal
               records up to the first tick whose decisions flip, estimates
               within 1e-5.  With several cards, the plane runs over every
               card too (outside the count).  Prints the arms' summaries,
               ``tests/test_fleet.py``'s headline asserts (reported: the card
               fits its own engine), ticks/s, the host ms a tick by profiler
               phase and the plane's site calls.
10. ``mobility`` client mobility, every launch count set to 0 first: both
               motion models rolled out on the card (64 clients, 160
               steps), ``default_mobile_scenario()`` at its defaults (4
               clients, 160 steps, 3 stations, fitted on the card),
               ``run_mobile_scenario`` under ``Obs`` in handover and static
               mode, and handover mode with the ``die`` and ``stale``
               in-flight semantics.  Fails unless the waypoint rollout equals
               ``rollout_ref`` exactly and the random walk within 1e-3, both
               repeat bit for bit, a second handover serve repeats bit for
               bit, and a CPU serve of the card-fitted artifact on the card's
               positions gives equal records up to the first flipped
               decision, estimates within 1e-5.  Prints the runs' summaries,
               the handovers, ``tests/test_mobility.py``'s headline asserts
               (reported), frames/s and the host ms a frame.
11. ``lm``      the LM early-exit cascade, once per family at full width
               (qwen2-7b: dense, flash_sdpa; rwkv6-1.6b: RWKV6, wkv6;
               deepseek-moe-16b: MoE, flash_sdpa at G = 1;
               deepseek-v2-lite-16b: MoE under MLA, no LM kernel;
               qwen2-vl-2b: VLM, flash_sdpa at G = 6, a 256-token vision
               prefix and M-RoPE ids with a 16 x 16 grid on it), every
               launch count set to 0 first and read right after: seeded
               weights on the card; the exit layer at num_layers // 2; one
               8 x 512 calibration batch through the weak stack, the
               ``lm_logits`` features and a seeded MLP head; an engine
               artifact -> ``LMCascade.load``; 4 served batches of 8 x 512
               through ``serve_batch``; 16 greedy tokens a row through the
               stack its decision chose; ``LMCascade.fit`` on two more
               8 x 512 batches and one ``serve_batch`` through the fitted
               cascade.  Then, counted as the stream path: the 4 batches
               through ``serve_stream`` (masks and estimates must equal
               ``serve_batch``'s bit for bit), again with a re-budget to 0.5
               at request 16 (masks may change from there on only, to the
               new threshold's), and ``cascade_generate`` on the first
               batch (tokens must equal the ones ``generate`` gave each
               row's stack).  Then, outside the count: the fit's calibration
               estimates against ``mlp_apply`` (1e-5), decode
               against the forward, the weak logits against the plain
               versions (bf16 as served, and float32), and the decisions
               against the CPU engine on the same features.  For the MoE
               families first an ``lm_routing`` line: each MoE layer's
               dropped share at capacity_factor 1.25 in a full-depth
               prefill (the grouped path) and a decode step (B 8, the flat
               path, capacity 1), and MLA's latent cache bytes against the
               expanded K / V's; decode / prefill against the forward run
               on a drop-free copy (capacity_factor E / K), the float32
               kernels-vs-plain check on the weak stack's first two layers,
               and each held run replays the routing of the run it is held
               against (``RoutingLog``: a bf16 rounding can flip a token's
               expert set, after which the two runs compute different
               functions by the reference's own rule; the flips of free
               runs are counted and printed).  For
               qwen2-7b and deepseek-moe-16b
               the two caches at full width and depth: the 8 x 512 batch
               prefilled into the 256-slot ring of
               ``long_context_variant(cfg, 256)`` (last logits against
               ``forward`` under the window) and 16 decode steps on the
               ``decode`` route (the first, past the boundary, against
               ``forward`` over the extended tokens), then the int8 cache
               (prefill logits bit-equal to the bf16 cache's, the first
               decode step within 5% of the largest logit of the bf16
               cache's, fewer bytes) and the bf16 cache, 16 steps each;
               ms a decode step of each.  Launches are
               also split by route and shape; the run fails if qwen2-7b's
               prefill missed flash_sdpa's ``wgmma`` route or its decode
               steps the ``decode`` route, or RWKV's prefill or decode
               missed ``wkv6``.  qwen2-vl-2b's stream path generates
               through each stack (``cascade_generate`` refuses M-RoPE ids:
               repro's call cuts them on the wrong axis) and it skips the
               cache checks.  zamba2-2.7b and whisper-base
               (``lm_generate_family``: no cascade, as in repro) decode 2
               batches of 8 x 512 (whisper-base's with 1500 seeded audio
               frames each), 16 greedy tokens a row, through ``generate``
               (flash_sdpa's launches must be 9 ``wgmma`` a prefill and 9
               ``decode`` a step for zamba2-2.7b; 18 ``wgmma`` a prefill, 6
               encoder + 6 decoder self + 6 cross, and 12 ``decode`` a step
               for whisper-base); then decode and prefill against the
               forward and kernels against plain, held on the first 2
               groups (zamba2-2.7b) or the first 2 encoder and decoder
               layers (whisper-base) in bf16 and float32, measured at full
               depth.
12. ``lm_train`` LM training, once per family at full width (rwkv6-1.6b
               whole; qwen2-7b with 2 of its 28 layers; deepseek-v2-lite-16b
               with 2 of its 27, one dense and one MoE; qwen2-vl-2b with 2
               of its 28; zamba2-2.7b with one group of its 9: 5 Mamba2
               layers and the shared block; whisper-base whole, 6 + 6
               layers over 1500 frames), bf16 compute over
               float32 parameters, remat on: every launch count set to 0
               first, 3 ``make_train_step`` steps at B 2 x S 512 on one
               ``synth_lm_batch`` batch at lr 0.01 / the largest fan-in
               (each loss finite and below the one before; launches must
               equal attention calls or RWKV layers x (forward +
               recompute) x steps), the last under
               ``torch.profiler`` for the card's busy share.  Then, outside
               the count: one step taken apart (forward, backward, update;
               CUDA events); the gradients through the kernels against
               ``plain=True`` leaf by leaf on the first 128 tokens (relative
               L2; the kernels no farther than twice the plain bf16
               gradient from the float32 plain gradient, + 1e-3); 3 steps on
               the seven reduced float32 configs (lr 3e-4) on the card against the
               CPU (within 2 lr_sum, at most 1% of elements beyond 1e-5);
               ``python -m repro_torch.launch.train`` for 2 steps on the
               card.  Prints step ms, tokens/s, peak memory, the busy and
               backward shares.
13. ``dryrun`` the single-card dry run (``launch.dryrun``) of the 10
               architectures x 4 assigned shapes against this card's memory
               (``torch.cuda.get_device_properties``) and the data sheet's
               rates: argument bytes (parameters, AdamW state, batch or
               cache) from meta tensors, whether they fit, model FLOPs and
               the roofline's dominant term.
14. ``mesh``  the multi-device half.  In parallel subprocesses, the dry
               run on the 32 x 8 production mesh (``python -m
               repro_torch.launch.dryrun --mesh single_pod``, a fake
               process group of 256 ranks, meta tensors) of one cell per
               family (``MESH_DRYRUN_CELLS``): per-device FLOPs, bytes and
               collective bytes by kind and axis, rank 0's argument bytes,
               the roofline, ``model_flops_ratio`` (must be in (0, 1.5]).
               Meanwhile one NCCL rank per visible card (one card: world 1,
               said so; NCCL takes one rank a device) on the mesh (1, world)
               of ("data", "model"): qwen2-7b at full width (bf16, seeded,
               ``attn_seq_shard``) under ``bind_mesh``, parameters placed by
               ``param_shardings`` (``tp``): the prefill of 8 x 512 and 16
               greedy decode steps on the ``"seq"`` cache, then one train
               step at 2 layers, B 2 x S 512 in ``tp`` and in ``fsdp``.  Each
               is held against the unbound path on the same card (each
               timed after a short warm-up of its own, outside the count):
               bit-equal at world 1; at world > 1 the prefill's and every
               decode step's logits and the loss within ``LM_BF16_REL_TOL``,
               the steps teacher-forced with the unbound path's tokens (a
               free run's first flipped token is printed).  The launch
               counts are set to 0 just before the sharded runs and read
               just after; flash_sdpa must launch.  Times (sharded and
               unbound) are printed beside the card's line.
15. ``examples`` every module of ``repro_torch.examples`` through its
               ``main`` on the card, in process, with ``EXAMPLES_RUNS``'
               arguments: quickstart; offload_detection ``--quick``;
               stream_offload; train_lm ``--steps 20`` (yi-6b scaled to
               ~100M, float32: flash_sdpa's ``simt`` route); serve_cascade
               (serving that checkpoint); train_lm ``--arch rwkv6_1b6
               --steps 3``; observability; netsim_congestion; video_offload;
               online_adaptation; fleet_scale (the plane over four shards of
               the card); mobility_handover.  Artifacts and output files go
               to a temporary directory, the scripts' printing to stderr;
               every launch count set to 0 first, each script's launches a
               ``kernel_stats`` delta.  Fails unless every script returns,
               the engine's save / load round trip is exact, the stream's
               seeded rerun is equal record for record, the LM loss falls
               over 20 steps, serve_cascade served the checkpoint and
               decided identically after save / load, observability
               processed its 512 frames, the four-shard plane is bit-identical
               to the engine, the waypoint rollout equals ``rollout_ref``
               exactly and the random walk within 1e-3 (both repeat bit for
               bit), every reported number is finite, and iou_matrix_batch,
               estimator_mlp, score_pipeline, flash_sdpa and wkv6 each
               launched (no script matches or suppresses a single image, so
               iou_matrix's one-image counter stays 0 here).  Prints one
               ``{"examples": ...}`` line: each script's arguments, seconds,
               launches and the numbers its ``run`` returned, the card's
               line.  The reward-head shapes the scripts launched are then
               timed as ``time_head`` rows (outside the count).
16. ``{"kernels": [...]}`` each kernel's launches on its paths (and, for
               flash_sdpa and wkv6, by route and shape and by LM family), its error against
               the plain version, its times and its bound (and the same at
               the decode step; for the reward head's two kernels, at each
               timed shape with its launches, which must account for every
               launch of the main paths; for the IoU kernels, each route's
               source, launches and timed shapes, and the video and fleet
               paths' launches by shape).  The paths: detection, train, stream
               (the detection stream and both LM streams), repro, video,
               fleet, mobility, lm, lm_train, mesh and examples; the run fails if score_pipeline,
               estimator_mlp or iou_matrix_batch never launched on the train,
               stream, repro or fleet path, estimator_mlp or iou_matrix_batch
               on the video path, estimator_mlp on the mobility path, or
               flash_sdpa or wkv6 on the lm_train path, or flash_sdpa on
               the mesh path.

The run's seconds are printed on the line before the card's line, and the
last line is ``{"ok": true, "device": {...}}``.  ``python3 chip_smoke.py
--head-times [--src DIR]`` runs only ``time_head``, and ``--iou-times [--src
DIR]`` only ``time_iou``, for the port in ``DIR`` (an A/B of two versions:
once with each, in turns, in one call).  Without a
GPU, or outside a checkout, it exits non-zero and prints no result.  The
serve and lm phases run seeded weights, so their mAPs and NLLs check the
plumbing; the train phase's mAPs are those of detectors trained on the card.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM data-sheet peaks (dense): HBM bytes/s, float32 CUDA-core FLOP/s,
# bf16 tensor-core FLOP/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
PEAK_BF16_OPS_PER_S = 989e12

NUM_CLASSES, TOP_K, IMAGE_SIZE, HIDDEN = 8, 25, 64.0, 128
N_IMAGES, N_CAL, REQUEST = 1024, 512, 64
CAL_CHUNK = 256  # images a calibration NMS launch takes (decode_detections' batch_size)
# the train phase: build_pipeline's and build_engine's own defaults
N_TRAIN, N_VAL, N_POOL, STEPS_WEAK, STEPS_STRONG = 3000, 2000, 1200, 500, 900
TRAIN_BATCH, PARITY_STEPS = 64, 5  # train_detector's batch; card-vs-CPU steps
PROFILED_STEPS = 20  # training steps timed, and traced for their device time
LM_FIT_BATCHES = 2  # LMCascade.fit's calibration batches of 8 x 512 a family


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
    window (four times the host's time for it), so the events see
    back-to-back device work and not the host's launch gaps (where the host
    is slower than that, they see both).
    ``host_us`` is the host's time a call in the last timing (``reps`` calls
    queued back to back, no sync): the wrapper's own cost a call."""

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
        self.host_us = host_ms * 1e3 / reps
        torch.cuda.synchronize()
        sleep = int(min(4.0 * host_ms + 0.1, 200.0) * self.cycles_per_ms)
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


def bound(bytes_moved: float, ops: float, peak_ops: float = PEAK_F32_OPS_PER_S):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    operations over ``peak_ops`` (float32 CUDA cores unless given)."""
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops * 1e3
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


def seeded_head_params(torch, rng, dev):
    """The reward head as ``score_pipeline`` takes it (F 387, H 128): the
    MLP's seeded weights, then the standardizer's mu and sigma."""
    F = TOP_K * (7 + NUM_CLASSES) + 4 + NUM_CLASSES
    w1, b1, w2, b2 = seeded_mlp(torch, rng, F, HIDDEN, dev)
    return dict(w1=w1, b1=b1, w2=w2, b2=b2,
                mu=torch.tensor(rng.normal(0, 0.1, F).astype(np.float32), device=dev),
                sigma=torch.tensor(rng.uniform(0.5, 2.0, F).astype(np.float32), device=dev))


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


# SASS opcodes that show how the reward head's kernels work: bulk async copies
# (UBLKCP), mbarrier operations (SYNCS), cluster barriers (UCGABAR), cp.async
# (LDGSTS), and generic loads (LD.E), as which the reads of another CTA's
# shared memory compile (cluster.map_shared_rank gives a generic address)
HEAD_OPCODES = ("UBLKCP", "SYNCS", "UCGABAR", "LDGSTS", "LD.E")


def sass_opcodes(library: Path):
    """How often each of HEAD_OPCODES appears in ``library``'s SASS (from
    cuobjdump beside nvcc), or None where cuobjdump is missing."""
    from repro_torch.kernels import _build

    exe = Path(_build.nvcc()).parent / "cuobjdump"
    if not exe.is_file():
        return None
    sass = subprocess.run([str(exe), "-sass", str(library)], capture_output=True, text=True,
                          timeout=120).stdout
    # "/*0a10*/  @!P0 SYNCS.ARRIVE.TRANS64 ... ;": the opcode after the address and any predicate
    ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)", sass)
    return {code: sum(op.startswith(code) for op in ops) for code in HEAD_OPCODES}


def build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    logs = _build.build_all()
    seconds = time.perf_counter() - t0
    ptxas = {  # registers, barriers, stack and spills of every kernel
        name: [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        for name, log in logs.items()
    }
    sass = {name: sass_opcodes(_build.library_path(name)) for name in HEAD_KERNELS}
    emit("build", {"seconds": round(seconds, 3), "built": sorted(logs), "ptxas": ptxas,
                   "head_sass_opcodes": sass})


def after(timer, op, kernel):
    """Device ms of ``kernel(op())`` less ``op`` alone: the kernel as the path
    launches it, right after the op that writes its input."""
    return timer(lambda: kernel(op())) - timer(op)


def held_err(what, got, want, tol):
    """The max abs error of ``got`` against ``want``; fails above ``tol``."""
    e = float((got.float() - want.float()).abs().max()) if got.numel() else 0.0
    if got.shape != want.shape or not np.isfinite(e) or e > tol:
        fail(f"{what}: max abs error {e} against tolerance {tol}")
    return e


def shards_on_plan(torch, what, call, plan, padded, rows, per):
    """A batch of ``rows`` launched as FleetPlane launches it: ``padded``
    (its tensors padded to whole shards) cut into shards of ``per`` rows,
    each launched as ``call(tensors, plan)`` on the whole batch's ``plan``.
    Fails unless the shards give one launch of the whole batch (``call``
    with no plan) bit for bit."""
    got = torch.cat([call([t[lo:lo + per] for t in padded], plan)
                     for lo in range(0, padded[0].shape[0], per)])[:rows]
    if not torch.equal(got, call([t[:rows] for t in padded], None)):
        fail(f"{what}: the shards on the whole batch's plan differ from its one launch")
    return got


def head_row(torch, timer, dev, rng, B, f, h, where, whole=None):
    """``time_head``'s row of ``estimator_mlp`` at (B, F ``f``, H ``h``) on
    seeded inputs, held against the plain version (1e-5, as in
    ``check_kernels``).  A shard row (B rows of a batch of ``whole``):
    the whole batch is launched in shards of B on its plan, held against
    the plain version and against its one launch, and the first shard is
    timed on that plan."""
    from repro_torch.kernels.estimator_mlp import estimator_mlp, estimator_mlp_ref
    from repro_torch.kernels.estimator_mlp.ops import head_plan

    f32 = 4
    rows = whole or B
    key = f"B={B} F={f} H={h}" + (f" of={whole}" if whole else "")
    x = torch.tensor(rng.normal(0, 1, (rows, f)).astype(np.float32), device=dev)
    mu = torch.tensor(rng.normal(0, 0.1, f).astype(np.float32), device=dev)
    sigma = torch.tensor(rng.uniform(0.5, 2.0, f).astype(np.float32), device=dev)
    w = seeded_mlp(torch, rng, f, h, dev)
    plan = head_plan(whole, f, h, dev) if whole else None
    if whole:
        n = -(-whole // B)
        got = shards_on_plan(torch, f"estimator_mlp {key}",
                             lambda t, p: estimator_mlp(t[0], *w, plan=p), plan,
                             [torch.cat([x, x.new_zeros((n * B - whole, f))])], whole, B)
        x0 = x[:B].contiguous()
    else:
        got, x0 = estimator_mlp(x, *w), x
    err = held_err(f"estimator_mlp {key}", got, estimator_mlp_ref(x, *w), 1e-5)
    path_ms = after(timer, lambda: (x0 - mu) / sigma, lambda x: estimator_mlp(x, *w, plan=plan))
    ms = timer(lambda: estimator_mlp(x0, *w, plan=plan))
    return dict(
        key=key, where=where, B=B, of=whole, F=f, H=h, max_abs_err=err, tol=1e-5, ms=ms,
        path_ms=path_ms, host_us=timer.host_us, plain_ms=timer(lambda: estimator_mlp_ref(x0, *w)),
        bytes=f32 * (B * f + f * h + 2 * h + 1 + B), ops=2 * B * f * h + 12 * B * h + 4 * B,
    )


def pipeline_row(torch, timer, dev, rng, params, B, K, where, whole=None):
    """``time_head``'s row of ``score_pipeline`` at a seeded (B, K) block
    with the reward head ``params`` (F 387, H 128), held against the plain
    version (2e-6, as in ``check_kernels``); a shard row as ``head_row``'s."""
    from repro_torch.detection.batch import DetectionsBatch
    from repro_torch.kernels.score_pipeline import score_pipeline, score_pipeline_ref
    from repro_torch.kernels.score_pipeline.ops import pipeline_plan

    f32 = 4
    F = TOP_K * (7 + NUM_CLASSES) + 4 + NUM_CLASSES
    kw = dict(num_classes=NUM_CLASSES, top_k=TOP_K, image_size=IMAGE_SIZE)
    rows = whole or B
    key = f"B={B} K={K}" + (f" of={whole}" if whole else "")
    block = seeded_block(torch, rng, rows, K, dev, empty_rows=rows // 16)
    plan = pipeline_plan(whole, K, TOP_K, F, HIDDEN, dev) if whole else None
    want = score_pipeline_ref(*block, *params.values(), IMAGE_SIZE, NUM_CLASSES, TOP_K)
    if whole:
        n = -(-whole // B)
        db = DetectionsBatch(**dict(zip(("boxes", "scores", "classes", "mask"), block)))
        padded = [getattr(db.pad_images(n * B), a) for a in ("boxes", "scores", "classes", "mask")]
        got = shards_on_plan(torch, f"score_pipeline {key}",
                             lambda t, p: score_pipeline(tuple(t), params, **kw, plan=p), plan,
                             padded, whole, B)
        block = tuple(t[:B].clone() for t in padded)
    else:
        got = score_pipeline(block, params, **kw)
    err = held_err(f"score_pipeline {key}", got, want, 2e-6)
    scores0 = block[1].clone()
    path_ms = after(timer, lambda: torch.mul(scores0, 1.0, out=block[1]),
                    lambda _: score_pipeline(block, params, **kw, plan=plan))
    ms = timer(lambda: score_pipeline(block, params, **kw, plan=plan))
    return dict(
        key=key, where=where, B=B, of=whole, K=K, max_abs_err=err, tol=2e-6, ms=ms,
        path_ms=path_ms, host_us=timer.host_us,
        plain_ms=timer(lambda: score_pipeline_ref(*block, *params.values(), IMAGE_SIZE,
                                                  NUM_CLASSES, TOP_K)),
        bytes=B * K * (16 + 4 + 4 + 1) + f32 * (F * HIDDEN + 2 * HIDDEN + 1 + 2 * F + B),
        # per image: a comparison sort's K log2 K for the stable top-k, the
        # feature row, the standardize step, the MLP, gelu and sigmoid
        ops=B * (K * int(np.ceil(np.log2(K))) + 30 * TOP_K + 3 * F + 2 * F * HIDDEN
                 + 12 * HIDDEN + 4),
    )


def time_head(torch, timer, dev):
    """``estimator_mlp`` and ``score_pipeline`` at each shape the main paths
    launch them.  ``ms``: device ms a call, calls back to back; ``path_ms``:
    as the path launches them, right after a PyTorch op that writes their
    input (``(x - mu) / sigma`` before ``estimator_mlp``, as
    ``predict_device`` does; an elementwise op on the scores before
    ``score_pipeline``), timed as (op, kernel) pairs less the op alone;
    ``host_us``: the wrapper's host time a call; ``plain_ms``: the plain
    version back to back.  Returns {kernel: [row, ...]}, each row with the
    bytes and operations of its bound."""
    rng = np.random.default_rng(7)
    F = TOP_K * (7 + NUM_CLASSES) + 4 + NUM_CLASSES
    shapes = {"estimator_mlp": [], "score_pipeline": []}
    # a row that ends in a batch size is a shard of that batch, launched (and
    # timed) on the batch's plan, as FleetPlane launches it, and keyed
    # "... of=<that batch size>" as the wrappers count such a launch
    for B, f, h, where, *whole in ((N_CAL, F, HIDDEN, "calibration estimates"),
                           (REQUEST, F, HIDDEN, "decide(features=...)"),
                           (LM_BATCH, 12, LM_HIDDEN, "LM cascade decide"),
                           (N_VAL, F, HIDDEN, "OffloadEngine.fit's calibration estimates (train)"),
                           (LM_FIT_BATCHES * LM_BATCH, 12, LM_HIDDEN,
                            "LMCascade.fit's calibration estimates"),
                           (STREAM_MICRO_BATCH, F, HIDDEN, "a stream's micro-batch drain"),
                           (REPRO_N_VAL, F, HIDDEN,
                            "the quick pipeline's build_engine calibration estimates (repro)"),
                           (REPRO_MICRO_BATCH, F, HIDDEN,
                            "streaming_multi_edge_study's micro-batch drain (repro)"),
                           (1, VIDEO_F, VIDEO_HIDDEN,
                            "a video / shift stream's submit, micro_batch 1 (video)"),
                           (VIDEO_CAL_ROWS, VIDEO_F, VIDEO_HIDDEN,
                            "the video / shift scenario's engine.fit calibration estimates "
                            "(video)"),
                           (7, F, HIDDEN, "engine.score at B 7 (fleet)"),
                           (2, F, HIDDEN, "FleetPlane.score's shard of B 7 (fleet)", 7),
                           (16, F, HIDDEN, "FleetPlane.score's shard of B 64 (fleet)", 64),
                           (250, F, HIDDEN, "engine.score at B 250 (fleet)"),
                           (63, F, HIDDEN, "FleetPlane.score's shard of B 250 (fleet)", 250),
                           (500, F, HIDDEN, "FleetPlane.score's shard of B 2000 (fleet)", 2000),
                           (CITY_CAL, CITY_F, CITY_HIDDEN,
                            "the city engine's calibration estimates (fleet)"),
                           (CITY_STREAMS, CITY_F, CITY_HIDDEN, "a city tick on one device (fleet)"),
                           (CITY_STREAMS // FLEET_SHARDS, CITY_F, CITY_HIDDEN,
                            "a city tick's shard of four (fleet)", CITY_STREAMS),
                           (MOBILE_CAL, MOBILE_F, MOBILE_HIDDEN,
                            "the mobile engine's calibration estimates (mobility)"),
                           (1, MOBILE_F, MOBILE_HIDDEN,
                            "a client's frame, micro_batch 1 (mobility)")):
        shapes["estimator_mlp"].append(head_row(torch, timer, dev, rng, B, f, h, where, *whole))
    params = seeded_head_params(torch, rng, dev)
    for B, K, where, *whole in (
            (REQUEST, 64, "a request"), (1, 64, "a single frame"),
            (N_VAL % REQUEST, 64, "the val split's last request (train)"),
            (13, FLEET_K, "engine.score_device at B 13 (fleet)"),
            (4, FLEET_K, "FleetPlane.score_detections' shard of B 13 (fleet)", 13),
            (250, FLEET_K, "engine.score_device at B 250 (fleet)"),
            (63, FLEET_K, "FleetPlane.score_detections' shard of B 250 (fleet)", 250)):
        shapes["score_pipeline"].append(pipeline_row(torch, timer, dev, rng, params, B, K,
                                                    where, *whole))
    return shapes


def finish_head_rows(name, rows, dev):
    """Each ``time_head`` row of kernel ``name`` gets the plan it launched
    (a shard's: cut from its batch's) and its bound."""
    from repro_torch.kernels.estimator_mlp.ops import head_plan, shard_plan
    from repro_torch.kernels.score_pipeline.ops import pipeline_plan

    F = TOP_K * (7 + NUM_CLASSES) + 4 + NUM_CLASSES
    for row in rows:
        plan = (head_plan(row["of"] or row["B"], row["F"], row["H"], dev)
                if name == "estimator_mlp" else
                pipeline_plan(row["of"] or row["B"], row["K"], TOP_K, F, HIDDEN, dev))
        plan = shard_plan(plan, row["B"]) if row["of"] else plan
        row["plan"] = dict(cs=plan.cs, tb=plan.tb, grid=plan.grid, smem=plan.smem)
        row["bound_ms"], row["bound_by"] = bound(row.pop("bytes"), row.pop("ops"))


def times_only(src: Path, kernels, time_fn) -> None:
    """``--head-times`` / ``--iou-times [--src DIR]``: only ``time_head`` /
    ``time_iou``, for the port in ``src`` (default: this checkout's), as one
    JSON line after the card's line; builds only ``kernels``.  An A/B of two
    versions runs this once with each ``src``, in turns, in one call on one
    card."""
    sys.path.insert(0, str(src))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: no CUDA device")
    from repro_torch.kernels import _build

    _build.build_all(kernels)
    shapes = time_fn(torch, Timer(torch), torch.device("cuda"))
    for rows in shapes.values():
        for r in rows:
            r["bound_ms"], r["bound_by"] = bound(r.pop("bytes"), r.pop("ops"))
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"src": str(src), "shapes": shapes}), flush=True)


def check_kernels(torch, timer, dev):
    """Every kernel against its plain version on the card.  Returns per-kernel
    records with max error, times and bound at the main-path shape."""
    from repro_torch.kernels.estimator_mlp import estimator_mlp, estimator_mlp_ref
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

    F = TOP_K * (7 + NUM_CLASSES) + 4 + NUM_CLASSES
    for B, f, h in ((1, F, HIDDEN), (37, F, HIDDEN), (512, F, HIDDEN), (4096, F, HIDDEN), (37, 33, 17)):
        x = torch.tensor(rng.normal(0, 1, (B, f)).astype(np.float32), device=dev)
        w = seeded_mlp(torch, rng, f, h, dev)
        hold("estimator_mlp", f"B={B} F={f} H={h}", estimator_mlp(x, *w), estimator_mlp_ref(x, *w), 1e-5)

    params = seeded_head_params(torch, rng, dev)
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
    # a NaN box coordinate (each of the four) in a valid top-scored slot: the
    # image's estimate is NaN, as in box_feature_stack; the NaN pattern must
    # be the plain version's exactly, the other estimates within 2e-6
    for B in (1, REQUEST):
        block = list(seeded_block(torch, rng, B, 64, dev))
        rows = list(range(0, B, 3))
        for i in rows:
            block[0][i, 1, i % 4] = float("nan")
            block[1][i, 1], block[3][i, 1] = 2.0, True
        got, want = score_pipeline(block, params, **kw), ref(block)
        sync()
        same_nan = torch.equal(got.isnan(), want.isnan()) and int(want.isnan().sum()) == len(rows)
        finite = ~want.isnan()
        e = float((got - want)[finite].abs().max()) if finite.any() else 0.0
        if not (same_nan and np.isfinite(e) and e <= 2e-6):
            fail(f"score_pipeline B={B} NaN boxes: NaN pattern equal {same_nan}, "
                 f"finite rows differ by {e} (tolerance 2e-6)")
        err["score_pipeline"] = max(err["score_pipeline"], e)
        cases.append({"kernel": "score_pipeline", "case": f"B={B} K=64 NaN box coordinates",
                      "max_abs_err": e, "tol": "NaN pattern exact, finite rows 2e-6"})

    # times and bounds at the main-path shapes
    records = {}
    # estimator_mlp and score_pipeline at every shape the main paths launch
    # them, each held against its plain version (FleetPlane's shards launched
    # as it launches them); the first of each is the kernel's record in the
    # kernels line
    shapes = time_head(torch, timer, dev)
    for name, rows in shapes.items():
        finish_head_rows(name, rows, dev)
        first = rows[0]
        records[name] = dict(shape=f"{first['key']} ({first['where']})", shapes=rows,
                             **{k: first[k] for k in ("ms", "path_ms", "host_us", "plain_ms",
                                                      "bound_ms", "bound_by")})
    for name, r in records.items():
        r["max_abs_err"] = max(err[name], *(row["max_abs_err"] for row in r["shapes"]))
    times = {k: {kk: r[kk] for kk in ("shape", "ms", "plain_ms", "bound_ms")}
             for k, r in records.items()}
    emit("check", {"cases": len(cases), "max_abs_err": err, "times": times,
                   "head_shapes": shapes, "detail": cases})
    return records


# the iou_matrix family: one source a route (iou.cuh holds what they share);
# a launch over one image counts in iou_matrix, over more in iou_matrix_batch
IOU_KERNELS = ("iou_matrix", "iou_matrix_batch")
IOU_LIBS = ("iou_matrix", "iou_nms", "iou_match")  # csrc/<name>.cu
IOU_SOURCES = {
    "matrix": "src/repro_torch/kernels/csrc/iou_matrix.cu",
    "nms": "src/repro_torch/kernels/csrc/iou_nms.cu",
    "match": "src/repro_torch/kernels/csrc/iou_match.cu",
}
NMS_IOU, NMS_SCORE = 0.45, 0.25  # decode_batch's thresholds
COCO_THRESHOLDS = tuple(float(t) for t in np.round(np.linspace(0.5, 0.95, 10), 2))
# aten ops that would show a sort, gather or scatter around the fused routes
SORT_OPS = ("sort", "gather", "scatter", "take_along", "index", "argmax", "where")


def seeded_nms(torch, rng, B, N, dev, tie_levels=8, pad=0):
    """(boxes, scores, classes) of B images of N slots: scores quantized to
    ``tie_levels`` (ties for the stable rank), three classes, the last
    ``pad`` slots of each image padding (class -1, score 0, zero box)."""
    boxes = seeded_boxes(rng, (B, N), IMAGE_SIZE)
    scores = rng.uniform(0, 1, (B, N))
    if tie_levels:
        scores = np.round(scores * tie_levels) / tie_levels
    classes = rng.integers(0, 3, (B, N))
    if pad:
        boxes[:, N - pad:], scores[:, N - pad:], classes[:, N - pad:] = 0.0, 0.0, -1
    return (torch.tensor(boxes, device=dev), torch.tensor(scores.astype(np.float32), device=dev),
            torch.tensor(classes.astype(np.int32), device=dev))


def seeded_match(torch, rng, B, K, M, dev, empty_rows=1):
    """Detections (B, K) near B images' M GT boxes, so that the IoU
    thresholds split them: tied scores, prefix masks, class -1 and zero boxes
    on padding, the first ``empty_rows`` images without a detection; as the
    eight tensors greedy_match takes, less the thresholds."""
    gt = seeded_boxes(rng, (B, M), IMAGE_SIZE)
    g_cls = rng.integers(0, NUM_CLASSES, (B, M))
    src = rng.integers(0, M, (B, K))
    det = np.take_along_axis(gt, src[..., None], 1) + rng.normal(0, 2.0, (B, K, 4))
    det[..., 2:] = np.maximum(det[..., 2:], det[..., :2] + 0.5)
    near = np.take_along_axis(g_cls, src, 1)
    d_cls = np.where(rng.uniform(0, 1, (B, K)) < 0.8, near, (near + 1) % NUM_CLASSES)
    d_mask = np.arange(K)[None] < rng.integers(1, K + 1, B)[:, None]
    d_mask[:empty_rows] = False
    g_mask = np.arange(M)[None] < rng.integers(1, M + 1, B)[:, None]
    arrays = (np.where(d_mask[..., None], det, 0).astype(np.float32),
              (np.round(rng.uniform(0, 1, (B, K)) * 8) / 8).astype(np.float32),
              np.where(d_mask, d_cls, -1).astype(np.int32), d_mask,
              np.where(g_mask[..., None], gt, 0).astype(np.float32),
              np.where(g_mask, g_cls, -1).astype(np.int32), g_mask)
    return [torch.tensor(a, device=dev) for a in arrays]


def matrix_cost(B, K, M):  # each box read once, each IoU written once; 14 ops a pair, 5 a box
    return dict(bytes=B * ((K + M) * 16 + K * M * 4), ops=B * (14 * K * M + 5 * (K + M)))


def nms_cost(B, N):
    """Boxes, scores, classes read once, the mask written once; a comparison
    sort's N log2 N, the N (N - 1) / 2 IoUs of later pairs (14 ops, 5 a box)
    and N scan steps an image."""
    log = int(np.ceil(np.log2(max(N, 2))))
    return dict(bytes=B * N * (16 + 4 + 4 + 1),
                ops=B * (N * log + 14 * N * (N - 1) // 2 + 5 * N + N))


def match_cost(B, K, M, T):
    """Each input read once, tp and match_gt written once; the sort, the K M
    IoUs, and T K M compares of the argmax an image."""
    log = int(np.ceil(np.log2(max(K, 2))))
    return dict(bytes=B * (K * (16 + 4 + 4 + 1) + M * (16 + 4 + 1)) + 4 * T + B * T * K * 5,
                ops=B * (K * log + 14 * K * M + 5 * (K + M) + T * K * M))


def aten_ops(torch, fn):
    """The aten ops ``fn`` dispatches (TorchDispatchMode)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    seen = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen.append(str(func.overloadpacket.__name__))
            return func(*args, **(kwargs or {}))

    with Record():
        fn()
    return seen


def time_iou(torch, timer, dev):
    """The IoU family's routes at the path's shapes: ``ms`` (back to back),
    ``path_ms`` (right after an op that writes the scores, as the detector's
    last op does; back-to-back calls of a programmatic dependent launch
    overlap each other's set-up), ``host_us`` (the wrapper's host time a
    call), ``plain_ms``.  Returns {route: [row, ...]}, each row with the
    bytes and operations of its bound."""
    from repro_torch.kernels.iou_matrix import (
        greedy_match, greedy_match_ref, iou_matrix_batch, iou_matrix_batch_ref, nms_keep,
        nms_keep_ref,
    )

    rng = np.random.default_rng(77)

    def after(op, kernel):
        return timer(lambda: kernel(op())) - timer(op)

    routes = {"nms": [], "match": [], "matrix": []}

    def timed(B, route, shape, where, call, plain, op, cost):
        ms = timer(call)
        host_us = timer.host_us
        routes[route].append(dict(
            kernel="iou_matrix" if B == 1 else "iou_matrix_batch", route=route, key=shape,
            where=where, ms=ms, host_us=host_us,
            path_ms=after(op, lambda _: call()) if op else None,
            plain_ms=timer(plain, reps=3, windows=5), **cost))

    for B, where in ((1, "a single frame"), (REQUEST, "a request"), (256, "a calibration chunk"),
                     (N_CAL, "the strong pass over all served images")):
        b, s, c = seeded_nms(torch, rng, B, 64, dev, tie_levels=None)
        s0 = s.clone()
        timed(B, "nms", f"B={B} N=64", where, lambda: nms_keep(b, s, c, NMS_IOU, NMS_SCORE),
              lambda: nms_keep_ref(b, s, c, NMS_IOU, NMS_SCORE),
              lambda: torch.mul(s0, 1.0, out=s), nms_cost(B, 64))
    for B, T, where in ((N_CAL, 1, "match_batch of the served images"),
                        (N_CAL, 2, "match_batch of the served images"),
                        (N_VAL, 1, "match_pairs_batched of the val split (train)"),
                        (N_POOL, 1, "match_batch of the pool split (train)"),
                        *((B, 2, f"FleetPlane.match {what} (fleet)") for B, what in (
                            (13, "at B 13"), (4, "a shard of B 13"), (150, "at B 150"),
                            (38, "a shard of B 150"), (FLEET_ROWS, f"at B {FLEET_ROWS}"),
                            (FLEET_ROWS // FLEET_SHARDS, f"a shard of B {FLEET_ROWS}")))):
        args = seeded_match(torch, rng, B, 64, 8, dev)
        thr = torch.tensor((0.5, 0.75)[:T], device=dev)
        s0 = args[1].clone()
        timed(B, "match", f"B={B} K=64 M=8 T={T}", where,
              lambda: greedy_match(*args, thr), lambda: greedy_match_ref(*args, thr),
              lambda: torch.mul(s0, 1.0, out=args[1]), match_cost(B, 64, 8, T))
    for B, K, M, T, where in ((VIDEO_STREAMS * VIDEO_FRAMES, 16, 8, 1,
                               "frame_accuracies of a video serve's frames (video)"),
                              (SHIFT_STREAMS * SHIFT_FRAMES, 8, 8, 1,
                               "the shift scenario's per-frame APs (video)")):
        args = seeded_match(torch, rng, B, K, M, dev)
        thr = torch.tensor((0.5,), device=dev)
        s0 = args[1].clone()
        timed(B, "match", f"B={B} K={K} M={M} T={T}", where,
              lambda: greedy_match(*args, thr), lambda: greedy_match_ref(*args, thr),
              lambda: torch.mul(s0, 1.0, out=args[1]), match_cost(B, K, M, T))
    for B, K, M, where in ((1, 64, 64, "standalone, a frame's slots"),
                           (REQUEST, 64, 64, "standalone, a request's slots"),
                           (N_CAL, 64, 8, "standalone, match_batch's IoU"),
                           (VIDEO_STREAMS, 16, 16,
                            "the video tracker's step: streams x max_dets x max_tracks")):
        a = torch.tensor(seeded_boxes(rng, (B, K), IMAGE_SIZE), device=dev)
        g = a if K == M and B != VIDEO_STREAMS else torch.tensor(
            seeded_boxes(rng, (B, M), IMAGE_SIZE), device=dev)
        g0 = g.clone()
        timed(B, "matrix", f"B={B} K={K} M={M}", where, lambda: iou_matrix_batch(a, g),
              lambda: iou_matrix_batch_ref(a, g),
              # the tracker writes its predicted boxes (boxes + vel) right before
              (lambda: torch.add(g0, 0.0, out=g)) if B == VIDEO_STREAMS else None,
              matrix_cost(B, K, M))
    return routes


def check_iou_routes(torch, timer, dev):
    """The iou_matrix family's three routes against their plain versions on
    the card (``matrix`` within 1e-6 in float32, 2e-2 in bf16; ``nms`` and
    ``match`` exactly) at the path's shapes and at the corners (tied scores,
    64-bit word and warp edges, COCO's 10 thresholds, all-masked images,
    IoU exactly at a threshold, the routes' size limits); that nms_batch and
    match_batch dispatch no sort, gather or scatter; then each route's times
    at the path's shapes.  Returns the records of iou_matrix (B = 1) and
    iou_matrix_batch."""
    from repro_torch.detection.batch import DetectionsBatch, GroundTruthBatch, match_batch
    from repro_torch.detection.nms import nms_batch
    from repro_torch.kernels.iou_matrix import (
        greedy_match, greedy_match_ref, iou_matrix, iou_matrix_batch, iou_matrix_batch_ref,
        iou_matrix_ref, nms_keep, nms_keep_ref,
    )

    sync = _sync(torch, dev)
    rng = np.random.default_rng(2024)
    cases, err = [], {k: 0.0 for k in IOU_KERNELS}

    def hold(B, route, case, got, want, tol=None):
        """``tol`` None: exactly equal (every tensor of ``got`` and ``want``)."""
        sync()
        kernel = "iou_matrix" if B == 1 else "iou_matrix_batch"
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        if tol is None:
            ok = all(g.shape == w.shape and g.dtype == w.dtype and torch.equal(g, w)
                     for g, w in zip(got, want))
            e = 0.0 if ok else float("inf")
        else:
            e = float((got[0].float() - want[0].float()).abs().max())
            ok = got[0].shape == want[0].shape and np.isfinite(e) and e <= tol
        if not ok:
            fail(f"{kernel} ({route} route) {case}: "
                 f"{'not exactly equal' if tol is None else f'max abs error {e} > {tol}'}")
        err[kernel] = max(err[kernel], e)
        cases.append({"kernel": kernel, "route": route, "case": case, "max_abs_err": e,
                      "tol": "exact" if tol is None else tol})

    # matrix: the standalone IoU, float32 and bf16
    for dtype, tol in ((torch.float32, 1e-6), (torch.bfloat16, 2e-2)):
        tname = str(dtype).split(".")[-1]
        for B, K, M in ((1, 64, 64), (64, 64, 64), (512, 64, 8), (256, 64, 64), (1, 1, 1),
                        (1, 511, 130), (3, 70, 33), (VIDEO_STREAMS, 16, 16)):
            a = torch.tensor(seeded_boxes(rng, (B, K), IMAGE_SIZE), device=dev).to(dtype)
            g = a if K == M and B != 512 else torch.tensor(
                seeded_boxes(rng, (B, M), IMAGE_SIZE), device=dev).to(dtype)
            if B == 1:
                hold(1, "matrix", f"N={K} M={M} {tname}", iou_matrix(a[0], g[0]),
                     iou_matrix_ref(a[0], g[0]), tol)
            else:
                hold(B, "matrix", f"B={B} K={K} M={M} {tname}", iou_matrix_batch(a, g),
                     iou_matrix_batch_ref(a, g), tol)
    # nms: the path's B at N 64 (the grid slots), then the word edges and the limit
    for B, N in ((1, 64), (REQUEST, 64), (256, 64), (N_CAL, 64), (3, 1), (3, 63), (3, 65),
                 (5, 130), (2, 1024)):
        for ties in (None, 8):
            args = seeded_nms(torch, rng, B, N, dev, tie_levels=ties, pad=N // 5)
            hold(B, "nms", f"B={B} N={N} ties={ties}", nms_keep(*args, NMS_IOU, NMS_SCORE),
                 nms_keep_ref(*args, NMS_IOU, NMS_SCORE))
    pair = (torch.tensor([[[0, 0, 2, 1], [0, 0, 1, 1]]], dtype=torch.float32, device=dev),
            torch.tensor([[0.9, 0.8]], device=dev), torch.zeros((1, 2), dtype=torch.int32, device=dev))
    for thr in (0.5, 0.49):  # the pair's IoU is 0.5 exactly
        hold(1, "nms", f"IoU at threshold {thr}", nms_keep(*pair, thr, 0.0), nms_keep_ref(*pair, thr, 0.0))
    # match: the path's shape, then warp edges, COCO thresholds, chunked tiles
    for B, K, M, T in ((N_CAL, 64, 8, 1), (N_CAL, 64, 8, 2), (N_VAL, 64, 8, 1), (N_POOL, 64, 8, 1),
                       (REQUEST, 64, 8, 10), (3, 64, 1, 1), (3, 64, 32, 10), (3, 64, 33, 10),
                       (2, 300, 1024, 2), (1, 5, 3, 1), (VIDEO_STREAMS * VIDEO_FRAMES, 16, 8, 1),
                       (SHIFT_STREAMS * SHIFT_FRAMES, 8, 8, 1),
                       # FleetPlane.match: each batch and its shards of ceil(B / 4) images
                       *[(b, FLEET_K, FLEET_M, len(FLEET_THRESHOLDS)) for B in FLEET_MATCH_B
                         for b in (B, -(-B // FLEET_SHARDS))]):
        args = seeded_match(torch, rng, B, K, M, dev, empty_rows=int(B > 1))
        thr = torch.tensor(COCO_THRESHOLDS[:T] if T > 2 else (0.5, 0.75)[:T], device=dev)
        hold(B, "match", f"B={B} K={K} M={M} T={T}", greedy_match(*args, thr),
             greedy_match_ref(*args, thr))
    f32 = dict(dtype=torch.float32, device=dev)
    at = [torch.tensor([[[0, 0, 1, 1]]], **f32), torch.tensor([[0.9]], **f32),
          torch.zeros((1, 1), dtype=torch.int32, device=dev), torch.ones((1, 1), dtype=torch.bool, device=dev),
          torch.tensor([[[0, 0, 2, 1]]], **f32), torch.zeros((1, 1), dtype=torch.int32, device=dev),
          torch.ones((1, 1), dtype=torch.bool, device=dev), torch.tensor([0.5, 0.55], **f32)]
    hold(1, "match", "IoU at threshold 0.5", greedy_match(*at), greedy_match_ref(*at))
    # NaN box coordinates, each of the four, in the first box of a pair, the
    # second or both: box_iou's union is NaN and its IoU 0 (fmaxf / fminf
    # would drop the NaN), on every route exactly
    def nan_at(t, rows, slot):
        t = t.clone()
        for i in rows:
            t[i, slot(i), i % 4] = float("nan")
        return t

    for side in ("first", "second", "both"):
        first, second = side in ("first", "both"), side in ("second", "both")
        for B in (1, 3):
            a = torch.tensor(seeded_boxes(rng, (B, 8), IMAGE_SIZE), device=dev)
            g = torch.tensor(seeded_boxes(rng, (B, 6), IMAGE_SIZE), device=dev)
            a, g = (nan_at(a, range(B), lambda i: i) if first else a), \
                (nan_at(g, range(B), lambda i: i + 1) if second else g)
            if B == 1:
                hold(1, "matrix", f"N=8 M=6 NaN {side}", iou_matrix(a[0], g[0]), iou_matrix_ref(a[0], g[0]))
            else:
                hold(B, "matrix", f"B={B} K=8 M=6 NaN {side}", iou_matrix_batch(a, g),
                     iou_matrix_batch_ref(a, g))
            args = seeded_match(torch, rng, B, 64, 8, dev, empty_rows=0)
            if first:
                args[0] = nan_at(args[0], range(B), lambda i: 0)
            if second:
                args[4] = nan_at(args[4], range(B), lambda i: 0)
            thr = torch.tensor(COCO_THRESHOLDS, device=dev)
            hold(B, "match", f"B={B} K=64 M=8 T=10 NaN {side}", greedy_match(*args, thr),
                 greedy_match_ref(*args, thr))
    for B in (1, REQUEST):  # NaN in each image's top-scored box and in another
        b, s_, c = seeded_nms(torch, rng, B, 64, dev, tie_levels=None)
        top = s_.argmax(dim=1).tolist()
        b = nan_at(nan_at(b, range(B), lambda i: top[i]), range(B), lambda i: (top[i] + 7) % 64)
        hold(B, "nms", f"B={B} N=64 NaN boxes", nms_keep(b, s_, c, NMS_IOU, NMS_SCORE),
             nms_keep_ref(b, s_, c, NMS_IOU, NMS_SCORE))
    # past a limit a CUDA tensor raises, it never takes the plain version
    for what, call in (("nms N=1025", lambda: nms_keep(*seeded_nms(torch, rng, 1, 1025, dev))),
                       ("match M=1025", lambda: greedy_match(*seeded_match(torch, rng, 1, 8, 1025, dev),
                                                             torch.tensor([0.5], device=dev)))):
        try:
            call()
        except ValueError:
            continue
        fail(f"{what}: no ValueError past the route's limit")

    # nms_batch and match_batch: one launch each, no sort, gather or scatter around it
    nb = seeded_nms(torch, rng, REQUEST, 64, dev)
    mb = seeded_match(torch, rng, REQUEST, 64, 8, dev)
    det = DetectionsBatch(boxes=mb[0], scores=mb[1], classes=mb[2], mask=mb[3])
    gt = GroundTruthBatch(boxes=mb[4], classes=mb[5], mask=mb[6])
    dispatched = {"nms_batch": aten_ops(torch, lambda: nms_batch(nb[0], nb[1], nb[2], NMS_IOU, NMS_SCORE)),
                  "match_batch": aten_ops(torch, lambda: match_batch(det, gt, (0.5, 0.75)))}
    for name, ops in dispatched.items():
        if any(w in op for op in ops for w in SORT_OPS):
            fail(f"{name} on the card dispatches a sort, gather or scatter: {ops}")

    routes = time_iou(torch, timer, dev)
    rows = [r for rs in routes.values() for r in rs]
    for r in rows:
        r["bound_ms"], r["bound_by"] = bound(r.pop("bytes"), r.pop("ops"))

    records = {}
    for kernel, first in (("iou_matrix", "B=1 N=64"), ("iou_matrix_batch", f"B={REQUEST} N=64")):
        mine = [r for r in rows if r["kernel"] == kernel]
        head = next(r for r in mine if r["route"] == "nms" and r["key"] == first)
        records[kernel] = dict(shape=f"nms route {head['key']} ({head['where']})", routes=mine,
                               max_abs_err=err[kernel],
                               **{k: head[k] for k in ("ms", "path_ms", "host_us", "plain_ms",
                                                       "bound_ms", "bound_by")})
    emit("check_iou", {"cases": len(cases), "max_abs_err": err, "routes": rows,
                       "dispatched": dispatched, "detail": cases})
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
    from repro_torch.kernels.flash_sdpa import flash_sdpa
    from repro_torch.kernels.iou_matrix import iou_matrix, iou_matrix_batch
    from repro_torch.kernels.score_pipeline import score_pipeline
    from repro_torch.kernels.wkv6 import wkv6
    from repro_torch.models.detector import (
        STRONG, WEAK, Detector, decode_batch, decode_detections, detector_apply,
    )
    from repro_torch.train.checkpoint import save_flat

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

    counters = (iou_matrix, iou_matrix_batch, estimator_mlp, score_pipeline, flash_sdpa, wkv6)
    reset_counts(counters)

    # -- calibration: weak detector + batched NMS, features, estimates
    cal_dets = timed("cal_weak_detect_ms", lambda: decode_detections(weak, cal_images,
                                                                     batch_size=CAL_CHUNK))
    nms_calls = -(-N_CAL // CAL_CHUNK)  # one a chunk, a request, a frame, a strong batch
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
        nms_calls += 1
        dec = timed("serve_decide_ms", lambda: engine.decide(wb))
        if r == 0:
            first = (wb, dec, timed("serve_decide_features_ms",
                                    lambda: engine.decide(features=engine.features(wb))))
        # the request's first frame, served alone
        wb1 = timed("serve_single_frame_ms", lambda: decode_batch(weak, imgs[:1]))
        nms_calls += 1
        singles.append((wb1, timed("serve_single_frame_ms", lambda: engine.decide(wb1)),
                        float(dec.estimates[0])))
        idx = np.flatnonzero(dec.offload)
        if idx.size:
            sb = timed("serve_strong_detect_ms", lambda: decode_batch(strong, imgs[idx]))
            nms_calls += 1
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
    nms_calls += 1
    match_calls = 4  # two match_batch calls in each match_pairs_batched
    weak_map = cascade_map(matched_all, np.zeros_like(offload), (0.5,))
    strong_map = cascade_map(matched_all, np.ones_like(offload), (0.5,))
    sync()
    launches = {w.__name__: w.launches for w in counters}
    split = split_counts(counters)
    # every NMS and every match_batch was one launch of its fused route
    routes = {k: split[k]["by_route"] for k in IOU_KERNELS}
    took = {r: sum(routes[k][r] for k in IOU_KERNELS) for r in ("matrix", "nms", "match")}
    if took != {"matrix": 0, "nms": nms_calls, "match": match_calls} or routes["iou_matrix"]["nms"] == 0:
        fail(f"the detection path's NMS ({nms_calls} calls) and matching ({match_calls} calls) "
             f"took the IoU routes {routes}")

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
        "stage_ms": stage, "launches": launches, "iou_routes": routes,
        "nms_calls": nms_calls, "match_calls": match_calls, "card": smi,
    })
    return launches, split


# --------------------------------------------------------------- the training slice

# The reward estimator fitted on the card against the same fit on the CPU
# (same init, features and rewards).  After 5 epochs the two agree within
# SHORT_FIT_TOL.  build_engine's 40 epochs (280 AdamW steps) amplify float32
# rounding (Adam turns noise in a near-zero gradient into a step of ~lr)
# until single estimates differ by far more than that, on one device as
# much as across two (PERF.md §6).  So the card's 40-epoch fit is held against
# the CPU's in FIT_SPREAD_DRAWS draws (the val features as they are, then
# moved by one ulp): the median over the draws of each draw's median and
# 99th percentile |estimate difference|, and the mean decisions differing,
# each within FIT_SPREAD_MULTIPLE times the same over draws of what one such
# move does on one device (CPU fits against the CPU fit, card fits against
# the card's; for decisions at least 1).  A one-ulp move once is a smaller
# push than rounding that differs at every step, and single draws spread by
# over ten times, hence the multiple.
SHORT_FIT_EPOCHS, SHORT_FIT_TOL = 5, 1e-4
FIT_SPREAD_DRAWS, FIT_SPREAD_MULTIPLE = 4, 10


def hold_training(what, got, want, lr_sum, max_share=0.01):
    """Parameters after N AdamW steps from one start, on two devices, at the
    tolerance tests/test_torch_train.py holds the port to repro: every
    element within 2 lr_sum (m_hat / sqrt(v_hat) is ~1 for any gradient
    above eps, so float32 noise in a near-zero gradient can move an element
    by lr a step), at most ``max_share`` of the elements beyond 1e-5 (None:
    not held).  ``got`` / ``want``: name -> tensor.  Returns (max |diff|,
    share beyond 1e-5)."""
    worst, far, total = 0.0, 0, 0
    for k, w in want.items():
        d = (got[k].detach().cpu() - w.detach().cpu()).abs()
        worst = max(worst, float(d.max()))
        far += int((d > 1e-5).sum())
        total += d.numel()
    if not np.isfinite(worst) or worst > 2 * lr_sum or (max_share is not None and far > max_share * total):
        fail(f"{what}: parameters differ by up to {worst} (2 lr_sum {2 * lr_sum}), "
             f"{far} of {total} elements beyond 1e-5")
    return worst, far / total


def train(torch, smi, dev):
    """The training slice, counted: ``build_pipeline`` at its defaults (WEAK
    and STRONG trained on the card, decoded with NMS, matched), ``build_engine``
    (ORIC rewards, the reward estimator fitted on the card, its calibration
    estimates through ``estimator_mlp``), then the val split served as
    requests of 64 through the trained cascade (WEAK + NMS -> ``decide``
    (``score_pipeline``) -> STRONG on the offloaded frames) and matched.
    Then, outside the count: each loss falls, 5 card steps against 5 CPU
    steps from one start, the calibration estimates against ``mlp_apply``,
    the artifact round trip and the same fit on the CPU.  Returns the
    launches of the counted run and their split."""
    from repro_torch.api import MLPRewardModel, OffloadEngine
    from repro_torch.convert import detector_params_from_jax, detector_params_to_jax
    from repro_torch.core.estimator import EstimatorConfig, mlp_apply
    from repro_torch.core.reward import RewardOracle, cascade_map, match_pairs_batched
    from repro_torch.data.shapes import ShapesDataset
    from repro_torch.detection.batch import DetectionsBatch, GroundTruthBatch
    from repro_torch.experiments.detection_repro import build_engine, build_pipeline
    from repro_torch.kernels.estimator_mlp import estimator_mlp
    from repro_torch.kernels.flash_sdpa import flash_sdpa
    from repro_torch.kernels.iou_matrix import iou_matrix, iou_matrix_batch
    from repro_torch.kernels.score_pipeline import score_pipeline
    from repro_torch.kernels.wkv6 import wkv6
    from repro_torch.models.detector import STRONG, WEAK, Detector, decode_batch
    from repro_torch.train.checkpoint import load_pytree
    from repro_torch.train.schedule import warmup_cosine
    from repro_torch.train.trainer import train_detector

    sync = _sync(torch, dev)
    stage: Dict[str, float] = {}

    def timed(name, fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        stage[name] = stage.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
        return out

    t_phase = time.perf_counter()
    counters = (iou_matrix, iou_matrix_batch, estimator_mlp, score_pipeline, flash_sdpa, wkv6)
    val = ShapesDataset.generate(N_VAL, seed=1)  # build_pipeline's val split (seed + 1)
    with tempfile.TemporaryDirectory() as tmp:
        reset_counts(counters)
        state = build_pipeline(N_TRAIN, N_VAL, N_POOL, STEPS_WEAK, STEPS_STRONG, force=True,
                               verbose=False, device=dev, cache_dir=tmp, stage_ms=stage)
        nms_calls = 2 * -(-N_VAL // CAL_CHUNK) + -(-N_POOL // CAL_CHUNK)  # decode_detections' chunks
        match_calls = 3  # val: weak and strong; pool: weak
        engine = timed("engine_fit_ms", lambda: build_engine(
            state, context_size=800, epochs=40, hidden=(HIDDEN,), device=dev))
        # the trained detectors, from the pipeline's cache (repro's HWIO layout)
        detectors = {}
        for cfg in (WEAK, STRONG):
            det = Detector(cfg, device=dev)
            det.load_state_dict(detector_params_from_jax(load_pytree(
                str(Path(tmp) / f"torch_detector_{cfg.name}.npz"),
                detector_params_to_jax(det.state_dict()))))
            detectors[cfg.name] = det

        # serve the val split as requests of 64 through the trained cascade
        fields = ("boxes", "scores", "classes", "mask")
        weak_batches, offload, estimates, strong_rows = [], [], [], {}
        for r in range(0, N_VAL, REQUEST):
            imgs = val.images[r : r + REQUEST]
            wb = timed("serve_weak_detect_ms", lambda: decode_batch(detectors["weak"], imgs))
            dec = timed("serve_decide_ms", lambda: engine.decide(wb))
            idx = np.flatnonzero(dec.offload)
            nms_calls += 1 + int(idx.size > 0)
            if idx.size:
                sb = timed("serve_strong_detect_ms", lambda: decode_batch(detectors["strong"], imgs[idx]))
                for j, i in enumerate(idx):
                    strong_rows[r + int(i)] = (sb, j)
            weak_batches.append(wb)
            offload.append(dec.offload)
            estimates.append(dec.estimates)
        offload, estimates = np.concatenate(offload), np.concatenate(estimates)
        weak_all = DetectionsBatch(**{f: torch.cat([getattr(b, f) for b in weak_batches]) for f in fields})
        rows = [strong_rows.get(i, (weak_all, i)) for i in range(N_VAL)]
        served_strong = DetectionsBatch(**{
            f: torch.cat([getattr(src, f)[j : j + 1] for src, j in rows]) for f in fields})
        gt = GroundTruthBatch.from_list(val.gts, device=dev)
        matched = timed("eval_match_ms", lambda: match_pairs_batched(weak_all, served_strong, gt, (0.5,)))
        match_calls += 2
        served_map = timed("eval_map_ms", lambda: cascade_map(matched, offload, (0.5,)))
        sync()
        phase_s = time.perf_counter() - t_phase
        launches = {c.__name__: c.launches for c in counters}
        split = split_counts(counters)
        routes = {k: split[k]["by_route"] for k in IOU_KERNELS}
        took = {r: sum(routes[k][r] for k in IOU_KERNELS) for r in ("matrix", "nms", "match")}
        if took != {"matrix": 0, "nms": nms_calls, "match": match_calls}:
            fail(f"the train path's NMS ({nms_calls} calls) and matching ({match_calls} calls) "
                 f"took the IoU routes {routes}")

        # -- checks, outside the count
        losses = {}
        for name, trace in state.train_losses.items():
            first, last = float(np.mean(trace[:50])), float(np.mean(trace[-50:]))
            if not (np.isfinite(trace).all() and last < first):
                fail(f"{name} detector: the loss did not fall (first 50 {first}, last 50 {last})")
            losses[name] = {"steps": len(trace), "first_50_mean": first, "last_50_mean": last,
                            "steps_per_s": len(trace) / (stage[f"train_{name}_ms"] / 1e3)}
        for name, v in (("weak", state.weak_map), ("strong", state.strong_map), ("served", served_map)):
            if not (np.isfinite(v) and 0.0 <= v <= 1.0):
                fail(f"{name} val mAP {v} is not in [0, 1]")
        if not (np.isfinite(estimates).all() and ((estimates >= 0) & (estimates <= 1)).all()):
            fail("served estimates are not finite in [0, 1]")
        # the calibration estimates (estimator_mlp) against mlp_apply on the card
        x = engine.features(state.weak_dets_val)
        est = engine.reward_model.estimator
        xs = (x - torch.tensor(est._mu, device=dev)) / torch.tensor(est._sigma, device=dev)
        with torch.no_grad():
            plain = mlp_apply(est.params, xs, sigmoid_out=True).cpu().numpy()
        cal_err = float(np.abs(plain - engine.calibration_scores).max())
        if x.shape != (N_VAL, TOP_K * (7 + NUM_CLASSES) + 4 + NUM_CLASSES) or cal_err > 1e-5:
            fail(f"calibration estimates: estimator_mlp vs mlp_apply differ by {cal_err} > 1e-5")
        # the artifact: save -> OffloadEngine.load -> identical decisions
        path = str(Path(tmp) / "engine.npz")
        engine.save(path)
        loaded = OffloadEngine.load(path, device=dev)
        a, b = engine.decide(features=x), loaded.decide(features=x)
        if not (np.array_equal(a.offload, b.offload) and np.array_equal(a.estimates, b.estimates)):
            fail("the reloaded engine artifact decides differently on the val features")
        # the same fit on the CPU: the same init (drawn on the CPU), the card's
        # features and the same rewards (build_engine's oracle, recomputed).
        # Features extracted on the CPU instead differ in float32 rounding,
        # which standardizing by a near-constant column's tiny sigma blows up
        rewards = RewardOracle.from_pool(state.pool_weak_evals, 800, np.random.default_rng(0)) \
            .oric_batch(state.val_pairs)
        if not np.array_equal(np.sort(rewards), engine.transform.state()["sorted_rewards"]):
            fail("build_engine's rewards are not the oracle's ORIC rewards of the val split")

        def fit(device, epochs, features=x):
            return OffloadEngine(
                reward_model=MLPRewardModel(
                    config=EstimatorConfig(hidden=(HIDDEN,), epochs=epochs, seed=0), device=device),
                ratio=0.2, device=device).fit(features=features.to(device), rewards=rewards)

        def gap(a, b):
            d = np.abs(a.calibration_scores - b.calibration_scores)
            differ = a.decide(features=x.to(a.device)).offload != b.decide(features=x.to(b.device)).offload
            return d, differ, {"max": float(d.max()), "p99": float(np.quantile(d, 0.99)),
                               "median": float(np.median(d)), "decisions_differing": int(differ.sum())}

        # the short fit: card and CPU agree at SHORT_FIT_TOL
        card, cpu = fit(dev, SHORT_FIT_EPOCHS), fit("cpu", SHORT_FIT_EPOCHS)
        d, differ, short = gap(card, cpu)
        near = np.abs(card.calibration_scores - card.policy.threshold) <= SHORT_FIT_TOL
        steps = SHORT_FIT_EPOCHS * (N_VAL // 256)
        sched = warmup_cosine(2e-3, max(steps // 20, 1), steps)
        worst, share = hold_training(
            f"the {SHORT_FIT_EPOCHS}-epoch estimator fit, card vs CPU",
            *({f"{n}.{k}": v for n, p in e.reward_model.estimator.params.items() for k, v in p.items()}
              for e in (card, cpu)), sum(sched(i) for i in range(steps)), max_share=None)
        short.update(epochs=SHORT_FIT_EPOCHS, near_threshold_rows=int(near.sum()),
                     params_max_abs=worst, params_share_beyond_1e_5=share)
        if d.max() > SHORT_FIT_TOL or (differ & ~near).any():
            fail(f"the {SHORT_FIT_EPOCHS}-epoch estimator fit, card vs CPU: estimates differ by "
                 f"{d.max()} (tolerance {SHORT_FIT_TOL}), {int((differ & ~near).sum())} decisions "
                 "differ away from the threshold")
        # build_engine's 40-epoch fit: the card repeats it bit for bit.  Against
        # the CPU it is held to the spread float32 rounding alone gives: draws
        # of the card-vs-CPU gap (on the val features, and on them moved by one
        # ulp each, a seeded random direction an element) against draws of the
        # gap one such move makes on one device (CPU against CPU, card against
        # card)
        repeat = fit(dev, 40)
        if not np.array_equal(repeat.calibration_scores, engine.calibration_scores):
            fail("build_engine's fit repeated on the card gives other estimates")
        cpu = fit("cpu", 40)
        draws = {"card_vs_cpu": [gap(engine, cpu)[2]], "one_device": []}
        for seed in range(FIT_SPREAD_DRAWS):
            u = np.random.default_rng(seed).uniform(size=tuple(x.shape)) < 0.5
            moved = torch.from_numpy(np.nextafter(
                x.cpu().numpy(), np.where(u, -np.inf, np.inf).astype(np.float32)))
            cpu_moved = fit("cpu", 40, moved)
            draws["one_device"].append(dict(gap(cpu, cpu_moved)[2], device="cpu"))
            if seed < FIT_SPREAD_DRAWS - 1:
                card_moved = fit(dev, 40, moved.to(dev))
                draws["card_vs_cpu"].append(gap(card_moved, cpu_moved)[2])
                draws["one_device"].append(dict(gap(engine, card_moved)[2], device="card"))
        typical = {w: {"median": float(np.median([d["median"] for d in runs])),
                       "p99": float(np.median([d["p99"] for d in runs])),
                       "decisions_differing": float(np.mean([d["decisions_differing"] for d in runs]))}
                   for w, runs in draws.items()}
        limit = {k: FIT_SPREAD_MULTIPLE * (max(v, 1.0) if k == "decisions_differing" else v)
                 for k, v in typical["one_device"].items()}
        full = dict(draws["card_vs_cpu"][0], epochs=40, card_repeat_equal=True, draws=draws,
                    typical=typical, limit=limit)
        if any(typical["card_vs_cpu"][k] > v for k, v in limit.items()):
            fail(f"build_engine's fit, card vs CPU: typical gaps {typical['card_vs_cpu']} above "
                 f"{FIT_SPREAD_MULTIPLE}x the one-ulp spread on one device {typical['one_device']}")
        fits = {"short": short, "full": full}

    # 5 steps of train_detector at STRONG's width from one seeded start, on
    # the card and on the CPU (TF32 off: the probe phase set both flags)
    ds = ShapesDataset.generate(PARITY_STEPS * TRAIN_BATCH, seed=0)
    card_det, card_loss = train_detector(STRONG, ds, steps=PARITY_STEPS, batch_size=TRAIN_BATCH,
                                         seed=10, log_every=0, device=dev)
    cpu_det, cpu_loss = train_detector(STRONG, ds, steps=PARITY_STEPS, batch_size=TRAIN_BATCH,
                                       seed=10, log_every=0, device="cpu")
    loss_rel = float(np.max(np.abs(np.array(card_loss) - cpu_loss) / np.abs(cpu_loss)))
    if loss_rel > 1e-4:
        fail(f"STRONG loss trace, card vs CPU: relative difference {loss_rel} > 1e-4")
    sched = warmup_cosine(3e-3, max(PARITY_STEPS // 10, 1), PARITY_STEPS)
    lr_sum = sum(sched(i) for i in range(PARITY_STEPS))
    worst, share = hold_training("STRONG after 5 steps, card vs CPU", card_det.state_dict(),
                                 cpu_det.state_dict(), lr_sum)
    step_ms = {cfg.name: step_device_ms(torch, cfg, ds, dev) for cfg in (WEAK, STRONG)}

    emit("train", {
        "images": {"train": N_TRAIN, "val": N_VAL, "pool": N_POOL},
        "steps": {"weak": STEPS_WEAK, "strong": STEPS_STRONG}, "batch": TRAIN_BATCH,
        "widths": {"weak": [list(WEAK.widths), WEAK.head_width],
                   "strong": [list(STRONG.widths), STRONG.head_width]},
        "cuts": [], "losses": losses,
        "stage_s": {k.removesuffix("_ms") + "_s": v / 1e3 for k, v in stage.items()},
        "phase_s": phase_s,
        "map50_val": {"weak_only": state.weak_map, "strong_only": state.strong_map,
                      "cascade_served": served_map,
                      "cascade_from_pipeline": cascade_map(state.val_pairs, offload, (0.5,))},
        "realized_ratio": float(offload.mean()), "target_ratio": 0.2,
        "requests": -(-N_VAL // REQUEST), "request_size": REQUEST,
        "checks": {"calibration_estimator_mlp_vs_mlp_apply": cal_err,
                   "artifact_round_trip_equal": True,
                   "fit_card_vs_cpu": fits, "short_fit_tol": SHORT_FIT_TOL,
                   "parity_steps": PARITY_STEPS, "parity_loss_max_rel": loss_rel,
                   "parity_params_max_abs": worst, "parity_params_share_beyond_1e-5": share,
                   "parity_2_lr_sum": 2 * lr_sum},
        "step_ms": step_ms,
        "launches": launches, "iou_routes": routes, "nms_calls": nms_calls,
        "match_calls": match_calls, "card": smi,
    })
    trained = {"engine": engine, "val": val, "weak": detectors["weak"],
               "weak_batches": weak_batches, "estimates": estimates, "offload": offload}
    return launches, split, trained


def step_device_ms(torch, cfg, ds, dev, steps=PROFILED_STEPS):
    """One training step's wall time (host clock, ``steps`` steps after a
    warm-up, device synced) and its device time over another ``steps``
    steps (``device_busy_ms``)."""
    from repro_torch.train.trainer import train_detector

    def run():
        return train_detector(cfg, ds, steps=steps, batch_size=TRAIN_BATCH, seed=3, log_every=0,
                              device=dev)

    train_detector(cfg, ds, steps=3, batch_size=TRAIN_BATCH, seed=3, log_every=0, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / steps
    busy, n_events = device_busy_ms(torch, run)
    device = busy / steps if busy is not None else None  # None: not measured
    return {"steps": steps, "wall_ms": wall, "device_ms": device,
            "device_share": device / wall if device is not None else None,
            "device_events_a_step": n_events / steps}



# --------------------------------------------------------------- the LM slice

# --------------------------------------------------------------- the streaming runtime

# The stream phase: the val split's frames, one per time unit, through
# OffloadRuntime over default_edge_fleet(3, seed=0) (least_loaded, degrade)
# in micro-batches of STREAM_MICRO_BATCH, re-budgeted mid-stream; then
# STREAM_SINGLE_FRAMES frames through OffloadSession.submit one at a time.
STREAM_MICRO_BATCH, STREAM_RATIO, STREAM_REBUDGET = 8, 0.2, {1000: 0.1}
STREAM_SINGLE_FRAMES = 64
STREAM_RATIO_TOL = 0.02  # realized ratio before / after the re-budget
STREAM_EST_TOL = 1e-5  # estimator_mlp against score_pipeline: two kernels, two summation orders
STREAM_PATH_KERNELS = ("score_pipeline", "estimator_mlp", "iou_matrix_batch")  # each must launch
# the same frames through simulate behind netsim uplinks, once a policy
STREAM_LINKED_POLICIES = ("queue_aware", "value_iteration")
VI_REF_TOL = 1e-4  # the value-iteration table against the Python oracle (tests/test_netsim.py)
VI_SOLVE_REPEATS = 5  # timed value-iteration solves on the card and on the CPU


def hold_flips(what, got_est, got_offload, want_est, thresholds):
    """Decisions ``got_offload`` (from estimates ``got_est``) against the
    threshold policy on ``want_est``: estimates within STREAM_EST_TOL, and a
    decision may differ only where an estimate lies within STREAM_EST_TOL of
    its threshold.  Returns the counts, for the report."""
    err = float(np.abs(got_est - want_est).max()) if len(want_est) else 0.0
    expected = want_est > thresholds
    near = np.abs(want_est - thresholds) <= STREAM_EST_TOL
    flips = got_offload != expected
    if not err <= STREAM_EST_TOL or (flips & ~near).any():
        fail(f"{what}: estimates differ by {err} (tolerance {STREAM_EST_TOL}); "
             f"{int((flips & ~near).sum())} decisions differ away from the threshold")
    return {"max_abs_err": err, "flips": int(flips.sum()), "near_threshold_rows": int(near.sum())}


def stream(torch, smi, dev, trained):
    """The streaming runtime on the card, counted: the val split through WEAK
    + NMS a request of 64 at a time, each request through
    ``OffloadSession.submit_batch`` (the fast path, ``score_pipeline``), the
    frames' features through ``simulate`` (the buffered path,
    ``estimator_mlp`` a micro-batch, under ``Obs``), then single frames
    through WEAK + NMS and ``OffloadSession.submit``.  Then, outside the
    count: the fast path against the train phase's ``engine.decide``, the
    buffered path against the fast path, a second ``simulate`` on the card
    and one on the CPU against the first, the realized ratios around the
    re-budget and the observability plane.  Returns the launches of the
    counted run and their split."""
    from repro_torch.api import OffloadEngine
    from repro_torch.core.policy import ThresholdPolicy
    from repro_torch.kernels.estimator_mlp import estimator_mlp
    from repro_torch.kernels.flash_sdpa import flash_sdpa
    from repro_torch.kernels.iou_matrix import iou_matrix, iou_matrix_batch
    from repro_torch.kernels.score_pipeline import score_pipeline
    from repro_torch.kernels.wkv6 import wkv6
    from repro_torch.models.detector import decode_batch
    from repro_torch.netsim import quantile_threshold, value_iteration_ref
    from repro_torch.netsim.policy import ValueIterationPolicy, _estimate_bins
    from repro_torch.obs import Obs
    from repro_torch.runtime import (
        OffloadSession,
        default_edge_fleet,
        default_linked_fleet,
        simulate,
    )

    sync = _sync(torch, dev)
    stage: Dict[str, float] = {}

    def timed(name, fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        stage[name] = stage.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
        return out

    engine, val, weak = trained["engine"], trained["val"], trained["weak"]
    sim = dict(strategy="least_loaded", on_saturation="degrade", ratio=STREAM_RATIO,
               micro_batch=STREAM_MICRO_BATCH, set_ratio_at=STREAM_REBUDGET, seed=0)

    def run_simulate(eng, x, obs=None):  # a fresh seeded fleet each run
        return simulate(eng, features=x, edges=default_edge_fleet(3, seed=0), obs=obs, **sim)

    def run_linked(eng, x):  # the same stream behind netsim uplinks
        return simulate(eng, features=x, edges=default_linked_fleet(3, seed=0), **sim)

    decode_batch(weak, val.images[:1])  # cuDNN's choice for one frame, outside the count
    counters = (iou_matrix, iou_matrix_batch, estimator_mlp, score_pipeline, flash_sdpa, wkv6)
    t_phase = time.perf_counter()
    reset_counts(counters)
    # -- frames enter through WEAK + NMS, a request of 64 at a time
    requests = [timed("weak_detect_ms", lambda: decode_batch(weak, val.images[r : r + REQUEST]))
                for r in range(0, N_VAL, REQUEST)]
    # -- the fast path: each request whole through one session
    session = OffloadSession(engine, micro_batch=STREAM_MICRO_BATCH)
    fast = []
    for wb in requests:
        fast += timed("fast_submit_batch_ms", lambda: session.submit_batch(wb))
    # -- the buffered path: the frames' features streamed through simulate
    x = timed("features_ms", lambda: torch.cat([engine.features(wb) for wb in requests]))
    before = {c.__name__: c.launches for c in counters}
    obs = Obs()
    sync()
    t0 = time.perf_counter()
    trace = run_simulate(engine, x, obs)
    simulate_s = time.perf_counter() - t0
    obs_launches = obs.kernel_delta()["launches"]
    simulate_launches = {c.__name__: c.launches - before[c.__name__] for c in counters}
    # -- single frames: WEAK + NMS on one image, then OffloadSession.submit
    single_session = OffloadSession(engine, micro_batch=STREAM_MICRO_BATCH)
    frames, singles = [], []
    for i in range(STREAM_SINGLE_FRAMES):
        wb1 = timed("single_weak_detect_ms", lambda: decode_batch(weak, val.images[i : i + 1]))
        frames.append(wb1)
        singles += timed("single_submit_ms", lambda: single_session.submit(wb1))
    singles += single_session.flush()
    # -- the link-fronted fleet under the two queue-aware policies
    linked, linked_s = {}, {}
    for policy in STREAM_LINKED_POLICIES:
        eng_p = engine.with_policy(policy)
        sync()
        t0 = time.perf_counter()
        linked[policy] = run_linked(eng_p, x)
        linked_s[policy] = time.perf_counter() - t0
    sync()
    phase_s = time.perf_counter() - t_phase
    launches = {c.__name__: c.launches for c in counters}
    split = split_counts(counters)

    # -- checks, outside the count
    est_fast = np.array([d.estimate for d in fast])
    off_fast = np.array([d.offload for d in fast])
    if [d.step for d in fast] != list(range(N_VAL)):
        fail("the fast path's steps are not the arrival order")
    same_detections = all(
        torch.equal(getattr(a, f), getattr(b, f))
        for a, b in zip(requests, trained["weak_batches"]) for f in ("boxes", "scores", "classes", "mask"))
    if not (np.array_equal(est_fast, trained["estimates"].astype(np.float64))
            and np.array_equal(off_fast, trained["offload"])):
        fail(f"the fast path (score_pipeline) differs from the train phase's engine.decide on the "
             f"same requests (detections equal: {same_detections}): estimates by "
             f"{float(np.abs(est_fast - trained['estimates']).max())}, "
             f"{int((off_fast != trained['offload']).sum())} decisions")
    # the buffered path (estimator_mlp) against the fast path, at the
    # threshold in force at each step
    cal = engine.calibration_scores
    thr = np.full(N_VAL, ThresholdPolicy(cal, STREAM_RATIO).threshold)
    for step, ratio in sorted(STREAM_REBUDGET.items()):
        thr[step:] = ThresholdPolicy(cal, ratio).threshold
    est_buf = np.array([r.estimate for r in trace.records])
    off_buf = np.array([r.offload for r in trace.records])
    buffered = hold_flips("the buffered path vs the fast path", est_buf, off_buf, est_fast, thr)
    # the single frames (their own one-image detections) against the same
    # detections decided as one request
    one = engine.decide(features=torch.cat([engine.features(b) for b in frames]))
    single = hold_flips("single frames through submit() vs decide()",
                        np.array([d.estimate for d in singles]),
                        np.array([d.offload for d in singles]), one.estimates.astype(np.float64),
                        np.full(len(frames), engine.policy.threshold))
    single["vs_request_max_abs_diff"] = float(np.abs(one.estimates - est_fast[:len(frames)]).max())
    # a second run on the card, without Obs: the same trace, record for record
    sync()
    t0 = time.perf_counter()
    again = run_simulate(engine, x)
    simulate_s_no_obs = time.perf_counter() - t0
    if again.records != trace.records or again.summary() != trace.summary():
        fail("two simulate runs on the card give different traces")
    # the same stream on the CPU, from the artifact: equal wherever no
    # decision flipped near the threshold (a flip changes the fleet's state,
    # so records after the first one may follow another course)
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "engine.npz")
        engine.save(path)
        cpu_engine = OffloadEngine.load(path, device="cpu")
    cpu_trace = run_simulate(cpu_engine, x.cpu())
    est_cpu = np.array([r.estimate for r in cpu_trace.records])
    off_cpu = np.array([r.offload for r in cpu_trace.records])
    cpu = hold_flips("simulate on the CPU vs the card", est_buf, off_buf, est_cpu, thr)
    flips = np.flatnonzero(off_cpu != off_buf)
    upto = int(flips[0]) if flips.size else N_VAL
    for a, b in zip(trace.records[:upto], cpu_trace.records[:upto]):
        a, b = a.as_dict(), b.as_dict()
        if abs(a.pop("estimate") - b.pop("estimate")) > STREAM_EST_TOL or a != b:
            fail(f"simulate on the CPU vs the card: record {a['step']} differs before any "
                 f"flip ({a} vs {b})")
    if not flips.size and cpu_trace.dispatcher != trace.dispatcher:
        fail("simulate on the CPU vs the card: dispatcher stats differ with no flip")
    cpu.update(first_flip=upto if flips.size else None, records_equal=upto)
    # the realized ratio before and after the re-budget
    (cut, after_ratio), = STREAM_REBUDGET.items()
    realized = {"before": float(off_buf[:cut].mean()), "after": float(off_buf[cut:].mean())}
    if abs(realized["before"] - STREAM_RATIO) > STREAM_RATIO_TOL \
            or abs(realized["after"] - after_ratio) > STREAM_RATIO_TOL:
        fail(f"realized ratios {realized} not within {STREAM_RATIO_TOL} of "
             f"{STREAM_RATIO} / {after_ratio}")
    # the linked runs on the CPU, from the artifact: estimates within 1e-5
    # everywhere, records equal up to the first decision that flipped (at
    # that step the fleet, queue and budget states are equal, so a flip
    # means the estimate lies within the two runs' rounding, 1e-5, of the
    # threshold in force)
    linked_report = {}
    for policy, trace_p in linked.items():
        cpu_p = run_linked(cpu_engine.with_policy(policy), x.cpu())
        est_p = np.array([r.estimate for r in trace_p.records])
        est_c = np.array([r.estimate for r in cpu_p.records])
        err = float(np.abs(est_p - est_c).max())
        flips_p = np.flatnonzero([a.offload != b.offload
                                  for a, b in zip(trace_p.records, cpu_p.records)])
        first = int(flips_p[0]) if flips_p.size else N_VAL
        if not err <= STREAM_EST_TOL:
            fail(f"{policy} on the linked fleet: card and CPU estimates differ by {err}")
        for a, b in zip(trace_p.records[:first], cpu_p.records[:first]):
            a, b = a.as_dict(), b.as_dict()
            a.pop("estimate"), b.pop("estimate")
            if a != b:
                fail(f"{policy} on the linked fleet: record {a['step']} differs from the CPU's "
                     f"before any flip ({a} vs {b})")
        if not flips_p.size and cpu_p.dispatcher != trace_p.dispatcher:
            fail(f"{policy} on the linked fleet: dispatcher stats differ from the CPU's")
        off_p = np.array([r.offload for r in trace_p.records])
        summary = trace_p.summary()
        linked_report[policy] = {
            "simulate_s": linked_s[policy], "frames_per_s": N_VAL / linked_s[policy],
            "realized_ratio": {"before": float(off_p[:cut].mean()),
                               "after": float(off_p[cut:].mean())},
            "outcomes": trace_p.outcome_counts(),
            "mean_offload_latency": summary["mean_offload_latency"],
            "latency_decomposition": trace_p.latency_decomposition(),
            "cpu_vs_card": {"max_abs_err": err, "flips": int(flips_p.size),
                            "first_flip": first if flips_p.size else None},
        }
        if any(not r.transmit_delay > 0.0 for r in trace_p.records
               if r.outcome == "offloaded"):
            fail(f"{policy} on the linked fleet: an offloaded frame paid no transit")
    if not sum(r["outcomes"].get("offloaded", 0) for r in linked_report.values()):
        fail("the linked fleet served no offload under either policy")
    # the value-iteration tables the card solved, against the Python oracle
    bins = _estimate_bins(cal, 32)
    vi_err = 0.0
    for ratio in (STREAM_RATIO, after_ratio):
        theta = ValueIterationPolicy(cal, ratio, device=dev).theta
        want_theta = value_iteration_ref(bins, quantile_threshold(cal, ratio))[1]
        vi_err = max(vi_err, float(np.abs(theta - want_theta).max()))
    if not vi_err <= VI_REF_TOL:
        fail(f"value iteration on the card differs from value_iteration_ref by {vi_err}")
    linked_report["value_iteration"]["theta_vs_ref_max_abs_err"] = vi_err
    # one solve (a construction: set_ratio solves the same way) on the card
    # and on the host CPU, host ms to the table, median of VI_SOLVE_REPEATS
    solve_ms = {}
    for where, label in ((dev, "card"), (torch.device("cpu"), "cpu")):
        ValueIterationPolicy(cal, STREAM_RATIO, device=where)  # first-call costs, untimed
        times = []
        for _ in range(VI_SOLVE_REPEATS):
            sync()
            t0 = time.perf_counter()
            ValueIterationPolicy(cal, STREAM_RATIO, device=where)
            times.append((time.perf_counter() - t0) * 1e3)
        solve_ms[label] = float(np.median(times))
    linked_report["value_iteration"]["solve_ms"] = solve_ms
    # the observability plane
    processed = obs.metrics.snapshot().get('repro_frames_processed_total{stream="0"}')
    report = obs.profiler.report()
    drains = N_VAL // STREAM_MICRO_BATCH
    n_flush = sum(e["name"] == "session.flush" for e in obs.tracer.events)
    if processed != N_VAL or n_flush != drains or report["session.score"]["count"] != drains:
        fail(f"Obs: {processed} frames processed (want {N_VAL}), {n_flush} session.flush spans "
             f"and {report['session.score']['count']} drains (want {drains})")
    if obs_launches != simulate_launches:
        fail(f"Obs's launch counts {obs_launches} differ from the wrappers' {simulate_launches}")

    emit("stream", {
        "frames": N_VAL, "requests": len(requests), "single_frames": STREAM_SINGLE_FRAMES,
        "micro_batch": STREAM_MICRO_BATCH, "fleet": "default_edge_fleet(3, seed=0)",
        "strategy": sim["strategy"], "on_saturation": sim["on_saturation"],
        "ratio": STREAM_RATIO, "set_ratio_at": STREAM_REBUDGET, "realized_ratio": realized,
        "simulate_s": simulate_s, "frames_per_s": N_VAL / simulate_s,
        "frames_per_s_without_obs": N_VAL / simulate_s_no_obs,
        "drain_host_ms": {k: report[k]["total_ms"] / report[k]["count"]
                          for k in ("session.score", "session.decide")},
        "profile": {k: {"total_ms": v["total_ms"], "count": v["count"]} for k, v in report.items()},
        "outcomes": trace.outcome_counts(), "dispatcher": trace.dispatcher,
        "telemetry": trace.telemetry.as_dict(),
        "linked_fleet": dict(fleet="default_linked_fleet(3, seed=0)", **linked_report),
        "checks": {"fast_vs_train_decide_equal": True, "detections_equal_train": same_detections,
                   "buffered_vs_fast": buffered, "single_frames": single,
                   "card_rerun_equal": True, "cpu_vs_card": cpu,
                   "obs_frames_processed": processed, "obs_flush_spans": n_flush,
                   "obs_launches": obs_launches},
        "stage_ms": stage, "phase_s": phase_s, "launches": launches, "card": smi,
    })
    return launches, split


# The repro phase: the paper's experiments as ``run_all(quick=True)`` runs
# them (1200 / 400 / 500 images, WEAK 250 and STRONG 400 steps at full
# width, context 400, the estimators' 20 epochs and the streaming study's
# engine at 10), then Fig. 7 and the token-bucket study on that state, and
# REPRO_CASCADE_FRAMES val frames one at a time through Cascade.from_engine.
REPRO_N_VAL, REPRO_CTX, REPRO_EPOCHS, REPRO_STREAM_EPOCHS = 400, 400, 20, 10
REPRO_MICRO_BATCH = 16  # streaming_multi_edge_study's micro-batch
REPRO_CASCADE_FRAMES = 64
REPRO_SHORT_EPOCHS = 2  # train_estimators held card against CPU
# The unbounded heads' out-of-fold predictions are also held within this
# many float32 ulps of the size of their last layer's summands (see
# hold_estimators): the deterministic bound of an (n+1)-term float32 sum is
# ~n+1 of them, n = 128 (the last hidden width).
SUMMAND_ULPS = 128


def record_engines(tdr):
    """Swap ``tdr.OffloadEngine`` for a subclass that lists every engine it
    fits, in fit order; returns the list and the function that restores it."""
    engines, base = [], tdr.OffloadEngine

    class Recorded(base):
        def fit(self, *args, **kwargs):
            engines.append(self)
            return super().fit(*args, **kwargs)

    tdr.OffloadEngine = Recorded

    def restore():
        tdr.OffloadEngine = base

    return engines, restore


def summand_scale(torch, engine, x):
    """Per row of host features ``x``: the size of the terms that the fitted
    MLP's last layer adds up, sum_j |w_j h_j| + |b|, on the CPU.  A feature
    that is constant over the training folds has sigma 1e-6, so a held-out
    row that differs there is standardized to ~1e6; its prediction is then
    a difference of terms ~1e5 that float32 rounds at ~1e-2 however small
    the result."""
    est = engine.reward_model.estimator
    h = torch.as_tensor((x - est._mu) / est._sigma, dtype=torch.float32)
    layers = [{k: v.detach().cpu() for k, v in est.params[f"layer{i}"].items()}
              for i in range(len(est.params))]
    for p in layers[:-1]:
        h = torch.nn.functional.gelu(h @ p["w"] + p["b"], approximate="tanh")
    last = layers[-1]
    return ((h * last["w"][:, 0]).abs().sum(1) + last["b"].abs()).numpy()


def hold_estimators(torch, what, got, want, tol, engines, fold_ix, x):
    """Two ``train_estimators`` runs of the same state (``got`` on the card,
    ``want`` on the CPU) with the engines each fitted, in fit order (head by
    head, fold by fold).  Each fold's weights agree within ``tol``; the
    bounded (sigmoid) heads' out-of-fold predictions within ``tol``; the two
    unbounded heads' within ``tol`` of 1 + their size plus SUMMAND_ULPS
    float32 ulps of the size of the last layer's summands, from the CPU's
    engine (``summand_scale``).  Returns the largest weight gap, each head's
    largest gap and, for the unbounded heads, the largest gap in ulps of
    that size, the rows where it is over 1e3 and the largest gap elsewhere."""
    got_engines, want_engines = engines
    folds = int(fold_ix.max()) + 1
    weight_gap = 0.0
    for a, b in zip(got_engines, want_engines, strict=True):
        pa, pb = a.reward_model.estimator.params, b.reward_model.estimator.params
        for name, layer in pb.items():
            for k, v in layer.items():
                weight_gap = max(weight_gap, float((pa[name][k].cpu() - v).abs().max()))
    if not weight_gap <= tol:
        fail(f"{what}: the fitted weights differ by {weight_gap} (tolerance {tol})")
    gaps, per_summand = {"weights": weight_gap}, {}
    for h, (k, v) in enumerate(want.preds.items()):
        err = np.abs(got.preds[k] - v)
        gaps[k] = float(err.max())
        bound = np.full(len(v), tol)
        if k in ("ORIC_vanilla", "ORI"):
            scale = np.zeros(len(v))
            for f in range(folds):
                te = fold_ix == f
                scale[te] = summand_scale(torch, want_engines[h * folds + f], x[te])
            bound += tol * np.abs(v) + SUMMAND_ULPS * 2.0 ** -24 * scale
            large = scale > 1e3
            per_summand[k] = {
                "ulps_of_summands": float((err / np.maximum(scale, 1e-30)).max() * 2.0 ** 24),
                "rows_summands_over_1e3": int(large.sum()),
                "max_gap_other_rows": float(err[~large].max()) if (~large).any() else 0.0,
            }
        bad = np.flatnonzero(err > bound)
        if len(bad):
            i = int(bad[np.argmax(err[bad])])
            fail(f"{what}: {k} differs by {err[i]} at row {i} (value {v[i]}, "
                 f"tolerance {bound[i]})")
    return dict(gaps, unbounded=per_summand)


def repro(torch, smi, dev):
    """The paper's experiments on the card, counted: ``run_all(quick=True)``
    into a temporary cache dir, then on its state ``figure7_input_study``,
    ``train_estimators`` again (as a caller of ``token_bucket_study`` does)
    and ``token_bucket_study``, and the first val frames one at a time
    through ``Cascade.from_engine`` (WEAK + NMS, the engine's one-frame
    ``score_pipeline`` launch, STRONG when offloaded).  Then, outside the
    count: the matching on the card against the CPU (exact), the Adaptive
    Feeding SVM and a short ``train_estimators`` against the CPU, the
    repeated estimators against run_all's, the curves at ratio 1.0 against
    the strong detector's mAP, the oracle against random, and the cascade
    against ``engine.decide``.  Returns the launches of the counted run and
    their split."""
    from repro_torch.core import AdaptiveFeedingSVM, Cascade, cascade_map, match_pairs_batched
    from repro_torch.core import ori_batch, topk_offload_mask
    from repro_torch.data.shapes import ShapesDataset
    from repro_torch.experiments import detection_repro as tdr
    from repro_torch.kernels.estimator_mlp import estimator_mlp
    from repro_torch.kernels.flash_sdpa import flash_sdpa
    from repro_torch.kernels.iou_matrix import iou_matrix, iou_matrix_batch
    from repro_torch.kernels.score_pipeline import score_pipeline
    from repro_torch.kernels.wkv6 import wkv6
    from repro_torch.models.detector import STRONG, WEAK, decode_batch

    sync = _sync(torch, dev)
    stage: Dict[str, float] = {}

    def timed(name, fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        stage[name] = stage.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
        return out

    counters = (iou_matrix, iou_matrix_batch, estimator_mlp, score_pipeline, flash_sdpa, wkv6)
    with tempfile.TemporaryDirectory() as cache:
        t_phase = time.perf_counter()
        reset_counts(counters)
        results = tdr.run_all(quick=True, force=True, device=dev, cache_dir=cache, stage_ms=stage)
        state = timed("load_state_ms", lambda: tdr.build_pipeline(device=dev, cache_dir=cache))
        fig7 = timed("figure7_ms", lambda: tdr.figure7_input_study(
            state, context_size=REPRO_CTX, n_val=len(state.val_pairs), device=dev,
            cache_dir=cache))
        bundle = timed("train_estimators_again_ms", lambda: tdr.train_estimators(
            state, context_size=REPRO_CTX, epochs=REPRO_EPOCHS, device=dev))
        token_bucket = timed("token_bucket_ms", lambda: tdr.token_bucket_study(state, bundle))
        # -- the cascade, a frame at a time: the streaming study's engine
        engine = timed("cascade_engine_ms", lambda: tdr.build_engine(
            state, context_size=REPRO_CTX, epochs=REPRO_STREAM_EPOCHS, device=dev))
        weak = tdr.load_detector(WEAK, device=dev, cache_dir=cache)
        strong = tdr.load_detector(STRONG, device=dev, cache_dir=cache)
        images = ShapesDataset.generate(REPRO_CASCADE_FRAMES, seed=1).images  # val's first frames
        cascade = Cascade.from_engine(lambda i: decode_batch(weak, images[i : i + 1]),
                                      lambda i: decode_batch(strong, images[i : i + 1]), engine)
        records = timed("cascade_ms", lambda: cascade.run(range(REPRO_CASCADE_FRAMES)))
        sync()
        phase_s = time.perf_counter() - t_phase
        launches = {c.__name__: c.launches for c in counters}
        split = split_counts(counters)
        results_file = Path(cache) / "torch_repro_results.json"
        if json.loads(results_file.read_text()) != json.loads(json.dumps(results)):
            fail(f"{results_file.name} differs from run_all's return value")

    # -- checks, outside the count
    checks = {}
    # the matching on the card (one match launch a call) against the CPU
    card = match_pairs_batched(state.weak_dets_val, state.strong_dets_val, state.val_gts,
                               device=dev)
    host = match_pairs_batched(state.weak_dets_val, state.strong_dets_val, state.val_gts,
                               device="cpu")
    for a, b in zip(card, host):
        for ea, eb in ((a.weak, b.weak), (a.strong, b.strong)):
            if ea.gt_counts != eb.gt_counts or sorted(ea.per_class) != sorted(eb.per_class) \
                    or any(not np.array_equal(ea.per_class[c][1], eb.per_class[c][1])
                           or not np.array_equal(ea.matched_gt[c], eb.matched_gt[c])
                           for c in eb.per_class):
                fail("match_pairs_batched on the card differs from the CPU (tp / match_gt)")
    checks["match_card_vs_cpu_equal"] = len(card)
    # the Adaptive Feeding SVM: card against CPU
    difficult = ori_batch(state.val_pairs) > 0
    svm = [AdaptiveFeedingSVM(c_plus=1.0, epochs=60, device=d).fit(state.features_val, difficult)
           for d in (dev, "cpu")]
    svm_err = float(np.abs(svm[0].w - svm[1].w).max())
    if not svm_err <= 1e-4 or abs(svm[0].b - svm[1].b) > 1e-4:
        fail(f"AdaptiveFeedingSVM on the card vs the CPU: weights differ by {svm_err}")
    checks["svm_card_vs_cpu_max_abs_err"] = svm_err
    # a short train_estimators: card against CPU
    short, fitted = [], []
    for d in (dev, "cpu"):
        engines, restore = record_engines(tdr)
        try:
            short.append(tdr.train_estimators(state, context_size=REPRO_CTX,
                                              epochs=REPRO_SHORT_EPOCHS, device=d))
        finally:
            restore()
        fitted.append(engines)
    fold_rng = np.random.default_rng(0)  # train_estimators' folds: its seed, its draws
    tdr._oric_and_ori(state, REPRO_CTX, fold_rng)
    fold_ix = np.arange(len(state.val_pairs)) % 5
    fold_rng.shuffle(fold_ix)
    checks["estimators_card_vs_cpu"] = hold_estimators(
        torch, "train_estimators on the card vs the CPU", short[0], short[1], SHORT_FIT_TOL,
        fitted, fold_ix, state.features_val)
    # the estimators again: the card repeats run_all's fit bit for bit
    curves = results["figure9_10"]["curves"]
    ratios = results["figure9_10"]["ratios"]
    for k, preds in bundle.preds.items():
        again = [cascade_map(state.val_pairs, topk_offload_mask(preds, r)) for r in ratios]
        if again != curves[f"est_{k}"]["map"]:
            fail(f"train_estimators repeated on the card gives another est_{k} curve")
    # every curve at ratio 1.0 is the strong detector's mAP; the oracle
    # beats random below it
    full = ratios.index(1.0)
    gaps = {k: abs(c["map"][full] - results["strong_map"]) for k, c in curves.items()}
    if max(gaps.values()) > 1e-9:
        fail(f"curves at ratio 1.0 differ from strong_map {results['strong_map']}: {gaps}")
    below = [(r, o, q) for r, o, q in zip(ratios, curves["oracle_ORIC"]["map"],
                                          curves["random"]["map"]) if r < 1.0 and o < q]
    if below:
        fail(f"oracle_ORIC below random at (ratio, oracle, random) {below}")
    checks.update(curves_at_1_max_gap=max(gaps.values()), oracle_above_random=True)
    # the cascade, frame by frame, against the engine on the same detections
    blocks = [r.weak_output for r in records]
    want = engine.decide(features=torch.cat([engine.features(b) for b in blocks]))
    checks["cascade_vs_decide"] = hold_flips(
        "Cascade.from_engine vs engine.decide", np.array([r.estimate for r in records]),
        np.array([r.offloaded for r in records]), want.estimates.astype(np.float64),
        np.full(len(records), engine.policy.threshold))

    af = results["figure9_10"]["adaptive_feeding"]
    emit("repro", {
        "quick": True, "n_val": len(state.val_pairs), "context_size": REPRO_CTX,
        "weak_map": results["weak_map"], "strong_map": results["strong_map"],
        "figure9_10": {"ratios": ratios, "curves": {k: c["map"] for k, c in curves.items()},
                       "adaptive_feeding": [(p["c_plus"], p["ratio"], p["map"]) for p in af],
                       "dcsb": results["figure9_10"]["dcsb"]},
        "figure5": results["figure5"]["curves"], "table2": results["table2"],
        "figure6": {k: {c: v[c] for c in ("base_map", "cls", "loc", "cls_loc", "dupe", "bkg",
                                           "miss")} for k, v in results["figure6"].items()},
        "figure7": fig7["curves"], "token_bucket": token_bucket,
        "streaming_multi_edge": {k: results["streaming_multi_edge"][k] for k in (
            "decided_ratio", "served_ratio", "map_served", "map_unconstrained")},
        "cascade": {"frames": len(records), "offload_ratio": cascade.offload_ratio(records)},
        "checks": checks, "stage_s": {k.removesuffix("_ms") + "_s": v / 1e3
                                      for k, v in stage.items()},
        "phase_s": phase_s, "launches": launches, "card": smi,
    })
    return launches, split


# --------------------------------------------------------------- the temporal layer

# The video phase: default_video_scenario and default_shift_scenario at their
# defaults (8 streams x 96 frames behind a congested 3-edge fleet; 4 x 160
# with the weak detector's hard classes flipping at frame 64), each engine
# fitted on the card from its 4 x 48 calibration clip.
VIDEO_STREAMS, VIDEO_FRAMES, VIDEO_RATIO = 8, 96, 0.3
VIDEO_THRESHOLD_RATIOS = (0.21, 0.24, 0.27, 0.30, 0.33)  # tests/test_video.py's headline grid
SHIFT_STREAMS, SHIFT_FRAMES = 4, 160
VIDEO_F, VIDEO_HIDDEN = 132, 32  # DetectionBoxFeatures(8 classes, top_k 8), hidden=(32,)
VIDEO_CAL_ROWS = 4 * 48  # both scenarios' calibration clips
VIDEO_TRACK_TOL = 1e-6  # the card's tracker against the CPU's: boxes, vel, conf
VIDEO_EST_TOL = 1e-5  # estimates of one engine on the card and on the CPU (the MLP tolerance)
VIDEO_REPLAY_BLOCKS = 30  # observation blocks of 6 replayed from an adaptive checkpoint
VIDEO_PATH_KERNELS = ("iou_matrix_batch", "estimator_mlp")  # each must launch in the video phase
TRACK_INT_FIELDS = ("ids", "active", "classes", "age", "det_track",
                    "n_active", "n_matched", "n_new", "n_dead")
# aten ops that make a view (no kernel): the rest of a tracker step's ops launch one each
VIEW_OPS = ("view", "_unsafe_view", "unsqueeze", "squeeze", "select", "slice", "expand", "alias",
            "t", "transpose", "permute", "as_strided", "unbind", "detach", "lift_fresh")


def first_flip(got, want):
    """Two ``VideoFleetTrace``s of one scenario, record by record in serve
    order (frame-major, the streams of a frame in turn): the largest
    estimate gap up to the first record that differs in anything but the
    estimate, and that record's (frame, stream) and estimate gap, or None
    where all are equal.  Fails if the first difference is not a flipped
    decision: up to a flip the two runs saw the same frames."""
    gap = 0.0
    for t in range(want.n_frames):
        for b, (gs, ws) in enumerate(zip(got.streams, want.streams)):
            g, w = gs.records[t].as_dict(), ws.records[t].as_dict()
            e = abs(g.pop("estimate") - w.pop("estimate"))
            if g != w:
                if g["offload"] == w["offload"]:
                    fail(f"video card vs CPU: frame {t} stream {b} differs before any flip: "
                         f"{g} vs {w}")
                return {"max_abs_err": gap, "first_flip": [t, b], "flip_estimate_gap": e}
            gap = max(gap, e)
    return {"max_abs_err": gap, "first_flip": None, "flip_estimate_gap": None}


def hold_staleness(what, trace, max_stale):
    """``tests/test_video.py``'s serve semantics on a trace: every record
    scored, staleness exactly on the frames served from an edge result and
    within ``max_stale``, telemetry that counts them, no frame covered
    before an offload came back, and over a fifth of the frames covered."""
    covered = 0
    for s in trace.streams:
        for r in s.records:
            edge = r.source == "edge"
            ok = r.effective_accuracy is not None and 0.0 <= r.effective_accuracy <= 1.0 \
                and (r.staleness is not None) == edge and r.source in ("edge", "weak") \
                and (not edge or 0.0 <= r.staleness <= max_stale)
            if not ok:
                fail(f"{what}: record {r.as_dict()} breaks the serve semantics")
            covered += edge
        tel = s.telemetry
        if tel.effective_frames != len(s.records) or \
                tel.covered_frames != sum(r.source == "edge" for r in s.records):
            fail(f"{what}: telemetry counts {tel} disagree with the records")
    first = min((r.step for s in trace.streams for r in s.records if r.source == "edge"),
                default=0)
    frac = trace.summary()["staleness"]["covered_fraction"]
    if not covered or first == 0 or frac <= 0.2:
        fail(f"{what}: covered {covered} frames from frame {first}, fraction {frac}")
    return frac


def video(torch, smi, dev):
    """The temporal layer on the card, counted: ``default_video_scenario``
    at its defaults (engine fitted on the card), ``temporal_hysteresis`` at
    0.3 twice (once through ``VideoRuntime`` under ``Obs`` for the
    ``video.*`` spans, once through ``run_video_scenario``), ``keyframe``,
    ``threshold`` over the headline's five target ratios; then
    ``default_shift_scenario`` and its frozen and adaptive arms.  Then,
    outside the count: the tracker on the card against the CPU's, a CPU
    serve of the card-fitted engine against the card's, the two card runs
    bit for bit, the serve semantics, the adaptive arm's updates and its
    checkpoint replayed bit for bit on the card, and one tracker step's host
    time.  Returns the launches of the counted run and their split."""
    from repro_torch.api import OffloadEngine
    from repro_torch.kernels.estimator_mlp import estimator_mlp
    from repro_torch.kernels.flash_sdpa import flash_sdpa
    from repro_torch.kernels.iou_matrix import iou_matrix, iou_matrix_batch
    from repro_torch.kernels.score_pipeline import score_pipeline
    from repro_torch.kernels.wkv6 import wkv6
    from repro_torch.obs import Obs
    from repro_torch.online import AdaptiveEngine, default_shift_scenario, run_shift_scenario
    from repro_torch.video import (
        VideoRuntime,
        VideoTracker,
        default_video_scenario,
        run_video_scenario,
        track_clip,
        track_clip_ref,
    )

    sync = _sync(torch, dev)
    stage: Dict[str, float] = {}

    def timed(name, fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        stage[name] = stage.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
        return out

    counters = (iou_matrix, iou_matrix_batch, estimator_mlp, score_pipeline, flash_sdpa, wkv6)
    t_phase = time.perf_counter()
    reset_counts(counters)
    scenario = timed("video_scenario_ms", lambda: default_video_scenario(
        VIDEO_STREAMS, VIDEO_FRAMES, device=dev))
    obs = Obs(metrics=False, tracing=False)
    engine = scenario.engine.with_policy("temporal_hysteresis", ratio=VIDEO_RATIO)
    runtime = VideoRuntime(engine, scenario.fleet(), strategy="least_loaded",
                           seed=scenario.seed, obs=obs)
    hyst = timed("serve_clip_ms", lambda: runtime.serve_clip(
        scenario.weak, scenario.strong, scenario.clip, ratio=VIDEO_RATIO,
        max_stale=scenario.max_stale))
    serve_s = stage["serve_clip_ms"] / 1e3
    again = timed("run_video_scenario_ms", lambda: run_video_scenario(
        scenario, "temporal_hysteresis", ratio=VIDEO_RATIO))
    key = timed("run_video_scenario_ms", lambda: run_video_scenario(
        scenario, "keyframe", ratio=VIDEO_RATIO))
    thresh = [timed("run_video_scenario_ms", lambda: run_video_scenario(
        scenario, "threshold", ratio=r)) for r in VIDEO_THRESHOLD_RATIOS]
    shift = timed("shift_scenario_ms", lambda: default_shift_scenario(device=dev))
    frozen = timed("shift_frozen_ms", lambda: run_shift_scenario(shift))
    adaptive = timed("shift_adaptive_ms", lambda: run_shift_scenario(shift, adaptive=True))
    sync()
    phase_s = time.perf_counter() - t_phase
    launches = {c.__name__: c.launches for c in counters}
    split = split_counts(counters)
    for c in split.values():  # reset_counts keeps the keys of earlier phases at 0
        c["by_shape"] = {k: n for k, n in c.get("by_shape", {}).items() if n}
    spans = obs.profiler.report()

    # -- checks, outside the count
    checks = {}
    if split["iou_matrix_batch"]["by_route"]["matrix"] == 0:
        fail(f"the video path launched no matrix route: {split['iou_matrix_batch']}")
    # the tracker on the card against the CPU's (and the numpy reference)
    card = track_clip(scenario.weak, device=dev)
    host = track_clip(scenario.weak, device="cpu")
    for ref_name, ref in (("cpu", host), ("track_clip_ref", track_clip_ref(scenario.weak))):
        for f in TRACK_INT_FIELDS:
            if not np.array_equal(getattr(card, f), getattr(ref, f)):
                fail(f"the tracker on the card differs from {ref_name} in {f}")
        gap = max(float(np.abs(getattr(card, f) - getattr(ref, f)).max())
                  for f in ("boxes", "vel", "conf"))
        if not gap <= VIDEO_TRACK_TOL:
            fail(f"the tracker on the card: boxes/vel/conf differ from {ref_name} by {gap}")
        checks[f"tracker_card_vs_{ref_name}_max_abs_err"] = gap
    # two card runs of one policy: bit for bit
    for s1, s2 in zip(hyst.streams, again.streams):
        if s1.records != s2.records:
            fail("two card runs of temporal_hysteresis differ")
    checks["card_runs_bit_identical"] = True
    # a CPU serve of the card-fitted engine (its artifact) against the card's
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "video_engine")
        scenario.engine.save(path)
        cpu_scenario = dataclasses.replace(scenario, engine=OffloadEngine.load(path, device="cpu"))
    cpu_run = run_video_scenario(cpu_scenario, "temporal_hysteresis", ratio=VIDEO_RATIO)
    checks["card_vs_cpu_serve"] = first_flip(hyst, cpu_run)
    if not checks["card_vs_cpu_serve"]["max_abs_err"] <= VIDEO_EST_TOL:
        fail(f"card vs CPU serve: estimates differ by {checks['card_vs_cpu_serve']}")
    checks["covered_fraction"] = hold_staleness("temporal_hysteresis on the card", hyst,
                                                scenario.max_stale)
    # the adaptive arm adapted; its checkpoint replays bit for bit on the card
    up = adaptive.updates
    if not (up["incremental_updates"] > 0 and up["refits"] > 0):
        fail(f"the adaptive arm made no incremental update or refit: {up}")
    ada = adaptive.adaptive
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "adaptive.npz")
        ada.save(path)
        back = AdaptiveEngine.load(path, device=dev)
    x_host = shift.features.cpu().numpy()
    rng = np.random.default_rng(0)
    blocks = [(rng.integers(0, len(x_host), 6), rng.uniform(0, 1, 6), rng.uniform(-0.5, 1.5, 6))
              for _ in range(VIDEO_REPLAY_BLOCKS)]
    before = (ada.refits, ada.incremental_updates)
    for arm in (ada, back):
        for idx, est, rw in blocks:
            arm.observe(x_host[idx], est, rw)
            arm.maybe_update()
    if (back.refits, back.incremental_updates) != (ada.refits, ada.incremental_updates) or \
            ada.refits == before[0] or ada.incremental_updates == before[1]:
        fail(f"adaptive replay: updates {before} -> {(ada.refits, ada.incremental_updates)} "
             f"and {(back.refits, back.incremental_updates)}")
    pa, pb = ada.engine.reward_model.estimator.params, back.engine.reward_model.estimator.params
    if not all(torch.equal(pa[n][k], pb[n][k]) for n in pa for k in pa[n]) or not np.array_equal(
            ada.engine.score(features=shift.features), back.engine.score(features=shift.features)):
        fail("the adaptive checkpoint's replay on the card is not bit-identical")
    checks["adaptive_replay_bit_identical"] = {
        "refits": [before[0], ada.refits], "incremental_updates": [before[1], ada.incremental_updates]}
    # one tracker step's host time: B streams, one step and its host copy
    tracker = VideoTracker(VIDEO_STREAMS, device=dev)
    frames = [scenario.weak.frame(t, device=dev) for t in range(VIDEO_FRAMES)]
    tracker.update(frames[0])
    sync()
    t0 = time.perf_counter()
    for fb in frames:
        tracker.update(fb)
    track_step_ms = (time.perf_counter() - t0) * 1e3 / VIDEO_FRAMES
    step_ops = aten_ops(torch, lambda: tracker.update(frames[0]))
    track_step_ops = {"aten_ops": len(step_ops),
                      "not_views": sum(op not in VIEW_OPS for op in step_ops)}

    def run_summary(tr):
        return {"realized_ratio": tr.realized_ratio(),
                "mean_effective_accuracy": tr.mean_effective_accuracy(),
                "covered_fraction": tr.staleness_profile()["covered_fraction"]}

    emit("video", {
        "streams": VIDEO_STREAMS, "frames": VIDEO_FRAMES,
        "headline": {
            "temporal_hysteresis": run_summary(hyst), "keyframe": run_summary(key),
            "threshold": {str(r): run_summary(tr) for r, tr in zip(VIDEO_THRESHOLD_RATIOS, thresh)},
        },
        "shift": {"frozen": frozen.summary(), "adaptive": adaptive.summary()},
        "serve_clip_s": serve_s, "serve_clip_frames_per_s": VIDEO_STREAMS * VIDEO_FRAMES / serve_s,
        "track_step_host_ms": track_step_ms, "track_step_aten_ops": track_step_ops,
        "video_spans": {k: v for k, v in spans.items() if k.startswith("video.")},
        "session_spans": {k: v for k, v in spans.items() if k.startswith("session.")},
        "checks": checks, "stage_s": {k.removesuffix("_ms") + "_s": v / 1e3
                                      for k, v in stage.items()},
        "phase_s": phase_s, "launches": launches, "launches_split": split, "card": smi,
    })
    return launches, split


def merge_split(into, split):
    """Add the by-route / by-shape counts of ``split`` into ``into``."""
    for k, parts in split.items():
        for part, counts in parts.items():
            dest = into.setdefault(k, {}).setdefault(part, {})
            for key, n in counts.items():
                dest[key] = dest.get(key, 0) + n
    return into


FLEET_SHARDS = 4  # logical shards of the one card: [cuda:0] * 4
FLEET_SCORE_B = (7, 64, 250, 2000)  # B 64: shards planned alone would run clusters of 4, not 2
FLEET_DETECT_B = (13, 250)
FLEET_MATCH_B = (13, 150, 2000)
FLEET_THRESHOLDS = (0.5, 0.75)
FLEET_ROWS, FLEET_K, FLEET_M = 2000, 64, 8  # seeded images a block, their boxes and GT boxes
CITY_STREAMS, CITY_CAL, CITY_F, CITY_HIDDEN = 1024, 4096, 12, 32  # default_city_scenario's
CITY_EST_TOL = 1e-5  # the card-fitted engine's estimates on the card and on the CPU (MLP)
FLEET_PATH_KERNELS = ("estimator_mlp", "score_pipeline", "iou_matrix_batch")  # ... in the fleet phase
MOBILE_STEPS, MOBILE_CAL, MOBILE_F, MOBILE_HIDDEN = 160, 256, 8, 16  # default_mobile_scenario's
MOBILE_IN_FLIGHT = ("survive", "die", "stale")
MOBILE_ROLLOUT_CLIENTS = 64  # clients of the two rollouts held against rollout_ref
MOBILE_WALK_TOL = 1e-3  # the random walk against rollout_ref (tests/test_mobility.py's)
MOBILE_EST_TOL = 1e-5
MOBILE_PATH_KERNELS = ("estimator_mlp",)  # ... in the mobility phase


def coordinated_kwargs(scenario):
    """The arguments ``run_city_scenario(coordinated=True)`` passes
    ``simulate_fleet`` (its defaults), for a run under ``Obs``."""
    return dict(n_shards=scenario.n_shards, ratio=0.25, redistribute_every=8.0, min_share=0.25,
                smooth=0.5, fleet_factory=scenario.fleet_factory, seed=scenario.seed)


def same_fleet_bits(what, got, want):
    """Two fleet traces record for record, bit for bit."""
    if len(got.steps) != len(want.steps):
        fail(f"{what}: {len(got.steps)} ticks against {len(want.steps)}")
    for t, (g, w) in enumerate(zip(got.steps, want.steps)):
        for f in ("estimates", "offload", "outcome", "latency"):
            if not np.array_equal(getattr(g, f), getattr(w, f), equal_nan=f == "latency"):
                fail(f"{what}: tick {t} differs in {f}")
    if got.telemetry != want.telemetry or got.budget != want.budget or \
            got.dispatcher != want.dispatcher:
        fail(f"{what}: the telemetry, budget or dispatcher report differs")


def fleet_first_flip(got, want):
    """Two fleet traces tick by tick: the largest estimate gap up to the
    first tick whose decisions differ, and that tick, or None where none
    does.  Fails if anything else differs first."""
    gap = 0.0
    for t, (g, w) in enumerate(zip(got.steps, want.steps)):
        gap = max(gap, float(np.abs(g.estimates - w.estimates).max()))
        if not np.array_equal(g.offload, w.offload):
            return {"max_abs_err": gap, "first_flip_tick": t,
                    "flipped_streams": int((g.offload != w.offload).sum())}
        if not (np.array_equal(g.outcome, w.outcome)
                and np.array_equal(g.latency, w.latency, equal_nan=True)):
            fail(f"fleet card vs CPU: tick {t} differs before any flip")
    return {"max_abs_err": gap, "first_flip_tick": None, "flipped_streams": 0}


def fleet_plane_checks(torch, dev, plane, engine, x, blocks, gts):
    """The plane over ``plane``'s devices against the single-device calls:
    ``score`` at FLEET_SCORE_B, ``score_detections`` at FLEET_DETECT_B,
    ``match`` at FLEET_MATCH_B and ``extract_features``, each bit for bit;
    and ``score`` (within 1e-5), ``score_detections`` (2e-6) and ``match``
    (exactly) against the plain versions on the same inputs."""
    from repro_torch.core.features import extract_features_batch
    from repro_torch.detection.batch import match_batch
    from repro_torch.kernels.estimator_mlp import estimator_mlp_ref
    from repro_torch.kernels.iou_matrix import greedy_match_ref
    from repro_torch.kernels.score_pipeline import score_pipeline_ref

    def block(batch, B):
        return type(batch)(**{f.name: getattr(batch, f.name)[:B]
                              for f in dataclasses.fields(batch)})

    def plain(what, B, got, want, tol):
        e = float(np.abs(got - want.cpu().numpy()).max())
        if not (got.shape == tuple(want.shape) and np.isfinite(e) and e <= tol):
            fail(f"FleetPlane over {plane.devices}: {what} at B {B} differs from the plain "
                 f"version by {e} (tolerance {tol})")
        out[f"{what}_max_abs_err"] = max(out.get(f"{what}_max_abs_err", 0.0), e)

    out = {}
    p = engine.reward_model.pipeline_params()
    head = (p["w1"], p["b1"], p["w2"], p["b2"])
    for B in FLEET_SCORE_B:
        got = plane.score(engine, x[:B])
        if not np.array_equal(got, engine.score(features=x[:B])):
            fail(f"FleetPlane over {plane.devices}: score at B {B} is not engine.score")
        xt = torch.tensor(x[:B], device=dev)
        if engine.reward_model.config.standardize:  # as predict_device does
            xt = (xt - p["mu"]) / p["sigma"]
        plain("score", B, got, estimator_mlp_ref(xt, *head), 1e-5)
    for B in FLEET_DETECT_B:
        db = block(blocks, B)
        got = plane.score_detections(engine, db)
        if not np.array_equal(got, engine.score_device(db).cpu().numpy()):
            fail(f"FleetPlane over {plane.devices}: score_detections at B {B} is not "
                 "engine.score_device")
        plain("score_detections", B, got, score_pipeline_ref(
            db.boxes, db.scores, db.classes, db.mask, *head, p["mu"], p["sigma"], IMAGE_SIZE,
            NUM_CLASSES, TOP_K), 2e-6)
        if not np.array_equal(plane.extract_features(db, NUM_CLASSES, TOP_K, IMAGE_SIZE),
                              extract_features_batch(db, NUM_CLASSES, TOP_K,
                                                     IMAGE_SIZE).cpu().numpy()):
            fail(f"FleetPlane over {plane.devices}: extract_features at B {B} differs")
    for B in FLEET_MATCH_B:
        db, gb = block(blocks, B), block(gts, B)
        got, want = plane.match(db, gb, FLEET_THRESHOLDS), match_batch(db, gb, FLEET_THRESHOLDS)
        if not (np.array_equal(got.tp, want.tp) and np.array_equal(got.match_gt, want.match_gt)):
            fail(f"FleetPlane over {plane.devices}: match at B {B} is not match_batch")
        tp, mj = greedy_match_ref(db.boxes, db.scores, db.classes, db.mask, gb.boxes, gb.classes,
                                  gb.mask, torch.tensor(FLEET_THRESHOLDS, device=dev))
        if not (np.array_equal(got.tp, tp.cpu().numpy())
                and np.array_equal(got.match_gt, mj.cpu().numpy())):
            fail(f"FleetPlane over {plane.devices}: match at B {B} is not the plain version")
        out[f"match_B{B}_tp"] = int(want.tp.sum())
    out["devices"] = [str(d) for d in plane.devices]
    return out


def fleet(torch, smi, dev):
    """The city-scale fleet on the card, counted: the sharded plane over
    four logical shards of the card (a fused engine at F 387, H 128 fitted
    on the card; ``score``, ``score_detections``, ``match``,
    ``extract_features``, each against its single-device call), then
    ``default_city_scenario()`` at its defaults fitted on the card and
    ``run_city_scenario`` coordinated and static on the default plane, the
    coordinated arm again over the four-shard plane and once more under
    ``Obs``.  Then, outside the count: the traces against each other bit for
    bit, a CPU run of the card-fitted engine's artifact, the plane over
    every card where there are several, and the headline of
    ``tests/test_fleet.py``.  Returns the launches of the counted run and
    their split."""
    from repro_torch.api import DetectionBoxFeatures, MLPRewardModel, OffloadEngine
    from repro_torch.core.estimator import EstimatorConfig
    from repro_torch.core.features import extract_features_batch
    from repro_torch.detection.batch import DetectionsBatch, GroundTruthBatch
    from repro_torch.fleet import (
        FleetPlane,
        default_city_scenario,
        run_city_scenario,
        simulate_fleet,
    )
    from repro_torch.kernels.estimator_mlp import estimator_mlp
    from repro_torch.kernels.flash_sdpa import flash_sdpa
    from repro_torch.kernels.iou_matrix import iou_matrix, iou_matrix_batch
    from repro_torch.kernels.score_pipeline import score_pipeline
    from repro_torch.kernels.wkv6 import wkv6
    from repro_torch.launch.mesh import make_fleet_mesh
    from repro_torch.obs import Obs, kernel_stats

    sync = _sync(torch, dev)
    stage: Dict[str, float] = {}

    def timed(name, fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        stage[name] = stage.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
        return out

    rng = np.random.default_rng(20)

    def detections(B):
        boxes, scores, classes, mask = seeded_block(torch, rng, B, FLEET_K, dev, empty_rows=B // 16)
        return DetectionsBatch(boxes=boxes, scores=scores, classes=classes, mask=mask)

    def ground_truth(B):
        boxes, _, classes, mask = seeded_block(torch, rng, B, FLEET_M, dev)
        return GroundTruthBatch(boxes=boxes, classes=classes, mask=mask)

    counters = (iou_matrix, iou_matrix_batch, estimator_mlp, score_pipeline, flash_sdpa, wkv6)
    t_phase = time.perf_counter()
    reset_counts(counters)
    calls0 = dict(kernel_stats.CALLS)
    # the plane: a fused engine at the deployable head, fitted on the card
    cal = extract_features_batch(detections(FLEET_ROWS), NUM_CLASSES, TOP_K, IMAGE_SIZE)
    engine = OffloadEngine(
        feature_extractor=DetectionBoxFeatures(num_classes=NUM_CLASSES, top_k=TOP_K,
                                               image_size=IMAGE_SIZE, device=dev),
        reward_model=MLPRewardModel(config=EstimatorConfig(hidden=(HIDDEN,), epochs=2),
                                    device=dev))
    timed("plane_fit_ms", lambda: engine.fit(features=cal, rewards=rng.uniform(0, 1, FLEET_ROWS)))
    blocks, gts = detections(FLEET_ROWS), ground_truth(FLEET_ROWS)
    x = extract_features_batch(blocks, NUM_CLASSES, TOP_K, IMAGE_SIZE).cpu().numpy()
    plane4 = FleetPlane(make_fleet_mesh(devices=[dev] * FLEET_SHARDS))
    checks = {"plane_logical_shards": timed("plane_checks_ms", lambda: fleet_plane_checks(
        torch, dev, plane4, engine, x, blocks, gts))}
    # the city
    scenario = timed("city_scenario_ms", lambda: default_city_scenario(device=dev))
    coord = timed("city_coordinated_ms", lambda: run_city_scenario(scenario, coordinated=True))
    static = timed("city_static_ms", lambda: run_city_scenario(scenario, coordinated=False))
    sharded = timed("city_sharded_ms", lambda: run_city_scenario(
        scenario, coordinated=True, plane=plane4))
    obs = Obs(metrics=False, tracing=False)
    t0 = time.perf_counter()
    again = simulate_fleet(scenario.engine, scenario.features, obs=obs,
                           **coordinated_kwargs(scenario))
    sync()
    traced_s = time.perf_counter() - t0
    sync()
    phase_s = time.perf_counter() - t_phase
    launches = {c.__name__: c.launches for c in counters}
    split = split_counts(counters)
    for c in split.values():
        c["by_shape"] = {k: n for k, n in c.get("by_shape", {}).items() if n}
    calls = {k: n - calls0.get(k, 0) for k, n in kernel_stats.CALLS.items()}
    spans = obs.profiler.report()

    # -- checks, outside the count
    same_fleet_bits("the coordinated arm over four logical shards", sharded.trace, coord.trace)
    same_fleet_bits("a second coordinated run", again, coord.trace)
    checks["sharded_plane_bit_identical"] = checks["second_run_bit_identical"] = True
    if torch.cuda.device_count() > 1:
        checks["plane_every_card"] = fleet_plane_checks(
            torch, dev, FleetPlane(make_fleet_mesh()), engine, x, blocks, gts)
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "city_engine")
        scenario.engine.save(path)
        cpu_scenario = dataclasses.replace(scenario, engine=OffloadEngine.load(path, device="cpu"))
    cpu_run = timed("city_cpu_ms", lambda: run_city_scenario(cpu_scenario, coordinated=True))
    checks["card_vs_cpu"] = fleet_first_flip(coord.trace, cpu_run.trace)
    if not checks["card_vs_cpu"]["max_abs_err"] <= CITY_EST_TOL:
        fail(f"city card vs CPU: estimates differ by {checks['card_vs_cpu']}")
    tel, stel = coord.trace.telemetry, static.trace.telemetry
    headline = {  # tests/test_fleet.py's asserts, on the card's own fit: reported
        "equal_budget_within_0.02": abs(coord.realized_ratio() - static.realized_ratio()) <= 0.02,
        "coordinated_beats_static": coord.mean_effective() > static.mean_effective(),
        "redistributions_at_least_2": tel.budget_redistributions >= 2,
        "hardest_up_easiest_down": tel.shard_shares[-1] > 0.25 > tel.shard_shares[0],
        "hardest_ratio_above_easiest": tel.shard_ratios[-1] > tel.shard_ratios[0],
        "static_split_unmoved": stel.shard_shares == (0.25,) * 4,
    }
    ticks = len(coord.trace.steps)
    emit("fleet", {
        "streams": scenario.n_streams, "ticks": scenario.n_ticks, "shards": scenario.n_shards,
        "plane_shards": FLEET_SHARDS,
        "coordinated": coord.summary(), "static": static.summary(), "headline": headline,
        "ticks_per_s": {k.removesuffix("_ms"): ticks / (stage[k] / 1e3) for k in
                        ("city_coordinated_ms", "city_static_ms", "city_sharded_ms")}
        | {"under_obs": ticks / traced_s},
        "tick_host_ms_by_phase": {k: v["total_ms"] / ticks for k, v in spans.items()},
        "tick_host_ms": traced_s * 1e3 / ticks,
        "checks": checks, "stage_s": {k.removesuffix("_ms") + "_s": v / 1e3
                                      for k, v in stage.items()},
        "site_calls": calls, "phase_s": phase_s, "launches": launches, "launches_split": split,
        "card": smi,
    })
    return launches, split


def mobile_first_flip(got, want):
    """Two mobile traces record by record (step-major): the largest estimate
    gap up to the first flipped decision, and its (step, client)."""
    gap = 0.0
    for g, w in zip(got.records, want.records):
        g, w = g.as_dict(), w.as_dict()
        e = abs(g.pop("estimate") - w.pop("estimate"))
        if g != w:
            if g["offload"] == w["offload"]:
                fail(f"mobility card vs CPU: {g} differs from {w} before any flip")
            return {"max_abs_err": gap, "first_flip": [g["step"], g["client"]],
                    "flip_estimate_gap": e}
        gap = max(gap, e)
    return {"max_abs_err": gap, "first_flip": None, "flip_estimate_gap": None}


def mobility(torch, smi, dev):
    """Client mobility on the card, counted: both motion models rolled out
    on the card, ``default_mobile_scenario()`` at its defaults fitted on the
    card, ``run_mobile_scenario`` under ``Obs`` in handover and static mode
    and the handover mode under the two other in-flight semantics.  Then,
    outside the count: the rollouts against ``rollout_ref`` and repeated,
    the handover run repeated bit for bit, a CPU serve of the card-fitted
    artifact on the card's positions, and the headline of
    ``tests/test_mobility.py``.  Returns the launches of the counted run and
    their split."""
    from repro_torch.api import OffloadEngine
    from repro_torch.kernels.estimator_mlp import estimator_mlp
    from repro_torch.kernels.flash_sdpa import flash_sdpa
    from repro_torch.kernels.iou_matrix import iou_matrix, iou_matrix_batch
    from repro_torch.kernels.score_pipeline import score_pipeline
    from repro_torch.kernels.wkv6 import wkv6
    from repro_torch.mobility import (
        MobileRuntime,
        MotionConfig,
        default_mobile_scenario,
        rollout,
        rollout_ref,
        run_mobile_scenario,
    )
    from repro_torch.obs import Obs

    sync = _sync(torch, dev)
    stage: Dict[str, float] = {}

    def timed(name, fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        stage[name] = stage.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
        return out

    counters = (iou_matrix, iou_matrix_batch, estimator_mlp, score_pipeline, flash_sdpa, wkv6)
    t_phase = time.perf_counter()
    reset_counts(counters)
    scenario = timed("mobile_scenario_ms", lambda: default_mobile_scenario(device=dev))
    motions = {"waypoint": scenario.motion,
               "random_walk": dataclasses.replace(scenario.motion, model="random_walk")}
    paths = {m: timed("rollout_ms", lambda: rollout(cfg, MOBILE_ROLLOUT_CLIENTS, MOBILE_STEPS,
                                                     seed=scenario.seed, device=dev))
             for m, cfg in motions.items()}
    obs = Obs()
    handover = timed("serve_handover_ms", lambda: run_mobile_scenario(scenario, "handover",
                                                                      obs=obs))
    static = timed("serve_static_ms", lambda: run_mobile_scenario(scenario, "static", obs=Obs()))
    others = {m: timed(f"serve_{m}_ms", lambda: run_mobile_scenario(scenario, "handover",
                                                                     in_flight=m))
              for m in MOBILE_IN_FLIGHT[1:]}
    sync()
    phase_s = time.perf_counter() - t_phase
    launches = {c.__name__: c.launches for c in counters}
    split = split_counts(counters)
    for c in split.values():
        c["by_shape"] = {k: n for k, n in c.get("by_shape", {}).items() if n}
    spans = obs.profiler.report()

    # -- checks, outside the count
    checks = {}
    for m, cfg in motions.items():
        ref = rollout_ref(cfg, MOBILE_ROLLOUT_CLIENTS, MOBILE_STEPS, seed=scenario.seed)
        err = float(np.abs(paths[m] - ref).max())
        if not (err == 0.0 if m == "waypoint" else err <= MOBILE_WALK_TOL):
            fail(f"rollout ({m}) on the card differs from rollout_ref by {err}")
        if not np.array_equal(paths[m], rollout(cfg, MOBILE_ROLLOUT_CLIENTS, MOBILE_STEPS,
                                                seed=scenario.seed, device=dev)):
            fail(f"a second rollout ({m}) on the card differs")
        checks[f"rollout_{m}_max_abs_err"] = err
    again = run_mobile_scenario(scenario, "handover")
    if [r.as_dict() for r in again.records] != [r.as_dict() for r in handover.records]:
        fail("a second handover serve on the card differs")
    checks["second_serve_bit_identical"] = True
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "mobile_engine")
        scenario.engine.save(path)
        cpu_engine = OffloadEngine.load(path, device="cpu")
    cpu_scn = dataclasses.replace(scenario, engine=cpu_engine)
    cpu_run = MobileRuntime(cpu_engine, cpu_scn.coverage, cpu_scn.fleet(), motion=cpu_scn.motion,
                            mode="handover", seed=cpu_scn.seed).serve(
        cpu_scn.features, cpu_scn.weak_acc, cpu_scn.strong_acc, positions=handover.positions)
    checks["card_vs_cpu"] = mobile_first_flip(handover, cpu_run)
    if not checks["card_vs_cpu"]["max_abs_err"] <= MOBILE_EST_TOL:
        fail(f"mobility card vs CPU: estimates differ by {checks['card_vs_cpu']}")
    headline = {  # tests/test_mobility.py's asserts, on the card's own fit: reported
        "equal_realized_ratio": abs(handover.realized_ratio() - static.realized_ratio()) <= 1e-12,
        "handover_beats_static":
            handover.mean_effective_accuracy() > static.mean_effective_accuracy(),
        "handovers_only_in_handover_mode": handover.n_handovers() >= 1
            and static.n_handovers() == 0,
        "same_positions": bool(np.array_equal(handover.positions, static.positions)),
    }
    steps, clients = scenario.features.shape[:2]
    frames = steps * clients
    serve_s = stage["serve_handover_ms"] / 1e3
    emit("mobility", {
        "clients": clients, "steps": steps,
        "stations": len(scenario.coverage.stations),
        "runs": {m: {k: v for k, v in tr.summary().items() if k not in ("telemetry", "dispatcher")}
                 for m, tr in (("handover", handover), ("static", static), *others.items())},
        "handovers": {"handover": handover.n_handovers(),
                      **{m: tr.n_handovers() for m, tr in others.items()}},
        "headline": headline,
        "frames_per_s": frames / serve_s, "frame_host_ms": serve_s * 1e3 / frames,
        "session_spans": {k: v for k, v in spans.items() if k.startswith("session.")},
        "checks": checks, "stage_s": {k.removesuffix("_ms") + "_s": v / 1e3
                                      for k, v in stage.items()},
        "phase_s": phase_s, "launches": launches, "launches_split": split, "card": smi,
    })
    return launches, split


LM_ARCHS = ("qwen2_7b", "rwkv6_1b6", "deepseek_moe_16b", "deepseek_v2_lite_16b", "qwen2_vl_2b",
            "zamba2_2b7", "whisper_base")
LM_BATCH, LM_SEQ, LM_SERVED, LM_TOKENS, LM_RATIO = 8, 512, 4, 16, 0.25
LM_HIDDEN, LM_TOP_K = 64, 8
LM_REBUDGET = {16: 0.5}  # the LM stream's re-budget: request -> ratio
# bf16 keeps 8 significant bits: one rounding moves a value by up to 2^-8 of
# itself, and a rounding that falls differently in one layer (another matmul
# shape, another attention order) travels through every later layer of
# seeded weights; the LM checks hold the largest logit difference to 5% of
# the largest logit
LM_BF16_REL_TOL = 0.05
# float32: the kernels and their plain versions differ only in summation
# order (~1e-7 of each output); a wrong mask, head or state would move the
# logits by their own size
LM_F32_REL_TOL = 1e-3
# flash_sdpa's tensor-core route against the float32 plain version: atol of
# this times max |v| (the bound of rounding P to bf16), rtol 2^-7
BF16_P_ATOL = 2 ** -8


def rel_diff(got, want):
    """max |got - want| / max |want|, the absolute difference and the share
    of rows whose argmax agrees."""
    got, want = got.float(), want.float()
    err = float((got - want).abs().max())
    rel = err / max(float(want.abs().max()), 1e-30)
    return {"rel": rel, "abs": err, "argmax_agree": float((got.argmax(-1) == want.argmax(-1)).float().mean())}


def hold_rel(name, got, want, tol):
    """rel_diff, failing past ``tol`` (only measured when ``tol`` is None)."""
    out = rel_diff(got, want)
    if tol is not None and not (np.isfinite(out["rel"]) and out["rel"] <= tol):
        fail(f"{name}: max |diff| {out['abs']} is {out['rel']:.4g} of the largest logit "
             f"(tolerance {tol})")
    return out


# the keys of the kernels line that carry the times at the LM path's other shapes
EXTRA_SHAPES = {"decode": "decode", "prefill G=1": "prefill_G1", "decode G=1": "decode_G1",
                "prefill G=6": "prefill_G6", "decode G=6": "decode_G6",
                "prefill D=80": "prefill_D80", "decode D=80": "decode_D80", "simt D=80": "simt_D80",
                "whisper encoder": "whisper_encoder",
                "whisper cross prefill": "whisper_cross_prefill",
                "whisper self prefill": "whisper_self_prefill",
                "whisper cross decode": "whisper_cross_decode"}


class RoutingLog:
    """The MoE routing of every ``moe_routing`` call while the log is active
    (it wraps ``repro_torch.models.layers.moe_routing``; checks only, never
    on a counted or timed run: each call copies its routing to the host).
    ``calls`` holds each call's expert ids and kept mask, token-major (T, K).

    With ``replay`` (one (T, K) array of expert ids a call, from another
    run), each call routes its tokens to those experts instead of its top K:
    its own probabilities give the gate, and the positions and the keep mask
    follow (``layers.moe_assign``).  Two forwards of one batch then route
    alike and differ only in their arithmetic.  In bf16 a rounding that
    falls differently moves a near-tied router logit and flips a token's
    expert set; from there the two forwards compute different functions, by
    the reference's own rule.  So the logit holds of the MoE families replay
    the first run's routing in the second, and the flips of the free runs
    are counted and printed."""

    def __init__(self, replay=None):
        self.calls, self.replay = [], replay

    def __enter__(self):
        from repro_torch.models import layers

        self._layers, self._routing = layers, layers.moe_routing

        def route(params, cfg, tok, G):
            r = self._routing(params, cfg, tok, G)
            if self.replay is not None:
                ids = r.expert_ids.new_tensor(self.replay[len(self.calls)]).reshape(r.expert_ids.shape)
                r = layers.moe_assign(r.probs, ids, r.capacity, r.gate.dtype)
            K = r.expert_ids.shape[-1]
            self.calls.append((r.expert_ids.reshape(-1, K).cpu().numpy(),
                               r.keep.reshape(-1, K).cpu().numpy()))
            return r

        layers.moe_routing = route
        return self

    def __exit__(self, *exc):
        self._layers.moe_routing = self._routing

    @classmethod
    def along(cls, B, *parts):
        """One log over the tokens of ``parts`` ((log, its S) each), joined
        along the sequence call by call: the routing of a prefill and a
        decode step, as a forward over their tokens would replay it."""
        out = cls()
        for calls in zip(*(log.calls for log, _ in parts)):
            ids, keep = (np.concatenate([c[i].reshape(B, S, -1) for c, (_, S) in zip(calls, parts)], 1)
                         for i in (0, 1))
            out.calls.append((ids.reshape(-1, ids.shape[-1]), keep.reshape(-1, keep.shape[-1])))
        return out

    def replay_ids(self):
        """Each call's expert ids, token-major: a ``replay`` of this run."""
        return [ids for ids, _ in self.calls]

    def flipped(self, other, B, S):
        """(B, S) bool: the tokens whose expert set or kept set differs from
        ``other``'s in some call (None without a MoE call)."""
        if not self.calls:
            return None

        def sets(log):
            return np.stack([np.concatenate([np.sort(ids, -1), np.sort(np.where(keep, ids, -1), -1)], -1)
                             .reshape(B, S, -1) for ids, keep in log.calls])

        return (sets(self) != sets(other)).any(axis=(0, 3))

    def dropped_share(self):
        """Each call's share of dropped assignments."""
        return [float(1.0 - keep.mean()) for _, keep in self.calls]


def flip_count(flipped):
    return None if flipped is None else {"tokens_flipped": int(flipped.sum()), "tokens": int(flipped.size)}


def check_lm_kernels(torch, timer, dev):
    """flash_sdpa and wkv6 against their plain versions on the card, at the
    reference tests' cases and at the LM path's shapes; times and bounds at
    the prefill shapes."""
    import torch.nn.functional as Fn
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_sdpa import flash_sdpa, flash_sdpa_ref
    from repro_torch.kernels.wkv6 import wkv6, wkv6_ref

    rng = np.random.default_rng(4321)
    cases, err = [], {}

    def normal(shape, dtype=torch.float32, scale=1.0):
        return torch.tensor(rng.normal(0, scale, shape).astype(np.float32), device=dev).to(dtype)

    def hold(kernel, case, got, want, atol, rtol=0.0, **extra):
        _sync(torch, dev)()
        got, want = got.float(), want.float()
        e = float((got - want).abs().max())
        excess = float(((got - want).abs() - (atol + rtol * want.abs())).max())
        if got.shape != want.shape or not np.isfinite(e) or excess > 0:
            fail(f"{kernel} {case}: max abs error {e} against atol {atol} + rtol {rtol} {extra}")
        err[kernel] = max(err.get(kernel, 0.0), e)
        cases.append({"kernel": kernel, "case": case, "max_abs_err": e, "atol": atol, "rtol": rtol,
                      **extra})

    # flash_sdpa: tests/test_kernels.py's five cases in float32 (2e-6 as
    # there; the simt route), then qwen2-7b's prefill (wgmma route) and decode
    # (decode route) shapes in bf16.  The decode route computes in float32 and
    # rounds the output to bf16 once, as the plain version does: one rounding
    # apart, rtol 2^-7.  The wgmma route also rounds P to bf16 before P V,
    # which moves a row by at most 2^-8 sum_j p_j |v_j| / l <= 2^-8 max |v|
    # (checked on the CPU in tests/test_torch_flash_routes.py): atol 2^-8 max
    # |v|, rtol 2^-7
    for B, S, T, H, K, D, window, off in [
        (1, 128, 128, 2, 1, 32, 0, 0), (2, 256, 256, 4, 2, 64, 0, 0),
        (1, 100, 300, 4, 4, 32, 0, 200), (2, 256, 256, 4, 2, 64, 64, 0),
        (1, 64, 512, 8, 2, 128, 128, 448),
    ]:
        q, k, v = normal((B, S, H, D)), normal((B, T, K, D)), normal((B, T, K, D))
        hold("flash_sdpa", f"B={B} S={S} T={T} H={H} K={K} D={D} window={window} q_offset={off} f32",
             flash_sdpa(q, k, v, window=window, q_offset=off),
             flash_sdpa_ref(q, k, v, window=window, q_offset=off), 2e-6)
    B, S, H, K, D = LM_BATCH, LM_SEQ, 28, 4, 128
    C = LM_SEQ + LM_TOKENS
    bf = torch.bfloat16
    q, k, v = normal((B, S, H, D), bf), normal((B, S, K, D), bf), normal((B, S, K, D), bf)
    routes = dict(flash_sdpa.launches_by_route)
    hold("flash_sdpa", f"prefill B={B} S=T={S} H={H} K={K} D={D} bf16",
         flash_sdpa(q, k, v), flash_sdpa_ref(q, k, v), BF16_P_ATOL * float(v.float().abs().max()),
         2 ** -7)
    qd, kd, vd = normal((B, 1, H, D), bf), normal((B, C, K, D), bf), normal((B, C, K, D), bf)
    hold("flash_sdpa", f"decode B={B} S=1 T={C} q_offset={S} bf16",
         flash_sdpa(qd, kd, vd, q_offset=S), flash_sdpa_ref(qd, kd, vd, q_offset=S), 1e-6, 2 ** -7)
    taken = {r: flash_sdpa.launches_by_route[r] - n for r, n in routes.items()}
    if taken != {"wgmma": 1, "decode": 1, "decode_combine": 1, "simt": 0}:
        fail(f"flash_sdpa at qwen2-7b's prefill and decode shapes took the routes {taken}")
    # deepseek-moe-16b's attention is MHA: G = 1 (16 query heads over 16 KV
    # heads), D 128, bf16; the same routes and bounds
    H1 = K1 = 16
    q1, k1, v1 = normal((B, S, H1, D), bf), normal((B, S, K1, D), bf), normal((B, S, K1, D), bf)
    hold("flash_sdpa", f"prefill B={B} S=T={S} H={H1} K={K1} D={D} bf16 (G=1)",
         flash_sdpa(q1, k1, v1), flash_sdpa_ref(q1, k1, v1),
         BF16_P_ATOL * float(v1.float().abs().max()), 2 ** -7)
    qd1, kd1, vd1 = normal((B, 1, H1, D), bf), normal((B, C, K1, D), bf), normal((B, C, K1, D), bf)
    hold("flash_sdpa", f"decode B={B} S=1 T={C} H={H1} K={K1} q_offset={S} bf16 (G=1)",
         flash_sdpa(qd1, kd1, vd1, q_offset=S), flash_sdpa_ref(qd1, kd1, vd1, q_offset=S), 1e-6,
         2 ** -7)
    taken = {r: flash_sdpa.launches_by_route[r] - n for r, n in routes.items()}
    if taken != {"wgmma": 2, "decode": 2, "decode_combine": 2, "simt": 0}:
        fail(f"flash_sdpa at deepseek-moe-16b's prefill and decode shapes (G = 1) took the routes "
             f"{taken} (with qwen2-7b's)")
    # qwen2-vl-2b: GQA 6 (12 query heads over 2), D 128.  zamba2-2.7b's shared
    # attention: MHA (32 / 32), D 80: the wgmma route in the D = 128 layout
    # (columns 80-127 zero-filled by TMA), the decode route at 10 chunks a
    # row, and in float32 the simt route (3 columns a lane, guarded); the
    # same bounds as above (float32: 2e-6, tests/test_kernels.py's)
    H6, K6 = 12, 2
    q6, k6, v6 = normal((B, S, H6, D), bf), normal((B, S, K6, D), bf), normal((B, S, K6, D), bf)
    hold("flash_sdpa", f"prefill B={B} S=T={S} H={H6} K={K6} D={D} bf16 (G=6)",
         flash_sdpa(q6, k6, v6), flash_sdpa_ref(q6, k6, v6),
         BF16_P_ATOL * float(v6.float().abs().max()), 2 ** -7)
    qd6, kd6, vd6 = normal((B, 1, H6, D), bf), normal((B, C, K6, D), bf), normal((B, C, K6, D), bf)
    hold("flash_sdpa", f"decode B={B} S=1 T={C} H={H6} K={K6} q_offset={S} bf16 (G=6)",
         flash_sdpa(qd6, kd6, vd6, q_offset=S), flash_sdpa_ref(qd6, kd6, vd6, q_offset=S), 1e-6,
         2 ** -7)
    H8 = K8 = 32
    D8 = 80
    q8, k8, v8 = normal((B, S, H8, D8), bf), normal((B, S, K8, D8), bf), normal((B, S, K8, D8), bf)
    hold("flash_sdpa", f"prefill B={B} S=T={S} H={H8} K={K8} D={D8} bf16 (D=80)",
         flash_sdpa(q8, k8, v8), flash_sdpa_ref(q8, k8, v8),
         BF16_P_ATOL * float(v8.float().abs().max()), 2 ** -7)
    qd8, kd8, vd8 = normal((B, 1, H8, D8), bf), normal((B, C, K8, D8), bf), normal((B, C, K8, D8), bf)
    hold("flash_sdpa", f"decode B={B} S=1 T={C} H={H8} K={K8} D={D8} q_offset={S} bf16 (D=80)",
         flash_sdpa(qd8, kd8, vd8, q_offset=S), flash_sdpa_ref(qd8, kd8, vd8, q_offset=S), 1e-6,
         2 ** -7)
    q8f, k8f, v8f = q8.float(), k8.float(), v8.float()
    hold("flash_sdpa", f"prefill B={B} S=T={S} H={H8} K={K8} D={D8} f32 (D=80, simt)",
         flash_sdpa(q8f, k8f, v8f), flash_sdpa_ref(q8f, k8f, v8f), 2e-6)
    taken = {r: flash_sdpa.launches_by_route[r] - n for r, n in routes.items()}
    if taken != {"wgmma": 4, "decode": 4, "decode_combine": 4, "simt": 1}:
        fail(f"flash_sdpa at qwen2-vl-2b's (G = 6) and zamba2-2.7b's (D = 80) shapes took the "
             f"routes {taken} (with the shapes above)")
    # whisper-base: MHA (8 / 8), D 64, bf16, no window.  The encoder attends
    # bidirectionally over its 1500 frames and the cross-attention over them
    # from 512 prompt tokens (wgmma, non-causal, T ragged: 1500 is no multiple
    # of a 128-key tile), the decoder's self-attention causally (wgmma), and
    # a decode step's cross-attention over every frame (decode, non-causal);
    # the same bounds as above
    F, HW, DW = get_config("whisper_base").encoder_frames, 8, 64
    qe, ke, ve = normal((B, F, HW, DW), bf), normal((B, F, HW, DW), bf), normal((B, F, HW, DW), bf)
    hold("flash_sdpa", f"encoder B={B} S=T={F} H=K={HW} D={DW} bf16 non-causal (whisper-base)",
         flash_sdpa(qe, ke, ve, causal=False), flash_sdpa_ref(qe, ke, ve, causal=False),
         BF16_P_ATOL * float(ve.float().abs().max()), 2 ** -7)
    qx = normal((B, S, HW, DW), bf)
    hold("flash_sdpa", f"cross prefill B={B} S={S} T={F} H=K={HW} D={DW} bf16 non-causal "
         f"(whisper-base)", flash_sdpa(qx, ke, ve, causal=False),
         flash_sdpa_ref(qx, ke, ve, causal=False), BF16_P_ATOL * float(ve.float().abs().max()),
         2 ** -7)
    kself, vself = normal((B, S, HW, DW), bf), normal((B, S, HW, DW), bf)
    hold("flash_sdpa", f"self prefill B={B} S=T={S} H=K={HW} D={DW} bf16 causal (whisper-base)",
         flash_sdpa(qx, kself, vself), flash_sdpa_ref(qx, kself, vself),
         BF16_P_ATOL * float(vself.float().abs().max()), 2 ** -7)
    qxd = normal((B, 1, HW, DW), bf)
    hold("flash_sdpa", f"cross decode B={B} S=1 T={F} H=K={HW} D={DW} bf16 non-causal "
         f"(whisper-base)", flash_sdpa(qxd, ke, ve, causal=False),
         flash_sdpa_ref(qxd, ke, ve, causal=False), 1e-6, 2 ** -7)
    taken = {r: flash_sdpa.launches_by_route[r] - n for r, n in routes.items()}
    if taken != {"wgmma": 7, "decode": 5, "decode_combine": 5, "simt": 1}:
        fail(f"flash_sdpa at whisper-base's encoder, cross prefill, self prefill (wgmma) and "
             f"cross decode (decode) shapes took the routes {taken} (with the shapes above)")

    # wkv6: tests/test_kernels.py's cases (1e-5 in float32, 5e-2 in bf16, as
    # there), then rwkv6-1.6b's prefill and decode shapes with the layer's
    # types (r/k/v bf16, w float32).  There both sides read the same values
    # and differ only in float32 summation order, but over 512 steps the
    # state holds sums of ~100 decayed terms and each output is a 64-term
    # dot product of them, so the rounding scales with the outputs' largest
    # magnitude, not with each output: 1e-5 of max |out| (and of max |state|).
    # Both are also held against a float64 run of the plain version.
    def wkv_inputs(B, T, H, K, V, xdt, wdt):
        w = torch.tensor(rng.uniform(0.5, 0.99, (B, T, H, K)).astype(np.float32), device=dev)
        return (normal((B, T, H, K), xdt), normal((B, T, H, K), xdt), normal((B, T, H, V), xdt),
                w.to(wdt), normal((H, K), scale=0.2), normal((B, H, K, V), scale=0.1))

    for B_, T, H_, K_, V in [(1, 8, 1, 8, 8), (2, 64, 3, 16, 16), (2, 33, 2, 64, 64)]:
        for dt, tol in ((torch.float32, 1e-5), (bf, 5e-2)):
            args = wkv_inputs(B_, T, H_, K_, V, dt, dt)
            for part, g, w in zip(("out", "state"), wkv6(*args), wkv6_ref(*args)):
                hold("wkv6", f"B={B_} T={T} H={H_} K={K_} V={V} {str(dt)[6:]} {part}", g, w, tol, tol)
    for T in (LM_SEQ, 1):
        args = wkv_inputs(LM_BATCH, T, 32, 64, 64, bf, torch.float32)
        exact = wkv6_ref(*(a.double() for a in args))
        for part, g, w, x in zip(("out", "state"), wkv6(*args), wkv6_ref(*args), exact):
            hold("wkv6", f"{'prefill' if T > 1 else 'decode'} B={LM_BATCH} T={T} H=32 K=V=64 "
                 f"r/k/v bf16 w f32 {part}", g, w, 1e-5 * float(w.abs().max()),
                 kernel_vs_f64=float((g.double() - x).abs().max()),
                 plain_vs_f64=float((w.double() - x).abs().max()))

    grads, train_times = check_lm_grads(torch, timer, dev, normal, wkv_inputs)
    refused = check_grad_refusals(torch, dev)

    # times and bounds at the prefill shapes (and flash_sdpa's decode step)
    def flash_record(label, q_, k_, v_, q_offset=0, causal=True):
        """Times and cost of one flash_sdpa call: a causal prefill (S = T,
        the causal pairs), a causal decode step (S = 1 at ``q_offset``: the
        keys 0..q_offset are read, the rest of the cache is masked) or a
        non-causal call (every key of every row); the library call is
        scaled_dot_product_attention on the same (B, heads, S, D) views
        (over the visible keys at a causal decode step)."""
        Bq, Sq, Hq, Dq = q_.shape
        Tq, Kq, size = k_.shape[1], k_.shape[2], q_.element_size()
        keys = q_offset + 1 if causal and Sq == 1 else Tq
        gqa = {"enable_gqa": True} if Hq != Kq else {}
        kl, vl = k_[:, :keys], v_[:, :keys]
        if causal and Sq > 1:
            pairs = Bq * Hq * Sq * (Sq + 1) // 2
        else:
            pairs = Bq * Hq * Sq * keys
        slow = {"reps": 5, "windows": 11} if Sq > 1 else {}
        return dict(
            shape=label,
            ms=timer(lambda: flash_sdpa(q_, k_, v_, causal=causal, q_offset=q_offset)),
            plain_ms=timer(lambda: flash_sdpa_ref(q_, k_, v_, causal=causal, q_offset=q_offset),
                           **slow),
            library_ms=timer(lambda: Fn.scaled_dot_product_attention(
                q_.transpose(1, 2), kl.transpose(1, 2), vl.transpose(1, 2),
                is_causal=causal and Sq > 1, **gqa)),
            bytes=size * (2 * Bq * Sq * Hq * Dq + 2 * Bq * keys * Kq * Dq), ops=4 * Dq * pairs,
            peak_ops=PEAK_BF16_OPS_PER_S if q_.dtype == bf else PEAK_F32_OPS_PER_S,
        )

    records = {"flash_sdpa": flash_record(
        f"B={B} S=T={S} H={H} K={K} D={D} bf16 causal (qwen2-7b prefill)", q, k, v)}
    extra = {
        "flash_sdpa (decode)": flash_record(
            f"B={B} S=1 T={C} q_offset={S} bf16 (qwen2-7b decode step)", qd, kd, vd, S),
        "flash_sdpa (prefill G=1)": flash_record(
            f"B={B} S=T={S} H={H1} K={K1} D={D} bf16 causal (deepseek-moe-16b prefill)", q1, k1, v1),
        "flash_sdpa (decode G=1)": flash_record(
            f"B={B} S=1 T={C} H={H1} K={K1} q_offset={S} bf16 (deepseek-moe-16b decode step)",
            qd1, kd1, vd1, S),
        "flash_sdpa (prefill G=6)": flash_record(
            f"B={B} S=T={S} H={H6} K={K6} D={D} bf16 causal (qwen2-vl-2b prefill)", q6, k6, v6),
        "flash_sdpa (decode G=6)": flash_record(
            f"B={B} S=1 T={C} H={H6} K={K6} q_offset={S} bf16 (qwen2-vl-2b decode step)",
            qd6, kd6, vd6, S),
        "flash_sdpa (prefill D=80)": flash_record(
            f"B={B} S=T={S} H={H8} K={K8} D={D8} bf16 causal (zamba2-2.7b prefill)", q8, k8, v8),
        "flash_sdpa (decode D=80)": flash_record(
            f"B={B} S=1 T={C} H={H8} K={K8} D={D8} q_offset={S} bf16 (zamba2-2.7b decode step)",
            qd8, kd8, vd8, S),
        "flash_sdpa (simt D=80)": flash_record(
            f"B={B} S=T={S} H={H8} K={K8} D={D8} f32 causal (zamba2-2.7b prefill, float32)",
            q8f, k8f, v8f),
        "flash_sdpa (whisper encoder)": flash_record(
            f"B={B} S=T={F} H=K={HW} D={DW} bf16 non-causal (whisper-base encoder)", qe, ke, ve,
            causal=False),
        "flash_sdpa (whisper cross prefill)": flash_record(
            f"B={B} S={S} T={F} H=K={HW} D={DW} bf16 non-causal (whisper-base cross prefill)",
            qx, ke, ve, causal=False),
        "flash_sdpa (whisper self prefill)": flash_record(
            f"B={B} S=T={S} H=K={HW} D={DW} bf16 causal (whisper-base decoder prefill)",
            qx, kself, vself),
        "flash_sdpa (whisper cross decode)": flash_record(
            f"B={B} S=1 T={F} H=K={HW} D={DW} bf16 non-causal (whisper-base cross decode step)",
            qxd, ke, ve, causal=False),
    }
    B, T, H, K, V = LM_BATCH, LM_SEQ, 32, 64, 64
    args = wkv_inputs(B, T, H, K, V, bf, torch.float32)
    n = B * T * H
    records["wkv6"] = dict(
        shape=f"B={B} T={T} H={H} K=V={K} r/k/v bf16 w f32 (rwkv6-1.6b prefill)",
        ms=timer(lambda: wkv6(*args)),
        plain_ms=timer(lambda: wkv6_ref(*args), reps=2, windows=5),
        library_ms=None,
        # r, k, v (bf16), w (f32), u, s0 read once; out, sT written once
        bytes=n * K * (2 + 2 + 4) + n * V * 2 + H * K * 4 + 2 * B * H * K * V * 4 + n * V * 4,
        # out_t = sum_k r_k S_kv + v_v sum_k r_k u_k k_k: r.S is one multiply-add
        # per state element (2), the update w S + k v is 3; the bonus term is
        # 3 K + 2 V per step, not per element
        ops=5 * n * K * V + n * (3 * K + 2 * V),
    )
    # the decode step (T = 1): the 8.4 MB state is read and written once
    args = wkv_inputs(B, 1, H, K, V, bf, torch.float32)
    extra["wkv6 (decode)"] = dict(
        shape=f"B={B} T=1 H={H} K=V={K} r/k/v bf16 w f32 (rwkv6-1.6b decode step)",
        ms=timer(lambda: wkv6(*args)),
        plain_ms=timer(lambda: wkv6_ref(*args)),
        library_ms=None,
        bytes=B * H * K * (2 + 2 + 4) + B * H * V * 2 + H * K * 4 + 2 * B * H * K * V * 4
        + B * H * V * 4,
        ops=5 * B * H * K * V + B * H * (3 * K + 2 * V),
    )
    for name, r in {**records, **extra}.items():
        r["bound_ms"], r["bound_by"] = bound(r.pop("bytes"), r.pop("ops"), r.pop("peak_ops", PEAK_F32_OPS_PER_S))
        r["max_abs_err"] = err[name.split()[0]]
    times = {k: {kk: r[kk] for kk in ("shape", "ms", "plain_ms", "library_ms", "bound_ms")}
             for k, r in {**records, **extra}.items()}
    emit("check_lm", {"cases": len(cases), "max_abs_err": err, "times": times,
                      "grads": grads, "train_times": train_times, "no_grad_kernels_raise": refused,
                      "detail": cases})
    for name, r in extra.items():  # the other shapes' numbers ride on the kernel's record
        kernel, sub = name.split(" ", 1)  # "decode", "prefill G=1", "decode G=1"
        records[kernel][EXTRA_SHAPES[sub[1:-1]]] = {
            kk: r[kk] for kk in ("shape", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
    for name, r in train_times.items():  # ... and the training shapes' forward and backward
        records[name]["train"] = r
    return records


# The Functions' backward is the plain version differentiated on the saved
# inputs: on one card the same ops as plain autograd on the same inputs and
# upstream gradient, so the two should be equal; held at 1e-6 of the largest
# |g| (float32 summation order, should a library pick another algorithm)
LM_GRAD_TOL = 1e-6


def grad_case(torch, kernel, case, fn, ref, ins, upstream):
    """The gradients of ``fn`` (a kernel's autograd Function) against the
    plain version ``ref``'s autograd on the same inputs and upstream
    gradient, within LM_GRAD_TOL of the largest; fails outside.  Returns
    the case's record."""
    ins = [t.detach().requires_grad_() for t in ins]
    got_out = fn(*ins)
    got_out = got_out if isinstance(got_out, tuple) else (got_out,)
    got = torch.autograd.grad(got_out, ins, upstream, allow_unused=True)
    want_out = ref(*ins)
    want_out = want_out if isinstance(want_out, tuple) else (want_out,)
    want = torch.autograd.grad(want_out, ins, upstream, allow_unused=True)
    errs = []
    for g, w in zip(got, want):
        if (g is None) != (w is None):
            fail(f"{kernel} {case}: a gradient is None on one side only")
        if g is None:
            continue
        e = float((g.float() - w.float()).abs().max())
        scale = float(w.float().abs().max())
        if g.dtype != w.dtype or not np.isfinite(e) or e > LM_GRAD_TOL * scale:
            fail(f"{kernel} {case}: Function vs plain autograd gradient differs by {e} "
                 f"(tolerance {LM_GRAD_TOL} x {scale})")
        errs.append(e)
    return {"kernel": kernel, "case": case, "max_abs_err": max(errs),
            "tol_rel_to_max_g": LM_GRAD_TOL}


def check_lm_grads(torch, timer, dev, normal, wkv_inputs):
    """flash_sdpa's and wkv6's autograd Functions against the plain versions'
    autograd on the card: flash_sdpa on the wgmma route (bf16, D 128, GQA 7)
    and the simt route (float32, D 32), causal, with and without a window,
    and on the wgmma route non-causal (whisper-base's cross-attention);
    wkv6 in float32 and bf16, gradients of out and sT to r, k, v, w, u and s0.
    Then the forward and backward times at the training shapes (lm_train:
    B 2 x S 512).  Returns (cases, times)."""
    from repro_torch.kernels.flash_sdpa import flash_sdpa, flash_sdpa_ref
    from repro_torch.kernels.wkv6 import wkv6, wkv6_ref

    bf = torch.bfloat16
    cases = []

    def hold_grads(*case):
        cases.append(grad_case(torch, *case))

    for route, dt, (B, S, H, K, D) in (("wgmma", bf, (2, 512, 28, 4, 128)),
                                       ("simt", torch.float32, (2, 128, 4, 2, 32))):
        for window in (0, S // 4):
            q, k, v = normal((B, S, H, D), dt), normal((B, S, K, D), dt), normal((B, S, K, D), dt)
            g = normal((B, S, H, D), dt)
            before = flash_sdpa.launches_by_route[route]
            hold_grads("flash_sdpa", f"{route} B={B} S=T={S} H={H} K={K} D={D} window={window}",
                       lambda q, k, v: flash_sdpa(q, k, v, window=window),
                       lambda q, k, v: flash_sdpa_ref(q, k, v, window=window), (q, k, v), (g,))
            if flash_sdpa.launches_by_route[route] != before + 1:
                fail(f"flash_sdpa's Function did not launch the {route} route")
    # non-causal on wgmma: whisper-base's cross-attention in training (512
    # queries over the 1500 frames, MHA 8, D 64)
    q, k, v = normal((2, 512, 8, 64), bf), normal((2, 1500, 8, 64), bf), normal((2, 1500, 8, 64), bf)
    g = normal((2, 512, 8, 64), bf)
    before = flash_sdpa.launches_by_route["wgmma"]
    hold_grads("flash_sdpa", "wgmma B=2 S=512 T=1500 H=K=8 D=64 non-causal",
               lambda q, k, v: flash_sdpa(q, k, v, causal=False),
               lambda q, k, v: flash_sdpa_ref(q, k, v, causal=False), (q, k, v), (g,))
    if flash_sdpa.launches_by_route["wgmma"] != before + 1:
        fail("flash_sdpa's Function did not launch the wgmma route (non-causal)")
    for dt in (torch.float32, bf):
        B, T, H, K = 2, 64, 4, 64
        ins = wkv_inputs(B, T, H, K, K, dt, torch.float32)
        up = (normal((B, T, H, K)), normal((B, H, K, K)))
        hold_grads("wkv6", f"B={B} T={T} H={H} K=V={K} r/k/v {str(dt)[6:]} w f32, d(out, sT)",
                   wkv6, wkv6_ref, ins, up)
        hold_grads("wkv6", f"B={B} T={T} H={H} K=V={K} r/k/v {str(dt)[6:]} w f32, d(out) only",
                   lambda *a: wkv6(*a)[0], lambda *a: wkv6_ref(*a)[0], ins, up[:1])

    # forward (the kernel through the Function) and backward (the plain
    # version's autograd) at the training shapes
    times = {}
    B, S, H, K, D = LM_TRAIN_BATCH, LM_TRAIN_SEQ, 28, 4, 128
    q, k, v = (normal(shape, bf).requires_grad_() for shape in
               ((B, S, H, D), (B, S, K, D), (B, S, K, D)))
    out, g = flash_sdpa(q, k, v), normal((B, S, H, D), bf)
    times["flash_sdpa"] = {
        "shape": f"B={B} S=T={S} H={H} K={K} D={D} bf16 causal (qwen2-7b lm_train)",
        "fwd_ms": timer(lambda: flash_sdpa(q, k, v)),
        "bwd_ms": timer(lambda: torch.autograd.grad(out, (q, k, v), g, retain_graph=True),
                        reps=5, windows=11),
        "plain_fwd_ms": timer(lambda: flash_sdpa_ref(q, k, v), reps=5, windows=11),
    }
    del out
    H, K = 32, 64
    ins = [t.requires_grad_() for t in wkv_inputs(B, S, H, K, K, bf, torch.float32)]
    out, _ = wkv6(*ins)
    g = normal((B, S, H, K))
    times["wkv6"] = {
        "shape": f"B={B} T={S} H={H} K=V={K} r/k/v bf16 w f32 (rwkv6-1.6b lm_train)",
        "fwd_ms": timer(lambda: wkv6(*ins)),
        "bwd_ms": timer(lambda: torch.autograd.grad(out, ins, g, retain_graph=True),
                        reps=1, windows=3),
        "plain_fwd_ms": timer(lambda: wkv6_ref(*ins), reps=1, windows=3),
    }
    del out
    return cases, times


def check_grad_refusals(torch, dev):
    """The kernels without a gradient raise on a CUDA input that requires
    grad under grad mode, and run under torch.no_grad()."""
    from repro_torch.kernels.estimator_mlp import estimator_mlp
    from repro_torch.kernels.iou_matrix import iou_matrix, iou_matrix_batch
    from repro_torch.kernels.score_pipeline import score_pipeline

    rng = np.random.default_rng(77)
    F = TOP_K * (7 + NUM_CLASSES) + 4 + NUM_CLASSES
    w1, b1, w2, b2 = seeded_mlp(torch, rng, F, HIDDEN, dev)
    x = torch.tensor(rng.normal(0, 1, (4, F)).astype(np.float32), device=dev)
    block = seeded_block(torch, rng, 2, 64, dev)
    sp = {"w1": w1, "b1": b1, "w2": w2, "b2": b2, "mu": torch.zeros(F, device=dev),
          "sigma": torch.ones(F, device=dev)}
    a = torch.tensor(seeded_boxes(rng, (2, 8)), device=dev)
    calls = {
        "estimator_mlp": lambda req: estimator_mlp(x.detach().requires_grad_(req), w1, b1, w2, b2),
        "score_pipeline": lambda req: score_pipeline(
            block, dict(sp, w1=w1.detach().requires_grad_(req)), image_size=IMAGE_SIZE,
            num_classes=NUM_CLASSES, top_k=TOP_K),
        "iou_matrix": lambda req: iou_matrix(a[0].detach().requires_grad_(req), a[1]),
        "iou_matrix_batch": lambda req: iou_matrix_batch(a.detach().requires_grad_(req), a),
    }
    out = {}
    for name, call in calls.items():
        try:
            call(True)
        except RuntimeError as e:
            out[name] = str(e).split(":")[0]
        else:
            fail(f"{name} returned a detached result for a CUDA input that requires grad")
        with torch.no_grad():
            call(True)
    return out


def lm_engine_artifact(path, x_cal, scores_fn, exit_layer, cfg_name, rng):
    """Write an engine artifact in the layout ``repro``'s ``LMCascade.save``
    writes: a seeded MLP head (F -> 64 -> 1) standardized on the calibration
    features, its estimates on them as the calibration scores, and the
    ``lm_logits`` extractor."""
    from repro_torch.core.estimator import EstimatorConfig
    from repro_torch.train.checkpoint import save_flat

    F = x_cal.shape[1]
    model_arrays = {
        "params": {
            "layer0": {"w": (rng.standard_normal((F, LM_HIDDEN)) * np.sqrt(2.0 / F)).astype(np.float32),
                       "b": np.zeros(LM_HIDDEN, np.float32)},
            "layer1": {"w": (rng.standard_normal((LM_HIDDEN, 1)) * np.sqrt(2.0 / LM_HIDDEN)).astype(np.float32),
                       "b": np.zeros(1, np.float32)},
        },
        "mu": x_cal.mean(dim=0).cpu().numpy().astype(np.float32),
        "sigma": (x_cal.std(dim=0, unbiased=False) + 1e-6).cpu().numpy().astype(np.float32),
    }
    model_meta = {"kind": "mlp", "in_dim": F, "use_fused": True,
                  "config": dataclasses.asdict(EstimatorConfig(hidden=(LM_HIDDEN,)))}
    calibration = scores_fn(model_arrays, model_meta)
    meta = {
        "kind": "offload_engine", "version": 1, "ratio": LM_RATIO, "transform": "cdf",
        "policy": {"name": "threshold", "kwargs": {}},
        "feature_extractor": {"name": "lm_logits", "spec": {"top_k": LM_TOP_K}},
        "reward_model": model_meta,
        "extra": {"exit_layer": exit_layer, "cfg_name": cfg_name},
    }
    arrays = {"model": model_arrays, "calibration": calibration.astype(np.float64),
              "transform_sorted": np.sort(rng.normal(0, 1, len(calibration)))}
    save_flat(path, arrays, meta)


def reset_counts(counters):
    """Every launch count of ``counters`` (and its by-route / by-shape split) to 0."""
    for c in counters:
        c.launches = 0
        for split in (getattr(c, "launches_by_route", {}), getattr(c, "launches_by_shape", {})):
            for key in split:
                split[key] = 0


def split_counts(counters):
    """The by-route and by-shape launch counts of the wrappers that keep them."""
    out = {}
    for c in counters:
        parts = {name: dict(getattr(c, f"launches_{name}")) for name in ("by_route", "by_shape")
                 if hasattr(c, f"launches_{name}")}
        if parts:
            out[c.__name__] = parts
    return out


def modality_fields(torch, cfg, B, S, dev, rng):
    """A batch's fields besides the tokens.  A VLM's: the vision prefix
    (``vision_patch_embeddings``, float32) and M-RoPE ids (3, B, S) with a
    grid on the prefix (rows of the largest divisor of ``vision_tokens`` not
    above its square root: 16 x 16 at qwen2-vl-2b; t = 0, h = row, w =
    column) and text after it (t = h = w, from the grid's largest id + 1),
    so that the three axes differ and M-RoPE is not its 1-D special case.
    An encoder-decoder's: ``audio_frame_embeddings`` (B, encoder_frames,
    d_model), float32.  {} for the other families."""
    from repro_torch.data.modality_stubs import audio_frame_embeddings, vision_patch_embeddings

    if cfg.arch_type == "encdec":
        return {"audio_frames": torch.from_numpy(
            audio_frame_embeddings(rng, B, cfg.encoder_frames, cfg.d_model)).to(dev)}
    if cfg.arch_type != "vlm":
        return {}
    V = cfg.vision_tokens
    width = max(w for w in range(1, int(V ** 0.5) + 1) if V % w == 0)
    p3d = np.zeros((3, B, S), np.int64)
    p3d[1, :, :V], p3d[2, :, :V] = np.arange(V) // width, np.arange(V) % width
    p3d[:, :, V:] = max(V // width, width) + np.arange(S - V)
    return {"vision_embeds": torch.from_numpy(vision_patch_embeddings(rng, B, V, cfg.d_model)).to(dev),
            "positions_3d": torch.from_numpy(p3d).to(dev)}


def batch_rows(batch, idx):
    """The rows ``idx`` of a batch's inputs (no labels): the M-RoPE ids'
    batch axis is their second."""
    return {k: v[:, idx] if k == "positions_3d" else v[idx] for k, v in batch.items() if k != "labels"}


def batch_cut(batch, rows, seq):
    """The first ``rows`` rows and ``seq`` positions of a batch (a VLM's
    vision prefix cut with the sequence; an encoder-decoder's audio frames
    whole: the encoder's length is the config's)."""
    return {k: v[:, :rows, :seq] if k == "positions_3d" else v[:rows] if k == "audio_frames"
            else v[:rows, :seq] for k, v in batch.items()}


def lm_serve_family(torch, dev, cfg, seed, counters):
    """One family's LM cascade at the width of ``cfg``: the counted main
    path, then the checks.  Returns (report, launches of the main path).
    A VLM batch carries its vision prefix and M-RoPE ids (``modality_fields``);
    ``cascade_generate`` refuses the ids (repro's call cuts them on the
    wrong axis), so a VLM's stream path generates through each stack
    instead, as the served batches do."""
    from repro_torch.api.features import LMLogitsFeatures
    from repro_torch.api.reward_model import MLPRewardModel
    from repro_torch.core.estimator import mlp_apply
    from repro_torch.data.lm_synth import synth_lm_batch
    from repro_torch.models import lm
    from repro_torch.serving.cascade_serving import LMCascade, truncate_params, truncated_config
    from repro_torch.core.policy import ThresholdPolicy
    from repro_torch.serving.decode_loop import cascade_generate, generate

    sync = _sync(torch, dev)
    stage: Dict[str, float] = {}

    def timed(name, fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        stage[name] = stage.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
        return out

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    params = timed("init_params_ms", lambda: lm.init_params(
        cfg, torch.Generator(device=dev).manual_seed(seed), device=dev))
    n_params = sum(t.numel() for t in lm.tree_leaves(params))
    exit_layer = max(cfg.num_layers // 2, 1)
    wparams, wcfg = truncate_params(params, cfg, exit_layer), truncated_config(cfg, exit_layer)
    rng = np.random.default_rng(seed)

    def lm_batch():
        toks, labels = synth_lm_batch(rng, LM_BATCH, LM_SEQ, cfg.vocab_size)
        return {"tokens": torch.from_numpy(toks).to(dev), "labels": torch.from_numpy(labels).to(dev),
                **modality_fields(torch, cfg, LM_BATCH, LM_SEQ, dev, rng)}

    cal, served = lm_batch(), [lm_batch() for _ in range(LM_SERVED)]
    # the library's first calls (cuBLAS handles) outside the counted, timed run
    lm.forward(wparams, wcfg, batch_cut(cal, 1, max(8, cfg.vision_tokens)))
    reset_counts(counters)

    # -- calibration: weak forward -> lm_logits features -> the MLP head
    wlogits, _ = timed("cal_weak_forward_ms", lambda: lm.forward(wparams, wcfg, cal))
    x_cal = timed("cal_features_ms",
                  lambda: LMLogitsFeatures(LM_TOP_K, device=dev)((wlogits, cal["labels"])))
    del wlogits

    def scores_fn(arrays, meta):
        return MLPRewardModel.from_state(arrays, meta, device=dev).predict(x_cal)

    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "lm_engine.npz")
        timed("cal_estimates_ms", lambda: lm_engine_artifact(
            path, x_cal, scores_fn, exit_layer, cfg.name, np.random.default_rng(seed + 1)))
        cascade = timed("engine_load_ms", lambda: LMCascade.load(path, cfg, device=dev))
        cpu_cascade = LMCascade.load(path, cfg, device="cpu")

    # -- serve: 4 batches of 8 x 512, then 16 greedy tokens a row through the
    # stack its decision chose
    results, tokens = [], []
    gen_ms = {"weak": {}, "strong": {}}
    gen_tokens = {"weak": 0, "strong": 0}
    gen_calls = {"weak": 0, "strong": 0}

    def stack_generate(batch, offload, count=True):
        """LM_TOKENS greedy tokens a row through the stack its decision chose."""
        toks = torch.zeros((LM_BATCH, LM_TOKENS), dtype=torch.int32, device=dev)
        for which, (p, c), rows in (("weak", (wparams, wcfg), np.flatnonzero(~offload)),
                                    ("strong", (params, cfg), np.flatnonzero(offload))):
            if rows.size:
                idx = torch.from_numpy(rows).to(dev)
                toks[idx] = generate(p, c, batch_rows(batch, idx), LM_TOKENS,
                                     stage_ms=gen_ms[which] if count else None)
                if count:
                    gen_tokens[which] += int(rows.size) * LM_TOKENS
                    gen_calls[which] += 1
        return toks

    for batch in served:
        out = cascade.serve_batch(params, batch, stage_ms=stage)
        results.append(out)
        tokens.append(stack_generate(batch, out["offload"]))
    # -- fit: LMCascade.fit on two more calibration batches (oracle NLL
    # rewards, the engine fitted on the card), then a served batch through it
    fit_cal = [lm_batch() for _ in range(LM_FIT_BATCHES)]
    fitted = timed("fit_ms", lambda: LMCascade.fit(params, cfg, exit_layer, fit_cal,
                                                   ratio=LM_RATIO, seed=seed))
    fit_out = timed("fit_serve_ms", lambda: fitted.serve_batch(params, served[0]))
    sync()
    launches = {c.__name__: c.launches for c in counters}
    split = split_counts(counters)
    if cfg.arch_type == "rwkv":
        shapes = split["wkv6"]["by_shape"]
        if shapes["prefill"] == 0 or shapes["decode"] == 0:
            fail(f"{cfg.name}: wkv6 launches by shape on the LM path: {shapes}")
    elif cfg.use_mla:
        # MLA's q/k width (192) is not flash_sdpa's: it attends in plain PyTorch
        if launches["flash_sdpa"] or launches["wkv6"]:
            fail(f"{cfg.name}: an LM kernel launched on the MLA path: {launches}")
    else:
        # bf16 prefill must take the tensor-core route, decode steps split-K
        routes = split["flash_sdpa"]["by_route"]
        if routes["wgmma"] == 0 or routes["decode"] == 0 or routes["simt"] != 0:
            fail(f"{cfg.name}: flash_sdpa's routes on the LM path: {routes}")
    # -- the stream, counted on its own: the served batches through one
    # session (serve_stream), again with a re-budget, then cascade_generate
    # on the first batch
    reset_counts(counters)
    streamed = timed("stream_ms", lambda: cascade.serve_stream(params, served, micro_batch=LM_BATCH))
    rebudgeted = timed("stream_ms", lambda: cascade.serve_stream(
        params, served, micro_batch=LM_BATCH, set_ratio_at=LM_REBUDGET))
    if "positions_3d" in served[0]:
        gen = timed("cascade_generate_ms", lambda: {
            "offload": streamed["offload"][:LM_BATCH],
            "tokens": stack_generate(served[0], streamed["offload"][:LM_BATCH], count=False)})
    else:
        gen = timed("cascade_generate_ms", lambda: cascade_generate(
            params, cfg, served[0], LM_TOKENS, engine=cascade.engine, exit_layer=exit_layer))
    sync()
    stream_launches = {c.__name__: c.launches for c in counters}
    stream_split = split_counts(counters)
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else None

    # -- checks, outside the count
    offload = np.concatenate([r["offload"] for r in results])
    estimates = np.concatenate([r["estimates"] for r in results])
    if estimates.shape != (LM_SERVED * LM_BATCH,) or not np.isfinite(estimates).all():
        fail(f"{cfg.name}: served estimates are not finite of shape ({LM_SERVED * LM_BATCH},)")
    if not ((estimates >= 0) & (estimates <= 1)).all():
        fail(f"{cfg.name}: served estimates fall outside [0, 1]")
    for r in results + [fit_out]:
        for key in ("nll_weak", "nll_strong", "nll_final"):
            if not np.isfinite(r[key]).all():
                fail(f"{cfg.name}: {key} is not finite")
    fit_cal_scores = fitted.engine.calibration_scores
    if fit_cal_scores.shape != (LM_FIT_BATCHES * LM_BATCH,) or not np.isfinite(fit_cal_scores).all() \
            or not np.isfinite(fit_out["estimates"]).all():
        fail(f"{cfg.name}: LMCascade.fit's estimates are not finite of shape "
             f"({LM_FIT_BATCHES * LM_BATCH},)")
    # the fit's calibration estimates (estimator_mlp) against mlp_apply on the
    # fit's features, recomputed (the weak forward repeats bit for bit)
    fit_x = []
    for batch in fit_cal:
        wl, _ = lm.forward(wparams, wcfg, batch)
        fit_x.append(fitted.engine.features((wl, batch["labels"])))
        del wl
    del fit_cal
    est = fitted.engine.reward_model.estimator
    fit_x = (torch.cat(fit_x) - torch.tensor(est._mu, device=dev)) / torch.tensor(est._sigma, device=dev)
    with torch.no_grad():
        plain = mlp_apply(est.params, fit_x, sigmoid_out=True).cpu().numpy()
    fit_cal_err = float(np.abs(plain - fit_cal_scores).max())
    if plain.shape != fit_cal_scores.shape or not fit_cal_err <= 1e-5:
        fail(f"{cfg.name}: LMCascade.fit's calibration estimates, estimator_mlp vs mlp_apply, "
             f"differ by {fit_cal_err} > 1e-5")
    all_toks = torch.cat(tokens)
    if int(all_toks.min()) < 0 or int(all_toks.max()) >= cfg.vocab_size:
        fail(f"{cfg.name}: generated token ids outside [0, {cfg.vocab_size})")

    b0 = served[0]
    checks = {}
    moe = cfg.arch_type == "moe"
    if moe:
        # seeded MoE weights amplify bf16 roundings with depth even where two
        # runs route alike (this phase on an H100, deepseek-moe-16b: decode
        # vs forward 0.014 of the largest logit at 2 layers, 0.138 at 28;
        # float32 within 1e-5; qwen2-7b 0.017 at 28), so the bf16 holds run
        # on the first LM_MOE_HELD_LAYERS layers (one dense, one MoE),
        # float32 holds there too, and the full depth is measured
        checks["moe"] = moe_routing_checks(torch, lm, params, cfg, b0["tokens"])
        checks["moe"]["full_depth_bf16"] = decode_vs_forward(
            torch, lm, params, moe_drop_free(cfg), b0, None)
        hparams = truncate_params(params, cfg, LM_MOE_HELD_LAYERS)
        hcfg = truncated_config(cfg, LM_MOE_HELD_LAYERS)
        checks.update(decode_vs_forward(torch, lm, hparams, moe_drop_free(hcfg), b0, LM_BF16_REL_TOL))
        checks["decode_vs_forward_f32"] = decode_vs_forward(
            torch, lm, lm.tree_map(lambda t: t.float(), hparams),
            dataclasses.replace(moe_drop_free(hcfg), dtype="float32"), b0, LM_F32_REL_TOL)
        checks["held_layers"] = LM_MOE_HELD_LAYERS
    else:
        checks.update(decode_vs_forward(torch, lm, params, cfg, b0, LM_BF16_REL_TOL))
    # the served batch 0's weak logits: kernels against the plain versions,
    # in bf16 as served, and in float32 (the weak stack's weights widened),
    # where only the kernels' float32 summation order differs.  A MoE family
    # measures the weak stack and holds its first LM_MOE_HELD_LAYERS layers
    # (14 float32 layers would not fit beside the bf16 model either)
    wk, checks["weak_logits_kernels_vs_plain"] = kernels_vs_plain(
        lm, wparams, wcfg, b0, None if moe else LM_BF16_REL_TOL)
    if moe:
        checks["kernels_vs_plain_held"] = kernels_vs_plain(lm, hparams, hcfg, b0, LM_BF16_REL_TOL)[1]
    f32_layers = LM_MOE_HELD_LAYERS if moe else exit_layer
    w32 = lm.tree_map(lambda t: t.float(), truncate_params(params, cfg, f32_layers))
    c32 = dataclasses.replace(truncated_config(cfg, f32_layers), dtype="float32")
    checks["weak_logits_kernels_vs_plain_f32"] = kernels_vs_plain(lm, w32, c32, b0, LM_F32_REL_TOL)[1]
    checks["weak_logits_kernels_vs_plain_f32"]["layers"] = f32_layers
    del w32
    # decisions on the card against the CPU engine on the same features
    feats = cascade.engine.features((wk, b0["labels"]))
    del wk
    card, cpu = cascade.engine.decide(features=feats), cpu_cascade.engine.decide(features=feats.cpu())
    e = float(np.abs(card.estimates - cpu.estimates).max())
    if not np.array_equal(card.offload, cpu.offload) or e > 2e-6:
        fail(f"{cfg.name}: decisions on the card vs the CPU: masks equal "
             f"{np.array_equal(card.offload, cpu.offload)}, estimates differ by {e}")
    checks["card_vs_cpu_estimates_max_abs_err"] = e
    # the same batch decided again: the weak forward repeats bit for bit
    checks["served_vs_recomputed_masks_equal"] = bool(np.array_equal(card.offload, results[0]["offload"]))
    checks["served_vs_recomputed_estimates_max_abs_err"] = float(
        np.abs(card.estimates - results[0]["estimates"]).max())
    # the stream: serve_batch's masks and estimates bit for bit (the same
    # estimator_mlp launch on the same features); the re-budget moves the
    # masks from its request on, to the threshold at the new ratio; the
    # session-gated decode gives the tokens generate gave each row's stack
    if not (np.array_equal(streamed["offload"], offload)
            and np.array_equal(streamed["estimates"], estimates.astype(np.float64))):
        fail(f"{cfg.name}: serve_stream differs from serve_batch")
    (at, ratio), = LM_REBUDGET.items()
    want = offload.copy()
    want[at:] = estimates[at:] > ThresholdPolicy(cascade.engine.calibration_scores, ratio).threshold
    if not (np.array_equal(rebudgeted["offload"], want)
            and np.array_equal(rebudgeted["estimates"], streamed["estimates"])):
        fail(f"{cfg.name}: serve_stream with set_ratio_at {LM_REBUDGET}: masks "
             f"{rebudgeted['offload'].astype(int).tolist()}, want {want.astype(int).tolist()}")
    if not (np.array_equal(gen["offload"], results[0]["offload"]) and torch.equal(gen["tokens"], tokens[0])):
        fail(f"{cfg.name}: the stream's generate differs from serve_batch's decisions + generate")
    checks["stream"] = {
        "serve_stream_equals_serve_batch": True,
        "rebudget_at": at, "rebudget_ratio": ratio,
        "realized_before_after": [float(rebudgeted["offload"][:at].mean()),
                                  float(rebudgeted["offload"][at:].mean())],
        "cascade_generate_equals_generate": True,
        "stream_generate": "generate on each stack" if "positions_3d" in b0 else "cascade_generate",
        "telemetry": streamed["telemetry"], "rebudget_telemetry": rebudgeted["telemetry"],
        "cascade_generate_telemetry": gen.get("telemetry"),
    }

    if cfg.arch_type == "dense":
        checks["caches"] = lm_cache_checks(torch, dev, params, cfg, b0["tokens"])
    elif moe and not cfg.use_mla:
        checks["caches"] = lm_cache_checks(torch, dev, hparams, moe_drop_free(hcfg), b0["tokens"])

    gen_total_ms = sum(sum(d.values()) for d in gen_ms.values())
    report = {
        "arch": cfg.name, "params": n_params, "layers": cfg.num_layers, "exit_layer": exit_layer,
        "d_model": cfg.d_model, "vocab": cfg.vocab_size, "dtype": cfg.dtype,
        "batch": LM_BATCH, "seq": LM_SEQ, "served_batches": LM_SERVED, "tokens_per_row": LM_TOKENS,
        "realized_ratio": float(offload.mean()), "target_ratio": LM_RATIO,
        "nll_weak": float(np.mean([r["nll_weak"].mean() for r in results])),
        "nll_strong": float(np.mean([r["nll_strong"].mean() for r in results])),
        "nll_final": float(np.mean([r["nll_final"].mean() for r in results])),
        "stage_ms_per_batch": {
            "weak_prefill_ms": stage["weak_forward_ms"] / LM_SERVED,
            "strong_prefill_ms": stage["strong_forward_ms"] / LM_SERVED,
            "decide_ms": stage["decide_ms"] / LM_SERVED,
            "nll_ms": stage["nll_ms"] / LM_SERVED,
        },
        # one decode step makes a token for every row of its stack's sub-batch
        "decode_ms_per_step": {w: d["decode_ms"] / (gen_calls[w] * (LM_TOKENS - 1)) if d else None
                               for w, d in gen_ms.items()},
        "generate_ms": gen_ms,
        "generated_tokens": gen_tokens,
        "generated_tokens_per_s": sum(gen_tokens.values()) / (gen_total_ms / 1e3),
        "setup_ms": {k: v for k, v in stage.items() if k.startswith(("init", "cal", "engine"))},
        "fit": {"calibration_batches": LM_FIT_BATCHES, "rows": LM_FIT_BATCHES * LM_BATCH,
                "fit_ms": stage["fit_ms"], "serve_batch_ms": stage["fit_serve_ms"],
                "rewards_sorted": [float(v) for v in fitted.cdf.state()["sorted_rewards"]],
                "calibration_estimator_mlp_vs_mlp_apply": fit_cal_err,
                "served_offload_ratio": float(fit_out["offload_ratio"]),
                "served_nll_final": float(fit_out["nll_final"].mean())},
        "stream_ms": {"serve_stream": stage["stream_ms"] / 2,
                      "cascade_generate": stage["cascade_generate_ms"]},
        "peak_memory_gib": peak_gib,
        "checks": checks, "launches": launches, "launches_split": split,
        "stream_launches": stream_launches, "stream_launches_split": stream_split,
    }
    return report, launches


def moe_drop_free(cfg):
    """``cfg`` with capacity_factor E / K: every expert has room for every
    token of a dispatch group, int(T K / E * E / K) + 1 >= T, so nothing
    drops."""
    return dataclasses.replace(cfg, capacity_factor=cfg.num_experts / cfg.top_k)


def moe_routing_checks(torch, lm, params, cfg, tokens):
    """The MoE family's routing at its own capacity_factor, outside the
    count: each MoE layer's dropped share in a full-depth prefill of the
    8 x 512 batch (the grouped path) and in the decode step after it (B 8,
    the flat path, capacity 1); for MLA the latent cache's bytes against
    the expanded K / V's at B 8, C 528."""
    with RoutingLog() as at_prefill:
        last, cache = lm.prefill(params, cfg, {"tokens": tokens}, capacity=LM_SEQ + 1)
    with RoutingLog() as at_decode:
        lm.decode_step(params, cfg, cache, last.argmax(-1), LM_SEQ)
    from repro_torch.models.layers import moe_grouped

    mc, T = cfg.moe(), tokens.numel()
    groups = mc.groups if moe_grouped(mc, T) else 1
    out = {
        "capacity_factor": mc.capacity_factor,
        "prefill": {"tokens": T, "groups": groups,
                    "capacity": int((T // groups * mc.top_k / mc.num_experts) * mc.capacity_factor) + 1,
                    "dropped_share_by_layer": at_prefill.dropped_share()},
        "decode": {"tokens": LM_BATCH, "groups": 1,
                   "capacity": int((LM_BATCH * mc.top_k / mc.num_experts) * mc.capacity_factor) + 1,
                   "dropped_share_by_layer": at_decode.dropped_share()},
    }
    for part in ("prefill", "decode"):
        shares = out[part]["dropped_share_by_layer"]
        out[part]["dropped_share_mean"] = sum(shares) / len(shares)
    if cfg.use_mla:
        C = LM_SEQ + LM_TOKENS
        latent = lm.init_cache(cfg, LM_BATCH, C, device=tokens.device)
        out["mla_cache_bytes"] = {
            "batch": LM_BATCH, "slots": C,
            "latent": sum(t.numel() * t.element_size() for t in latent.values()),
            "expanded_kv": 2 * cfg.num_layers * LM_BATCH * C * cfg.num_heads * cfg.head_dim
            * torch.finfo(cfg.act_dtype).bits // 8}
        del latent
    emit("lm_routing", {"arch": cfg.name, **out})
    return out


LM_MOE_HELD_LAYERS = 2  # the MoE families' bf16 and float32 holds: one dense layer, one MoE


def decode_vs_forward(torch, lm, params, cfg, batch, tol):
    """Decode at position S and the prefill's last logits against a forward
    over the S + 1 tokens that replays their routing (RoutingLog), held at
    ``tol`` (measured only when None); with MoE layers (on a drop-free
    ``cfg``: the three runs route different token counts), also the flips
    of a free forward and its distance to the decode step.  A VLM's decode
    step takes 1-D RoPE at S (no ids, as ``generate`` calls it): the
    forward's ids for that token are S."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    with RoutingLog() as at_prefill:
        last, cache = lm.prefill(params, cfg, batch, capacity=S + 1)
    nxt = last.argmax(-1)
    with RoutingLog() as at_decode:
        dl, _ = lm.decode_step(params, cfg, cache, nxt, S)
    del cache
    extended = dict(batch, tokens=torch.cat([tokens, nxt[:, None]], 1))
    if "positions_3d" in batch:
        extended["positions_3d"] = torch.cat(
            [batch["positions_3d"], torch.full((3, B, 1), S, device=tokens.device)], 2)
    both = RoutingLog.along(B, (at_prefill, S), (at_decode, 1))
    with RoutingLog(replay=both.replay_ids()) as at_forward:
        full, _ = lm.forward(params, cfg, extended)
    if any(share for log in (at_prefill, at_decode, at_forward) for share in log.dropped_share()):
        fail(f"{cfg.name}: the drop-free copy dropped assignments")
    out = {"decode_vs_forward": hold_rel(f"{cfg.name} decode vs forward", dl, full[:, -1], tol),
           "prefill_vs_forward": hold_rel(f"{cfg.name} prefill vs forward", last, full[:, -2], tol)}
    del full
    if both.calls:
        with RoutingLog() as free:
            full, _ = lm.forward(params, cfg, extended)
        out.update(layers=cfg.num_layers, dtype=cfg.dtype, capacity_factor=cfg.capacity_factor,
                   flips_vs_free_forward=flip_count(both.flipped(free, B, S + 1)),
                   free_forward_decode_rel=rel_diff(dl, full[:, -1])["rel"])
    return out


def kernels_vs_plain(lm, params, cfg, batch, tol):
    """The forward through the kernels against ``plain=True`` replaying its
    routing, held at ``tol`` (measured only when None); with MoE layers also
    the tokens a free plain forward routes otherwise, by layer, and its
    distance.  Returns (the kernels' logits, the report)."""
    with RoutingLog() as kernels:
        wk, _ = lm.forward(params, cfg, batch)
    with RoutingLog(replay=kernels.replay_ids()):
        wp, _ = lm.forward(params, cfg, batch, plain=True)
    out = hold_rel(f"{cfg.name} logits ({cfg.num_layers} layers, {cfg.dtype}), kernels vs plain",
                   wk, wp, tol)
    del wp
    if kernels.calls:
        B, S = wk.shape[:2]
        with RoutingLog() as free:
            wp, _ = lm.forward(params, cfg, batch, plain=True)
        out.update(layers=cfg.num_layers, free_plain_rel=rel_diff(wk, wp)["rel"],
                   flips_vs_free_plain={**flip_count(kernels.flipped(free, B, S)), "by_layer": [
                       int((np.sort(a, -1) != np.sort(b, -1)).any(-1).sum())
                       for a, b in zip(kernels.replay_ids(), free.replay_ids())]})
        del wp
    return wk, out


# zamba2-2.7b and whisper-base (no cascade: repro serves both through
# generate): LM_GENERATE_SERVED batches of 8 x 512 through generate (for
# whisper-base each with its 1500 seeded audio frames); the bf16 and float32
# holds run on a cut of the stack (zamba2-2.7b: its first LM_HYBRID_HELD_GROUPS
# groups, 10 Mamba2 layers and two applications of the shared block;
# whisper-base: its first LM_ENCDEC_HELD_LAYERS encoder and decoder layers),
# and the full depth is measured: seeded deep stacks amplify bf16 roundings
# (PERF.md section 6)
LM_GENERATE_SERVED, LM_HYBRID_HELD_GROUPS, LM_ENCDEC_HELD_LAYERS = 2, 2, 2


def held_cut(lm, params, cfg):
    """The cut of a generate-only family that its holds run on (views) and
    its config."""
    if cfg.arch_type == "hybrid":
        g = LM_HYBRID_HELD_GROUPS
        cut = dict(params, mamba_groups=lm.tree_map(lambda a: a[:g], params["mamba_groups"]))
        return cut, dataclasses.replace(cfg, num_layers=g * cfg.shared_attn_period)
    n = LM_ENCDEC_HELD_LAYERS
    cut = dict(params, **{k: lm.tree_map(lambda a: a[:n], params[k])
                          for k in ("enc_layers", "dec_layers")})
    return cut, dataclasses.replace(cfg, num_layers=n, encoder_layers=n)


def generate_routes(cfg, n):
    """flash_sdpa's launches by route for ``n`` generate calls of LM_TOKENS
    tokens: a wgmma launch for each attention of the prefill, a decode
    launch and its merge for each attention of each of the LM_TOKENS - 1
    decode steps (the hybrid: the shared block's, once a group; the
    encoder-decoder: the encoder's, then the decoder's self- and
    cross-attention at prefill, the decoder's two at a step)."""
    if cfg.arch_type == "hybrid":
        prefill = step = cfg.num_shared_attn
    else:
        prefill, step = cfg.encoder_layers + 2 * cfg.num_layers, 2 * cfg.num_layers
    steps = step * (LM_TOKENS - 1) * n
    return {"wgmma": prefill * n, "decode": steps, "decode_combine": steps, "simt": 0}


def lm_generate_family(torch, dev, cfg, seed, counters):
    """A family served through ``generate`` (the hybrid, the encoder-decoder)
    at the width of ``cfg``: LM_GENERATE_SERVED batches of 8 x 512 through
    ``generate`` (prefill + LM_TOKENS - 1 greedy decode steps, LM_TOKENS
    tokens a row), counted; then, outside the count, decode and prefill
    against the forward and the kernels against the plain versions, held on
    ``held_cut`` in bf16 and in float32, measured at full depth.  Returns
    (report, launches)."""
    from repro_torch.data.lm_synth import synth_lm_batch
    from repro_torch.models import lm
    from repro_torch.serving.decode_loop import generate

    sync = _sync(torch, dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(seed), device=dev)
    sync()
    init_ms = (time.perf_counter() - t0) * 1e3
    rng = np.random.default_rng(seed)
    batches = [{"tokens": torch.from_numpy(synth_lm_batch(rng, LM_BATCH, LM_SEQ, cfg.vocab_size)[0]).to(dev),
                **modality_fields(torch, cfg, LM_BATCH, LM_SEQ, dev, rng)}
               for _ in range(LM_GENERATE_SERVED)]
    lm.forward(params, cfg, batch_cut(batches[0], 1, 8))  # first library calls
    sync()
    reset_counts(counters)
    stage: Dict[str, float] = {}
    tokens = [generate(params, cfg, b, LM_TOKENS, stage_ms=stage) for b in batches]
    sync()
    launches = {c.__name__: c.launches for c in counters}
    split = split_counts(counters)
    n = LM_GENERATE_SERVED
    want = generate_routes(cfg, n)
    if split["flash_sdpa"]["by_route"] != want or sum(launches.values()) != launches["flash_sdpa"]:
        fail(f"{cfg.name}: launches on the generate path {launches}, flash_sdpa by route "
             f"{split['flash_sdpa']['by_route']}, derived {want}")
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else None
    all_toks = torch.cat(tokens)
    if all_toks.shape != (n * LM_BATCH, LM_TOKENS) or int(all_toks.min()) < 0 \
            or int(all_toks.max()) >= cfg.vocab_size:
        fail(f"{cfg.name}: generated tokens of shape {tuple(all_toks.shape)} or ids outside "
             f"[0, {cfg.vocab_size})")

    b0 = batches[0]
    hparams, hcfg = held_cut(lm, params, cfg)
    h32 = lm.tree_map(lambda t: t.float(), hparams)
    c32 = dataclasses.replace(hcfg, dtype="float32")
    checks = decode_vs_forward(torch, lm, hparams, hcfg, b0, LM_BF16_REL_TOL)
    checks["decode_vs_forward_f32"] = decode_vs_forward(torch, lm, h32, c32, b0, LM_F32_REL_TOL)
    checks["full_depth_bf16"] = decode_vs_forward(torch, lm, params, cfg, b0, None)
    checks["kernels_vs_plain"] = kernels_vs_plain(lm, hparams, hcfg, b0, LM_BF16_REL_TOL)[1]
    checks["kernels_vs_plain_f32"] = kernels_vs_plain(lm, h32, c32, b0, LM_F32_REL_TOL)[1]
    checks["kernels_vs_plain_full_depth_bf16"] = kernels_vs_plain(lm, params, cfg, b0, None)[1]
    checks["held_layers"] = {"num_layers": hcfg.num_layers, "encoder_layers": hcfg.encoder_layers}
    del h32
    cache = lm.init_cache(cfg, LM_BATCH, LM_SEQ + LM_TOKENS, device=dev)
    cache_bytes = {k: v.numel() * v.element_size() for k, v in cache.items()}
    del cache
    gen_ms = stage["prefill_ms"] + stage["decode_ms"]
    family = ({"mamba_layers": cfg.num_mamba_layers, "groups": cfg.num_shared_attn}
              if cfg.arch_type == "hybrid" else
              {"encoder_layers": cfg.encoder_layers, "encoder_frames": cfg.encoder_frames})
    report = {
        "arch": cfg.name, "params": sum(t.numel() for t in lm.tree_leaves(params)),
        "layers": cfg.num_layers, **family,
        "d_model": cfg.d_model, "vocab": cfg.vocab_size, "dtype": cfg.dtype,
        "batch": LM_BATCH, "seq": LM_SEQ, "batches": n, "tokens_per_row": LM_TOKENS,
        "init_params_ms": init_ms,
        "prefill_ms_per_batch": stage["prefill_ms"] / n,
        "decode_ms_per_step": stage["decode_ms"] / (n * (LM_TOKENS - 1)),
        "generated_tokens_per_s": n * LM_BATCH * LM_TOKENS / (gen_ms / 1e3),
        "cache_bytes": {"batch": LM_BATCH, "slots": LM_SEQ + LM_TOKENS, **cache_bytes},
        "peak_memory_gib": peak_gib, "checks": checks,
        "launches": launches, "launches_derived": want, "launches_split": split,
    }
    return report, launches


LM_RING_WINDOW, LM_CACHE_STEPS = 256, 16  # the ring's slots; decode steps on each cache


def lm_cache_checks(torch, dev, params, cfg, tokens):
    """The two dense-attention caches at the width and depth of ``cfg``,
    outside the count: ``long_context_variant(cfg, 256)`` prefilled with the
    8 x 512 batch into a 256-slot ring, then 16 decode steps (the decode
    route at q_offset min(pos, C - 1)); the int8 cache (``kv_quant``) and
    the plain cache, 16 decode steps each on the same tokens.  Holds the
    ring's prefill logits against ``forward`` under the window and its
    first decode step (past the boundary) against ``forward`` over the
    extended tokens, at the phase's bf16 tolerance; the int8 prefill logits
    bit-equal to the plain cache's, its first decode step within 5% of the
    largest logit (tests/test_perf_variants.py), and its bytes below the
    plain cache's.  A MoE family comes on its drop-free copy, and each
    held run replays the routing of the run it is held against
    (RoutingLog).  Returns the holds and the ms a decode step of each."""
    from repro_torch.configs import long_context_variant
    from repro_torch.kernels.flash_sdpa import flash_sdpa
    from repro_torch.models import lm

    sync = _sync(torch, dev)
    out = {}

    B, S = tokens.shape

    def decode_run(c, cache, nxt, start, feed=None, replay=None):
        """LM_CACHE_STEPS decode steps from ``start``, each fed the greedy
        token of the step before (of ``feed``'s step, when given): (every
        step's logits, ms a step over all but the first, the first step's
        routing, replaying ``replay`` when given)."""
        logits, first = [], RoutingLog(replay=replay)
        for i in range(LM_CACHE_STEPS):
            if i == 1:
                sync()
                t0 = time.perf_counter()
            if i == 0:
                with first:
                    lg, cache = lm.decode_step(params, c, cache, nxt, start + i)
            else:
                lg, cache = lm.decode_step(params, c, cache, nxt, start + i)
            logits.append(lg)
            nxt = (lg if feed is None else feed[i]).argmax(-1)
        sync()
        return logits, (time.perf_counter() - t0) * 1e3 / (LM_CACHE_STEPS - 1), first

    rcfg = long_context_variant(cfg, window=LM_RING_WINDOW)
    with RoutingLog() as at_prefill:
        last, cache = lm.prefill(params, rcfg, {"tokens": tokens}, capacity=LM_RING_WINDOW)
    with RoutingLog(replay=at_prefill.replay_ids()):
        full, _ = lm.forward(params, rcfg, {"tokens": tokens})
    out["ring_prefill_vs_forward"] = hold_rel(
        f"{cfg.name} ring prefill vs forward (window {LM_RING_WINDOW})", last, full[:, -1],
        LM_BF16_REL_TOL)
    del full
    nxt = last.argmax(-1)
    routes = dict(flash_sdpa.launches_by_route)
    ring_logits, out["ring_decode_ms_per_step"], first = decode_run(rcfg, cache, nxt, S)
    if flash_sdpa.launches_by_route["decode"] - routes["decode"] != LM_CACHE_STEPS * cfg.num_layers:
        fail(f"{cfg.name}: the ring decode did not take flash_sdpa's decode route every step")
    with RoutingLog(replay=RoutingLog.along(B, (at_prefill, S), (first, 1)).replay_ids()):
        ext, _ = lm.forward(params, rcfg, {"tokens": torch.cat([tokens, nxt[:, None]], 1)})
    out["ring_first_step_vs_forward"] = hold_rel(
        f"{cfg.name} ring decode at pos {S} vs forward", ring_logits[0], ext[:, -1],
        LM_BF16_REL_TOL)
    del ext, cache, ring_logits

    C = tokens.shape[1] + LM_CACHE_STEPS
    qcfg = dataclasses.replace(cfg, kv_quant=True)
    last, cache = lm.prefill(params, cfg, {"tokens": tokens}, capacity=C)
    qlast, qcache = lm.prefill(params, qcfg, {"tokens": tokens}, capacity=C)
    if not torch.equal(qlast, last):
        fail(f"{cfg.name}: the int8 cache's prefill logits differ from the plain cache's")
    nbytes = {name: sum(t.numel() * t.element_size() for t in c.values())
              for name, c in (("bf16", cache), ("int8", qcache))}
    if not nbytes["int8"] < nbytes["bf16"]:
        fail(f"{cfg.name}: the int8 cache is not smaller: {nbytes}")
    nxt = last.argmax(-1)
    plain_logits, out["bf16_decode_ms_per_step"], first = decode_run(cfg, cache, nxt, S)
    # the same tokens into the int8 cache: the plain run's greedy choices
    qlogits, out["int8_decode_ms_per_step"], _ = decode_run(
        qcfg, qcache, nxt, S, feed=plain_logits, replay=first.replay_ids())
    out["int8_first_step_vs_bf16"] = hold_rel(f"{cfg.name} int8 cache decode vs bf16 cache",
                                              qlogits[0], plain_logits[0], LM_BF16_REL_TOL)
    rel = [float((q.float() - p.float()).abs().max() / p.float().abs().max())
           for q, p in zip(qlogits, plain_logits)]
    out.update({"int8_prefill_bit_equal": True, "cache_bytes": nbytes,
                "int8_vs_bf16_rel_by_step_max": max(rel), "ring_slots": LM_RING_WINDOW,
                "decode_steps": LM_CACHE_STEPS})
    return out


def lm_serve(torch, smi, dev):
    """The LM phase: each family in turn, its model freed before the next
    (the hybrid and the encoder-decoder through ``lm_generate_family``: no
    cascade, no stream).
    Returns the launches of the main-path runs, summed, and their by-route /
    by-shape split; then the same for the families' streams; and each
    family's main-path launches."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.estimator_mlp import estimator_mlp
    from repro_torch.kernels.flash_sdpa import flash_sdpa
    from repro_torch.kernels.iou_matrix import iou_matrix, iou_matrix_batch
    from repro_torch.kernels.score_pipeline import score_pipeline
    from repro_torch.kernels.wkv6 import wkv6

    counters = (iou_matrix, iou_matrix_batch, estimator_mlp, score_pipeline, flash_sdpa, wkv6)
    total = {c.__name__: 0 for c in counters}
    stream_total = dict(total)
    split_total, stream_split, by_family = {}, {}, {}
    for i, cfg in enumerate(get_config(a) for a in LM_ARCHS):
        t0 = time.perf_counter()
        family = lm_generate_family if cfg.arch_type in ("hybrid", "encdec") else lm_serve_family
        report, launches = family(torch, dev, cfg, seed=10 + i, counters=counters)
        report["seconds"] = time.perf_counter() - t0
        report["card"] = smi
        emit("lm", report)
        by_family[cfg.name] = launches
        for k, n in launches.items():
            total[k] += n
        for k, n in report.get("stream_launches", {}).items():
            stream_total[k] += n
        merge_split(split_total, report["launches_split"])
        merge_split(stream_split, report.get("stream_launches_split", {}))
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return total, split_total, stream_total, stream_split, by_family


# --------------------------------------------------------------- LM training

# lm_train: each family at full width (qwen2-7b cut to 2 of its 28 layers:
# float32 parameters, gradients and the two moments, with the functional
# AdamW's old and new trees at once, do not fit 80 GB for all 28), bf16
# compute over float32 parameters, remat on; LM_TRAIN_STEPS make_train_step
# steps on one synth_lm_batch batch, so that each step's loss is the loss of
# the same batch after the steps before it
LM_TRAIN_MODELS = (("rwkv6_1b6", {}), ("qwen2_7b", {"num_layers": 2}),
                   ("deepseek_v2_lite_16b", {"num_layers": 2}),  # one dense layer, one MoE
                   ("qwen2_vl_2b", {"num_layers": 2}),
                   ("zamba2_2b7", {"num_layers": 6}),  # one group: 5 Mamba2 layers + the shared block
                   ("whisper_base", {}))  # 6 encoder + 6 decoder layers, 1500 frames
LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_STEPS = 2, 512, 3
LM_TRAIN_LR = 3e-4  # the launcher's default: the card-vs-CPU steps on the reduced configs
# AdamW's first steps move every element by about lr (m_hat / sqrt(v_hat) is
# +-1), with the sign of its gradient on this batch, so a layer of fan-in n
# moves its output by about lr * n of itself: at 3e-4 that is 0.6 at d 2048
# and 2.1 / 5.7 at rwkv6's / qwen2's d_ff, and the first card run saw
# rwkv6's loss on the batch rise (11.48 -> 13.85).  The full-width steps
# take lr = LM_TRAIN_SHIFT / the largest fan-in, a 1% move of each output
LM_TRAIN_SHIFT = 0.01


def train_lr(cfg) -> float:
    """The full-width steps' learning rate (LM_TRAIN_SHIFT)."""
    return LM_TRAIN_SHIFT / max(cfg.d_model, cfg.d_ff, cfg.num_heads * cfg.head_dim)
LM_TRAIN_PARITY_STEPS, LM_TRAIN_PARITY_SEQ = 3, 64  # card vs CPU, reduced float32 configs
# kernels against plain=True, one step's gradients leaf by leaf by relative L2
# error.  In bf16 the two forwards differ by roundings that fall differently
# (the wgmma route rounds P to bf16 where the plain version keeps it in
# float32; wkv6's float32 summation order moves a value across a bf16
# rounding), and a leaf whose gradient is a sum over the batch's tokens with
# much cancellation (a mix or norm vector) then moves by a large share of
# itself: the first card run saw rwkv6's cm_mix at 0.12 of its L2 norm.  The
# bound is therefore each leaf's own bf16 noise, measured: the plain bf16
# gradient's distance to the float32 plain gradient (the reference, only
# float32 summation order from exact).  The kernels' bf16 gradient may be at
# most LM_TRAIN_GRAD_NOISE times that distance from the reference, plus
# LM_F32_REL_TOL; by the triangle inequality the kernels-vs-plain distance of
# a leaf is then at most (LM_TRAIN_GRAD_NOISE + 1) times its noise, which is
# the bound printed beside it.  Two runs with the same kind of noise over a
# leaf of thousands of elements give distances of about the same size.
LM_TRAIN_GRAD_NOISE = 2.0
# the gradient check runs three backward passes (kernels, plain bf16, plain
# float32); rwkv6's plain wkv6 backward is a host loop over the tokens (~7 s
# a pass at 512), so the check takes the batch's first 128 tokens
LM_GRAD_CHECK_SEQ = 128
LM_TRAIN_PATH_KERNELS = ("flash_sdpa", "wkv6")  # each must launch in the lm_train phase


def flat_leaves(tree, prefix=""):
    """name -> tensor of a parameter tree (for hold_training)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def device_busy_ms(torch, fn):
    """The card's busy time over ``fn`` and its count of device events: the
    durations of the kernels and copies ``torch.profiler`` records on the
    card, summed (one stream: they do not overlap).  The raw events are
    read, not ``prof.events()``: a plain wkv6 backward makes ~10^5 launches.
    (None, 0) where the profiler saw the card do nothing (not measured)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ns = [e.duration_ns() for e in prof.profiler.kineto_results.events()
          if e.device_type() == DeviceType.CUDA]
    return (sum(ns) / 1e6, len(ns)) if ns else (None, 0)


def lm_train_family(torch, dev, cfg, seed, counters):
    """One family's training at the width of ``cfg``: a short warm-up, the
    counted steps (the last one profiled), then, outside the count, one step
    taken apart and the gradient check (kernels vs plain).  Returns
    (report, launches)."""
    from repro_torch.core.estimator import value_and_grad
    from repro_torch.data.lm_synth import synth_lm_batch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import lm
    from repro_torch.train.adamw import adamw_init, adamw_update

    sync = _sync(torch, dev)
    torch.cuda.reset_peak_memory_stats(dev)
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(seed), device=dev,
                            dtype=torch.float32)
    n_params = sum(t.numel() for t in lm.tree_leaves(params))
    rng = np.random.default_rng(0)
    toks, labels = synth_lm_batch(rng, LM_TRAIN_BATCH, LM_TRAIN_SEQ, cfg.vocab_size)
    batch = {"tokens": torch.from_numpy(toks).to(dev), "labels": torch.from_numpy(labels).to(dev),
             **modality_fields(torch, cfg, LM_TRAIN_BATCH, LM_TRAIN_SEQ, dev, rng)}
    lr = train_lr(cfg)

    def events():
        return [torch.cuda.Event(enable_timing=True) for _ in range(4)]

    def grads_of(c, b, plain=False):
        with torch.enable_grad():
            return value_and_grad(lambda p, c_, b_: lm.loss_fn(p, c_, b_, plain=plain), params, c, b)[1]

    # the library's first calls (kernel modules, cuBLAS handles) outside the
    # count and the timings: one forward and backward at 16 tokens
    grads_of(cfg, batch_cut(batch, 1, 16))

    # the counted main path: LM_TRAIN_STEPS make_train_step steps, the last
    # one under torch.profiler for the card's busy time (the profiler
    # launches nothing; its wall time is the host's, slowed by the profiler)
    step = make_train_step(cfg, lr=lr)
    opt = adamw_init(params)
    sync()
    reset_counts(counters)
    losses, step_ms = [], []

    def one_step():
        nonlocal params, opt
        s, t = events()[:2]
        s.record()
        params, opt, loss = step(params, opt, batch)
        t.record()
        t.synchronize()
        step_ms.append(s.elapsed_time(t))
        losses.append(float(loss))

    for _ in range(LM_TRAIN_STEPS - 1):
        one_step()
    busy_ms, n_events = device_busy_ms(torch, one_step)
    launches = {c.__name__: c.launches for c in counters}
    split = split_counts(counters)
    if not (np.isfinite(losses).all() and all(b < a for a, b in zip(losses, losses[1:]))):
        fail(f"{cfg.name}: training losses on one batch do not fall step by step: {losses}")
    # launches: forward + remat recompute an attention or RWKV layer a step
    # (MLA attends in plain PyTorch: no kernel; the hybrid attends once a
    # group, its Mamba2 layers are tensor ops; the encoder-decoder once an
    # encoder layer and twice a decoder layer)
    kernel = "wkv6" if cfg.arch_type == "rwkv" else None if cfg.use_mla else "flash_sdpa"
    layers = {"hybrid": cfg.num_shared_attn,
              "encdec": cfg.encoder_layers + 2 * cfg.num_layers}.get(cfg.arch_type, cfg.num_layers)
    derived = layers * (2 if cfg.remat else 1) * LM_TRAIN_STEPS if kernel else 0
    if (kernel and launches[kernel] != derived) or sum(launches.values()) != derived:
        fail(f"{cfg.name}: lm_train launches {launches}, derived {kernel} {derived}")

    # one more step taken apart: forward, backward, update (CUDA events)
    e = events()
    with torch.enable_grad():
        leaves = lm.tree_map(lambda t: t.detach().requires_grad_(True), params)
        e[0].record()
        loss = lm.loss_fn(leaves, cfg, batch)
        e[1].record()
        grads = grads_tree(params, torch.autograd.grad(loss, list(lm.tree_leaves(leaves))))
        e[2].record()
    del leaves, loss
    new = adamw_update(grads, opt, params, lr)
    e[3].record()
    e[3].synchronize()
    del new, grads, opt
    parts = {"forward_ms": e[0].elapsed_time(e[1]), "backward_ms": e[1].elapsed_time(e[2]),
             "update_ms": e[2].elapsed_time(e[3])}
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30

    # (b) the gradients through the kernels against plain=True, leaf by leaf,
    # with the float32 plain gradient as the reference (LM_TRAIN_GRAD_NOISE),
    # on the batch's first LM_GRAD_CHECK_SEQ tokens
    cut = batch_cut(batch, LM_TRAIN_BATCH, LM_GRAD_CHECK_SEQ)
    got, plain = flat_leaves(grads_of(cfg, cut)), flat_leaves(grads_of(cfg, cut, plain=True))
    ref = flat_leaves(grads_of(dataclasses.replace(cfg, dtype="float32"), cut, plain=True))
    leaves = {}
    for name, g in got.items():
        w, t = plain.pop(name), ref.pop(name)
        n = float(t.norm())
        r = {"kernels_vs_plain": float((g - w).norm()) / n, "kernels_vs_f32": float((g - t).norm()) / n,
             "plain_vs_f32": float((w - t).norm()) / n}
        r["bound_vs_f32"] = LM_TRAIN_GRAD_NOISE * r["plain_vs_f32"] + LM_F32_REL_TOL
        r["bound_vs_plain"] = (LM_TRAIN_GRAD_NOISE + 1) * r["plain_vs_f32"] + LM_F32_REL_TOL
        if not all(np.isfinite(list(r.values()))) or r["kernels_vs_f32"] > r["bound_vs_f32"]:
            fail(f"{cfg.name}: gradient leaf {name}: kernels at relative L2 {r['kernels_vs_f32']} "
                 f"from the float32 gradient, the plain version at {r['plain_vs_f32']} (bound "
                 f"{r['bound_vs_f32']}); kernels vs plain {r['kernels_vs_plain']}")
        leaves[name] = r
    del got, plain, ref
    worst = max(leaves, key=lambda k: leaves[k]["kernels_vs_plain"])

    steady = step_ms[-2]  # the last step the profiler did not slow
    report = {
        "arch": cfg.name, "params": n_params, "layers": cfg.num_layers, "d_model": cfg.d_model,
        "vocab": cfg.vocab_size, "dtype": cfg.dtype, "param_dtype": "float32", "remat": cfg.remat,
        "batch": LM_TRAIN_BATCH, "seq": LM_TRAIN_SEQ, "lr": lr, "losses": losses,
        "step_ms": step_ms, "tokens_per_s": LM_TRAIN_BATCH * LM_TRAIN_SEQ / (steady / 1e3),
        "peak_memory_gib": peak_gib,
        "step_parts_ms": parts,
        "backward_share": parts["backward_ms"] / sum(parts.values()),
        "device_busy_ms": busy_ms, "device_events": n_events,
        "device_busy_share": busy_ms / steady if busy_ms is not None else None,
        "profiled_step": LM_TRAIN_STEPS,
        "grad_check_seq": LM_GRAD_CHECK_SEQ,
        "grad_rel_l2": {"worst_kernels_vs_plain_leaf": worst, **leaves[worst],
                        "max_kernels_vs_f32": max(r["kernels_vs_f32"] for r in leaves.values()),
                        "max_plain_vs_f32": max(r["plain_vs_f32"] for r in leaves.values()),
                        "leaves": leaves},
        "launches": launches, "launches_derived": {kernel: derived} if kernel else {},
        "launches_split": split,
    }
    del params
    return report, launches


def grads_tree(params, grads):
    """The flat gradients (``tree_leaves`` order) as a tree like ``params``."""
    from repro_torch.models import lm

    it = iter(grads)
    order = {id(t): next(it) for t in lm.tree_leaves(params)}
    return lm.tree_map(lambda t: order[id(t)], params)


def lm_train_parity(torch, dev):
    """Card against CPU on the reduced float32 configs: LM_TRAIN_PARITY_STEPS
    steps from one start on the same batches, held with hold_training's
    criterion (within 2 lr_sum, at most 1% of elements beyond 1e-5)."""
    from repro_torch.configs import get_config
    from repro_torch.data.lm_synth import synth_lm_batch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import lm
    from repro_torch.train.adamw import adamw_init

    out = {}
    for i, arch in enumerate(LM_ARCHS):
        cfg = lm.reduced(get_config(arch))
        start = lm.init_params(cfg, torch.Generator().manual_seed(20 + i), device="cpu",
                               dtype=torch.float32)
        rng = np.random.default_rng(i)
        batches = []
        for _ in range(LM_TRAIN_PARITY_STEPS):
            toks, labels = synth_lm_batch(rng, LM_TRAIN_BATCH, LM_TRAIN_PARITY_SEQ, cfg.vocab_size)
            batches.append({"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels),
                            **modality_fields(torch, cfg, LM_TRAIN_BATCH, LM_TRAIN_PARITY_SEQ, "cpu", rng)})
        got = {}
        for d in (dev, torch.device("cpu")):
            params = lm.tree_map(lambda t: t.to(d), start)
            opt, step, losses = adamw_init(params), make_train_step(cfg, lr=LM_TRAIN_LR), []
            for batch in batches:
                b = {k: v.to(d) for k, v in batch.items()}
                params, opt, loss = step(params, opt, b)
                losses.append(float(loss))
            got[d.type] = (flat_leaves(params), losses)
        worst, share = hold_training(f"{cfg.name} lm_train card vs CPU", got["cuda"][0],
                                     got["cpu"][0], LM_TRAIN_PARITY_STEPS * LM_TRAIN_LR)
        out[cfg.name] = {"steps": LM_TRAIN_PARITY_STEPS, "seq": LM_TRAIN_PARITY_SEQ,
                         "max_abs_diff": worst, "share_beyond_1e-5": share,
                         "losses_card": got["cuda"][1], "losses_cpu": got["cpu"][1]}
    return out


def lm_train(torch, smi, dev):
    """The lm_train phase: each family in turn (its model freed before the
    next), counted; then card vs CPU on the reduced configs and the launcher
    on the card, outside the count.  Returns the launches, their split and
    each family's launches."""
    import dataclasses as dc

    from repro_torch.configs import get_config
    from repro_torch.kernels.estimator_mlp import estimator_mlp
    from repro_torch.kernels.flash_sdpa import flash_sdpa
    from repro_torch.kernels.iou_matrix import iou_matrix, iou_matrix_batch
    from repro_torch.kernels.score_pipeline import score_pipeline
    from repro_torch.kernels.wkv6 import wkv6
    from repro_torch.launch import train as launcher

    t_phase = time.perf_counter()
    counters = (iou_matrix, iou_matrix_batch, estimator_mlp, score_pipeline, flash_sdpa, wkv6)
    total = {c.__name__: 0 for c in counters}
    split_total, by_family = {}, {}
    for i, (arch, cut) in enumerate(LM_TRAIN_MODELS):
        cfg = dc.replace(get_config(arch), **cut)
        t0 = time.perf_counter()
        report, launches = lm_train_family(torch, dev, cfg, seed=30 + i, counters=counters)
        report.update(cut=cut, seconds=time.perf_counter() - t0, card=smi)
        emit("lm_train", report)
        by_family[cfg.name] = launches
        for k, n in launches.items():
            total[k] += n
        merge_split(split_total, report["launches_split"])
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    parity = lm_train_parity(torch, dev)
    _, losses = launcher.main(["--arch", "qwen2_7b", "--steps", "2", "--device", "cuda"])
    emit("lm_train_checks", {"card_vs_cpu": parity, "launcher_losses": losses,
                             "seconds": time.perf_counter() - t0,
                             "phase_seconds": time.perf_counter() - t_phase, "card": smi})
    return total, split_total, by_family


def dry_run(smi):
    """The single-card dry run (``launch.dryrun``) of every arch x shape,
    read against this card's memory (``torch.cuda.get_device_properties``):
    meta tensors only, nothing runs on the card."""
    from repro_torch.configs import ARCH_IDS
    from repro_torch.launch import dryrun
    from repro_torch.launch.input_specs import SHAPES

    t0 = time.perf_counter()
    card = dryrun.card_spec()
    if not card["memory_source"].startswith("torch.cuda.get_device_properties"):
        fail(f"the dry run did not read the card's memory: {card}")
    rows = []
    for arch in ARCH_IDS:
        for shape in SHAPES:
            r = dryrun.report(arch, shape, card)
            if not (r["model_flops"] > 0 and r["argument_bytes"]["total"] > 0):
                fail(f"dry run {arch} {shape}: {r}")
            rows.append({"arch": arch, "shape": shape, "fits_one_card": r["fits_one_card"],
                         "argument_bytes": r["argument_bytes"]["total"],
                         "model_flops": r["model_flops"], "recurrence_flops": r["recurrence_flops"],
                         **r["roofline"]})
    emit("dryrun", {"card": card, "card_smi": smi, "cases": len(rows),
                    "fit_one_card": sum(r["fits_one_card"] for r in rows), "reports": rows,
                    "seconds": time.perf_counter() - t0})


# ---------------------------------------------------------------------------
# the mesh phase: the multi-device half
# ---------------------------------------------------------------------------

MESH_DRYRUN_CELLS = (("qwen2_7b", "train_4k"), ("qwen2_vl_2b", "prefill_32k"),
                     ("deepseek_moe_16b", "train_4k"), ("rwkv6_1b6", "decode_32k"),
                     ("zamba2_2b7", "prefill_32k"), ("whisper_base", "train_4k"))
MESH_ARCH, MESH_SEED = "qwen2_7b", 50
MESH_PREFILL, MESH_STEPS = (8, 512), 16  # the serve step's batch x prompt, greedy decode steps
MESH_TRAIN = (2, 2, 512)  # layers, batch, sequence of the train step
MESH_PATH_KERNELS = ("flash_sdpa",)  # must launch on the mesh path


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _mesh_launches(counters):
    return {c.__name__: c.launches for c in counters}, split_counts(counters)


def mesh_rank(rank: int, world: int, port: int, out: str) -> None:
    """One NCCL rank of the mesh phase (spawned, one a card): qwen2-7b's
    prefill, greedy decode and train steps unbound on this card (the
    reference) and sharded over the (1, world) mesh; rank 0 writes what it
    held and measured to ``out``."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.data.lm_synth import synth_lm_batch
    from repro_torch.kernels.flash_sdpa import flash_sdpa
    from repro_torch.kernels.wkv6 import wkv6
    from repro_torch.launch import mesh as lmesh
    from repro_torch.launch import sharding as tsh
    from repro_torch.launch.meshctx import bind_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import lm
    from repro_torch.train.adamw import adamw_init
    from repro_torch.tree import tree_leaves

    torch.cuda.set_device(rank)
    dev = torch.device("cuda", rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world, device_id=dev)
    counters = (flash_sdpa, wkv6)
    report = {"world": world, "mesh": [1, world], "arch": MESH_ARCH}

    def held(name, got, want, tol):
        got = got.full_tensor() if hasattr(got, "full_tensor") else got
        if world == 1:
            if not torch.equal(got, want):
                fail(f"mesh {name}: the sharded result is not bit-equal to the unbound one "
                     f"at world 1 ({rel_diff(got, want)})")
            return {"bit_equal": True}
        return hold_rel(f"mesh {name}", got, want, tol)

    def timed(fn):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out_ = fn()
        torch.cuda.synchronize(dev)
        return out_, (time.perf_counter() - t0) * 1e3

    try:
        mesh = lmesh.make_mesh((1, world), ("data", "model"), device_type="cuda")
        mapping = lmesh.logical_axes()
        cfg = get_config(MESH_ARCH)
        B, S = MESH_PREFILL
        params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(MESH_SEED), dev)
        rng = np.random.default_rng(MESH_SEED)
        tokens = torch.from_numpy(synth_lm_batch(rng, B, S, cfg.vocab_size)[0]).to(dev, torch.int64)

        def serve(p, batch, n=MESH_STEPS, forced=None):
            """Prefill, then ``n`` decode steps on the greedy tokens, or on
            ``forced``'s (teacher forcing: both paths decode one sequence)."""
            logits, cache = lm.prefill(p, cfg, batch, capacity=S + MESH_STEPS)
            first = logits
            toks, steps = [], []
            for t in range(n):
                full = logits.full_tensor() if hasattr(logits, "full_tensor") else logits
                tok = full.argmax(-1) if forced is None else forced[:, t]
                toks.append(full.argmax(-1))
                logits, cache = lm.decode_step(p, cfg, cache, tok, S + t)
                steps.append(logits)
            return first, torch.stack(toks, 1), steps, cache

        # each timed run follows a short warm-up of its own path (kernels'
        # first launches, DTensor's sharding propagation), outside the count
        serve(params, {"tokens": tokens}, 2)
        (first_u, toks_u, steps_u, _), unbound_ms = timed(lambda: serve(params, {"tokens": tokens}))
        # at world > 1 the sharded steps decode the unbound path's tokens: in
        # bf16 a near-tie argmax of seeded weights flips under another
        # summation order, after which two free runs decode different text
        forced = None if world == 1 else toks_u
        with bind_mesh(mesh, mapping, cache_mode="seq"):
            p = tsh.distribute(params, tsh.param_shardings(params, mesh, mapping))
            batch = {"tokens": tokens}
            b = tsh.distribute(batch, tsh.batch_shardings(batch, mesh, mapping))
            serve(p, b, 2)
            reset_counts(counters)
            (first_s, toks_s, steps_s, cache_s), sharded_ms = timed(
                lambda: serve(p, b, forced=forced))
            serve_launches = _mesh_launches(counters)
            free = toks_s if world == 1 else serve(p, b)[1]
        flips = (free != toks_u).any(dim=0).nonzero()
        report["serve"] = {
            "prefill_logits": held("prefill logits", first_s, first_u, LM_BF16_REL_TOL),
            "step_logits": [held(f"decode step {i} logits", g, w, LM_BF16_REL_TOL)
                            for i, (g, w) in enumerate(zip(steps_s, steps_u))],
            "teacher_forced": forced is not None,
            "argmax_agree": float((toks_s == toks_u).float().mean()),
            "tokens_equal": bool(torch.equal(free, toks_u)),
            "first_free_flip": int(flips[0]) if len(flips) else None,
            "cache_placements": {k: [str(x) for x in v.placements] for k, v in cache_s.items()},
            "ms": sharded_ms, "unbound_ms": unbound_ms, "launches": serve_launches[0],
            "launches_split": serve_launches[1]}
        if world == 1 and not report["serve"]["tokens_equal"]:
            fail("mesh: the sharded greedy tokens differ from the unbound ones at world 1")
        del params, p, cache_s, steps_s, steps_u
        torch.cuda.empty_cache()

        L, Bt, St = MESH_TRAIN
        tcfg = dataclasses.replace(cfg, num_layers=L)
        toks, labels = synth_lm_batch(rng, Bt, St, cfg.vocab_size)
        tbatch = {"tokens": torch.from_numpy(toks).to(dev, torch.int64),
                  "labels": torch.from_numpy(labels).to(dev, torch.int64)}
        step = make_train_step(tcfg, lr=train_lr(tcfg))
        split = json.loads(json.dumps(serve_launches[1]))

        def train_run(mode):
            """One step from the seeded float32 parameters, unbound (mode None)
            or sharded; the loss, AdamW ``mu`` and new parameters come back to
            the host (the card holds one run at a time)."""
            tparams = lm.init_params(tcfg, torch.Generator(device=dev).manual_seed(MESH_SEED + 1),
                                     dev, dtype=torch.float32)
            if mode is None:
                step(tparams, adamw_init(tparams), tbatch)
                (p1, o1, loss), ms = timed(lambda: step(tparams, adamw_init(tparams), tbatch))
                launches = None
            else:
                with bind_mesh(mesh, mapping):
                    ps = tsh.distribute(tparams, tsh.param_shardings(tparams, mesh, mapping, mode))
                    del tparams
                    os_ = adamw_init(ps)  # zeros placed like the parameters, as the rules place them
                    bs = tsh.distribute(tbatch, tsh.batch_shardings(tbatch, mesh, mapping))
                    step(ps, os_, bs)
                    reset_counts(counters)
                    (p1, o1, loss), ms = timed(lambda: step(ps, os_, bs))
                    launches = _mesh_launches(counters)
                    del ps, os_

            def host(t):
                return (t.full_tensor() if hasattr(t, "full_tensor") else t).cpu()

            got = (host(loss), [host(t) for t in tree_leaves(o1.mu)],
                   [host(t) for t in tree_leaves(p1)])
            del p1, o1
            torch.cuda.empty_cache()
            return got, ms, launches

        (loss_u, mu_u, p_u), unbound_ms, _ = train_run(None)
        report["train"] = {"unbound_ms": unbound_ms, "loss": float(loss_u)}
        train_launches = {c.__name__: 0 for c in counters}
        for mode in ("tp", "fsdp"):
            (loss_s, mu_s, p_s), ms, (launches, by) = train_run(mode)
            for k, n in launches.items():
                train_launches[k] += n
            merge_split(split, by)
            row = {"ms": ms, "loss": held(f"{mode} train loss", loss_s, loss_u, LM_BF16_REL_TOL)}
            row["grad_max_rel"] = max(rel_diff(g, w)["rel"] for g, w in zip(mu_s, mu_u))
            if world == 1:
                for what, got, want in (("mu", mu_s, mu_u), ("params", p_s, p_u)):
                    for g, w in zip(got, want):
                        held(f"{mode} train {what}", g, w, None)
                row["bit_equal"] = True
            report["train"][mode] = row
        report["train"]["launches"] = train_launches
        report["launches"] = {k: serve_launches[0][k] + train_launches[k]
                              for k in serve_launches[0]}
        report["launches_split"] = split
        report["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
        if rank == 0:
            with open(out, "w") as f:
                json.dump(report, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def mesh_step_check(world=None):
    """Spawn one NCCL rank a card (``world`` of them, default every visible
    card) for ``mesh_rank``; returns rank 0's report."""
    import torch
    import torch.multiprocessing as mp

    world = world or torch.cuda.device_count()
    with tempfile.TemporaryDirectory() as tmp:
        out = str(Path(tmp) / "mesh.json")
        mp.spawn(mesh_rank, args=(world, _free_port(), out), nprocs=world, join=True)
        with open(out) as f:
            return json.load(f)


def mesh_dry_run_start():
    """The dry-run cells on the production mesh, one subprocess each, all
    started at once (meta tensors and a fake process group: no card)."""
    env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="")
    procs = []
    for arch, shape in MESH_DRYRUN_CELLS:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--mesh", "single_pod",
               "--arch", arch, "--shape", shape]
        procs.append((arch, shape, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)))
    return procs


def mesh_dry_run_finish(procs):
    rows = []
    for arch, shape, t0, proc in procs:
        out, err = proc.communicate(timeout=600)
        if proc.returncode != 0:
            fail(f"mesh dry run {arch} {shape} exited {proc.returncode}: {err[-2000:]}")
        r = json.loads([x for x in out.splitlines() if x.startswith("{")][-1])
        ratio = r["model_flops_ratio"]
        if not (r["devices"] == 256 and r["per_device"]["hlo_flops"] > 0 and ratio
                and 0 < ratio <= 1.5):
            fail(f"mesh dry run {arch} {shape}: {r}")
        pd = r["per_device"]
        rows.append({"arch": arch, "shape": shape, "mesh": r["mesh"],
                     "seconds": time.perf_counter() - t0, "trace_s": r["lower_s"],
                     "flops": pd["hlo_flops"], "bytes": pd["hlo_bytes"],
                     "collective_bytes": pd["collective_bytes"],
                     "collectives": pd["collectives"], "by_axis": pd["collectives_by_axis"],
                     "argument_bytes": r["memory"]["argument_bytes"],
                     "fits_one_card": r["memory"]["fits_one_card"],
                     "roofline": {k: v for k, v in r["roofline"].items() if k != "rates"},
                     "model_flops_ratio": ratio})
    return rows


def mesh(torch, smi):
    """The mesh phase.  Returns the sharded runs' launches and their split."""
    t_phase = time.perf_counter()
    procs = mesh_dry_run_start()
    world = torch.cuda.device_count()
    report = mesh_step_check(world)
    report["card"] = smi
    if world == 1:
        report["note"] = "one card: world 1 (NCCL takes one rank a device)"
    missing = [k for k in MESH_PATH_KERNELS if report["launches"][k] == 0]
    if missing:
        fail(f"kernels never launched on the mesh path: {missing}")
    emit("mesh_step", report)
    rows = mesh_dry_run_finish(procs)
    emit("mesh_dryrun", {"cells": rows, "card": smi,
                         "phase_seconds": time.perf_counter() - t_phase})
    # every counter's split (the other kernels do not run on this path)
    from repro_torch.kernels.estimator_mlp import estimator_mlp
    from repro_torch.kernels.flash_sdpa import flash_sdpa
    from repro_torch.kernels.iou_matrix import iou_matrix, iou_matrix_batch
    from repro_torch.kernels.score_pipeline import score_pipeline
    from repro_torch.kernels.wkv6 import wkv6

    counters = (iou_matrix, iou_matrix_batch, estimator_mlp, score_pipeline, flash_sdpa, wkv6)
    reset_counts(counters)
    split = split_counts(counters)
    split.update(report["launches_split"])
    return report["launches"], split


# the examples phase: each module of repro_torch.examples through its main()
# on the card, in this order (serve_cascade serves the checkpoint the first
# train_lm run writes, before the RWKV run writes its own to the same path)
EXAMPLES_RUNS = (
    ("quickstart", []),
    ("offload_detection", ["--quick"]),
    ("stream_offload", []),
    ("train_lm", ["--steps", "20"]),
    ("serve_cascade", []),
    ("train_lm", ["--arch", "rwkv6_1b6", "--steps", "3"]),
    ("observability", []),
    ("netsim_congestion", []),
    ("video_offload", []),
    ("online_adaptation", []),
    ("fleet_scale", []),
    ("mobility_handover", []),
)
# the kernels the scripts reach.  No script matches or suppresses one image,
# so iou_matrix's one-image counter is not among them (the IoU routes launch
# under iou_matrix_batch); score_pipeline neither: the scripts decide lists
# of detections, as the JAX package's do, and the fused pipeline runs only on
# a padded DetectionsBatch (it launches on the serve, train, stream, repro
# and fleet paths)
EXAMPLES_PATH_KERNELS = ("iou_matrix_batch", "estimator_mlp", "flash_sdpa", "wkv6")
EXAMPLES_OBS_FRAMES = 512  # observability's stream


def _bulk(value) -> bool:
    """A path, or an array or tensor of one or more dimensions."""
    return getattr(value, "ndim", 0) > 0 or (isinstance(value, str) and os.sep in value)


def headline(obj):
    """What a script's ``run`` returned, as JSON, without its paths and
    arrays: numpy scalars and 0-d tensors as Python numbers, keys as str."""
    if isinstance(obj, dict):
        return {k if isinstance(k, str) else str(k): headline(v) for k, v in obj.items()
                if not _bulk(v)}
    if isinstance(obj, (list, tuple)):
        return [headline(v) for v in obj if not _bulk(v)]
    if hasattr(obj, "item"):
        return obj.item()
    return obj if obj is None or isinstance(obj, (bool, int, float, str)) else str(obj)


def finite_numbers(what, obj):
    """Fail unless every number in ``obj`` (nested dicts and lists) is
    finite, but for the two values the package gives as undefined, as
    ``repro`` does: a coverage sample's ``time_to_loss`` = inf (the client
    never leaves coverage) and the NaN numbers of an empty subset (a dict
    with ``pct`` 0: table II's)."""
    if isinstance(obj, dict):
        empty = obj.get("pct") == 0.0
        for k, v in obj.items():
            if not ((k == "time_to_loss" and v == float("inf"))
                    or (empty and isinstance(v, float) and np.isnan(v))):
                finite_numbers(f"{what}.{k}", v)
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            finite_numbers(f"{what}[{i}]", v)
    elif isinstance(obj, float) and not np.isfinite(obj):
        fail(f"{what} is {obj}")


def check_example(name, args, out):
    """Each script's own invariants on the card, and finite numbers in what
    its ``run`` returned (``headline``, which the examples line prints)."""
    head = headline(out)
    finite_numbers(name, head)
    if name == "offload_detection" and not out["round_trip_exact"]:
        fail("offload_detection: the engine's save / load round trip is not exact")
    if name == "stream_offload" and not out["rerun_equal"]:
        fail("stream_offload: the seeded rerun's records differ")
    if name == "train_lm" and "--arch" not in args and not out["last10"] < out["first10"]:
        fail(f"train_lm: the loss did not fall ({out['first10']} -> {out['last10']})")
    if name == "serve_cascade" and not (out["loaded"] and out["decisions_identical"]):
        fail(f"serve_cascade: checkpoint loaded {out['loaded']}, decisions identical after "
             f"save / load {out['decisions_identical']}")
    if name == "observability" and out["processed"] != EXAMPLES_OBS_FRAMES:
        fail(f"observability: {out['processed']} frames processed of {EXAMPLES_OBS_FRAMES}")
    if name == "fleet_scale" and not (out["plane"]["bit_identical"]
                                      and out["plane"]["devices"] == FLEET_SHARDS):
        fail(f"fleet_scale: the plane is not bit-identical to the engine: {out['plane']}")
    if name == "mobility_handover":
        m = out["motion"]
        if not (m["waypoint"]["max_abs"] == 0.0 and m["random_walk"]["max_abs"] <= MOBILE_WALK_TOL
                and all(v["rerun_identical"] for v in m.values())):
            fail(f"mobility_handover: rollout against rollout_ref / rerun: {m}")
    return head


def examples(torch, smi, dev):
    """The examples phase: every module of ``repro_torch.examples`` through
    its ``main`` on the card (``EXAMPLES_RUNS``), its artifacts and output
    files in a temporary directory, the scripts' printing sent to stderr;
    every launch count set to 0 first and each script's launches taken as a
    ``kernel_stats`` delta.  Fails unless every script returns, its
    invariants hold (``check_example``) and every kernel of
    ``EXAMPLES_PATH_KERNELS`` launched.  Returns the phase's launches, their
    split, and the scripts that launched each reward-head shape."""
    import repro_torch.examples as ex
    import repro_torch.experiments.detection_repro as tdr
    from repro_torch.kernels.estimator_mlp import estimator_mlp
    from repro_torch.kernels.flash_sdpa import flash_sdpa
    from repro_torch.kernels.iou_matrix import iou_matrix, iou_matrix_batch
    from repro_torch.kernels.score_pipeline import score_pipeline
    from repro_torch.kernels.wkv6 import wkv6
    from repro_torch.obs import kernel_stats

    counters = (iou_matrix, iou_matrix_batch, estimator_mlp, score_pipeline, flash_sdpa, wkv6)
    t_phase = time.perf_counter()
    reset_counts(counters)
    rows, head_where = [], {}
    cwd, saved = os.getcwd(), (ex.ARTIFACTS, tdr.ARTIFACTS)
    with tempfile.TemporaryDirectory() as tmp:
        ex.ARTIFACTS = tdr.ARTIFACTS = tmp
        os.chdir(tmp)
        try:
            for name, args in EXAMPLES_RUNS:
                mod = importlib.import_module(f"repro_torch.examples.{name}")
                before, shapes_before = kernel_stats.snapshot(), split_counts(counters)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(sys.stderr):
                    out = mod.main(args)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                launches = kernel_stats.delta(before, kernel_stats.snapshot())["launches"]
                for kernel, parts in split_counts(counters).items():
                    for key, n in parts.get("by_shape", {}).items():
                        if n > shapes_before.get(kernel, {}).get("by_shape", {}).get(key, 0):
                            head_where.setdefault((kernel, key), []).append(name)
                rows.append({"script": name, "args": args, "seconds": seconds,
                             "launches": {k: n for k, n in launches.items() if n},
                             "result": check_example(name, args, out)})
        finally:
            os.chdir(cwd)
            ex.ARTIFACTS, tdr.ARTIFACTS = saved
    phase_s = time.perf_counter() - t_phase
    launches = {c.__name__: c.launches for c in counters}
    split = split_counts(counters)
    for c in split.values():
        c["by_shape"] = {k: n for k, n in c.get("by_shape", {}).items() if n}
    missing = [k for k in EXAMPLES_PATH_KERNELS if launches[k] == 0]
    print(json.dumps({"examples": {"scripts": rows, "phase_s": phase_s, "launches": launches,
                                   "launches_split": split, "card": smi}}), flush=True)
    if missing:
        fail(f"kernels never launched on the examples path: {missing}")
    return launches, split, head_where


def add_head_rows(torch, timer, dev, records, head_where):
    """``time_head`` rows for the reward-head shapes the examples launched
    that no row times yet, each ``where`` naming its scripts and each held
    against the plain version, so that the timed and held shapes account
    for every launch of the main paths."""
    rng = np.random.default_rng(11)
    params = None
    for (name, key), scripts in sorted(head_where.items()):
        if name not in HEAD_KERNELS or key in {r["key"] for r in records[name]["shapes"]}:
            continue
        dims = {k: int(v) for k, v in (kv.split("=") for kv in key.split())}
        where = f"{', '.join(sorted(set(scripts)))} (examples)"
        if name == "estimator_mlp":
            row = head_row(torch, timer, dev, rng, dims["B"], dims["F"], dims["H"], where,
                           dims.get("of"))
        else:
            params = params or seeded_head_params(torch, rng, dev)
            row = pipeline_row(torch, timer, dev, rng, params, dims["B"], dims["K"], where,
                               dims.get("of"))
        finish_head_rows(name, [row], dev)
        records[name]["shapes"].append(row)
        records[name]["max_abs_err"] = max(records[name]["max_abs_err"], row["max_abs_err"])


def check_example_lm_kernels(torch, dev, records):
    """flash_sdpa and wkv6 against their plain versions at the shapes the
    examples launch them: the ~100M models of ``train_lm.scaled_100m``
    (float32, head dim 64, so flash_sdpa takes its simt route) at
    train_lm's batch (the forward, and the Function's gradients against the
    plain version's autograd, as the train step's backward takes them) and
    at serve_cascade's (the forward); wkv6 at the RWKV model's heads from a
    zero state, as the layer runs it (the forward, and the gradients of
    out).  The shapes are read from the modules (``scaled_100m`` and the
    defaults of ``run``).  Each case joins its kernel's record as
    ``examples_holds``; the forward errors also its ``max_abs_err``."""
    import inspect

    from repro_torch.examples import serve_cascade, train_lm
    from repro_torch.kernels.flash_sdpa import flash_sdpa, flash_sdpa_ref
    from repro_torch.kernels.wkv6 import wkv6, wkv6_ref

    rng = np.random.default_rng(2626)
    holds = {"flash_sdpa": [], "wkv6": []}

    def normal(shape, scale=1.0):
        return torch.tensor(rng.normal(0, scale, shape).astype(np.float32), device=dev)

    def hold(kernel, case, got, want, tol):
        e = held_err(f"{kernel} {case}", got, want, tol)
        holds[kernel].append({"case": case, "max_abs_err": e, "tol": tol})
        records[kernel]["max_abs_err"] = max(records[kernel]["max_abs_err"], e)

    def defaults(mod):
        params = inspect.signature(mod.run).parameters
        return params["batch"].default, params["seq"].default

    dense = train_lm.scaled_100m("yi_6b")
    H, K, D, win = dense.num_heads, dense.num_kv_heads, dense.head_dim, dense.window
    for mod in (train_lm, serve_cascade):
        B, S = defaults(mod)
        q, k, v = normal((B, S, H, D)), normal((B, S, K, D)), normal((B, S, K, D))
        case = f"{mod.__name__.rsplit('.', 1)[1]}: B={B} S=T={S} H={H} K={K} D={D} f32 window={win}"
        before = flash_sdpa.launches_by_route["simt"]
        hold("flash_sdpa", case, flash_sdpa(q, k, v, window=win),
             flash_sdpa_ref(q, k, v, window=win), 2e-6)
        if flash_sdpa.launches_by_route["simt"] != before + 1:
            fail(f"flash_sdpa at {case} did not take the simt route")
        if mod is train_lm:
            holds["flash_sdpa"].append(grad_case(
                torch, "flash_sdpa", f"{case}, gradients",
                lambda q, k, v: flash_sdpa(q, k, v, window=win),
                lambda q, k, v: flash_sdpa_ref(q, k, v, window=win), (q, k, v),
                (normal((B, S, H, D)),)))
    rwkv = train_lm.scaled_100m("rwkv6_1b6").rwkv()
    B, T = defaults(train_lm)
    H, K = rwkv.num_heads, rwkv.head_size
    w = torch.tensor(rng.uniform(0.5, 0.99, (B, T, H, K)).astype(np.float32), device=dev)
    ins = (normal((B, T, H, K)), normal((B, T, H, K)), normal((B, T, H, K)), w,
           normal((H, K), scale=0.2), torch.zeros((B, H, K, K), device=dev))
    case = f"train_lm --arch rwkv6_1b6: B={B} T={T} H={H} K=V={K} f32, zero state"
    # the LM prefill's rule (check_lm_kernels): 1e-5 of the largest |out| / |state|
    for part, got, want in zip(("out", "state"), wkv6(*ins), wkv6_ref(*ins)):
        hold("wkv6", f"{case} {part}", got, want, 1e-5 * float(want.abs().max()))
    holds["wkv6"].append(grad_case(torch, "wkv6", f"{case}, gradients of out",
                                   lambda *a: wkv6(*a)[0], lambda *a: wkv6_ref(*a)[0], ins,
                                   (normal((B, T, H, K)),)))
    for kernel, cases in holds.items():
        records[kernel]["examples_holds"] = cases
    emit("check_examples_lm", holds)


KERNELS = {  # the IoU kernels' source: the route of their record (nms; IOU_SOURCES has all three)
    "iou_matrix": ("src/repro_torch/kernels/csrc/iou_nms.cu", "src/repro/kernels/iou_matrix/kernel.py:27"),
    "iou_matrix_batch": ("src/repro_torch/kernels/csrc/iou_nms.cu", "src/repro/kernels/iou_matrix/kernel.py:46"),
    "estimator_mlp": ("src/repro_torch/kernels/csrc/estimator_mlp.cu", "src/repro/kernels/estimator_mlp/kernel.py:19"),
    "score_pipeline": ("src/repro_torch/kernels/csrc/score_pipeline.cu", "src/repro/kernels/score_pipeline/kernel.py:32"),
    "flash_sdpa": ("src/repro_torch/kernels/csrc/flash_sdpa_wgmma.cu", "src/repro/kernels/flash_sdpa/kernel.py:24"),
    "wkv6": ("src/repro_torch/kernels/csrc/wkv6.cu", "src/repro/kernels/wkv6/kernel.py:22"),
}
# flash_sdpa's three routes, one source each: prefill (the "source" above),
# decode (split-K + merge), and float32 / D = 32
FLASH_SOURCES = {
    "wgmma": "src/repro_torch/kernels/csrc/flash_sdpa_wgmma.cu",
    "decode": "src/repro_torch/kernels/csrc/flash_sdpa_decode.cu",
    "simt": "src/repro_torch/kernels/csrc/flash_sdpa.cu",
}
LM_PATH_KERNELS = ("flash_sdpa", "wkv6", "estimator_mlp")  # each must launch in the lm phase
TRAIN_PATH_KERNELS = ("iou_matrix_batch", "estimator_mlp", "score_pipeline")  # ... in the train phase
REPRO_PATH_KERNELS = ("iou_matrix_batch", "estimator_mlp", "score_pipeline")  # ... in the repro phase
HEAD_KERNELS = ("estimator_mlp", "score_pipeline")  # the reward head: timed at each main-path shape


def main() -> None:
    t_start = time.perf_counter()
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run chip_smoke.py from a checkout of the repo")
    args = sys.argv[1:]
    for flag, kernels, time_fn in (("--head-times", HEAD_KERNELS, time_head),
                                   ("--iou-times", IOU_LIBS, time_iou)):
        if flag in args:
            times_only(Path(args[args.index("--src") + 1]).resolve() if "--src" in args else SRC,
                       kernels, time_fn)
            return
    sys.path.insert(0, str(SRC))
    import torch

    smi = probe(torch)
    build()
    dev = torch.device("cuda")
    timer = Timer(torch)
    records = check_kernels(torch, timer, dev)
    records.update(check_iou_routes(torch, timer, dev))
    records.update(check_lm_kernels(torch, timer, dev))
    check_example_lm_kernels(torch, dev, records)
    detection, detection_split = serve(torch, smi, dev)
    train_launches, train_split, trained = train(torch, smi, dev)
    stream_launches, stream_split = stream(torch, smi, dev, trained)
    del trained
    repro_launches, repro_split = repro(torch, smi, dev)
    video_launches, video_split = video(torch, smi, dev)
    fleet_launches, fleet_split = fleet(torch, smi, dev)
    mobility_launches, mobility_split = mobility(torch, smi, dev)
    lm_launches, lm_split, lm_stream, lm_stream_split, lm_by_family = lm_serve(torch, smi, dev)
    lm_train_launches, lm_train_split, lm_train_by_family = lm_train(torch, smi, dev)
    dry_run(smi)
    mesh_launches, mesh_split = mesh(torch, smi)
    examples_launches, examples_split, head_where = examples(torch, smi, dev)
    add_head_rows(torch, timer, dev, records, head_where)
    # the stream path: the detection stream and the two LM streams
    stream_launches = {k: n + lm_stream[k] for k, n in stream_launches.items()}
    merge_split(stream_split, lm_stream_split)
    paths = {"detection": detection, "train": train_launches, "stream": stream_launches,
             "repro": repro_launches, "video": video_launches, "fleet": fleet_launches,
             "mobility": mobility_launches, "lm": lm_launches, "lm_train": lm_train_launches,
             "mesh": {k: mesh_launches.get(k, 0) for k in lm_launches},
             "examples": examples_launches}
    splits = {"detection": detection_split, "train": train_split, "stream": stream_split,
              "repro": repro_split, "video": video_split, "fleet": fleet_split,
              "mobility": mobility_split, "lm": lm_split, "lm_train": lm_train_split,
              "mesh": mesh_split, "examples": examples_split}
    for name in HEAD_KERNELS:  # each timed shape's launches on the main paths
        for row in records[name]["shapes"]:
            row["launches"] = sum(sp.get(name, {}).get("by_shape", {}).get(row["key"], 0)
                                  for sp in splits.values())
        total = sum(row["launches"] for row in records[name]["shapes"])
        if total != sum(p[name] for p in paths.values()):
            fail(f"{name}: the timed shapes account for {total} of its launches "
                 f"({ {p: n[name] for p, n in paths.items()} }); by shape: "
                 f"{ {p: sp.get(name) for p, sp in splits.items()} }")
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        r = records[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(p[name] for p in paths.values()), "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r.get("library_ms"),
            "launches_by_path": {p: n[name] for p, n in paths.items()},
            **({"launches_split": lm_split[name],
                "lm_launches_by_family": {f: n[name] for f, n in lm_by_family.items()}}
               if name in lm_split and name not in HEAD_KERNELS + IOU_KERNELS else {}),
            **{key: r[key] for key in EXTRA_SHAPES.values() if key in r},
            **({"train": r["train"], "lm_train_launches_split": lm_train_split.get(name),
                "lm_train_launches_by_family": {f: n[name] for f, n in lm_train_by_family.items()}}
               if "train" in r else {}),
            **({k: r[k] for k in ("path_ms", "host_us", "shapes")} if name in HEAD_KERNELS else {}),
            **({"sources_by_route": FLASH_SOURCES} if name == "flash_sdpa" else {}),
            **({"examples_holds": r["examples_holds"]} if "examples_holds" in r else {}),
            **({"sources_by_route": IOU_SOURCES,
                "launches_by_route": {p: sp[name]["by_route"] for p, sp in splits.items()
                                      if p != "lm"},
                "launches_by_shape": {p: splits[p][name]["by_shape"] for p in ("video", "fleet")},
                **{k: r[k] for k in ("path_ms", "host_us", "routes")}}
               if name in IOU_KERNELS else {}),
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    missing = [k["name"] for k in kernels if k["launches"] == 0]
    if missing:
        fail(f"kernels never launched on their serve paths: {missing}")
    missing = [k for k in LM_PATH_KERNELS if paths["lm"][k] == 0]
    if missing:
        fail(f"kernels never launched on the LM path: {missing}")
    missing = [k for k in LM_TRAIN_PATH_KERNELS if paths["lm_train"][k] == 0]
    if missing:
        fail(f"kernels never launched on the lm_train path: {missing}")
    missing = [k for k in TRAIN_PATH_KERNELS if paths["train"][k] == 0]
    if missing:
        fail(f"kernels never launched on the train path: {missing}")
    missing = [k for k in STREAM_PATH_KERNELS if paths["stream"][k] == 0]
    if missing:
        fail(f"kernels never launched on the stream path: {missing}")
    missing = [k for k in REPRO_PATH_KERNELS if paths["repro"][k] == 0]
    if missing:
        fail(f"kernels never launched on the repro path: {missing}")
    missing = [k for k in VIDEO_PATH_KERNELS if paths["video"][k] == 0]
    if missing:
        fail(f"kernels never launched on the video path: {missing}")
    missing = [k for k in FLEET_PATH_KERNELS if paths["fleet"][k] == 0]
    if missing:
        fail(f"kernels never launched on the fleet path: {missing}")
    missing = [k for k in MOBILE_PATH_KERNELS if paths["mobility"][k] == 0]
    if missing:
        fail(f"kernels never launched on the mobility path: {missing}")
    missing = [k for k in MESH_PATH_KERNELS if paths["mesh"][k] == 0]
    if missing:
        fail(f"kernels never launched on the mesh path: {missing}")
    print(json.dumps({"seconds": time.perf_counter() - t_start}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
