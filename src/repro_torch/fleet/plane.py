"""The sharded serve-time data plane: the batched offload hot path (reward
scoring from features or from a ``DetectionsBatch``, ``match_batch``,
``extract_features_batch``) with **streams as the sharded axis** over the
devices of :func:`repro_torch.launch.mesh.make_fleet_mesh` — bit for bit
the single-device results.

The port of ``repro.fleet.plane``.  ``repro`` runs one ``shard_map``
program over a JAX mesh; here one process launches each shard's work on the
shard's device (launches are asynchronous, so the devices work side by
side) and gathers the results onto the first device.  A mesh may repeat a
device (``["cpu"] * 4``, or four times ``cuda:0``), which runs the shard
logic on one device.

Bit-exactness is the contract (the fleet runtime compares shards' decisions
against single-device traces), and it does not come free:

* On the card, the reward head's launch plan (``mlp_plan``: cluster size,
  F-split, tile, F-chunks) follows the batch size, and with it the order of
  each row's float32 sums.  So every shard launches ``estimator_mlp`` (for
  :meth:`FleetPlane.score`) or ``score_pipeline`` (for
  :meth:`FleetPlane.score_detections`) with the plan of the *global* batch,
  cut to the shard's rows (``plan=``).
* On the CPU, the plain version's float32 results depend on the row count
  (``x @ w1``'s blocking) and on a row's place in it (the vectorized
  elementwise loops take their last elements one at a time), so a CPU
  shard would have to recompute the whole batch's layout to match it: the
  CPU shards instead take their rows of one plain call over the whole
  batch.  The card's ``plan=`` launches are the sharded scoring under
  test; on the CPU the shard sizes and the gathering are exercised by
  ``match`` and ``extract_features``.
* COCO matching plans per image (``iou_plan``), and the feature stack is
  per-image tensor arithmetic: neither needs padding.

``score_detections`` runs ``score_pipeline`` per shard, the route
``engine.score_device(batch)`` takes; it equals that bit for bit (the port's
composed features -> ``estimator_mlp`` route agrees with it within 1e-5
only, so the plane holds the one route).  With one device, or a reward model
that is not fused, every method falls through to the engine's own path.
Results come back to the host as numpy, as ``repro``'s do.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.features import box_feature_stack, extract_features_batch, pad_box_axis
from repro_torch.detection.batch import (
    DetectionsBatch,
    GroundTruthBatch,
    MatchResult,
    match_batch,
)
from repro_torch.kernels.estimator_mlp import estimator_mlp
from repro_torch.kernels.estimator_mlp.ops import head_plan
from repro_torch.kernels.iou_matrix import greedy_match
from repro_torch.kernels.score_pipeline import score_pipeline
from repro_torch.kernels.score_pipeline.ops import pipeline_plan
from repro_torch.launch.mesh import make_fleet_mesh
from repro_torch.obs.kernel_stats import count_call

#: the JAX plane's Pallas tiling arguments to ``match``: the port's match
#: route plans its own tiles per image
TPU_MATCH_ARGS = ("interpret", "tile_b", "tile_n", "tile_m")

_BLOCK_FIELDS = ("boxes", "scores", "classes", "mask")
_GT_FIELDS = ("boxes", "classes", "mask")


def _pad_rows(t: torch.Tensor, rows: int) -> torch.Tensor:
    """``t`` extended with zero rows to ``rows`` rows."""
    if t.shape[0] == rows:
        return t
    return torch.cat([t, t.new_zeros((rows - t.shape[0],) + tuple(t.shape[1:]))])


class FleetPlane:
    """The offload data plane over a list of shard devices.

    Parameters
    ----------
    mesh : sequence of devices or None
        Shard ``s`` runs on ``mesh[s]`` (typically ``make_fleet_mesh``'s
        list); ``None`` builds one over ``n_shards`` visible CUDA devices.
    n_shards : int or None
        Device count for the constructed mesh (``None`` = all visible);
        ignored when ``mesh`` is given.
    """

    def __init__(self, mesh: Optional[Sequence] = None, *, n_shards: Optional[int] = None):
        self.devices: List[torch.device] = (
            make_fleet_mesh(devices=mesh) if mesh is not None else make_fleet_mesh(n_shards)
        )
        self._params: Dict[torch.device, Tuple[dict, dict]] = {}

    @property
    def n_devices(self) -> int:
        return len(self.devices)

    def shard_sizes(self, n: int) -> Tuple[int, int]:
        """(rows per shard, padded total) for ``n`` items over the mesh —
        the last shard is ragged; padding fills it."""
        per = -(-n // self.n_devices)
        return per, per * self.n_devices

    def _head(self, model, device: torch.device) -> Dict[str, torch.Tensor]:
        """The model's ``pipeline_params`` bundle on ``device`` (copied once
        a device while the model's bundle stays the same object)."""
        bundle = model.pipeline_params()
        got = self._params.get(device)
        if got is None or got[0] is not bundle:
            got = (bundle, {k: v.to(device) for k, v in bundle.items()})
            self._params[device] = got
        return got[1]

    def _gather(self, outs: Sequence[torch.Tensor], n: int) -> np.ndarray:
        home = self.devices[0]
        return torch.cat([o.to(home) for o in outs])[:n].cpu().numpy()

    # ------------------------------------------------------------- scoring

    def score(self, engine, features) -> np.ndarray:
        """Batched reward estimates with rows sharded over the mesh —
        bit-identical to ``engine.score``.  Non-fused reward models (and
        1-device meshes) fall through to the engine's own path."""
        x = np.asarray(features, np.float32)
        model = engine.reward_model
        B = x.shape[0]
        if self.n_devices == 1 or B == 0 or not getattr(model, "fused", False):
            return np.asarray(engine.score(features=x))
        count_call("fleet_plane.score")
        p = model.pipeline_params()
        xt = engine.features(features=x)
        if model.config.standardize:  # as predict_device does
            xt = (xt - p["mu"]) / p["sigma"]
        per, total = self.shard_sizes(B)
        xt = _pad_rows(xt, total)
        F, H = p["w1"].shape
        outs, plain = [], None
        for s, dev in enumerate(self.devices):
            w = self._head(model, dev)
            args = (w["w1"], w["b1"], w["w2"], w["b2"])
            lo, hi = s * per, (s + 1) * per
            if dev.type == "cuda":
                outs.append(estimator_mlp(xt[lo:hi].to(dev), *args,
                                          plan=head_plan(B, F, H, dev)))
            else:  # the plain version, once over the whole batch
                plain = estimator_mlp(xt[:B].to(dev), *args) if plain is None else plain
                outs.append(plain[lo:hi])
        return self._gather(outs, B)

    def score_detections(self, engine, batch: DetectionsBatch) -> np.ndarray:
        """Boxes -> estimates with images sharded over the mesh, one
        ``score_pipeline`` launch a shard — bit-identical to
        ``engine.score_device(batch)``.  Engines without the fused MLP and
        the box feature extractor, and 1-device meshes, fall through to the
        engine's own device path."""
        B = len(batch)
        if self.n_devices == 1 or B == 0 or not engine._fused_pipeline_ready(batch, None):
            return engine.score_device(batch).cpu().numpy()
        count_call("fleet_plane.score_detections")
        fx, model = engine.feature_extractor, engine.reward_model
        per, total = self.shard_sizes(B)
        padded = batch.pad_images(total)
        F, H = model.pipeline_params()["w1"].shape
        K, top_k = padded.max_boxes, int(fx.top_k)
        kw = dict(num_classes=int(fx.num_classes), top_k=top_k, image_size=float(fx.image_size))
        outs, plain = [], None
        for s, dev in enumerate(self.devices):
            params = self._head(model, dev)
            lo, hi = s * per, (s + 1) * per
            if dev.type == "cuda":
                block = tuple(getattr(padded, f)[lo:hi].to(dev) for f in _BLOCK_FIELDS)
                outs.append(score_pipeline(block, params, **kw,
                                           plan=pipeline_plan(B, K, top_k, F, H, dev)))
            else:  # the plain version, once over the whole batch
                if plain is None:
                    block = tuple(getattr(padded, f)[:B].to(dev) for f in _BLOCK_FIELDS)
                    plain = score_pipeline(block, params, **kw)
                outs.append(plain[lo:hi])
        return self._gather(outs, B)

    # ------------------------------------------------------------ matching

    def match(
        self,
        det: DetectionsBatch,
        gt: GroundTruthBatch,
        iou_thresholds: Sequence[float] = (0.5,),
        **kwargs,
    ) -> MatchResult:
        """Batched COCO greedy matching with images sharded over the mesh,
        one ``match`` launch of the IoU family a shard on the card —
        bit-identical to single-device :func:`match_batch`.  The JAX plane's
        tiling arguments (``interpret``, ``tile_b``, ``tile_n``,
        ``tile_m``) do not exist here and raise."""
        if kwargs:
            tpu = sorted(set(kwargs) & set(TPU_MATCH_ARGS))
            raise TypeError(
                f"FleetPlane.match() got {sorted(kwargs)}: "
                + (f"{tpu} are the TPU kernel's tiling arguments; the CUDA match route "
                   "plans its own tiles" if tpu else "unexpected keyword arguments")
            )
        if len(det) != len(gt):
            raise ValueError(f"batch size mismatch: {len(det)} dets vs {len(gt)} gts")
        B = len(det)
        if self.n_devices == 1 or B == 0:
            return match_batch(det, gt, iou_thresholds)
        per, total = self.shard_sizes(B)
        det_p, gt_p = det.pad_images(total), gt.pad_images(total)
        tps, mjs = [], []
        for s, dev in enumerate(self.devices):
            lo, hi = s * per, (s + 1) * per
            d = [getattr(det_p, f)[lo:hi].to(dev) for f in _BLOCK_FIELDS]
            g = [getattr(gt_p, f)[lo:hi].to(dev) for f in _GT_FIELDS]
            thresholds = torch.tensor(list(iou_thresholds), dtype=torch.float32, device=dev)
            tp, mj = greedy_match(*d, *g, thresholds)
            tps.append(tp)
            mjs.append(mj)
        return MatchResult(
            tp=self._gather(tps, B),
            match_gt=self._gather(mjs, B),
            iou_thresholds=tuple(float(t) for t in iou_thresholds),
        )

    # ------------------------------------------------------------ features

    def extract_features(
        self,
        batch: DetectionsBatch,
        num_classes: int,
        top_k: int = 25,
        image_size: float = 1.0,
    ) -> np.ndarray:
        """The weak-output feature stack with images sharded over the mesh
        — bit-identical to :func:`extract_features_batch`."""
        B = len(batch)
        if self.n_devices == 1 or B == 0:
            return extract_features_batch(batch, num_classes, top_k, image_size).cpu().numpy()
        per, total = self.shard_sizes(B)
        padded = batch.pad_images(total)
        outs = []
        for s, dev in enumerate(self.devices):
            block = [getattr(padded, f)[s * per : (s + 1) * per].to(dev) for f in _BLOCK_FIELDS]
            arrays = pad_box_axis(*block, int(top_k))
            outs.append(box_feature_stack(*arrays, float(image_size), int(num_classes),
                                          int(top_k)))
        return self._gather(outs, B)
