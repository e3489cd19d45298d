"""Video promptable concept segmentation: per-frame detect + track.

Counterpart of efficientsam3_tpu/video/pipeline.py (which mirrors the
reference's sam3_video_base.py _det_track_one_frame), a host-driven loop
over the two device programs of a frame:

  1. detection on the current frame (the image model's grounding, through
     the ``detector`` callable, + mask NMS),
  2. tracker propagation for all object slots (one batched tracker step),
  3. association planning on the host: the mask-IoU matrix between
     detections and tracked masks; tracks match one-to-one by the Hungarian
     method (or any-above-threshold); detections spawn new masklets only
     when unmatched AND confident,
  4. hotstart bookkeeping: keep-alive counters, removal of young unmatched
     or duplicate masklets, suppression, optional masklet confirmation;
     reconditioning on high-confidence high-IoU detections; execution of
     adds and removes,
  5. output assembly with hotstart RETRO-EMISSION: outputs are buffered for
     ``hotstart_delay`` frames and emitted only after the removal and
     confirmation verdicts for that window are known, so a masklet
     confirmed at frame t is retroactively visible on frames t-delay..t.

``add_instance_points`` routes user clicks on a tracked masklet through the
tracker predictor, re-conditioning that object's memory at the clicked
frame.

The planning is host code over numpy, as in the JAX package. What touches
the device besides the two programs: the mask-IoU matrices (one matrix
product each, on the tracker's device) and one device -> host copy of the
tracked low-res masks per frame (a second on a frame that spawns, removes or
re-conditions). Emission fills holes on the host (``ops/cc``).
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Optional

import numpy as np
import torch

from efficientsam3_tpu_torch.ops.cc import fill_holes_in_mask_scores_host
from efficientsam3_tpu_torch.ops.interpolate import resize_bilinear
from efficientsam3_tpu_torch.ops.masks import mask_iou, nms_masks


@dataclasses.dataclass
class VideoPCSConfig:
    """Detection/tracking heuristics (reference sam3_video_base.py:36-133,
    defaults follow the reference unless noted)."""

    det_score_thresh: float = 0.5  # score_threshold_detection
    nms_iou_thresh: float = 0.7  # det_nms_thresh (ref default 0 = off)
    assoc_iou_thresh: float = 0.5  # det "matched to" a track
    trk_assoc_iou_thresh: float = 0.5  # track "matched by" a det
    new_det_thresh: float = 0.6  # score needed to spawn a new masklet
    o2o_matching_masklets: bool = True  # Hungarian for track matching
    # hotstart (sam3_video_base.py:54-63): hold outputs for `hotstart_delay`
    # frames; young masklets unmatched/duplicated >= thresh frames inside the
    # window are removed retroactively
    hotstart_delay: int = 15
    hotstart_unmatch_thresh: int = 3
    hotstart_dup_thresh: int = 3
    suppress_unmatched_only_within_hotstart: bool = True
    init_trk_keep_alive: int = 0
    max_trk_keep_alive: int = 8
    min_trk_keep_alive: int = -4
    decrease_trk_keep_alive_for_empty_masklets: bool = False
    # masklet confirmation (sam3_video_base.py:74-77)
    masklet_confirmation_enable: bool = False
    masklet_confirmation_consecutive_det_thresh: int = 3
    # reconditioning (sam3_video_base.py:453): re-anchor a masklet's memory
    # on a high-confidence (>=0.8) high-IoU (>=0.8) matched detection every
    # nth frame (-1 = off, the reference default)
    recondition_every_nth_frame: int = -1
    fill_hole_area: int = 16  # sam3_video_base.py:69
    obj_slots: int = 8
    max_dets: int = 20


@dataclasses.dataclass
class Masklet:
    obj_id: int
    start_frame: int
    consecutive_matched: int = 0
    confirmed: bool = False


class VideoPCSPredictor:
    """Single-host video PCS: text-prompted detection + streaming tracking."""

    HIGH_CONF_THRESH = 0.8  # reconditioning gates (sam3_video_base.py:1277)
    HIGH_IOU_THRESH = 0.8

    def __init__(
        self,
        detector,
        tracker_predictor,
        cfg: Optional[VideoPCSConfig] = None,
        detector_batch=None,
        frame_chunk: int = 1,
    ):
        """detector: callable(frame (H,W,3), text_state) ->
            {'masks' (D, H, W) bool, 'scores' (D,), 'boxes' (D, 4)} after
            thresholding+NMS (host-filtered).
        tracker_predictor: video.predictor.TrackerPredictor.
        detector_batch + frame_chunk > 1 enable chunked detection:
        detections for the next `frame_chunk` frames are computed in ONE
        batched call of fixed width. Frame-parallel detection (the
        reference's P2, sam3_image.py:701 forward_video_grounding_multigpu)
        wraps the batched model call in parallel.frame_parallel over a
        'frames' mesh axis: each rank grounds its share of the chunk and the
        outputs are all-gathered, so every rank turns the whole chunk into
        per-frame dicts (tests/test_torch_parallel.py runs it on two ranks).
        detector_batch: callable(frames (F,H,W,3), text_state) -> list of F
        per-frame detection dicts.
        """
        self.detector = detector
        self.detector_batch = detector_batch
        self.frame_chunk = frame_chunk
        self.tracker = tracker_predictor
        self.cfg = cfg or VideoPCSConfig()
        self._next_obj_id = 0
        self.device = tracker_predictor.device  # where the IoU matrices run

    def _detect(self, session, t, reverse=False):
        """Single-frame detection, or chunk-prefetched batched detection."""
        if self.detector_batch is None or self.frame_chunk <= 1:
            return self.detector(session["frames"][t], session["text_state"])
        cache = session.setdefault("_det_cache", {})
        if t not in cache:
            n = session["state"]["num_frames"]
            step = -1 if reverse else 1
            idxs = [
                u for u in range(t, t + step * self.frame_chunk, step)
                if 0 <= u < n
            ]
            # pad to the fixed chunk width
            padded = idxs + [idxs[-1]] * (self.frame_chunk - len(idxs))
            batch = np.stack([np.asarray(session["frames"][u]) for u in padded])
            outs = self.detector_batch(batch, session["text_state"])
            for k, u in enumerate(idxs):
                cache[u] = outs[k]
        return cache.pop(t)

    def _resize_masks(self, masks, size):
        m = torch.as_tensor(masks, device=self.device).float()[:, None]
        return (resize_bilinear(m, size)[:, 0] > 0.5).cpu().numpy()

    # -- association (reference sam3_video_base.py:1160) -------------------
    def associate_det_trk(self, det_masks, det_scores, trk_masks, trk_obj_ids):
        """Returns (new_det_inds, unmatched_trk_ids, det_to_matched_trk_ids,
        trk_id_to_high_conf_det, empty_trk_ids)."""
        cfg = self.cfg
        trk_obj_ids = np.asarray(trk_obj_ids, np.int64)
        n_det, n_trk = det_masks.shape[0], trk_masks.shape[0]
        if n_trk == 0:
            new = np.nonzero(np.asarray(det_scores) >= cfg.new_det_thresh)[0]
            return new, np.array([], np.int64), {}, {}, np.array([], np.int64)
        trk_nonempty = trk_masks.reshape(n_trk, -1).any(axis=1)
        if n_det == 0:
            return (
                np.array([], np.int64),
                trk_obj_ids[trk_nonempty],
                {},
                {},
                trk_obj_ids[~trk_nonempty],
            )

        if det_masks.shape[1:] != trk_masks.shape[1:]:
            # resize to the smaller resolution (sam3_video_base.py:1224-1240)
            if np.prod(det_masks.shape[1:]) < np.prod(trk_masks.shape[1:]):
                trk_masks = self._resize_masks(trk_masks, det_masks.shape[1:])
            else:
                det_masks = self._resize_masks(det_masks, trk_masks.shape[1:])
        ious = mask_iou(torch.as_tensor(det_masks, device=self.device).bool(),
                        torch.as_tensor(trk_masks, device=self.device).bool()).cpu().numpy()

        if cfg.o2o_matching_masklets:
            from scipy.optimize import linear_sum_assignment

            rows, cols = linear_sum_assignment(1.0 - ious)
            trk_matched = np.zeros(n_trk, bool)
            for d, t in zip(rows, cols):
                if ious[d, t] >= cfg.trk_assoc_iou_thresh:
                    trk_matched[t] = True
        else:
            trk_matched = (ious >= cfg.trk_assoc_iou_thresh).any(axis=0)
        unmatched_trk = trk_obj_ids[trk_nonempty & ~trk_matched]
        empty_trk = trk_obj_ids[~trk_nonempty]

        det_scores = np.asarray(det_scores)
        is_new = (det_scores >= cfg.new_det_thresh) & ~(
            ious >= cfg.assoc_iou_thresh
        ).any(axis=1)
        new_det = np.nonzero(is_new)[0]

        det_to_trk = {
            d: trk_obj_ids[ious[d] >= cfg.assoc_iou_thresh] for d in range(n_det)
        }
        recond = {}
        high = (
            (det_scores >= self.HIGH_CONF_THRESH)
            & ~is_new
            & (ious.max(axis=1) >= self.HIGH_IOU_THRESH)
        )
        for d in np.nonzero(high)[0]:
            recond[int(trk_obj_ids[np.argmax(ious[d])])] = int(d)
        return new_det, unmatched_trk, det_to_trk, recond, empty_trk

    # -- session lifecycle --------------------------------------------------

    def init_session(self, frames, text_state):
        return {
            "frames": frames,
            "text_state": text_state,
            "state": self.tracker.init_state(frames),
            "masklets": {},  # obj_id -> Masklet
            "meta": {
                "obj_first_frame": {},
                "unmatched_frames": defaultdict(list),
                "keep_alive": {},
                "overlap_frames": defaultdict(list),
                "removed": set(),
                "suppressed": defaultdict(set),  # frame -> obj_ids
                "unconfirmed": {},  # frame -> set(obj_ids)
            },
        }

    def add_instance_points(self, session, frame_idx, obj_id, points, labels):
        """User clicks on a TRACKED masklet mid-video (reference
        sam3_video_inference.py:1415 add_tracker_new_points): re-condition
        its memory at this frame; later frames attend to the new memory."""
        if obj_id not in session["state"]["obj_ids"]:
            raise ValueError(f"object {obj_id} is not tracked")
        self.tracker.add_new_points_or_box(
            session["state"], frame_idx, obj_id, points=points, labels=labels
        )
        out = session["state"]["cond_frames"][frame_idx]
        slot = session["state"]["obj_ids"].index(obj_id)
        return out["low_res_masks"][slot, 0].float().cpu().numpy()

    # -- per-frame step (reference _det_track_one_frame) --------------------

    def _step(self, session, t, reverse=False):
        cfg = self.cfg
        state = session["state"]
        masklets = session["masklets"]
        meta = session["meta"]

        # 1. detection (optionally chunk-prefetched / frame-parallel)
        det = self._detect(session, t, reverse)
        det_masks = np.asarray(det["masks"])[: cfg.max_dets]
        det_scores = np.asarray(det["scores"])[: cfg.max_dets]
        if cfg.nms_iou_thresh > 0 and len(det_masks) > 1:
            # per-frame detector mask-NMS (reference det_nms_thresh,
            # sam3_image.py:817-831 applies nms_masks to video detections)
            keep = nms_masks(
                torch.as_tensor(det_masks, device=self.device),
                torch.as_tensor(det_scores, device=self.device), cfg.nms_iou_thresh,
            ).cpu().numpy()
            det_masks = det_masks[keep]
            det_scores = det_scores[keep]

        # 2. propagate existing masklets (one batched tracker program)
        trk_ids = [m.obj_id for m in masklets.values()]
        trk_masks = np.zeros((0, 1, 1), bool)
        frame_out = tracked = None
        if trk_ids and state["cond_frames"]:
            with torch.inference_mode():
                frame_out = self.tracker._run_track_frame(state, t, reverse)
            state["non_cond_frames"][t] = frame_out
            self.tracker._trim_non_cond(state, t, reverse)
            slots = [state["obj_ids"].index(i) for i in trk_ids]
            # the frame's one device -> host copy of the tracked masks
            tracked = frame_out["low_res_masks"][:, 0].float().cpu().numpy()
            trk_masks = tracked[slots] > 0

        # 3. association
        new_det, unmatched_trk, det_to_trk, recond, empty_trk = (
            self.associate_det_trk(det_masks, det_scores, trk_masks, trk_ids)
        )

        # 4. hotstart bookkeeping (_process_hotstart)
        hot_diff = t - cfg.hotstart_delay if not reverse else t + cfg.hotstart_delay
        newly_removed = set()
        matched_trks = set()
        for ids in det_to_trk.values():
            matched_trks.update(int(i) for i in ids)
        ka = meta["keep_alive"]
        for oid in matched_trks:
            ka[oid] = min(cfg.max_trk_keep_alive, ka.get(oid, 0) + 1)
        for oid in unmatched_trk:
            oid = int(oid)
            meta["unmatched_frames"][oid].append(t)
            ka[oid] = max(cfg.min_trk_keep_alive, ka.get(oid, 0) - 1)
        if cfg.decrease_trk_keep_alive_for_empty_masklets:
            for oid in empty_trk:
                ka[int(oid)] = max(cfg.min_trk_keep_alive, ka.get(int(oid), 0) - 1)

        def _in_hotstart(oid):
            first = meta["obj_first_frame"][oid]
            return (first > hot_diff) if not reverse else (first < hot_diff)

        for oid, frames_u in meta["unmatched_frames"].items():
            if oid in meta["removed"] or oid in newly_removed or oid not in masklets:
                continue
            if len(frames_u) >= cfg.hotstart_unmatch_thresh and _in_hotstart(oid):
                newly_removed.add(oid)
            if (
                ka.get(oid, 0) <= 0
                and not cfg.suppress_unmatched_only_within_hotstart
            ):
                meta["suppressed"][t].add(oid)

        # duplicate removal: several masklets matched to one detection
        for d, ids in det_to_trk.items():
            ids = [int(i) for i in ids]
            if len(ids) < 2:
                continue
            first = (min if not reverse else max)(
                ids, key=lambda x: meta["obj_first_frame"][x]
            )
            for oid in ids:
                if oid != first:
                    meta["overlap_frames"][(first, oid)].append(t)
        for (first, oid), frames_o in meta["overlap_frames"].items():
            if oid in meta["removed"] or oid in newly_removed or oid not in masklets:
                continue
            if len(frames_o) >= cfg.hotstart_dup_thresh and _in_hotstart(oid):
                newly_removed.add(oid)

        for oid in newly_removed:
            self.tracker.remove_object(state, oid)
            masklets.pop(oid, None)
        meta["removed"].update(newly_removed)

        # reconditioning on high-confidence high-IoU matched detections
        if (
            cfg.recondition_every_nth_frame > 0
            and t % cfg.recondition_every_nth_frame == 0
        ):
            for oid, d in recond.items():
                if oid in masklets:
                    self.tracker.add_new_mask(state, t, oid, det_masks[d])

        # execution: spawn new masklets from unmatched confident detections
        spawned = set()
        for i in new_det:
            if len(state["obj_ids"]) >= cfg.obj_slots:
                break
            obj_id = self._next_obj_id
            self._next_obj_id += 1
            self.tracker.add_new_mask(state, t, obj_id, det_masks[i])
            masklets[obj_id] = Masklet(obj_id, t)
            meta["obj_first_frame"][obj_id] = t
            ka[obj_id] = cfg.init_trk_keep_alive
            spawned.add(obj_id)

        # masklet confirmation via consecutive matched detections; the BIRTH
        # detection counts as a match (sam3_video_base.py:1681-1685)
        unconfirmed = set()
        for m in masklets.values():
            if m.obj_id in matched_trks or m.obj_id in spawned:
                m.consecutive_matched += 1
            else:
                m.consecutive_matched = 0
            if (
                m.consecutive_matched
                >= cfg.masklet_confirmation_consecutive_det_thresh
            ):
                m.confirmed = True
            if not m.confirmed:
                unconfirmed.add(m.obj_id)
        meta["unconfirmed"][t] = unconfirmed

        # 5. raw per-frame outputs (filtered at emission time)
        out_masks = {}
        src = state["cond_frames"].get(t) or state["non_cond_frames"].get(t)
        if src is not None and masklets:
            if src is not frame_out or newly_removed or spawned or t in state["cond_frames"]:
                # slots shifted or rows rewritten since the copy above
                tracked = src["low_res_masks"][:, 0].float().cpu().numpy()
            for m in masklets.values():
                slot = state["obj_ids"].index(m.obj_id)
                if self.tracker._slot_ok(src, slot):
                    # copy: buffered outputs must survive later slot shifts
                    out_masks[m.obj_id] = tracked[slot].copy()
        return {"frame_idx": t, "masks": out_masks, "det_scores": det_scores}

    # -- emission with hotstart retro-filtering -----------------------------

    def _emit(self, session, raw, reverse=False):
        cfg = self.cfg
        meta = session["meta"]
        t = raw["frame_idx"]
        # confirmation verdict is read `thresh - 1` frames in the future
        # (sam3_video_inference.py:287-296)
        delay = cfg.masklet_confirmation_consecutive_det_thresh - 1
        status_frame = t + delay if not reverse else t - delay
        status_frame = max(0, min(status_frame, session["state"]["num_frames"] - 1))
        unconfirmed = (
            meta["unconfirmed"].get(status_frame, set())
            if cfg.masklet_confirmation_enable
            else set()
        )
        drop = meta["removed"] | meta["suppressed"].get(t, set()) | unconfirmed
        ids, masks = [], []
        for oid, mask in raw["masks"].items():
            if oid in drop:
                continue
            ids.append(oid)
            masks.append(mask)
        masks = np.stack(masks) if masks else np.zeros((0, 1, 1), np.float32)
        if cfg.fill_hole_area > 0 and len(ids):
            # host union-find: emission already runs on host numpy.
            # remove_sprinkles=True matches the reference video call sites
            # (sam3_video_base.py:970, :1147)
            masks = fill_holes_in_mask_scores_host(
                masks, cfg.fill_hole_area, remove_sprinkles=True,
                native=self.device.type == "cuda",
            )
        return {
            "frame_idx": t,
            "obj_ids": ids,
            "masks": masks,
            "det_scores": raw["det_scores"],
        }

    def propagate(self, session, start_frame: int = 0, reverse: bool = False):
        """Generator over frames with hotstart retro-emission."""
        cfg = self.cfg
        n = session["state"]["num_frames"]
        order = range(start_frame, -1, -1) if reverse else range(start_frame, n)
        order = list(order)
        buffer = []
        for t in order:
            raw = self._step(session, t, reverse)
            if cfg.hotstart_delay > 0:
                buffer.append(raw)
                if t == order[-1]:
                    yield_list, buffer = buffer, []
                elif len(buffer) >= cfg.hotstart_delay:
                    yield_list, buffer = buffer[:1], buffer[1:]
                else:
                    yield_list = []
            else:
                yield_list = [raw]
            for raw_out in yield_list:
                yield self._emit(session, raw_out, reverse)

    def run_video(self, frames, text_state, start_frame: int = 0):
        """Convenience wrapper: one-shot session + forward propagation."""
        session = self.init_session(frames, text_state)
        yield from self.propagate(session, start_frame)
