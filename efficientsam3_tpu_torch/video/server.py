"""Session-based video predictor server.

Counterpart of efficientsam3_tpu/video/server.py (which mirrors the
reference's request-dispatch server: start_session / handle_request /
handle_stream_request / shutdown, without its per-GPU worker processes): a
thread-safe session registry over one TrackerPredictor in this process.

Request verbs: add_points, add_mask, remove_object, propagate_in_video (a
streaming generator), cancel, close_session.
"""

from __future__ import annotations

import threading
import time
import uuid
from typing import Iterator, Optional

import numpy as np
import torch


def _device_name(device) -> str:
    if device.type == "cuda":
        return f"{device}: {torch.cuda.get_device_name(device)}"
    return str(device)


def _to_numpy(masks):
    if isinstance(masks, torch.Tensor):
        return masks.float().cpu().numpy()
    return np.asarray(masks)


class Session:
    def __init__(self, session_id: str, frames, tracker_state):
        self.session_id = session_id
        self.frames = frames
        self.state = tracker_state
        self.created = time.time()
        self.cancelled = threading.Event()


class VideoPredictorServer:
    """Single-host serving facade over VideoPCSPredictor / TrackerPredictor."""

    def __init__(self, tracker_predictor, detector=None, pcs_config=None):
        self.tracker = tracker_predictor
        self.detector = detector
        self.pcs_config = pcs_config
        self._sessions: dict[str, Session] = {}
        self._lock = threading.Lock()

    # -- session lifecycle (reference :132 start_session) -----------------
    def start_session(self, frames) -> str:
        session_id = uuid.uuid4().hex
        state = self.tracker.init_state(frames)
        with self._lock:
            self._sessions[session_id] = Session(session_id, frames, state)
        return session_id

    def _get(self, session_id: str) -> Session:
        with self._lock:
            if session_id not in self._sessions:
                raise KeyError(f"unknown session {session_id}")
            return self._sessions[session_id]

    def close_session(self, session_id: str):
        with self._lock:
            self._sessions.pop(session_id, None)

    def shutdown(self):
        with self._lock:
            self._sessions.clear()

    def session_stats(self) -> dict:
        """Session counts and ages, and the device the tracker runs on."""
        with self._lock:
            return {
                "num_sessions": len(self._sessions),
                "sessions": {
                    s.session_id: {
                        "num_frames": s.state["num_frames"],
                        "num_objects": len(s.state["obj_ids"]),
                        "age_s": time.time() - s.created,
                    }
                    for s in self._sessions.values()
                },
                "devices": [_device_name(self.tracker.device)],
            }

    # -- prompt requests ---------------------------------------------------
    def add_points(self, session_id, frame_idx, obj_id, points=None, labels=None,
                   box=None):
        s = self._get(session_id)
        return self.tracker.add_new_points_or_box(
            s.state, frame_idx, obj_id, points=points, labels=labels, box=box
        )

    def add_mask(self, session_id, frame_idx, obj_id, mask):
        s = self._get(session_id)
        return self.tracker.add_new_mask(s.state, frame_idx, obj_id, mask)

    def remove_object(self, session_id, obj_id):
        s = self._get(session_id)
        self.tracker.remove_object(s.state, obj_id)

    # -- streaming propagation (reference :119 handle_stream_request) ------
    def propagate_in_video(
        self, session_id, start_frame_idx: Optional[int] = None,
        reverse: bool = False,
    ) -> Iterator[dict]:
        s = self._get(session_id)
        for frame_idx, obj_ids, masks in self.tracker.propagate_in_video(
            s.state, start_frame_idx=start_frame_idx, reverse=reverse
        ):
            if s.cancelled.is_set():
                s.cancelled.clear()
                return
            yield {
                "session_id": session_id,
                "frame_idx": frame_idx,
                "obj_ids": obj_ids,
                "masks": _to_numpy(masks),
            }

    def cancel(self, session_id):
        self._get(session_id).cancelled.set()
