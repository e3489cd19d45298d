"""Video/image loading for inference (host only).

The port's copy of efficientsam3_tpu/video/io.py; PIL, cv2 and imageio are
imported where a loader first needs them. Mirrors reference sam3/sam3/model/io_utils.py (JPEG-folder videos, mp4
decoding, async prefetch loaders, fp16 CPU offload). JPEG/PNG frame
folders (the DAVIS/MOSE/SA-V layout) load through PIL with a threaded
prefetcher; mp4s decode through cv2 with an imageio fallback, either
whole (load_video_frames) or streaming (Mp4FrameReader — the analog of
the reference's TorchCodec streaming loader, io_utils.py:486, without a
torchcodec dependency).
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Optional, Sequence

import numpy as np

FRAME_EXTS = (".jpg", ".jpeg", ".png")


def list_frame_files(path: str) -> list:
    files = [
        f for f in sorted(os.listdir(path)) if f.lower().endswith(FRAME_EXTS)
    ]
    if not files:
        raise FileNotFoundError(f"no image frames in {path}")
    return [os.path.join(path, f) for f in files]


def load_frame(path: str, resolution: Optional[int] = None) -> np.ndarray:
    from PIL import Image

    img = Image.open(path).convert("RGB")
    if resolution is not None:
        img = img.resize((resolution, resolution), Image.BILINEAR)
    return np.asarray(img, np.uint8)


def load_video_frames(
    path: str,
    resolution: Optional[int] = None,
    offload_to_fp16: bool = False,
    max_frames: Optional[int] = None,
):
    """Load a video as (T, H, W, 3). `path` is a frame folder or an mp4
    (mp4 requires cv2/torchcodec; reference io_utils.py:29)."""
    if os.path.isdir(path):
        files = list_frame_files(path)[:max_frames]
        frames = np.stack([load_frame(f, resolution) for f in files])
    else:
        frames = _load_mp4(path, resolution, max_frames)
    if offload_to_fp16:
        frames = (frames.astype(np.float16) / 255.0)
    return frames


def iter_mp4_frames(path, resolution=None, max_frames=None):
    """Stream decoded RGB uint8 frames from an mp4, one at a time (bounded
    memory for long videos). Backend chain: cv2, then imageio."""
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        cap = cv2.VideoCapture(path)
        if not cap.isOpened():
            raise FileNotFoundError(f"could not open video {path}")
        try:
            n = 0
            while max_frames is None or n < max_frames:
                ok, frame = cap.read()
                if not ok:
                    break
                frame = np.ascontiguousarray(frame[:, :, ::-1])
                if resolution is not None:
                    frame = cv2.resize(frame, (resolution, resolution))
                n += 1
                yield frame
        finally:
            cap.release()
        return
    try:
        import imageio.v3 as iio
    except ImportError as e:
        raise ImportError(
            "mp4 decoding needs cv2 or imageio; extract frames to a JPEG "
            "folder instead"
        ) from e
    from PIL import Image

    for n, frame in enumerate(iio.imiter(path)):
        if max_frames is not None and n >= max_frames:
            break
        frame = np.asarray(frame, np.uint8)
        if resolution is not None:
            frame = np.asarray(
                Image.fromarray(frame).resize(
                    (resolution, resolution), Image.BILINEAR
                )
            )
        yield frame


def _load_mp4(path, resolution, max_frames):
    frames = list(iter_mp4_frames(path, resolution, max_frames))
    if not frames:
        raise ValueError(f"no frames decoded from {path}")
    return np.stack(frames)


class Mp4FrameReader:
    """Streaming mp4 access with a threaded decode-ahead buffer — the
    sequential-read analog of AsyncFrameLoader for container videos
    (reference's TorchCodec async loader, io_utils.py:486): frames arrive
    in order, __getitem__ blocks until the requested frame is decoded, and
    frames older than keep_window are evicted."""

    def __init__(self, path: str, resolution: Optional[int] = None,
                 prefetch: int = 8, offload_to_fp16: bool = False,
                 keep_window: Optional[int] = None):
        self.offload_to_fp16 = offload_to_fp16
        self.keep_window = keep_window
        self._frames: dict[int, np.ndarray] = {}
        self._produced = -1
        self._done = False
        self._error = None
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._queue = queue.Queue(maxsize=prefetch)
        self._it = iter_mp4_frames(path, resolution)
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _producer(self):
        try:
            for i, frame in enumerate(self._it):
                if self.offload_to_fp16:
                    frame = frame.astype(np.float16) / 255.0
                self._queue.put(None)  # backpressure slot
                with self._cv:
                    self._frames[i] = frame
                    self._produced = i
                    self._cv.notify_all()
        except Exception as e:  # surface decode errors to the consumer
            with self._cv:
                self._error = e
                self._cv.notify_all()
                return
        with self._cv:
            self._done = True
            self._cv.notify_all()

    def __getitem__(self, idx: int) -> np.ndarray:
        with self._cv:
            while idx not in self._frames:
                if self._error is not None:
                    raise self._error
                if idx <= self._produced or self._done:
                    raise IndexError(
                        f"frame {idx} unavailable (evicted or past the end; "
                        "Mp4FrameReader is forward-streaming)"
                    )
                self._cv.wait(timeout=30)
            frame = self._frames[idx]
            if self.keep_window is not None:
                for k in [k for k in self._frames if k < idx - self.keep_window]:
                    del self._frames[k]
        try:
            self._queue.get_nowait()
        except queue.Empty:
            pass
        return frame

    @property
    def num_frames_decoded(self) -> int:
        with self._lock:
            return self._produced + 1


class AsyncFrameLoader:
    """Threaded frame prefetcher (reference AsyncImageFrameLoader
    io_utils.py:339): index access blocks only until that frame is decoded."""

    def __init__(self, frame_paths: Sequence[str], resolution: Optional[int] = None,
                 prefetch: int = 8, offload_to_fp16: bool = False,
                 keep_window: Optional[int] = None):
        """offload_to_fp16 stores decoded frames as normalized fp16 (halved
        host RAM, reference io_utils.py CPU-offload); keep_window evicts
        frames more than `keep_window` indices behind the newest access so
        long videos stream in bounded memory (re-decoded on re-access)."""
        self.paths = list(frame_paths)
        self.resolution = resolution
        self.offload_to_fp16 = offload_to_fp16
        self.keep_window = keep_window
        self._frames: dict[int, np.ndarray] = {}
        self._produced = -1
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._queue = queue.Queue(maxsize=prefetch)
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def __len__(self):
        return len(self.paths)

    def _decode(self, path):
        frame = load_frame(path, self.resolution)
        if self.offload_to_fp16:
            frame = frame.astype(np.float16) / 255.0
        return frame

    def _producer(self):
        for i, p in enumerate(self.paths):
            frame = self._decode(p)
            self._queue.put(None)  # backpressure slot
            with self._cv:
                self._frames[i] = frame
                self._produced = i
                self._cv.notify_all()

    def __getitem__(self, idx: int) -> np.ndarray:
        with self._cv:
            while idx not in self._frames:
                if idx <= self._produced:
                    # already evicted: synchronous re-decode
                    return self._decode(self.paths[idx])
                self._cv.wait(timeout=30)
            frame = self._frames[idx]
            if self.keep_window is not None:
                for k in [k for k in self._frames if k < idx - self.keep_window]:
                    del self._frames[k]
        try:
            self._queue.get_nowait()
        except queue.Empty:
            pass
        return frame
