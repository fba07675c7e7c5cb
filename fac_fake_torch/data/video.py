"""Video decode, the predictor's frame-sampling policy and the S3D snippet
indices (host side) — the port of the scoring paths' part of
`fac_fake_tpu/data/video.py`.

`cv2` is imported only inside the decoding methods: the machine with the
card has no cv2, and `VideoScorer` accepts any reader with ``frame_count``
and ``stream_frames_at_indices`` in its place.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np


def predict_indices(frame_count: int, fraction: float = 0.1,
                    jump: int = 5) -> List[int]:
    """The reference predictor reads the frame at the current position and
    *then* seeks, so iteration 1 and 2 both hit frame 0; afterwards the
    position advances by `jump`. Iterations = int(fraction · frame_count)
    (`cvit_prediction.py:160-198`)."""
    n = int(frame_count * fraction)
    out: List[int] = []
    for k in range(n):
        idx = 0 if k == 0 else jump * (k - 1)
        if idx >= frame_count:
            break
        out.append(idx)
    return out


def first_n_indices(frame_count: int, n: int = 20) -> List[int]:
    """The single-GPU S3D trainer's snippet: the first ``n`` crops."""
    return list(range(min(n, frame_count)))


def strided_indices(frame_count: int, limit: int = 200, stride: int = 10) -> List[int]:
    """The S3D test snippet: every ``stride``-th of the first ``limit`` crops."""
    return list(range(0, min(limit, frame_count), stride))


class VideoReader:
    """Streaming cv2 decoder: grab/retrieve over a sorted index list
    (duplicates re-emit the decoded frame), BGR→RGB."""

    def frame_count(self, path: str) -> int:
        import cv2
        cap = cv2.VideoCapture(path)
        try:
            return int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        finally:
            cap.release()

    def stream_frames_at_indices(self, path: str, frame_idxs: Sequence[int],
                                 chunk: int = 16, stop=None):
        """Yield ``(frames (K, H, W, 3) uint8 RGB, read_idxs)`` in ``chunk``-sized
        groups while keeping the decoder open, so a caller can stop early
        (the predictor's 29-crop cap). ``stop`` (zero-arg callable) is checked
        per grab, so `ChunkPrefetcher.close` can abort a chunk mid-decode.
        A decode failure ends the stream (the reference's error contract)."""
        import cv2
        if len(frame_idxs) == 0:
            return
        cap = cv2.VideoCapture(path)
        try:
            frames, read_idxs = [], []
            decoded = None
            decoded_idx = -1
            for want in frame_idxs:
                if want < decoded_idx:
                    raise ValueError("frame indices must be sorted")
                while decoded_idx < want:
                    if stop is not None and stop():
                        return
                    if not cap.grab():
                        break
                    decoded_idx += 1
                    decoded = None
                if decoded_idx < want:
                    break
                if decoded is None:
                    ok, frame = cap.retrieve()
                    if not ok or frame is None:
                        break
                    decoded = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
                frames.append(decoded)
                read_idxs.append(want)
                if len(frames) >= chunk:
                    yield np.stack(frames), list(read_idxs)
                    frames, read_idxs = [], []
            if frames:
                yield np.stack(frames), read_idxs
        finally:
            cap.release()


class ChunkPrefetcher:
    """1-deep background prefetch over a stream of ``(frames, idxs)`` chunks:
    chunk N+1 decodes on a worker thread while the consumer runs chunk N's
    detection.

    ``make_gen(stop)`` builds the underlying generator with a cooperative stop
    callable, so `close` aborts an in-flight chunk at frame granularity.
    ``decode_s`` and ``frames`` are counted on the producer side. An
    exception in the generator is re-raised by the consumer at the end of
    the stream."""

    def __init__(self, make_gen):
        import queue
        import threading
        self._stop = threading.Event()
        self._q = queue.Queue(maxsize=1)
        self._gen = make_gen(self._stop.is_set)
        self.error = None
        self.decode_s = 0.0
        self.frames = 0
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Blocking put that gives up once close() has set stop (a plain put
        could block forever on the refilled 1-slot queue)."""
        import queue
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _work(self):
        import time
        gen = iter(self._gen)
        try:
            while True:
                t0 = time.perf_counter()
                try:
                    item = next(gen)
                except StopIteration:
                    break
                self.decode_s += time.perf_counter() - t0
                self.frames += len(item[0])
                if not self._put(item):
                    break
        except Exception as e:  # re-raised by __next__ at end of stream
            self.error = e
        finally:
            self._put(None)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is None:
            if self.error is not None:
                raise self.error
            raise StopIteration
        return item

    def close(self, timeout: float = 10.0) -> bool:
        """Stop the worker and release the decoder. Call from the consuming
        thread. Returns whether the worker joined within ``timeout``: only
        then are ``decode_s`` and ``frames`` final."""
        import queue
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=timeout)
        return not self._thread.is_alive()
