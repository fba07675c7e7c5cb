"""Video decode and frame-sampling policies (host side) — the port of
`fac_fake_tpu/data/video.py`.

Index policies are pure functions, so every reference code path's frame
choices are reproducible:

  * `evenly_spaced_indices` — `read_frames` (`helpers_read_video_1.py:22-48`)
  * `random_indices`        — `read_random_frames` (`:50-69`)
  * `predict_indices`       — the CViT predictor's seek-by-5 loop
  * `first_n_indices` / `strided_indices` — the S3D snippets

`cv2` is imported only inside the decoding methods: the machine with the
card has no cv2. The sampling readers (`read_frames_at_indices`,
`read_random_frames`, ...) are functions of any ``reader`` with
``frame_count`` and ``stream_frames_at_indices``, so an in-memory reader
drives them (and `VideoScorer`) as the cv2 `VideoReader` does.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


def evenly_spaced_indices(frame_count: int, num_frames: int, jitter: int = 0,
                          seed: Optional[int] = None) -> np.ndarray:
    idxs = np.linspace(0, frame_count - 1, num_frames, endpoint=True).astype(np.int64)
    if jitter > 0:
        rng = np.random.RandomState(seed)
        idxs = np.clip(idxs + rng.randint(-jitter, jitter, len(idxs)), 0,
                       frame_count - 1)
    return idxs


def random_indices(frame_count: int, num_frames: int,
                   seed: Optional[int] = None) -> np.ndarray:
    """Sorted, drawn WITH replacement (as the reference draws them): an
    index can repeat."""
    rng = np.random.RandomState(seed)
    return np.sort(rng.choice(np.arange(frame_count), num_frames))


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


def read_frames_at_indices(reader, path: str, frame_idxs: Sequence[int],
                           verbose: bool = False):
    """``(frames (N, H, W, 3) uint8 RGB, read indices)`` of ``reader`` at the
    sorted ``frame_idxs``, or None when no frame decodes. A stream that ends
    early (a truncated file) gives the frames read before the fault."""
    stacks, read_idxs = [], []
    for frames, idxs in reader.stream_frames_at_indices(path, frame_idxs, chunk=1 << 30):
        stacks.append(frames)
        read_idxs.extend(idxs)
    if not stacks:
        if verbose:
            print(f"No frames read from {path}")
        return None
    return (stacks[0] if len(stacks) == 1 else np.concatenate(stacks)), read_idxs


def read_frames(reader, path: str, num_frames: int, jitter: int = 0,
                seed: Optional[int] = None, verbose: bool = False):
    n = reader.frame_count(path)
    if n <= 0:
        return None
    return read_frames_at_indices(reader, path, evenly_spaced_indices(n, num_frames, jitter, seed),
                                  verbose)


def read_random_frames(reader, path: str, num_frames: int, seed: Optional[int] = None,
                       verbose: bool = False):
    n = reader.frame_count(path)
    if n <= 0:
        return None
    return read_frames_at_indices(reader, path, random_indices(n, num_frames, seed), verbose)


def read_middle_frame(reader, path: str, verbose: bool = False):
    n = reader.frame_count(path)
    if n <= 0:
        return None
    return read_frames_at_indices(reader, path, [n // 2], verbose)


class VideoReader:
    """Streaming cv2 decoder: grab/retrieve over a sorted index list
    (duplicates re-emit the decoded frame), BGR→RGB, optional insets.

    ``spool``: a file of at most ``SPOOL_MAX_BYTES`` is first copied to a
    local temporary file in one sequential read (ffmpeg's small seeky reads
    are slow on network mounts); the last ``_SPOOL_CACHE`` copies are kept,
    so the usual frame_count → read pair copies once."""

    SPOOL_MAX_BYTES = 512 << 20
    _SPOOL_CACHE = 16

    def __init__(self, verbose: bool = False, insets: Tuple[float, float] = (0.0, 0.0),
                 spool: bool = True):
        import threading
        self.verbose = verbose
        self.insets = insets
        self.spool = spool
        self._spooled: "dict[str, str]" = {}
        self._spool_lock = threading.Lock()

    def _local(self, path: str) -> str:
        """A local filesystem path for ``path`` (its spooled copy when enabled)."""
        if not self.spool:
            return path
        import os
        with self._spool_lock:
            hit = self._spooled.get(path)
        if hit is not None and os.path.exists(hit):
            return hit
        try:
            if os.path.getsize(path) > self.SPOOL_MAX_BYTES:
                return path
            import shutil
            import tempfile
            fd, tmp = tempfile.mkstemp(suffix=os.path.splitext(path)[1] or ".mp4",
                                       prefix="fac_spool_")
            os.close(fd)
            shutil.copyfile(path, tmp)
        except OSError:
            return path
        with self._spool_lock:
            self._spooled[path] = tmp
            while len(self._spooled) > self._SPOOL_CACHE:
                old = self._spooled.pop(next(iter(self._spooled)))   # the oldest
                try:
                    os.unlink(old)
                except OSError:
                    pass
        return tmp

    def __del__(self):
        import os
        for tmp in getattr(self, "_spooled", {}).values():
            try:
                os.unlink(tmp)
            except OSError:
                pass

    def frame_count(self, path: str) -> int:
        import cv2
        cap = cv2.VideoCapture(self._local(path))
        try:
            return int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        finally:
            cap.release()

    def read_frames(self, path: str, num_frames: int, jitter: int = 0,
                    seed: Optional[int] = None):
        return read_frames(self, path, num_frames, jitter, seed, self.verbose)

    def read_random_frames(self, path: str, num_frames: int, seed: Optional[int] = None):
        return read_random_frames(self, path, num_frames, seed, self.verbose)

    def read_middle_frame(self, path: str):
        return read_middle_frame(self, path, self.verbose)

    def read_frame_at_index(self, path: str, idx: int):
        return read_frames_at_indices(self, path, [idx], self.verbose)

    def read_frames_at_indices(self, path: str, frame_idxs: Sequence[int]):
        return read_frames_at_indices(self, path, frame_idxs, self.verbose)

    def stream_frames_at_indices(self, path: str, frame_idxs: Sequence[int],
                                 chunk: int = 16, stop=None):
        """Yield ``(frames (K, H, W, 3) uint8 RGB, read_idxs)`` in ``chunk``-sized
        groups while keeping the decoder open, so a caller can stop early
        (the predictor's 29-crop cap). ``stop`` (zero-arg callable) is checked
        per grab, so `ChunkPrefetcher.close` can abort a chunk mid-decode.
        A frame that will not grab or retrieve, or a decode exception, ends
        the stream (the reference's error contract); unsorted indices raise."""
        import cv2
        if len(frame_idxs) == 0:
            return
        if any(b < a for a, b in zip(frame_idxs[:-1], frame_idxs[1:])):
            raise ValueError("frame indices must be sorted")
        cap = cv2.VideoCapture(self._local(path))
        try:
            frames, read_idxs = [], []
            decoded = None
            decoded_idx = -1
            for want in frame_idxs:
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
                    decoded = self._postprocess(frame)
                frames.append(decoded)
                read_idxs.append(want)
                if len(frames) >= chunk:
                    yield np.stack(frames), list(read_idxs)
                    frames, read_idxs = [], []
            if frames:
                yield np.stack(frames), read_idxs
        except Exception:      # a decode fault: the stream ends, as the reference's
            if self.verbose:
                print(f"Exception while reading {path}")
            return
        finally:
            cap.release()

    def _postprocess(self, frame: np.ndarray) -> np.ndarray:
        import cv2
        frame = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
        if self.insets[0] > 0:
            p = int(frame.shape[1] * self.insets[0])
            frame = frame[:, p:-p]
        if self.insets[1] > 0:
            q = int(frame.shape[0] * self.insets[1])
            frame = frame[q:-q]
        return frame


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
