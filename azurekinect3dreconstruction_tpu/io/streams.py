"""Host-parallel capture: per-camera threads + latest-wins frame channels +
host->device double buffering.

Replaces the reference's entire concurrency layer (SURVEY.md §2.3):
``KinectCaptureThread(threading.Thread, daemon=True)`` with a bounded
``Queue(maxsize=5)``, non-blocking drop-on-full puts and a drain-to-latest
consumer (reference CreateMesh.py:72-189), the global ``running`` flag +
SIGINT handler + join(timeout=1) shutdown (:19-26,899-903), capture retry
with backoff (:165-167) and the all-or-nothing synchronized multi-camera
grab with 5 retries (InitialReconstruction-CUDA-2cam:210-225).

``DeviceFeeder`` adds the device piece the reference never had: a two-deep
device-side buffer so ``device_put`` of frame k+1 overlaps compute on frame k
(SURVEY.md §7.3 host<->device streaming).
"""

from __future__ import annotations

import queue
import signal
import threading
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from azurekinect3dreconstruction_tpu.utils.telemetry import log_error, log_info, log_warning


class CaptureThread(threading.Thread):
    """Daemon thread pulling frames from any callable source into a bounded
    latest-wins queue."""

    def __init__(self, capture_fn: Callable[[], Optional[tuple]], camera_id: int = 0,
                 maxsize: int = 5, retry_backoff: float = 1.0):
        super().__init__(daemon=True, name=f"capture-{camera_id}")
        self.capture_fn = capture_fn
        self.camera_id = camera_id
        self.queue: "queue.Queue" = queue.Queue(maxsize=maxsize)
        self.retry_backoff = retry_backoff
        self._running = threading.Event()
        self._running.set()
        self.frames_captured = 0
        self.frames_dropped = 0

    def run(self) -> None:
        while self._running.is_set():
            try:
                frame = self.capture_fn()
            except Exception as e:  # capture failure -> retry with backoff
                log_warning(f"camera {self.camera_id}: capture error {e}; retrying")
                time.sleep(self.retry_backoff)
                continue
            if frame is None:
                time.sleep(0.001)
                continue
            self.frames_captured += 1
            try:
                self.queue.put_nowait(frame)
            except queue.Full:
                self.frames_dropped += 1  # drop: consumer keeps latest-wins

    def get_latest_frame(self, timeout: float = 0.0):
        """Drain the queue and return the newest frame (None if empty)."""
        frame = None
        try:
            frame = self.queue.get(timeout=timeout) if timeout else self.queue.get_nowait()
        except queue.Empty:
            return None
        while True:
            try:
                frame = self.queue.get_nowait()
            except queue.Empty:
                return frame

    def stop(self, join_timeout: float = 1.0) -> None:
        self._running.clear()
        self.join(timeout=join_timeout)


class MultiCameraRig:
    """Synchronized capture across cameras: all-or-nothing frame sets with
    retries (reference InitialReconstruction-CUDA-2cam:210-225)."""

    def __init__(self, capture_fns: Sequence[Callable[[], Optional[tuple]]],
                 maxsize: int = 5):
        self.threads = [CaptureThread(fn, i, maxsize) for i, fn in enumerate(capture_fns)]
        self._installed_sigint = False

    def start(self) -> None:
        for t in self.threads:
            t.start()
        log_info(f"started {len(self.threads)} capture thread(s)")

    def get_synchronized_frames(self, retries: int = 5, timeout: float = 0.2):
        """Latest frame from every camera, or None if any camera starves."""
        for _ in range(retries):
            frames = [t.get_latest_frame(timeout=timeout) for t in self.threads]
            if all(f is not None for f in frames):
                return frames
        return None

    def stop(self) -> None:
        for t in self.threads:
            t.stop()

    def install_sigint_handler(self, on_shutdown: Optional[Callable] = None) -> None:
        """Graceful Ctrl-C (reference CreateMesh.py:19-26)."""

        def handler(signum, frame):
            log_info("shutting down (SIGINT)")
            self.stop()
            if on_shutdown:
                on_shutdown()
            raise KeyboardInterrupt

        signal.signal(signal.SIGINT, handler)
        self._installed_sigint = True


class DeviceFeeder:
    """Two-deep host->device pipeline: ``put()`` uploads frame k+1 while the
    consumer computes on frame k. At 640x576 u16 + RGB this is ~2 MB/frame —
    trivial bandwidth, but per-frame synchronous transfers would serialize
    the pipeline."""

    def __init__(self, depth: int = 2):
        import jax

        self._jax = jax
        self.depth = depth
        self._buf: List[tuple] = []

    def put(self, *arrays) -> None:
        import jax
        import jax.numpy as jnp

        # async host->device; tree_map handles nested structures (e.g. the
        # ((d0,c0),(d1,c1)) pairs a multi-camera rig yields)
        devs = jax.tree_util.tree_map(jnp.asarray, tuple(arrays))
        self._buf.append(devs)
        while len(self._buf) > self.depth:
            self._buf.pop(0)

    def get(self) -> Optional[tuple]:
        """Oldest in-flight frame (already resident or nearly so)."""
        if not self._buf:
            return None
        return self._buf.pop(0)

    def __len__(self) -> int:
        return len(self._buf)


def prefetch_to_device(frames, depth: int = 2):
    """Wrap a (depth, color) frame iterator with double-buffered host->device
    uploads (BASELINE north star: "frames double-buffered to device"): frame
    k+1's transfer is issued before frame k is yielded to the consumer, so
    upload overlaps compute instead of serializing with it. Yields device
    arrays; ``RGBDFrame.from_raw`` and every pipeline accept them as-is."""
    feeder = DeviceFeeder(depth=depth)
    it = iter(frames)
    for arrays in it:
        feeder.put(*arrays)
        if len(feeder) >= depth:
            yield feeder.get()
    while len(feeder):
        yield feeder.get()
