"""Live audio playback sinks — the reference's cpal output-stream role.

The reference plays synthesized audio through a cpal callback that pulls
samples on the OS audio thread's hard real-time schedule
(grail-rs examples/cli.rs:205-272, examples/interactive.rs:41-70).
Here the same pull contract is a `CallbackSink`: the producer write()s
blocks into a chunk queue and a consumer callback pulls `block` samples
every block/sample_rate seconds, counting underruns (each one is a missed
deadline an audio device would render as a glitch) — the same counters as
benchmarks/latency.py.

Three consumer flavors:
  * device   — a real `sounddevice` output stream when that package is
               importable and an output device exists (optional dependency;
               never required);
  * paced    — a mock callback thread on a wall-clock deadline schedule
               (headless environments: same contract, no audio hardware);
  * manual   — no thread; the caller invokes pull() itself (tests).
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Optional

import numpy as np


class CallbackSink:
    """Pull-contract audio sink with deadline/underrun accounting."""

    def __init__(self, sample_rate: float, block: int = 1024,
                 mode: str = "paced"):
        self.sample_rate = float(sample_rate)
        self.block = int(block)
        self.mode = mode
        self.period = self.block / self.sample_rate
        self.pulls = 0
        self.underruns = 0
        self.worst_late_ms = 0.0
        # chunk deque + head offset: O(1) amortized write, O(block) pull. A
        # single flat array rebuilt per write made producer cost O(total
        # backlog) per write — the sink itself induced the underruns it
        # counts once the backlog grew
        self._chunks = collections.deque()
        self._head_off = 0          # consumed samples of the head chunk
        self._buffered = 0          # total buffered samples
        self._lock = threading.Lock()
        self._started = False    # audio in flight: empty pulls = underruns
        self._ended = True       # end-of-utterance declared: empty = idle
        self._closed = False
        self._thread: Optional[threading.Thread] = None
        self._stream = None
        if mode == "device":
            import sounddevice as sd   # caller gates on importability

            self._stream = sd.OutputStream(
                samplerate=self.sample_rate, channels=1,
                blocksize=self.block, dtype="float32",
                callback=self._device_callback)
            self._stream.start()
        elif mode == "paced":
            self._thread = threading.Thread(target=self._paced_loop,
                                            daemon=True)
            self._thread.start()
        elif mode != "manual":
            raise ValueError(f"unknown sink mode {mode!r}")

    # -- producer side -----------------------------------------------------

    def write(self, samples: np.ndarray) -> None:
        a = np.asarray(samples, np.float32).ravel()
        with self._lock:
            if len(a):
                self._chunks.append(a)
                self._buffered += len(a)
            self._started = True
            self._ended = False

    def end(self) -> None:
        """Declare end-of-utterance: once the buffer drains past it, empty
        pulls are idle silence (the REPL between user lines), not
        underruns. A gap BEFORE end() — the producer falling behind the
        callback mid-utterance — still counts."""
        with self._lock:
            self._ended = True

    @property
    def buffered_seconds(self) -> float:
        with self._lock:
            return self._buffered / self.sample_rate

    def drain(self, timeout: float = 60.0) -> None:
        """Block until the consumer has played everything buffered (the
        reference CLI sleeps for the audio duration after stream.play(),
        examples/cli.rs:266-270)."""
        t0 = time.monotonic()
        while time.monotonic() - t0 < timeout:
            with self._lock:
                if self._buffered == 0:
                    return
            time.sleep(self.period / 2)

    def close(self) -> dict:
        """Stop the consumer; returns the deadline counters."""
        self._closed = True
        if self._thread is not None:
            self._thread.join(timeout=2 * self.period + 1.0)
        if self._stream is not None:
            self._stream.stop()
            self._stream.close()
        return self.stats()

    def stats(self) -> dict:
        return {"pulls": self.pulls, "underruns": self.underruns,
                "worst_late_ms": round(self.worst_late_ms, 2),
                "block": self.block,
                "period_ms": round(self.period * 1e3, 2)}

    # -- consumer side -----------------------------------------------------

    def pull(self, frames: Optional[int] = None) -> np.ndarray:
        """One callback pull: returns `frames` samples, zero-filling (and
        counting an underrun) when the buffer can't cover the block."""
        n = self.block if frames is None else int(frames)
        with self._lock:
            take = min(n, self._buffered)
            parts = []
            need = take
            while need:
                head = self._chunks[0]
                avail = len(head) - self._head_off
                use = min(avail, need)
                parts.append(head[self._head_off:self._head_off + use])
                self._head_off += use
                need -= use
                if self._head_off == len(head):
                    self._chunks.popleft()
                    self._head_off = 0
            self._buffered -= take
            out = (parts[0] if len(parts) == 1
                   else np.concatenate(parts) if parts
                   else np.empty(0, np.float32))
            started, ended = self._started, self._ended
            if take < n and started and ended:
                self._started = False   # utterance fully played out
        self.pulls += 1
        if take < n:
            if started and not ended:
                self.underruns += 1     # producer starved the callback
            out = np.concatenate([out, np.zeros(n - take, np.float32)])
        return out

    def _device_callback(self, outdata, frames, time_info, status):
        if status and getattr(status, "output_underflow", False):
            self.underruns += 1
        outdata[:, 0] = self.pull(frames)

    def _paced_loop(self):
        t0 = time.monotonic()
        k = 0
        while not self._closed:
            k += 1
            target = t0 + k * self.period
            now = time.monotonic()
            if now < target:
                time.sleep(target - now)
            else:
                self.worst_late_ms = max(self.worst_late_ms,
                                         (now - target) * 1e3)
            self.pull()


def device_available() -> bool:
    """True when `sounddevice` imports AND reports an output device."""
    try:
        import sounddevice as sd

        return any(d.get("max_output_channels", 0) > 0
                   for d in sd.query_devices())
    except Exception:
        return False


def open_sink(sample_rate: float, block: int = 1024) -> CallbackSink:
    """A device sink when real audio hardware exists, else the paced mock
    (same pull contract and deadline counters either way). Stream
    construction can fail even when a device is listed (claimed by another
    process, PortAudio backend mismatch) — degrade to paced, don't crash
    --play."""
    if device_available():
        try:
            return CallbackSink(sample_rate, block, mode="device")
        except Exception as e:          # pragma: no cover - needs hardware
            import sys

            print(f"audio device unavailable ({e}); falling back to the "
                  "paced sink", file=sys.stderr)
    return CallbackSink(sample_rate, block, mode="paced")


__all__ = ["CallbackSink", "device_available", "open_sink"]
