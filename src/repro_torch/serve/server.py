"""Async dispatch loop: many concurrent requests onto one slot engine.

The server owns a :class:`~repro_torch.serve.slots.SlotEngine` and runs a
single dispatch thread (the engine's step is one device program;
parallelism comes from the batch, not from threads racing the device):

* ``submit()`` is thread-safe and returns a :class:`RequestFuture`
  immediately — any number of client threads can submit concurrently;
* the scheduler interleaves **prefill** of waiting requests with
  **decode** of resident slots: each loop iteration admits up to
  ``prefill_per_step`` queued requests into free slots (skipping
  admission when the page pool is exhausted), then advances every live
  slot one token;
* per-step results arrive as one packed :class:`ResultTokens` array
  (single device→host copy); finished sequences (EOS or length budget)
  are evicted without draining the batch, and their futures resolve.
"""
from __future__ import annotations

import dataclasses
import itertools
import queue as queue_mod
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from .slots import SlotEngine


@dataclasses.dataclass
class Request:
    """One generation request (prompt -> up to max_new_tokens)."""

    prompt: np.ndarray                     # (s0,) int32
    max_new_tokens: int
    frontend: Optional[np.ndarray] = None  # encdec/vlm conditioning
    rid: int = -1
    submitted_at: float = 0.0


class RequestFuture:
    """Per-request future: blocks until the sequence finishes."""

    def __init__(self, request: Request):
        self.request = request
        self._done = threading.Event()
        self._tokens: List[int] = []
        self._error: Optional[BaseException] = None
        self.first_token_at: Optional[float] = None
        self.finished_at: Optional[float] = None

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        """The generated tokens (truncated at EOS when one is set)."""
        if not self._done.wait(timeout):
            raise TimeoutError(f"request {self.request.rid} not finished")
        if self._error is not None:
            raise self._error
        return np.asarray(self._tokens, np.int32)

    @property
    def latency_s(self) -> float:
        assert self.finished_at is not None
        return self.finished_at - self.request.submitted_at

    @property
    def ttft_s(self) -> float:
        assert self.first_token_at is not None
        return self.first_token_at - self.request.submitted_at

    # -- server side -------------------------------------------------------
    def _emit(self, token: int) -> None:
        if self.first_token_at is None:
            self.first_token_at = time.perf_counter()
        self._tokens.append(token)

    def _finish(self) -> None:
        self.finished_at = time.perf_counter()
        self._done.set()

    def _fail(self, err: BaseException) -> None:
        self._error = err
        self.finished_at = time.perf_counter()
        self._done.set()


class ContinuousServer:
    """Continuous-batching server over a :class:`SlotEngine`.

    Use as a context manager (starts/stops the dispatch thread), or call
    :meth:`start` / :meth:`shutdown` explicitly.  ``drain()`` blocks
    until everything submitted so far has finished.
    """

    def __init__(self, engine: SlotEngine, *, prefill_per_step: int = 1):
        self.engine = engine
        self.prefill_per_step = max(1, int(prefill_per_step))
        self._queue: "queue_mod.Queue[RequestFuture]" = queue_mod.Queue()
        self._resident: Dict[int, RequestFuture] = {}      # slot -> future
        self._budget: Dict[int, int] = {}                  # slot -> left
        self._ids = itertools.count()
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self._all_done = threading.Event()
        self._all_done.set()
        self.stats = {"steps": 0, "prefills": 0, "tokens": 0,
                      "occupancy_sum": 0.0, "evictions": 0,
                      "admission_stalls": 0}

    # -- client API --------------------------------------------------------
    def submit(self, prompt: np.ndarray, *,
               max_new_tokens: Optional[int] = None,
               frontend: Optional[np.ndarray] = None) -> RequestFuture:
        scfg = self.engine.serve_cfg
        req = Request(prompt=np.asarray(prompt, np.int32),
                      max_new_tokens=max_new_tokens or scfg.max_new_tokens,
                      frontend=frontend,
                      rid=next(self._ids),
                      submitted_at=time.perf_counter())
        fut = RequestFuture(req)
        with self._inflight_lock:
            self._inflight += 1
            self._all_done.clear()
        self._queue.put(fut)
        self._wake.set()
        return fut

    def drain(self, timeout: Optional[float] = None) -> None:
        if not self._all_done.wait(timeout):
            raise TimeoutError("server did not drain in time")

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "ContinuousServer":
        assert self._thread is None, "server already started"
        self._thread = threading.Thread(target=self._run,
                                        name="continuous-server", daemon=True)
        self._thread.start()
        return self

    def shutdown(self, *, drain: bool = True,
                 timeout: Optional[float] = None) -> None:
        if drain:
            self.drain(timeout)
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None

    def __enter__(self) -> "ContinuousServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.shutdown(drain=not any(exc))

    # -- scheduler ---------------------------------------------------------
    def _admit(self) -> int:
        """Move up to ``prefill_per_step`` queued requests into free
        slots; requests the page pool cannot host yet go back to the
        front of the queue."""
        admitted = 0
        held: List[RequestFuture] = []
        while (admitted < self.prefill_per_step
                and self.engine.free_slots()):
            try:
                fut = self._queue.get_nowait()
            except queue_mod.Empty:
                break
            req = fut.request
            try:
                res = self.engine.insert(req.prompt,
                                         max_new_tokens=req.max_new_tokens,
                                         frontend=req.frontend)
            except Exception as err:        # bad request (e.g. too long)
                fut._fail(err)
                self._request_done()
                continue
            if res is None:                 # pool exhausted: wait for evicts
                held.append(fut)
                self.stats["admission_stalls"] += 1
                break
            slot, first_tok = res
            self.stats["prefills"] += 1
            self.stats["tokens"] += 1
            fut._emit(first_tok)
            admitted += 1
            if self._finished_on(fut, first_tok, emitted=1):
                self.engine.evict(slot)
                self.stats["evictions"] += 1
                fut._finish()
                self._request_done()
            else:
                self._resident[slot] = fut
                self._budget[slot] = req.max_new_tokens - 1
        for fut in held:                    # preserve arrival order
            self._queue.queue.appendleft(fut)
        return admitted

    def _finished_on(self, fut: RequestFuture, token: int, *,
                     emitted: int) -> bool:
        eos = self.engine.serve_cfg.eos_id
        return ((eos is not None and token == eos)
            or emitted >= fut.request.max_new_tokens)

    def _request_done(self) -> None:
        with self._inflight_lock:
            self._inflight -= 1
            if self._inflight == 0:
                self._all_done.set()

    def _run(self) -> None:
        while not self._stop.is_set():
            self._admit()
            if not self._resident:
                if self._queue.empty():
                    self._wake.wait(timeout=0.05)
                    self._wake.clear()
                continue
            result = self.engine.step()
            self.stats["steps"] += 1
            self.stats["occupancy_sum"] += self.engine.occupancy
            for slot, fut in list(self._resident.items()):
                if not result.valid_at(slot):
                    continue
                tok = result.token_at(slot)
                fut._emit(tok)
                self.stats["tokens"] += 1
                self._budget[slot] -= 1
                done = self._finished_on(
                    fut, tok,
                    emitted=fut.request.max_new_tokens - self._budget[slot])
                if done or self._budget[slot] <= 0:
                    self.engine.evict(slot)
                    self.stats["evictions"] += 1
                    del self._resident[slot], self._budget[slot]
                    fut._finish()
                    self._request_done()
        # on shutdown without drain: fail whatever is left
        leftovers = list(self._resident.values())
        self._resident.clear()
        while True:
            try:
                leftovers.append(self._queue.get_nowait())
            except queue_mod.Empty:
                break
        for fut in leftovers:
            fut._fail(RuntimeError("server shut down"))
            self._request_done()

    # -- reporting ---------------------------------------------------------
    def mean_occupancy(self) -> float:
        steps = self.stats["steps"]
        return self.stats["occupancy_sum"] / steps if steps else 0.0
