"""Continuous batching: cross-request join/leave for the AR decode loop.

Counterpart of indextts_tpu/runtime/batcher.py. N slots decode in lockstep
chunks of `chunk_steps`; between chunks the host harvests finished slots
and admits queued requests, each prefilled alone and written into its
slot's cache rows (runtime/decode.py `GPTDecoder.prefill_request`). All
per-row state lives on the device (`SlotState`); on the card a chunk is
`chunk_steps` replays of one captured step, and the host reads the slots
once a chunk, in one device-to-host copy.

Shapes are static: one (n_slots, cap) state, one text bucket per batcher.
Requests longer than the bucket are rejected (the engine's segmenter
already caps segment length). The caches hold the real prompt length S =
conditioning (34) + text_bucket + 2 + start (1) and max_new more keys,
rounded up by `cache_cap`; the JAX batcher's cap (batcher.py:76) counts 32
conditioning positions, two short, so its last steps write a clamped slot.

Sampling draws from the state's generator, seeded once from the
batcher's `seed` (the JAX state's `PRNGKey(seed)`); a request's own seed
reaches only its tail, the s2mel noise.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np
import torch

from indextts_tpu_torch.runtime.decode import GPTDecoder, cache_cap


@dataclasses.dataclass
class _Pending:
    req_id: int
    conds: torch.Tensor  # (1, P, D)
    text_ids: np.ndarray
    enqueued_at: float
    priority: int = 0  # lower admits first (ties: arrival order)
    ready: Optional[torch.cuda.Event] = None  # conds computed (on the card)


@dataclasses.dataclass
class CompletedRequest:
    req_id: int
    codes: np.ndarray  # (n,) int64 including the stop token (if emitted)
    queued_s: float
    decode_chunks: int


class ContinuousBatcher:
    # queue-wait seconds that promote a pending segment by one priority
    # level: under sustained arrivals, strict breadth-first admission would
    # let every new request's first segment bypass older requests' tail
    # segments indefinitely; aging bounds that starvation to roughly
    # AGING_S * max_segment_index seconds of extra wait.
    AGING_S = 10.0

    def __init__(
        self,
        decoder: GPTDecoder,
        n_slots: int = 8,
        text_bucket: int = 64,
        max_new: int = 600,
        chunk_steps: int = 32,
        temperature: float = 0.8,
        top_p: float = 0.8,
        repetition_penalty: float = 10.0,
        seed: int = 0,
    ):
        self.dec = decoder
        self.B = n_slots
        self.bucket = text_bucket
        self.max_new = max_new
        self.chunk = chunk_steps
        cfg = decoder.cfg
        self.prompt_len = cfg.condition_num_latent + 2 + (text_bucket + 2) + 1
        self.cap = cache_cap(self.prompt_len, max_new)
        self.state = decoder.slot_state(n_slots, self.cap, max_new, temperature, top_p,
                                        repetition_penalty, seed)
        self._queue: List[_Pending] = []
        self._slot_req: List[Optional[_Pending]] = [None] * n_slots
        self._slot_chunks = [0] * n_slots
        self._next_id = 0
        self.completed: List[CompletedRequest] = []
        # cumulative: chunks run, codes harvested, wall seconds in admit + chunks
        self.chunks = 0
        self.tokens = 0
        self.seconds = 0.0

    # -- request intake -----------------------------------------------------

    def submit(self, conds: torch.Tensor, text_ids: np.ndarray, priority: int = 0,
               ready: Optional[torch.cuda.Event] = None) -> int:
        """Queue one request (conds (1, P, D) latents, raw text ids).
        `ready` is an event after which conds may be read, where they were
        computed on another stream.

        priority orders ADMISSION only (lower first, FIFO within a level):
        multi-segment callers pass the segment index so every request's
        first segment is admitted before any request's later segments —
        breadth-first across requests, which is what streaming TTFB sees."""
        if len(text_ids) > self.bucket:
            raise ValueError(f"text length {len(text_ids)} exceeds bucket {self.bucket}")
        rid = self._next_id
        self._next_id += 1
        self._queue.append(_Pending(rid, conds, np.asarray(text_ids, np.int64),
                                    time.perf_counter(), int(priority), ready))
        return rid

    def busy(self) -> bool:
        """A slot holds a request."""
        return any(r is not None for r in self._slot_req)

    # -- scheduling ---------------------------------------------------------

    def _admit(self):
        """Prefill queued requests into the free slots, in (aged) priority
        order, on the decoder's stream."""
        free = [b for b in range(self.B) if self._slot_req[b] is None]
        if free and len(self._queue) > 1:
            # stable: FIFO within an (aged) priority level
            now = time.perf_counter()
            self._queue.sort(key=lambda p: (p.priority - (now - p.enqueued_at) / self.AGING_S,
                                            p.req_id))
        dev = self.dec.device
        for slot in free:
            if not self._queue:
                break
            p = self._queue.pop(0)
            if p.ready is not None:
                torch.cuda.current_stream(dev).wait_event(p.ready)
            ids, pos, valid = self.dec.build_text_prompt_arrays(
                p.text_ids[None], np.asarray([len(p.text_ids)]), self.bucket)
            self.dec.prefill_request(self.state, slot, p.conds,
                                     *(torch.as_tensor(a, device=dev) for a in (ids, pos, valid)))
            self._slot_req[slot] = p
            self._slot_chunks[slot] = 0

    def _harvest(self, view: np.ndarray):
        """Complete the requests whose slots finished, from the chunk's one
        read of the slots (`GPTDecoder.read_slots`), and free their slots."""
        for b in range(self.B):
            p = self._slot_req[b]
            if p is None or not view[b, 0]:
                continue
            n = int(view[b, 1])
            self.completed.append(CompletedRequest(
                req_id=p.req_id, codes=view[b, 2:2 + n].copy(),
                queued_s=time.perf_counter() - p.enqueued_at,
                decode_chunks=self._slot_chunks[b]))
            self.tokens += n
            self.state.active[b].fill_(False)
            self._slot_req[b] = None

    def step(self) -> bool:
        """Admit, run one chunk and harvest, on the decoder's stream.
        Returns False, running nothing, when no slot holds a request after
        admission."""
        t0 = time.perf_counter()
        with torch.inference_mode(), self.dec.on_stream():
            self._admit()
            if not self.busy():
                return False
            self.dec.step_chunk(self.state, self.chunk, self.dec.sampling.do_sample)
            for b in range(self.B):
                if self._slot_req[b] is not None:
                    self._slot_chunks[b] += 1
            self._harvest(self.dec.read_slots(self.state))
        self.chunks += 1
        self.seconds += time.perf_counter() - t0
        return True

    def run(self, max_chunks: int = 10_000) -> List[CompletedRequest]:
        """Drain the queue; returns all completed requests."""
        chunks = 0
        while self._queue or self.busy():
            if not self.step():
                break
            chunks += 1
            if chunks >= max_chunks:
                raise RuntimeError("continuous batcher exceeded max_chunks")
        return sorted(self.completed, key=lambda c: c.req_id)


class ContinuousService:
    """Persistent serving front-end over ContinuousBatcher.

    submit() is thread-safe and returns a concurrent.futures.Future that
    resolves to a SegmentResult: the AR decode runs inside the shared chunked
    loop (requests from different clients batch dynamically), and the cascade
    tail (latent -> s2mel -> vocoder) runs per request as it completes.

    The service decodes with its own GPTDecoder over the engine's
    UnifiedVoice (its own stream, generator, states and lock), as the JAX
    service builds a sibling decoder, so the engine's sequential `generate`
    and the shared loop never contend for one state.

    tail_workers > 0 runs the cascade tail in a small thread pool, each tail
    on its thread's current stream, so the decode loop keeps dispatching
    chunks while a finished segment's tail computes; 0 runs it inline on the
    decode thread. Serving env: TARS_CONTINUOUS_TAIL_WORKERS.
    """

    def __init__(self, engine, n_slots: int = 4, text_bucket: int = 64,
                 max_new: Optional[int] = None, chunk_steps: int = 32, seed: int = 0,
                 tail_workers: int = 0):
        self.engine = engine
        rt = engine.cfg.runtime
        self.max_new = max_new or rt.max_mel_tokens
        dec = engine.decoder
        self.decoder = GPTDecoder(dec.model, dec.cfg, dec.sampling, kv_int8=dec.kv_int8)
        self.bat = ContinuousBatcher(
            self.decoder, n_slots=n_slots, text_bucket=text_bucket, max_new=self.max_new,
            chunk_steps=chunk_steps, temperature=rt.temperature, top_p=rt.top_p,
            repetition_penalty=rt.repetition_penalty, seed=seed)
        self._tail_pool = (ThreadPoolExecutor(max_workers=tail_workers,
                                              thread_name_prefix="tars-tail")
                           if tail_workers > 0 else None)
        self._cv = threading.Condition(threading.Lock())
        self._incoming: List[tuple] = []
        self._futures: Dict[int, Future] = {}
        self._meta: Dict[int, tuple] = {}
        self._running = True
        self._error: Optional[BaseException] = None  # what ended the worker
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def submit(self, spk, emo, text_ids, emo_alpha: float = 1.0, emo_vector=None,
               seed: Optional[int] = None, priority: int = 0) -> Future:
        """Queue one segment; returns a Future[SegmentResult]. priority is
        the caller's segment index (breadth-first admission across
        requests — see ContinuousBatcher.submit)."""
        eng = self.engine
        # the JAX batcher's blend, use_random off (indextts_tpu/runtime/
        # batcher.py:326-345); `ready` follows the blended conds
        emovec, conds = eng.segment_conds(spk, emo, emo_alpha, emo_vector)
        ready = None
        if conds.is_cuda:
            ready = torch.cuda.Event()
            ready.record()
        fut: Future = Future()
        with self._cv:
            if not self._running:
                # no thread reads the queue any more: fail now, not at the
                # caller's timeout
                err = RuntimeError("ContinuousService is not running"
                                   + (f": its decode loop failed ({self._error!r})"
                                      if self._error is not None else " (shut down)"))
                err.__cause__ = self._error
                fut.set_exception(err)
                return fut
            self._incoming.append((conds, np.asarray(text_ids, np.int64), spk, emovec, seed,
                                   fut, time.perf_counter(), int(priority), ready))
            self._cv.notify()
        return fut

    def _worker(self):
        try:
            self._worker_loop()
        except BaseException as e:  # worker death must not strand futures
            with self._cv:
                self._running = False
                self._error = e
            self._fail_pending(e)
            raise

    def _fail_pending(self, exc: BaseException):
        """Fail every future still pending in the service (queued or
        submitted-but-unharvested), releasing its conds/spk metadata.
        Futures whose tails are RUNNING are left alone — their in-flight
        _finish_one resolves them (set_exception on a RUNNING future would
        SUCCEED and clobber the imminent result); the try/except covers
        the narrow claim race that remains."""
        with self._cv:
            pending = list(self._futures.values())
            pending += [t[5] for t in self._incoming]
            self._futures.clear()
            self._meta.clear()
            self._incoming = []
        for fut in pending:
            if not fut.done() and not fut.running():
                try:
                    fut.set_exception(exc)
                except Exception:  # claimed/resolved in the race window
                    pass

    def _worker_loop(self):
        bat = self.bat
        while True:
            with self._cv:
                while (self._running and not self._incoming and not bat._queue
                       and not bat.busy()):
                    self._cv.wait(timeout=0.5)
                if not self._running:
                    return
                moved, self._incoming = self._incoming, []
                for conds, text_ids, spk, emovec, seed, fut, t0, prio, ready in moved:
                    try:
                        rid = bat.submit(conds, text_ids, priority=prio, ready=ready)
                    except ValueError as e:
                        fut.set_exception(e)
                        continue
                    self._futures[rid] = fut
                    self._meta[rid] = (spk, emovec, text_ids, seed, t0)
            if not bat.step():
                continue
            done, bat.completed = bat.completed, []
            for c in done:
                with self._cv:
                    fut = self._futures.pop(c.req_id, None)
                    # None after a shutdown that outlived its join: the
                    # future was failed and the metadata released
                    meta = self._meta.pop(c.req_id, None)
                if fut is None or meta is None or fut.cancelled():
                    continue
                if self._tail_pool is not None:
                    # the decode loop moves straight on to the next chunk;
                    # the tail (and its blocking PCM read) runs meanwhile
                    try:
                        self._tail_pool.submit(self._finish_one, c, meta, fut)
                    except RuntimeError:
                        # pool already shut down (late harvest during
                        # shutdown): finish inline rather than stranding the
                        # future with a confusing submit error
                        self._finish_one(c, meta, fut)
                else:
                    self._finish_one(c, meta, fut)

    def _finish_one(self, c: CompletedRequest, meta: tuple, fut: Future):
        # claims the future atomically: a caller cancel() that lands before
        # this point wins cleanly, and set_result can no longer race
        # cancellation into InvalidStateError (which would kill the decode
        # thread in inline mode). A future already FINISHED (shutdown's
        # _fail_pending raced a late harvest) raises here — treat as
        # resolved-elsewhere, never as a worker-killing error.
        try:
            if not fut.set_running_or_notify_cancel():
                return
        except Exception:
            return
        spk, emovec, text_ids, seed, t0 = meta
        try:
            res = self.engine._finish_from_codes(spk, emovec, text_ids, c.codes, seed,
                                                 time.perf_counter() - t0)
            try:
                fut.set_result(res)
            except Exception:  # resolved elsewhere (shutdown raced the tail)
                pass
        except Exception as e:  # surface cascade errors to the caller
            try:
                fut.set_exception(e)
            except Exception:
                pass

    def shutdown(self, timeout: float = 60.0):
        """Stop the decode loop (a bounded join), stop taking tails, and
        fail every future still pending; running tails finish theirs."""
        with self._cv:
            self._running = False
            self._cv.notify_all()
        # bounded: a worker wedged in a device call must not hang shutdown.
        # If it outlives the join and harvests later, its futures are
        # failed below and its harvest skips them
        self._thread.join(timeout=timeout)
        if self._tail_pool is not None:
            # wait=False: a tail wedged in a device call must not hang
            # shutdown either; running tails keep their claimed futures
            self._tail_pool.shutdown(wait=False)
        self._fail_pending(RuntimeError("ContinuousService shut down"))
