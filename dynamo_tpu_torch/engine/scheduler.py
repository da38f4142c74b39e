"""Continuous-batching scheduler driving the ModelRunner.

Port of `dynamo_tpu/engine/scheduler.py`, trimmed to the engine core: slot
based continuous batching, chunked prefill, the prefix cache through
`PagePool`, fused decode blocks with pipelined dispatch/drain, speculative
decoding (DYNT_SPEC_*: n-gram drafts verified in one batched forward,
`_maybe_dispatch_spec`), per-token streaming, cancellation, the stop
conditions (max_tokens, eos, stop_token_ids, ignore_eos), and logits
processors: penalties, logit_bias, min_p, min_tokens, guided decoding and
registered `logits_processors` (`llm/logits_processing.py`). A processor
sequence takes the host-sampling decode path: per-token steps that copy its
raw logits row to the host (`_decode_single`), verified on the host under
speculation (`_commit_spec_host`). It runs in its own thread; results cross
into asyncio through the `emit` callbacks. The page pool's registrations
and evictions reach the `on_stored` / `on_removed` hooks (the worker's KV
events), and `queue_depth` and the last step's stats feed its load metrics.

Scheduling per iteration, as in the JAX package:
  1. admit waiting requests into free slots while pages allocate
  2. DISPATCH a speculative verification step (decode_spec) when drafts are
     worth it, else a fused decode block (decode_multi, optionally
     depth-pipelined on device-resident tokens) for all decode-ready slots,
     no readback yet
  3. advance at most one prefill-chunk budget of prompt tokens: one chunk
     per prefilling sequence, several sequences' chunks in one batched
     dispatch (`ModelRunner.prefill_chunk_batch`)
  4. admit again (arrivals that landed during dispatch), then run the gap
     callbacks (`run_in_gap`: a streamed transfer's page gather)
  5. drain the decode block: the loop's one blocking device-to-host copy

Each sequence's page allocation carries block * depth tokens of slack (at
least spec_k + 1 with speculation on), so a sequence that stops inside a
block, or past rejected drafts, writes its surplus KV into its own pages;
the surplus tokens are discarded at drain.

Disaggregated serving and the drain ladder ride the worker's transfer
table (`engine/worker.py`, `llm/kv_transfer.py`): a prefill-only sequence
stops after its prompt pass and parks its pages (`_finish_prefill_only`,
streamed chunk by chunk through `_stream_prefill_chunk`); a sequence
submitted with pulled KV (`onboard_blocks`) skips prefill (`_onboard`), or
resumes a drained peer's stream (`_onboard_resume`); `drain_sweep` and
`drain_expire` are the departure ladder's rungs, and a draining scheduler
bounces new arrivals with an in-band migrate. Page gathers, scatters and
releases run on this thread, between steps (`run_in_step`) or in a step's
dispatch/drain gap (`run_in_gap`).

With a KV block manager (`kvbm=`, `block_manager/`), the pool's
registrations also queue the KVBM offload, whose page gathers ride the
dispatch/drain gap (`run_in_gap`, budgeted by `_offload_pressure`), and
admission onboards the prompt blocks the prefix cache missed but a tier
holds (`_onboard_from_kvbm`): the blocks are scattered into the new pages
instead of prefilled.

Priority classes (`request.priority`: interactive > standard > batch) order
admission, class-strict and FIFO within a class (one stable sort per drain
of the arrivals). A waiting head with no free slot, or no pages, preempts
the cheapest lower-class decode slot (DYNT_PREEMPT_ENABLE), on the step's
first admit pass only, when no decode block is in flight: with a KVBM park
store (`kvbm.park_sequence`, at most DYNT_PREEMPT_MAX_PARKED) the victim's
computed pages are gathered on the step stream, copied to pinned host memory
and synchronised, and only then released (`_preempt_seq`); the sequence
keeps its seed, generated tokens, speculation and processor state and
resumes when pressure clears (`_resume_parked`: the bundle is staged on the
side stream and scattered into new pages, the prefix cache's pages
skipped), continuing its stream unchanged. With no park store the victim
takes the cooperative in-band migrate, which the frontend's `Migration`
replays. Each park, migrate, resume, expiry and drop replays against the
`preemption` spec (`runtime/conformance.py`) when DYNT_CONFORMANCE is on.

Each step is split into host and device time with no added sync
(`steptrace`, `perf/steptrace.py`): dispatch scopes around the graph
replays, drain scopes around the readbacks that already block, and the
committed sample's split in the stats. A sequence submitted with a
`record_id` stamps its flight-recorder timeline where the reference's does
(`runtime/flight_recorder.py`): scheduled, prefill_start, first_token, its
prefill and decode device windows, and the drain rungs.

Multi-LoRA: a sequence carries the adapter slot the worker resolved for it
(`submit(lora_idx=)`, 0 the base model), and every step it joins feeds that
slot to the runner (`_lora_idx` for decode-kind steps, each prefill row's
own); preemption keeps it across a park and resume, and the prefix cache
already salts block hashes by adapter (`request.kv_salt()`).
`lora_in_flight` counts the live, waiting, incoming and parked sequences on
a slot, so an unload cannot free a slot a parked sequence will resume on.

Not ported yet (a later slice): multimodal. Such requests finish with an
error. Embedding requests never reach `submit`: the worker runs them on the
scheduler thread between steps (`run_in_step`, `ModelRunner.embed`).
"""

from __future__ import annotations

import dataclasses
import logging
import queue as thread_queue
import threading
import time
from typing import Callable, Optional

import numpy as np

from ..config import env
from ..llm.logits_processing import (
    LogitBiasProcessor,
    MinPProcessor,
    MinTokensProcessor,
    PenaltyProcessor,
    RepetitionPenaltyProcessor,
    host_sample,
    resolve_processors,
)
from ..llm.protocols import EngineOutput, PreprocessedRequest, class_rank
from ..perf.steptrace import StepTrace
from ..runtime.conformance import observe
from ..runtime.flight_recorder import get_recorder
from ..runtime.metrics import PREEMPT_TOTAL
from ..tokens import TokenBlockSequence, compute_block_hashes
from .model_runner import DeviceBundle, ModelRunner, bucket_table_width
from .pages import PageAllocation, PagePool
from .sampler import TOP_LOGPROBS_K
from .spec import BlockLookahead, NGramProposer, SlotSpec, propose_for

log = logging.getLogger("dynamo_tpu_torch.scheduler")


def _observe_preempt(instance: str, event: str) -> None:
    """Feed the `preemption` lifecycle to the conformance monitor. The
    instance key is scheduler-scoped (an id(self) prefix), so a migrated
    request replayed on a peer starts a fresh lifecycle there."""
    observe("preemption", instance, event)


@dataclasses.dataclass
class _Seq:
    request: PreprocessedRequest
    emit: Callable[[EngineOutput], None]
    block_hashes: list[int]
    alloc: PageAllocation
    block_table: np.ndarray
    slot: int
    prompt_len: int
    prefill_pos: int  # next prompt position to prefill
    generated: list[int] = dataclasses.field(default_factory=list)
    last_token: int = 0
    cancelled: bool = False
    finished: bool = False
    seed: int = 0
    # Whether the allocation includes the slack pages fused decode and
    # speculation overrun into (False only when the slacked span would
    # exceed capacity).
    slack_ok: bool = True
    # Speculation state (engine/spec.py): the proposer's index over this
    # sequence's history and its acceptance EMA; None with speculation off.
    spec: Optional[SlotSpec] = None
    # Logits processors (llm/logits_processing.py), instantiated per request
    # at _prepare; non-empty routes this sequence through the host-sampling
    # decode path (per-token steps with a raw-logits readback).
    processors: Optional[list] = None
    # Processor sequences defer their FIRST token past prefill (prefill
    # samples on the device, with no processors): the first decode step
    # re-runs the last prompt token at prompt_len - 1 (a KV rewrite of the
    # same values, up to rounding) and the host path picks the token.
    first_deferred: bool = False
    # Disaggregated prefill side: a prefill-only sequence stops after its
    # first sampled token and hands its pages to the worker's transfer table
    # (on_prefill_done) instead of releasing them. keep_pages: the reap
    # skips the release (the transfer's claim or expiry releases once).
    prefill_only: bool = False
    on_prefill_done: Optional[Callable[["_Seq", int, list[int]], dict]] = None
    keep_pages: bool = False
    # Streamed handoff: called on the scheduler thread after each NON-final
    # prefill chunk with the newly completed page ids; its first call
    # returns the kv_transfer_params emitted mid-stream, so the decode
    # worker pulls while later chunks compute. Called with None on an abort
    # (cancel or error before on_prefill_done).
    on_prefill_chunk: Optional[Callable[["_Seq", Optional[list[int]]],
                                        Optional[dict]]] = None
    streamed_pages: int = 0  # full pages already parked with the transfer
    stream_started: bool = False  # transfer registered (pages parked)
    stream_done: bool = False  # on_prefill_done ran (a clean finish)
    # Disaggregated decode side: pulled KV (a host bundle or a staged
    # DeviceBundle) and the prefill side's first token; admission scatters
    # instead of prefilling.
    onboard_blocks: Optional[object] = None
    onboard_first_token: Optional[int] = None
    # Drain-handoff destination: the source's seed, generated tokens and
    # prompt length, shipped with onboard_blocks, so decode continues the
    # committed stream instead of re-prefilling.
    resume_state: Optional[dict] = None
    # Flight-recorder timeline key (the worker's generate qualifies prefill
    # legs); None for bare-scheduler callers, whose stamps are no-ops.
    record_id: Optional[str] = None
    # prefill_start stamped (keeps the chunk loop off the recorder's lock)
    prefill_stamped: bool = False
    # Device-time attribution (perf/steptrace.py): the monotonic time of the
    # FIRST prefill dispatch, and the device windows accumulated per phase,
    # flushed onto the timeline at first_token (prefill) and at the finish
    # (decode).
    prefill_submit_ts: Optional[float] = None
    device_prefill_ms: float = 0.0
    device_decode_ms: float = 0.0
    # Priority class: orders admission (class-strict, stable within a class)
    # and marks lower-class decode slots as preemption donors; parked_pages
    # is how many leading block-table pages the park bundle covers, so the
    # resume scatters exactly what the park gathered.
    priority_class: str = "standard"
    parked_pages: int = 0
    # The adapter slot of the runner's LoRA pack (0: the base model)
    lora_idx: int = 0

    @property
    def rank(self) -> int:
        return class_rank(self.priority_class)

    @property
    def decode_ready(self) -> bool:
        return self.prefill_pos >= self.prompt_len

    @property
    def kv_len(self) -> int:
        return self.prompt_len + len(self.generated)


@dataclasses.dataclass
class SchedulerStats:
    steps: int = 0
    prefill_tokens: int = 0  # prompt tokens computed (prefix-cache hits excluded)
    decode_tokens: int = 0
    # The last step's wall time and tokens, published in LoadMetrics
    last_step_wall_ms: float = 0.0
    prefill_tokens_last_step: int = 0
    decode_tokens_last_step: int = 0
    # The last committed step's split (perf/steptrace.py): device window
    # and host residual, mirrored into LoadMetrics; they sum to its wall.
    # The full sample and the totals live on scheduler.steptrace.
    device_ms_last_step: float = 0.0
    host_ms_last_step: float = 0.0
    # Speculative decoding: verification steps run, draft tokens proposed
    # and accepted (bonus tokens excluded); spec_last_k is the longest draft
    # mined in the latest step, spec_ema the mean acceptance EMA over the
    # slots that proposed in it.
    spec_steps: int = 0
    spec_proposed: int = 0
    spec_accepted: int = 0
    spec_last_k: int = 0
    spec_ema: float = 0.0
    # Prefill iterations whose chunks went out as one batched dispatch
    prefill_batched_steps: int = 0
    # Logits processors: per-token decode or verification steps that read
    # raw logits rows back for processor slots, and the host milliseconds
    # spent in each processor class and in `host_sample` (key
    # "host_sample") over all of them.
    logits_steps: int = 0
    host_ms: dict = dataclasses.field(default_factory=dict)
    # Verification steps that carried a processor slot (_commit_spec_host)
    spec_logits_steps: int = 0
    # KV pages parked with the transfer table before their prompt finished
    # prefilling (the streamed disaggregated handoff)
    disagg_streamed_pages: int = 0
    # The drain ladder (engine/drain.py): sequences vacated per rung on the
    # source (handoff / replay / error), handoffs resumed on the
    # destination, and arrivals bounced while draining
    drain_handoff: int = 0
    drain_replayed: int = 0
    drain_errored: int = 0
    drain_resumed: int = 0
    drain_bounced: int = 0
    # Prompt blocks onboarded from the KVBM tiers at admission (each
    # skipped a page of prefill)
    kvbm_onboarded_blocks: int = 0
    # Preemption: batch decode slots parked to the KVBM park store or
    # cooperatively migrated under interactive pressure, and parked
    # sequences resumed
    preempt_parked: int = 0
    preempt_migrated: int = 0
    preempt_resumed: int = 0


def _bundle_pages(blocks) -> int:
    """Pages in a pulled bundle (a staged DeviceBundle or a host tensor)."""
    if isinstance(blocks, DeviceBundle):
        blocks = blocks.tensor
    return int(blocks.shape[0])


def _bundle_slice(blocks, lo: int, hi: int):
    if isinstance(blocks, DeviceBundle):
        return DeviceBundle(blocks.tensor[lo:hi], blocks.ready)
    return blocks[lo:hi]


def _unsupported(request: PreprocessedRequest) -> Optional[str]:
    """Why this engine cannot serve `request` yet, or None."""
    if request.media_hashes or request.media_embeddings is not None:
        return "multimodal requests are not ported yet"
    return None


class InferenceScheduler:
    def __init__(
        self,
        runner: ModelRunner,
        on_stored: Optional[Callable[[list[int], Optional[int]], None]] = None,
        on_removed: Optional[Callable[[list[int]], None]] = None,
        kvbm=None,  # Optional[block_manager.KvBlockManager]
    ) -> None:
        """`on_stored(hashes, parent)` / `on_removed(hashes)` hear, on the
        scheduler thread, the prefix-cache registrations and evictions of
        the page pool: the worker's KV events. `kvbm`, a KvBlockManager,
        hears the registrations too (its offload queue) and is attached to
        this engine."""
        self.runner = runner
        self.kvbm = kvbm
        cfg = runner.config
        self.page_size = cfg.page_size
        # Multi-step decode block (DYNT_DECODE_BLOCK): >1 fuses K decode
        # steps into one runner call; tokens then stream in blocks of K.
        self.decode_block = max(1, int(env("DYNT_DECODE_BLOCK") or 1))
        self.decode_pipeline = max(1, int(env("DYNT_DECODE_PIPELINE") or 1))
        # Speculative decoding (DYNT_SPEC_*): draftless n-gram proposals
        # verified in one batched forward; off for runners that cannot
        # verify (a caller's unified attention_fn).
        self.spec_enabled = (bool(env("DYNT_SPEC_ENABLE"))
                             and runner.supports_spec)
        self.spec_k = max(1, int(env("DYNT_SPEC_MAX_K")))
        self.spec_min_ema = float(env("DYNT_SPEC_MIN_EMA"))
        self.spec_cutoff = max(0, int(env("DYNT_SPEC_BATCH_CUTOFF")))
        # Cross-request continuations keyed by the chained block hashes the
        # prefix cache registers.
        self.spec_lookahead = (BlockLookahead(cfg.page_size)
                               if self.spec_enabled else None)
        # Streamed-chunk token budget of prefill-only sequences
        # (DYNT_DISAGG_CHUNK; 0 = the engine's prefill chunk)
        self.disagg_chunk = max(0, int(env("DYNT_DISAGG_CHUNK") or 0))
        # Preemption under interactive pressure: batch decode slots park to
        # the KVBM park store, or migrate cooperatively without one.
        self.preempt_enabled = bool(env("DYNT_PREEMPT_ENABLE"))
        self.preempt_max_parked = max(0, int(env("DYNT_PREEMPT_MAX_PARKED")))
        self._parked: list[_Seq] = []
        # Graceful drain (engine/drain.py): while draining, new arrivals
        # bounce with an in-band migrate the frontend replays on a peer.
        self.draining = False

        def _stored(hashes: list[int], parent: Optional[int]) -> None:
            # G1 registrations fan out to the router's events AND the KVBM
            # offload queue
            if on_stored is not None:
                on_stored(hashes, parent)
            if kvbm is not None:
                kvbm.notify_stored(hashes, parent)

        self.pool = PagePool(cfg.num_pages, on_stored=_stored,
                             on_removed=on_removed)
        if kvbm is not None:
            # Offload gathers ride the dispatch/drain gap (run_in_gap): they
            # queue behind the decode block, and the bandwidth budget reads
            # the step wall time to back off under serving pressure. The
            # D2H copies run on the offload thread (bundle_to_host).
            kvbm.attach_engine(
                lookup_pages=lambda hs: [self.pool.lookup(h) for h in hs],
                gather=runner.gather_pages_device,
                run_in_step=self.run_in_gap,
                step_pressure=self._offload_pressure,
                to_host=runner.bundle_to_host,
            )
        self.max_batch = cfg.max_batch
        self._slots: list[Optional[_Seq]] = [None] * cfg.max_batch
        self._waiting: list[_Seq] = []
        self._incoming: thread_queue.Queue = thread_queue.Queue()
        # Callbacks run on this thread between steps (run_in_step), and in
        # the gap between a decode block's dispatch and its drain
        # (run_in_gap)
        self._control: thread_queue.Queue = thread_queue.Queue()
        self._gap_control: thread_queue.Queue = thread_queue.Queue()
        # Final-chunk prefill tokens whose host readback is deferred one
        # iteration: (seq, device token). The copy then sits behind the
        # next decode block, so prefill never blocks the serving loop.
        self._pending_prefill: list = []
        self._wake = threading.Event()
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        self.error: Optional[BaseException] = None
        self.stats = SchedulerStats()
        # Device-time attribution (perf/steptrace.py): each step's device
        # window against its host residual, with no added device sync
        self.steptrace = StepTrace()
        # The tokenizer handed to logits-processor factories that declare a
        # `tokenizer` parameter (guided decoding needs it); the worker sets
        # it from its card.
        self.logits_tokenizer = None
        # decode input buffers (reused)
        b, p = cfg.max_batch, cfg.max_pages_per_seq
        self._tokens = np.zeros(b, np.int32)
        self._positions = np.zeros(b, np.int32)
        self._tables = np.zeros((b, p), np.int32)
        self._kv_lens = np.zeros(b, np.int32)
        self._active = np.zeros(b, bool)
        self._temp = np.ones(b, np.float32)
        self._top_p = np.ones(b, np.float32)
        self._top_k = np.zeros(b, np.int32)
        self._seeds = np.zeros(b, np.uint32)
        self._steps = np.zeros(b, np.int32)
        self._lora_idx = np.zeros(b, np.int32)

    # -- public (thread-safe) ---------------------------------------------

    def start(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="engine-scheduler")
            self._thread.start()

    def stop(self) -> None:
        self._stop = True
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=30.0)

    def submit(
        self,
        request: PreprocessedRequest,
        emit: Callable[[EngineOutput], None],
        *,
        prefill_only: bool = False,
        on_prefill_done: Optional[Callable] = None,
        on_prefill_chunk: Optional[Callable] = None,
        onboard_blocks=None,
        onboard_first_token: Optional[int] = None,
        resume_state: Optional[dict] = None,
        record_id: Optional[str] = None,
        lora_idx: int = 0,
    ) -> "_SubmitHandle":
        """Queue a request. A prefill-only one (disaggregated prefill) stops
        after its prompt pass and parks its pages through `on_prefill_done`
        (and, streamed, `on_prefill_chunk`); one with `onboard_blocks`
        (pulled KV) skips prefill: with `onboard_first_token` it continues a
        remote prefill, with `resume_state` a drained peer's stream.
        `record_id` names the flight-recorder timeline its phases stamp;
        `lora_idx` is its adapter slot (resolved by the caller)."""
        handle = _SubmitHandle(self._wake.set)
        self._incoming.put((request, emit, handle, {
            "prefill_only": prefill_only,
            "on_prefill_done": on_prefill_done,
            "on_prefill_chunk": on_prefill_chunk,
            "onboard_blocks": onboard_blocks,
            "onboard_first_token": onboard_first_token,
            "resume_state": resume_state,
            "record_id": record_id,
            "lora_idx": lora_idx,
        }))
        self._wake.set()
        return handle

    def lora_in_flight(self, lora_slot: int) -> int:
        """Sequences still bound to an adapter slot: admitted, waiting,
        just submitted, or parked by a preemption (it resumes on its slot;
        the reference does not count parked ones). Scheduler thread only
        (run it through `run_in_step`): the incoming queue is drained first,
        so a submission that already resolved the adapter is counted."""
        self._drain_incoming()
        live = ([s for s in self._slots if s is not None] + self._waiting
                + self._parked)
        return sum(1 for s in live
                   if s.lora_idx == lora_slot
                   and not s.finished and not s.cancelled)

    def _queue_callback(self, q: thread_queue.Queue,
                        fn: Callable[[], object]) -> thread_queue.Queue:
        out: thread_queue.Queue = thread_queue.Queue(1)

        def wrapped() -> None:
            try:
                out.put((fn(), None))
            except Exception as exc:  # noqa: BLE001 — delivered to caller
                out.put((None, exc))

        q.put(wrapped)
        self._wake.set()
        return out

    def run_in_step(self, fn: Callable[[], object]) -> thread_queue.Queue:
        """Run `fn` on the scheduler thread between steps (page gathers,
        scatters and releases must not interleave with a step). Returns a
        1-item queue that receives (result, exception)."""
        return self._queue_callback(self._control, fn)

    def run_in_gap(self, fn: Callable[[], object]) -> thread_queue.Queue:
        """Like run_in_step, but `fn` runs inside a step's dispatch/drain
        gap, after the decode block is issued and before its readback, so
        its device work (a streamed transfer's gather) queues behind the
        block instead of delaying the next dispatch. An idle loop runs it
        at once."""
        return self._queue_callback(self._gap_control, fn)

    # -- scheduler thread --------------------------------------------------

    def _loop(self) -> None:
        log.info("scheduler loop up (max_batch=%d pages=%d)",
                 self.max_batch, self.pool.num_pages)
        try:
            while not self._stop:
                self._drain_control()
                self._drain_incoming()
                if not self._step():
                    # idle: gap work has no dispatch/drain window to ride
                    self._drain_gap()
                    self._wake.wait(timeout=0.05)
                    self._wake.clear()
        except BaseException as exc:
            # A failed device step leaves the pool in an unknown state:
            # stop serving and fail every live stream instead of hanging.
            log.exception("scheduler loop failed")
            self.error = exc
            self._fail_all(f"engine failed: {exc!r}")
            raise
        finally:
            # run_in_step / run_in_gap callers block on their result queue:
            # callbacks queued during shutdown still run.
            self._drain_control()
            self._drain_gap()

    def _run_callbacks(self, q: thread_queue.Queue) -> None:
        while True:
            try:
                fn = q.get_nowait()
            except thread_queue.Empty:
                return
            try:
                fn()
            except Exception:  # noqa: BLE001 — a bad callback (a deferred
                # page release) must not kill the engine loop
                log.exception("scheduler callback failed")

    def _drain_control(self) -> None:
        self._run_callbacks(self._control)

    def _drain_gap(self) -> None:
        self._run_callbacks(self._gap_control)

    def _fail_all(self, reason: str) -> None:
        self._drain_incoming()
        live = self._waiting + [s for s in self._slots if s is not None]
        for seq in live:
            if not seq.finished and not seq.cancelled:
                seq.finished = True
                seq.emit(EngineOutput(finish_reason="error", error=reason))
        for seq in self._parked:
            # their bundles were gathered from a pool that is gone
            self._drop_parked(seq.request.request_id)
            if not seq.cancelled:
                seq.emit(EngineOutput(finish_reason="error", error=reason))
                seq.cancelled = True
        self._parked.clear()

    def _drain_incoming(self) -> None:
        added = False
        while True:
            try:
                request, emit, handle, extra = self._incoming.get_nowait()
            except thread_queue.Empty:
                if added:
                    # Class-strict admission order: ONE stable sort per
                    # drain keeps FIFO within a class while a fresh
                    # interactive arrival overtakes every waiting batch one.
                    self._waiting.sort(key=lambda s: -s.rank)
                return
            if self.error is not None:
                emit(EngineOutput(finish_reason="error",
                                  error=f"engine failed: {self.error!r}"))
                continue
            if self.draining:
                # Vacating: an arrival that raced the routers' draining flip
                # bounces with an in-band migrate; the frontend's Migration
                # replays it on a peer.
                self.stats.drain_bounced += 1
                emit(EngineOutput(finish_reason="migrate",
                                  error="worker draining; replay on a peer"))
                continue
            seq = self._prepare(request, emit)
            if seq is not None:
                for name, value in extra.items():
                    setattr(seq, name, value)
                handle.seq = seq
                if handle._cancelled:  # cancelled before the seq existed
                    seq.cancelled = True
                self._waiting.append(seq)
                added = True

    def _page_span(self, prompt_len: int, max_tokens: int,
                   with_slack: bool = True) -> int:
        """Pages for a sequence. With slack: fused/pipelined decode writes
        up to block*depth - 1 tokens past the stop position before the host
        sees the stop, and a verification step writes up to spec_k rejected
        drafts past it, so those positions must land in pages this sequence
        owns. Capacity CHECKS use the slack-free span."""
        slack = (self.decode_block * max(1, self.decode_pipeline)
                 if with_slack and self.decode_block > 1 else 0)
        if with_slack and self.spec_enabled:
            slack = max(slack, self.spec_k + 1)
        return -(-(prompt_len + max_tokens + slack) // self.page_size)

    def _prepare(self, request: PreprocessedRequest, emit) -> Optional[_Seq]:
        reason = _unsupported(request)
        if reason is not None:
            emit(EngineOutput(finish_reason="error", error=reason))
            return None
        prompt_len = len(request.token_ids)
        total_pages = self._page_span(prompt_len,
                                      request.sampling.max_tokens,
                                      with_slack=False)
        if (prompt_len == 0
                or prompt_len >= self.runner.config.max_context
                or total_pages > self.runner.config.max_pages_per_seq
                or total_pages > self.pool.num_pages - 1):
            emit(EngineOutput(
                finish_reason="error",
                error=(f"request needs {total_pages} pages / "
                       f"{prompt_len} prompt tokens; exceeds engine capacity"),
            ))
            return None
        block_hashes = compute_block_hashes(
            request.token_ids, self.page_size, lora_id=request.kv_salt())
        seed = request.sampling.seed
        if seed is None:
            seed = abs(hash(request.request_id)) & 0xFFFFFFFF
        try:
            processors = self._build_processors(request)
        except (ValueError, TypeError, KeyError) as exc:
            emit(EngineOutput(finish_reason="error",
                              error=f"logits processors: {exc}"))
            return None
        seq = _Seq(
            request=request, emit=emit, block_hashes=block_hashes,
            alloc=PageAllocation([], [], 0),
            block_table=np.zeros(self.runner.config.max_pages_per_seq,
                                 np.int32),
            slot=-1, prompt_len=prompt_len, prefill_pos=0, seed=seed,
            processors=processors,
            priority_class=request.priority or "standard",
        )
        if self.spec_enabled:
            stop_ids = set(request.stop.stop_token_ids)
            if not request.stop.ignore_eos:
                stop_ids |= set(request.eos_token_ids)
            hasher = TokenBlockSequence(self.page_size,
                                        lora_id=request.kv_salt())
            hasher.extend(request.token_ids)
            seq.spec = SlotSpec(proposer=NGramProposer(request.token_ids),
                                stop_ids=frozenset(stop_ids), hasher=hasher)
        return seq

    def _build_processors(self, request: PreprocessedRequest):
        """Instantiate the request's logits processors (explicit specs +
        implicit ones for logit_bias and penalties), in the reference's
        order. Non-empty switches the sequence onto the host-sampling decode
        path."""
        procs: list = []
        s = request.sampling
        if s.logit_bias:
            procs.append(LogitBiasProcessor(
                {int(k): float(v) for k, v in s.logit_bias.items()}))
        if s.frequency_penalty or s.presence_penalty:
            procs.append(PenaltyProcessor(s.frequency_penalty,
                                          s.presence_penalty))
        if s.repetition_penalty != 1.0:
            # HF semantics penalize prompt AND generated tokens
            procs.append(RepetitionPenaltyProcessor(
                s.repetition_penalty, prompt_ids=request.token_ids))
        if request.stop.min_tokens:
            procs.append(MinTokensProcessor(
                request.stop.min_tokens,
                list(request.eos_token_ids)
                + list(request.stop.stop_token_ids)))
        if request.logits_processors:
            procs.extend(resolve_processors(request.logits_processors,
                                            tokenizer=self.logits_tokenizer))
        if s.min_p and s.temperature > 0:
            # temperature 0 is argmax: min_p can never change it, and the
            # processor would force the per-step host readback for nothing.
            # LAST: the min_p floor is relative to the max probability of
            # the distribution actually sampled from, after guided / user
            # processors have masked it; ahead of them it could mask every
            # grammar-legal token (an all -inf row).
            procs.append(MinPProcessor(s.min_p, s.temperature))
        return procs or None

    def _admit(self, allow_preempt: bool = False) -> int:
        """Admit waiting sequences into free slots, head first. With
        `allow_preempt` (the step's first pass, no decode block in flight)
        a parked sequence of the head's class or better resumes before the
        head, a head with no free slot or no pages preempts a lower-class
        decode slot, and parked sequences resume at the end."""
        admitted = 0
        while self._waiting:
            seq = self._waiting[0]
            if seq.cancelled:
                self._waiting.pop(0)
                continue
            # A parked sequence of the head's class or better resumes BEFORE
            # the head: it was admitted first, and a waiting batch request
            # must not take the slot ahead of a parked standard one.
            if allow_preempt and self._resume_parked(limit=1,
                                                     min_rank=seq.rank):
                admitted += 1
                continue
            free_slots = [i for i, s in enumerate(self._slots) if s is None]
            if not free_slots:
                # No slot: preempt a lower-class decode slot and retry. Only
                # on the step's first pass: the late pass runs with a decode
                # block in flight, whose drain would append tokens to a
                # victim that no longer owns its pages.
                if allow_preempt and self._try_preempt_for(seq):
                    continue
                break
            total_pages = self._slacked_span(seq)
            alloc = self.pool.allocate(seq.block_hashes, total_pages)
            if alloc is None:
                # page starvation is the other trigger: a parked victim
                # returns its pages to the pool
                if allow_preempt and self._try_preempt_for(seq):
                    continue
                break  # no pages; retry next iteration
            # Never skip the whole prompt: recompute at least the last token
            # so there are logits to sample from (cached pages stay correct:
            # the recomputed KV is identical).
            seq.alloc = alloc
            pages = alloc.pages
            seq.block_table[: len(pages)] = pages
            seq.prefill_pos = min(alloc.cached_blocks * self.page_size,
                                  seq.prompt_len - 1)
            # Pulled-KV sequences carry their pages in onboard_blocks: a
            # KVBM lookup would be redundant (and overwritten) for them.
            if self.kvbm is not None and seq.onboard_blocks is None:
                self._onboard_from_kvbm(seq)
            seq.slot = free_slots[0]
            self._slots[seq.slot] = seq
            self._waiting.pop(0)
            if seq.record_id is not None:
                # admission ends the queue wait (first write wins, so a
                # page-starved retry cannot move it)
                get_recorder().stamp(seq.record_id, "scheduled")
            admitted += 1
            if seq.onboard_blocks is not None:
                if seq.resume_state is not None:
                    self._onboard_resume(seq)
                else:
                    self._onboard(seq)
        if allow_preempt:
            # the pressure check ran: parked sequences resume when slots and
            # pages are back and nothing of a higher class is waiting
            admitted += self._resume_parked()
        return admitted

    def _slacked_span(self, seq: _Seq) -> int:
        """Pages to allocate for `seq` (setting `seq.slack_ok`): its span
        with the decode slack, or without it when that would not fit."""
        total_pages = self._page_span(seq.prompt_len,
                                      seq.request.sampling.max_tokens)
        seq.slack_ok = (total_pages <= self.runner.config.max_pages_per_seq
                        and total_pages <= self.pool.num_pages - 1)
        if not seq.slack_ok:
            total_pages = self._page_span(
                seq.prompt_len, seq.request.sampling.max_tokens,
                with_slack=False)
        return total_pages

    # -- preemption: park to the KVBM, or migrate ---------------------------

    def _park_capacity_ok(self) -> bool:
        return (self.kvbm is not None
                and hasattr(self.kvbm, "park_sequence")
                and len(self._parked) < self.preempt_max_parked)

    def _preempt_victim(self, head_rank: int) -> Optional[_Seq]:
        """The cheapest lower-class decode slot to evict: lowest class
        first, then fewest generated tokens (the least KV to move, the least
        work to replay), then slot index. Only plain decode-ready slots
        qualify: prefill-only, transfer-owning and first-token-deferred
        sequences hold state a park cannot carry."""
        best = None
        for seq in self._slots:
            if seq is None or seq.finished or seq.cancelled:
                continue
            if seq.prefill_only or seq.keep_pages or seq.first_deferred:
                continue
            if not seq.decode_ready or not seq.generated:
                continue
            if seq.rank >= head_rank:
                continue
            key = (seq.rank, len(seq.generated), seq.slot)
            if best is None or key < best[0]:
                best = (key, seq)
        return best[1] if best is not None else None

    def _try_preempt_for(self, head: _Seq) -> bool:
        """Free a slot and its pages for `head` by preempting a lower-class
        victim. True only when a park freed them NOW (the caller retries the
        admission); a migrate returns False: its slot and pages come back at
        the reap, the END of this step, and retrying in this pass would
        migrate every lower-class slot for one waiting head."""
        if not self.preempt_enabled:
            return False
        victim = self._preempt_victim(head.rank)
        if victim is None:
            return False
        return self._preempt_seq(victim)

    def _preempt_seq(self, victim: _Seq) -> bool:
        """Preempt one decode slot. Park: its computed pages are gathered on
        the step stream (behind every step that wrote them), copied to
        pinned host memory and synchronised, and only then released to the
        pool (a release before the copy ends would race the next
        allocation); the bundle goes to the KVBM park store and the sequence
        keeps its seed, tokens, speculation and processor state for the
        resume. Otherwise the cooperative in-band migrate, which the
        frontend's Migration replays; the reap releases its pages. Returns
        whether the park freed the slot and pages at once."""
        rid = victim.request.request_id
        # KV on the device: positions 0 .. kv_len - 2 (the last generated
        # token's KV is written by its next decode step)
        computed = max(0, victim.kv_len - 1)
        n_pages = -(-computed // self.page_size) if computed else 0
        parked = False
        if self._park_capacity_ok() and n_pages > 0:
            ids = np.asarray(victim.block_table[:n_pages], np.int32)
            bundle = self.runner.bundle_to_host(
                self.runner.gather_pages_device(ids))
            parked = bool(self.kvbm.park_sequence(rid, bundle))
        if parked:
            self.pool.release(
                victim.alloc, victim.block_hashes,
                computed_blocks=victim.prefill_pos // self.page_size)
            self._slots[victim.slot] = None
            victim.slot = -1
            victim.alloc = PageAllocation([], [], 0)
            victim.parked_pages = n_pages
            self._parked.append(victim)
            self.stats.preempt_parked += 1
            PREEMPT_TOTAL.labels(kind="park").inc()
            _observe_preempt(f"{id(self)}:{rid}", "park")
            get_recorder().event(victim.record_id, "preempt", kind="park",
                                 pages=n_pages,
                                 tokens_preserved=len(victim.generated))
            log.info("preempted %s to KVBM (%d pages, %d tokens kept)",
                     rid, n_pages, len(victim.generated))
            return True
        # The Migration operator replays prompt + generated on a peer (or
        # here, later) under DYNT_PREEMPT_MIGRATION_LIMIT.
        victim.finished = True
        self.stats.preempt_migrated += 1
        PREEMPT_TOTAL.labels(kind="migrate").inc()
        _observe_preempt(f"{id(self)}:{rid}", "migrate")
        get_recorder().event(victim.record_id, "preempt", kind="migrate",
                             tokens_preserved=len(victim.generated))
        victim.emit(EngineOutput(finish_reason="migrate",
                                 error="preempted under interactive pressure"))
        log.info("preempted %s via cooperative migrate", rid)
        return False

    def _resume_parked(self, limit: Optional[int] = None,
                       min_rank: int = -1) -> int:
        """Resume parked sequences when pressure clears: a free slot, pages,
        and no higher-class request waiting (`min_rank` further restricts
        the candidates: the admit loop resumes only those that outrank or
        equal its head). The deadline kept burning across the park: an
        expired sequence finishes with an error instead of resuming into a
        reply nobody waits for. The bundle is staged on the runner's side
        stream and scattered into the new pages behind its event; cached
        prompt pages already hold the same KV, so only the rest is
        written."""
        if not self._parked:
            return 0
        waiting_rank = max(
            (s.rank for s in self._waiting if not s.cancelled), default=-1)
        resumed = 0
        # the higher class first; park order (FIFO) within a class
        for seq in sorted(self._parked, key=lambda s: -s.rank):
            if limit is not None and resumed >= limit:
                break
            rid = seq.request.request_id
            if seq.cancelled:
                self._parked.remove(seq)
                self._drop_parked(rid)
                _observe_preempt(f"{id(self)}:{rid}", "drop")
                continue
            deadline = seq.request.deadline
            if deadline is not None and deadline.expired():
                self._parked.remove(seq)
                self._drop_parked(rid)
                seq.finished = True
                get_recorder().event(seq.record_id, "preempt",
                                     kind="expired")
                _observe_preempt(f"{id(self)}:{rid}", "expire")
                seq.emit(EngineOutput(
                    finish_reason="error",
                    error="deadline exceeded while preempted"))
                continue
            if seq.rank < waiting_rank or seq.rank < min_rank:
                continue  # pressure persists: stay parked
            free_slots = [i for i, s in enumerate(self._slots) if s is None]
            if not free_slots:
                break
            alloc = self.pool.allocate(seq.block_hashes,
                                       self._slacked_span(seq))
            if alloc is None:
                break
            bundle = self.kvbm.claim_parked(rid)
            if bundle is None:
                # The park store lost the bundle; a resume must never
                # scatter garbage: degrade to the cooperative migrate.
                self.pool.release(alloc, seq.block_hashes, computed_blocks=0)
                self._parked.remove(seq)
                seq.finished = True
                self.stats.preempt_migrated += 1
                PREEMPT_TOTAL.labels(kind="migrate").inc()
                _observe_preempt(f"{id(self)}:{rid}", "migrate")
                seq.emit(EngineOutput(
                    finish_reason="migrate",
                    error="park bundle lost; replay elsewhere"))
                continue
            self._parked.remove(seq)
            seq.alloc = alloc
            pages = alloc.pages
            seq.block_table[: len(pages)] = pages
            cached_n = min(alloc.cached_blocks, seq.parked_pages)
            target = np.asarray(seq.block_table[cached_n:seq.parked_pages],
                                np.int32)
            if len(target):
                self.runner.scatter_pages(
                    target, self.runner.stage_bundle(bundle[cached_n:]))
            seq.slot = free_slots[0]
            self._slots[seq.slot] = seq
            seq.parked_pages = 0
            self.stats.preempt_resumed += 1
            PREEMPT_TOTAL.labels(kind="resume").inc()
            _observe_preempt(f"{id(self)}:{rid}", "resume")
            get_recorder().event(seq.record_id, "preempt", kind="resume",
                                 tokens_preserved=len(seq.generated))
            log.info("resumed parked %s (%d tokens preserved)",
                     rid, len(seq.generated))
            resumed += 1
        return resumed

    def _drop_parked(self, rid: str) -> None:
        if self.kvbm is not None and hasattr(self.kvbm, "drop_parked"):
            self.kvbm.drop_parked(rid)

    def _onboard_from_kvbm(self, seq: _Seq) -> None:
        """KVBM onboard at admission: prompt blocks the G1 prefix cache
        missed but G2/G3/G4 hold are scattered into the freshly allocated
        pages instead of prefilled. At least one prompt token is kept for
        recompute (the logits source). The read is host work on this
        thread, as in the reference; the upload is staged on the runner's
        side stream and the scatter waits for it on the step stream."""
        cached_n = seq.alloc.cached_blocks
        # Only blocks fully inside prompt_len - 1 can skip compute.
        max_blocks = (seq.prompt_len - 1) // self.page_size
        candidates = seq.block_hashes[cached_n:max_blocks]
        if not candidates:
            return
        start = time.perf_counter()
        n = self.kvbm.match_prefix(candidates)
        if n == 0:
            return
        bundle = self.kvbm.read_blocks(candidates[:n])
        if bundle is None:
            # evicted between match and read: a designed degrade to
            # recompute
            return
        target = np.asarray(seq.block_table[cached_n : cached_n + n],
                            np.int32)
        self.runner.scatter_pages(target, self.runner.stage_bundle(bundle))
        if seq.record_id is not None:
            # ms: this thread's time for the match, the tier reads and the
            # upload and scatter issue
            get_recorder().event(
                seq.record_id, "kvbm_onload", blocks=n,
                tokens=n * self.page_size,
                ms=(time.perf_counter() - start) * 1e3)
        seq.prefill_pos = (cached_n + n) * self.page_size
        self.stats.kvbm_onboarded_blocks += n
        log.info("kvbm onboard: %d blocks (skipping %d prefill tokens) for %s",
                 n, n * self.page_size, seq.request.request_id)

    def _onboard(self, seq: _Seq) -> None:
        """Disaggregated decode side: write the pulled prompt KV into this
        pool and enter decode directly (no prefill pass). Cached prefix
        pages already hold the same KV (same hash chain, same tokens): only
        the rest is written."""
        n_prompt_pages = -(-seq.prompt_len // self.page_size)
        cached_n = min(seq.alloc.cached_blocks, n_prompt_pages)
        self._scatter_onboard(seq, cached_n, n_prompt_pages)
        seq.prefill_pos = seq.prompt_len
        if seq.processors:
            # The prefill worker sampled the first token with no processors:
            # discard it; the first decode step regenerates its logits
            # through the host path (_defer_first_token's rewrite).
            self._defer_first_token(seq)
            return
        self._append_token(seq, int(seq.onboard_first_token),
                           prompt_tokens=seq.prompt_len)

    def _onboard_resume(self, seq: _Seq) -> None:
        """Drain-handoff destination: the pulled bundle covers every
        computed position, prompt AND generated tokens up to kv_len - 2 (the
        last generated token's KV is written by its next decode step, as on
        the source). Write it, restore the seed and the generated history,
        and continue decoding: the (seed, step) sampler keys pick up where
        the source stopped. Nothing is emitted here: the delivered tokens
        stay delivered, and the source reported prompt_tokens on its first
        frame."""
        state = seq.resume_state or {}
        gen = [int(t) for t in (state.get("generated") or [])]
        n_pages = int(_bundle_pages(seq.onboard_blocks))
        # the cache can only cover prompt blocks
        cached_n = min(seq.alloc.cached_blocks, n_pages)
        self._scatter_onboard(seq, cached_n, n_pages)
        seq.prefill_pos = seq.prompt_len
        seq.generated = gen
        seq.last_token = gen[-1] if gen else int(seq.request.token_ids[-1])
        if state.get("seed") is not None:
            seq.seed = int(state["seed"]) & 0xFFFFFFFF
        if seq.spec is not None and gen:
            # the proposer's index and the hash chain see the whole history
            seq.spec.extend(gen)
        self.stats.drain_resumed += 1
        if seq.record_id is not None:
            get_recorder().event(seq.record_id, "drain_resume",
                                 pages=n_pages, tokens_preserved=len(gen))
        log.info("resumed drained %s (%d tokens preserved, %d pages pulled)",
                 seq.request.request_id, len(gen), n_pages)

    def _scatter_onboard(self, seq: _Seq, lo: int, hi: int) -> None:
        """Write pages [lo, hi) of the pulled bundle into the sequence's
        pages [lo, hi), then drop the bundle."""
        blocks = seq.onboard_blocks
        seq.onboard_blocks = None  # free its memory
        if hi <= lo:
            return
        self.runner.scatter_pages(np.asarray(seq.block_table[lo:hi], np.int32),
                                  _bundle_slice(blocks, lo, hi))

    def _offload_pressure(self) -> float:
        """Step-time pressure for the KVBM offload budget: the last step's
        wall time while sequences are live, 0 when idle (an idle engine's
        step thread is free: offload at full rate)."""
        if self._waiting or any(s is not None for s in self._slots):
            return self.stats.last_step_wall_ms
        return 0.0

    def queue_depth(self) -> tuple[int, int]:
        """(live slots, waiting sequences). Parked sequences count as
        waiting: they hold live client streams the admission estimators
        must see as backlog."""
        active = sum(1 for s in self._slots if s is not None)
        return active, len(self._waiting) + len(self._parked)

    def active_kv_tokens(self) -> int:
        """KV tokens the live decode slots attend: the working set of the
        live roofline gauges. Read across threads without a lock: a slightly
        stale sum only skews a gauge."""
        return sum(seq.kv_len for seq in list(self._slots)
                   if seq is not None and not seq.finished
                   and not seq.cancelled)

    def _step(self) -> bool:
        start = time.monotonic()
        self.steptrace.begin()
        # Preemption and resume only on this first pass: no decode block is
        # in flight yet, so a victim's pages are gathered and released
        # without racing a pending drain.
        admitted = self._admit(allow_preempt=True)
        # Deferred prefill tokens from the PREVIOUS iteration: their device
        # work was queued before this iteration's dispatches.
        ripe = self._pending_prefill
        self._pending_prefill = []
        # Dispatch decode FIRST (no readback): the block runs on the device
        # while the host prepares and issues prefill and admits arrivals.
        pending = self._dispatch_decode()
        prefill_tokens = self._prefill_some()
        self._drain_incoming()
        admitted += self._admit()
        # gap work (a streamed transfer's gather) queues behind the block
        self._drain_gap()
        finalized = 0
        for seq, tok_dev in ripe:
            finalized += self._finalize_prefill(seq, tok_dev)
        decode_tokens = self._drain_decode(pending)
        self._reap_finished()
        if prefill_tokens or decode_tokens or admitted or finalized:
            self.stats.steps += 1
            self.stats.prefill_tokens += prefill_tokens
            self.stats.decode_tokens += decode_tokens
            self.stats.prefill_tokens_last_step = prefill_tokens
            self.stats.decode_tokens_last_step = decode_tokens
            self.stats.last_step_wall_ms = (time.monotonic() - start) * 1e3
            sample = self.steptrace.commit(self.stats.last_step_wall_ms)
            self.stats.device_ms_last_step = sample.device_ms
            self.stats.host_ms_last_step = sample.host_ms
            return True
        return False

    def _prefill_some(self) -> int:
        """Advance prefill by one chunk per prefilling sequence, filling one
        SHARED token budget per iteration (decode ITL protection). Several
        sequences' chunks go out as one batched dispatch; per-row results
        equal single dispatches (the sampler keys on (seed, step), never
        on the row)."""
        budget = self.runner.max_prefill_chunk
        work: list[tuple[_Seq, int]] = []
        spent = 0
        for seq in self._slots:
            if seq is None or seq.cancelled or seq.decode_ready:
                continue
            if budget - spent < min(self.page_size, budget):
                break  # leftover budget too small to be worth a dispatch
            per = budget - spent
            if (seq.prefill_only and seq.on_prefill_chunk is not None
                    and self.disagg_chunk > 0):
                # the streamed handoff's granularity: smaller chunks start
                # the KV stream earlier
                per = min(per, self.disagg_chunk)
            chunk = min(per, seq.prompt_len - seq.prefill_pos)
            if chunk <= 0:
                continue
            if seq.record_id is not None and not seq.prefill_stamped:
                # the first chunk of real prefill compute only
                seq.prefill_stamped = True
                get_recorder().stamp(seq.record_id, "prefill_start")
            work.append((seq, chunk))
            spent += chunk
        if not work:
            return 0
        if len(work) > 1 and self._can_batch_prefill(work):
            return self._prefill_batch(work)
        return sum(self._prefill_single(seq, chunk) for seq, chunk in work)

    def _can_batch_prefill(self, work: list) -> bool:
        """Cross-sequence chunk batching needs a runner with the batched
        entry point (the port has no mirrored driver and no media)."""
        return hasattr(self.runner, "prefill_chunk_batch")

    def _prefill_single(self, seq: _Seq, chunk: int) -> int:
        tokens = np.asarray(
            seq.request.token_ids[seq.prefill_pos : seq.prefill_pos + chunk],
            np.int32)
        is_final = seq.prefill_pos + chunk >= seq.prompt_len
        sampling = seq.request.sampling
        # Only a final chunk whose token the host needs now reads back: a
        # prefill-only sequence's (its transfer params carry it) and one
        # that wants logprob data. Plain final chunks defer the copy one
        # iteration (_pending_prefill), and a processor sequence discards
        # its token (_defer_first_token).
        sync = is_final and (seq.prefill_only or (sampling.logprobs
                                                  and not seq.processors))
        # A chunk read back in the call is one blocking window, all device;
        # the others stamp their submit only (a deferred token's window
        # closes at its drain).
        scope = (self.steptrace.sync("prefill", self.stats.steps) if sync
                 else self.steptrace.dispatch("prefill", self.stats.steps))
        if seq.prefill_submit_ts is None:
            seq.prefill_submit_ts = time.monotonic()
        with scope:
            token = self.runner.prefill_chunk(
                tokens, seq.prefill_pos, seq.block_table,
                kv_len_after=seq.prefill_pos + chunk,
                sampling=(sampling.temperature, sampling.top_p,
                          sampling.top_k, seq.seed),
                return_device=not sync, lora_idx=seq.lora_idx,
            )
        if sync:
            # the prompt pass's device window: first chunk dispatched ->
            # final token on the host
            seq.device_prefill_ms = max(
                0.0, (time.monotonic() - seq.prefill_submit_ts) * 1e3)
        seq.prefill_pos += chunk
        if not is_final:
            self._stream_prefill_chunk(seq)
        elif seq.prefill_only:
            self._finish_prefill_only(seq, int(token))
        elif seq.processors:
            self._defer_first_token(seq)
        elif sync:
            self._append_token(seq, token, prompt_tokens=seq.prompt_len,
                               sample_info=self.runner.last_prefill_sample)
        else:
            self._pending_prefill.append((seq, token))
        return chunk

    def _prefill_batch(self, work: list) -> int:
        """Dispatch several sequences' prefill chunks at once
        (`ModelRunner.prefill_chunk_batch`); final chunks are handled as
        `_prefill_single` handles them: a plain final token is deferred
        through `_pending_prefill`, a prefill-only or logprobs row reads back
        at once, and a processor sequence defers its first token to
        decode."""
        finals = [seq.prefill_pos + chunk >= seq.prompt_len
                  for seq, chunk in work]
        rows = []
        for seq, chunk in work:
            s = seq.request.sampling
            rows.append((np.asarray(seq.request.token_ids[
                seq.prefill_pos : seq.prefill_pos + chunk], np.int32),
                seq.prefill_pos, seq.block_table, seq.prefill_pos + chunk,
                (s.temperature, s.top_p, s.top_k, seq.seed), seq.lora_idx))
        want_samples = any(final and seq.request.sampling.logprobs
                           and not seq.processors
                           for final, (seq, _) in zip(finals, work))
        now = time.monotonic()
        for seq, _chunk in work:
            if seq.prefill_submit_ts is None:
                seq.prefill_submit_ts = now
        with self.steptrace.dispatch("prefill", self.stats.steps):
            toks_dev = self.runner.prefill_chunk_batch(
                rows, want_samples=want_samples)
        samples = self.runner.last_prefill_samples
        self.stats.prefill_batched_steps += 1
        host_toks = None
        total = 0
        for row, ((seq, chunk), is_final) in enumerate(zip(work, finals)):
            seq.prefill_pos += chunk
            total += chunk
            if not is_final:
                self._stream_prefill_chunk(seq)
                continue
            if seq.processors and not seq.prefill_only:
                self._defer_first_token(seq)
                continue
            if not (seq.prefill_only or seq.request.sampling.logprobs):
                self._pending_prefill.append((seq, toks_dev[row]))
                continue
            if host_toks is None:
                with self.steptrace.drain("prefill"):
                    host_toks = toks_dev.cpu().numpy()
            seq.device_prefill_ms = max(
                0.0, (time.monotonic() - seq.prefill_submit_ts) * 1e3)
            if seq.prefill_only:
                self._finish_prefill_only(seq, int(host_toks[row]))
                continue
            self._append_token(seq, int(host_toks[row]),
                               prompt_tokens=seq.prompt_len,
                               sample_info=samples[row])
        return total

    def _stream_prefill_chunk(self, seq: _Seq) -> None:
        """Streamed handoff: park this prefill-only sequence's newly
        completed FULL pages with the transfer table mid-prefill. The first
        parked chunk also emits kv_transfer_params (no finish_reason), so
        the router dispatches the decode leg, which starts pulling while
        later chunks still compute. The pages' gather is queued on the step
        stream after this chunk's dispatch, so it reads what it wrote."""
        if not seq.prefill_only or seq.on_prefill_chunk is None:
            return
        ready = seq.prefill_pos // self.page_size
        if ready <= seq.streamed_pages:
            return
        new_pages = [int(p)
                     for p in seq.block_table[seq.streamed_pages:ready]]
        params = seq.on_prefill_chunk(seq, new_pages)
        seq.streamed_pages = ready
        self.stats.disagg_streamed_pages += len(new_pages)
        if params is not None and not seq.stream_started:
            seq.stream_started = True
            # The transfer owns the pages from here: the reap must not
            # release them even if the sequence dies mid-stream (the abort
            # hook fails the transfer, which releases exactly once).
            seq.keep_pages = True
            seq.emit(EngineOutput(token_ids=[], kv_transfer_params=params))

    def _finish_prefill_only(self, seq: _Seq, first_token: int) -> None:
        """Disaggregated prefill side: park the prompt pages with the
        transfer table (on_prefill_done) and answer with kv_transfer_params
        instead of decoding; the decode worker pulls the pages."""
        n_prompt_pages = -(-seq.prompt_len // self.page_size)
        page_ids = [int(p) for p in seq.block_table[:n_prompt_pages]]
        params: dict = {}
        if seq.on_prefill_done is not None:
            params = seq.on_prefill_done(seq, first_token, page_ids)
            seq.keep_pages = True
            seq.stream_done = True  # a clean finish: no abort hook at reap
        seq.finished = True
        if seq.record_id is not None:
            get_recorder().stamp(seq.record_id, "first_token")
            if seq.device_prefill_ms:
                get_recorder().device(seq.record_id, "prefill",
                                      seq.device_prefill_ms)
        seq.emit(EngineOutput(
            token_ids=[], finish_reason="stop", prompt_tokens=seq.prompt_len,
            kv_transfer_params={**params, "first_token": first_token}))

    def release_transfer_pages(self, seq: _Seq) -> None:
        """Release a parked sequence's pages once its transfer is claimed and
        served, or expires (thread-safe: it runs as a control callback).

        A STREAMING transfer can be released while its prompt pass still
        runs (the puller died or timed out): the remaining chunks still
        write into those pages, so they must not return to the pool yet.
        The sequence is cancelled instead and the reap releases its pages
        once it stops stepping."""
        def release() -> None:
            if not (seq.finished or seq.cancelled):
                # The prefill leg's stream is still consumed (the router's
                # background drain): end it with a terminal frame.
                seq.cancelled = True
                seq.keep_pages = False
                seq.emit(EngineOutput(
                    finish_reason="cancelled",
                    error="kv transfer abandoned; prefill cancelled"))
                return
            computed = seq.prefill_pos // self.page_size
            self.pool.release(seq.alloc, seq.block_hashes,
                              computed_blocks=computed)

        self._control.put(release)
        self._wake.set()

    def _finalize_prefill(self, seq: _Seq, tok_dev) -> int:
        """Copy a deferred final-chunk token to the host and hand the
        sequence to decode. Returns 1 if a token was delivered."""
        if seq.cancelled or seq.finished:
            return 0
        # anchored=False: the chunk behind this token was submitted last
        # step; this step's prefill submit stamp (if any) is another
        # sequence's chunk, so only the blocked wait counts.
        with self.steptrace.drain("prefill", anchored=False):
            token = int(tok_dev.cpu().reshape(-1)[0])
        if seq.prefill_submit_ts is not None:
            seq.device_prefill_ms = max(
                0.0, (time.monotonic() - seq.prefill_submit_ts) * 1e3)
        self._append_token(seq, token, prompt_tokens=seq.prompt_len)
        return 1

    def _defer_first_token(self, seq: _Seq) -> None:
        """Processor sequences discard the device-sampled prefill token; the
        first decode step (input = the last prompt token at position
        prompt_len - 1, rewriting its KV) regenerates its logits and the
        host path picks the token."""
        seq.first_deferred = True
        seq.last_token = int(seq.request.token_ids[-1])

    def _dispatch_decode(self):
        """Decode phase 1: fill the batch buffers and issue the fused
        block(s) with no readback; `_drain_decode` copies them back after
        prefill and admission have overlapped the device time. The
        per-token path (block 1, logprobs, or logits processors) reads back
        here and returns a ("count", n) handle."""
        ready = [s for s in self._slots
                 if s is not None and s.decode_ready and not s.finished
                 and not s.cancelled
                 and (len(s.generated) > 0 or s.first_deferred)]
        # Sequences whose first token just came from prefill already have
        # generated[0]; they join decode from the next step. (Processor
        # sequences instead join with first_deferred set: their first token
        # comes from the host path.)
        if not ready:
            return None
        self._active[:] = False
        # Inactive slots: zero history (their writes go to scratch page 0)
        # and neutral sampling parameters.
        self._kv_lens[:] = 0
        self._positions[:] = 0
        self._temp[:] = 0.0
        self._top_p[:] = 1.0
        self._top_k[:] = 0
        self._lora_idx[:] = 0
        for seq in ready:
            i = seq.slot
            self._tokens[i] = seq.last_token
            self._positions[i] = seq.kv_len - 1  # position of last_token
            self._tables[i] = seq.block_table
            self._kv_lens[i] = seq.kv_len
            self._active[i] = True
            s = seq.request.sampling
            self._temp[i] = s.temperature
            self._top_p[i] = s.top_p
            self._top_k[i] = s.top_k
            self._seeds[i] = seq.seed
            self._steps[i] = len(seq.generated)
            self._lora_idx[i] = seq.lora_idx
        want_logprobs = any(s.request.sampling.logprobs for s in ready)
        want_logits = any(s.processors for s in ready)
        spec = self._maybe_dispatch_spec(ready, want_logprobs, want_logits)
        if spec is not None:
            return spec
        prefill_pending = any(
            s is not None and not s.decode_ready and not s.cancelled
            for s in self._slots)
        # One processor slot puts the whole batch on per-token steps, as in
        # the reference.
        block, depth = self._decode_block_for(
            ready, want_logprobs or want_logits, prefill_pending)
        # Cut the block table to the live context (power-of-two widths), so
        # no decode attention path reads past what the batch can reach and
        # the runner's step graphs stay one per width bucket.
        max_kv = max(s.kv_len for s in ready) + block * depth
        width = bucket_table_width(-(-max_kv // self.page_size),
                                   self.runner.config.max_pages_per_seq)
        tables = np.ascontiguousarray(self._tables[:, :width])
        if block > 1:
            # Pipelined dispatch: block d+1 feeds on block d's DEVICE
            # tokens before block d is read back.
            device_blocks = []
            toks_dev = None
            # the submit stamps and the profiler's decode scope; the device
            # window runs from this scope's end to _drain_decode's readback
            with self.steptrace.dispatch("decode", self.stats.steps):
                for d in range(depth):
                    toks_dev = self.runner.decode_multi(
                        self._tokens if d == 0 else toks_dev[-1],
                        self._positions + d * block, tables,
                        self._kv_lens + d * block * self._active,
                        self._active, self._temp, self._top_p, self._top_k,
                        self._seeds, self._steps + d * block, k=block,
                        return_device=True, lora_idx=self._lora_idx,
                    )
                    device_blocks.append(toks_dev)
            return ("blocks", device_blocks, ready, block)
        return ("count", self._decode_single(ready, tables, want_logprobs,
                                             want_logits))

    def _drain_decode(self, pending) -> int:
        """Decode phase 2: copy the fused block(s) to the host and append
        tokens. Sequences that stopped inside a block have their surplus
        tokens discarded (their KV lives in the sequence's own slack
        pages)."""
        if pending is None:
            return 0
        if pending[0] == "count":
            return pending[1]
        if pending[0] == "spec":
            return self._drain_spec(pending)
        _kind, device_blocks, ready, block = pending
        # Copy EVERY block before emitting any token, so a finish frame
        # never goes out before the page release that follows it.
        with self.steptrace.drain("decode") as drain:
            blocks_np = [t.cpu().numpy() for t in device_blocks]
        # every live slot waited this device window out
        for seq in ready:
            seq.device_decode_ms += drain.device_ms
        count = 0
        for toks_k in blocks_np:
            for step in range(block):
                for seq in ready:
                    if seq.finished or seq.cancelled:
                        continue  # stopped inside the block: discard
                    self._append_token(seq, int(toks_k[step][seq.slot]))
                    count += 1
        return count

    # -- speculative decoding (engine/spec.py) ------------------------------

    def _maybe_dispatch_spec(self, ready: list, want_logprobs: bool,
                             want_logits: bool):
        """Try a speculative verification step instead of the fused /
        per-token decode. Returns a ("spec", ...) handle (drained by
        `_drain_decode`) or None to fall through.

        Policy: speculation trades FLOPs for latency; it wins at small batch
        on predictable text. Gated off batch-wide for logprobs requests
        (their data needs a readback per step), per iteration above the
        batch-pressure cutoff, and per slot by the acceptance EMA with
        periodic probing. Logits-processor slots ride along: their raw rows
        are read back and verified on the host with their processors applied
        position by position (`_commit_spec_host`), as the per-token path
        applies them."""
        if not self.spec_enabled:
            return None
        # Every fall-through means "no speculation this iteration": zero the
        # per-step k up front; the drain of a dispatched step writes it.
        self.stats.spec_last_k = 0
        if want_logprobs:
            return None
        if any(s.first_deferred for s in ready):
            # First-token-deferred processor sequences take their first
            # token through _decode_single; they speculate from the next
            # iteration.
            return None
        if self.spec_cutoff and len(ready) > self.spec_cutoff:
            return None
        need = self.spec_k + 1
        if not all(s.slack_ok
                   or (s.request.sampling.max_tokens - len(s.generated)
                       >= need)
                   for s in ready):
            return None
        drafts = np.zeros((self.max_batch, self.spec_k), np.int32)
        mined = 0
        expected = 0.0  # sum of ema * draft length: expected accepted tokens
        for seq in ready:
            sp = seq.spec
            if sp is None:
                continue
            sp.pending = 0
            remaining = seq.request.sampling.max_tokens - len(seq.generated)
            if (self.spec_min_ema > 0 and sp.ema < self.spec_min_ema
                    and not sp.wants_probe()):
                continue
            prop = propose_for(sp, self.spec_lookahead, self.spec_k,
                               remaining)
            if prop:
                sp.pending = len(prop)
                drafts[seq.slot, :len(prop)] = prop
                mined += len(prop)
                expected += sp.ema * len(prop)
        # A spec step is ONE dispatch emitting 1 + accepted tokens per slot;
        # the fused block it displaces emits `block` tokens per slot. The
        # expected accepted total must cover half a token per ready slot
        # (against per-token decode, as with block 1 or a processor batch,
        # any expected acceptance wins).
        per_token_alt = self.decode_block <= 1 or want_logits
        threshold = 0.0 if per_token_alt else 0.5 * len(ready)
        if mined == 0 or expected < threshold:
            return None
        max_kv = max(s.kv_len for s in ready) + need
        width = bucket_table_width(-(-max_kv // self.page_size),
                                   self.runner.config.max_pages_per_seq)
        proc_slots = [s.slot for s in ready if s.processors]
        with self.steptrace.dispatch("spec", self.stats.steps):
            targets, n_acc = self.runner.decode_spec(
                self._tokens, drafts, self._positions,
                np.ascontiguousarray(self._tables[:, :width]), self._kv_lens,
                self._active, self._temp, self._top_p, self._top_k,
                self._seeds, self._steps, want_logits=want_logits,
                logits_slots=proc_slots if want_logits else None,
                return_device=True, lora_idx=self._lora_idx)
        logits = self.runner.last_spec_logits if want_logits else None
        return ("spec", targets, n_acc, ready, drafts, logits, proc_slots)

    def _drain_spec(self, pending) -> int:
        """Copy a verification step back and commit each slot's verified
        prefix. The committed tokens are the per-position TARGET samples
        (sequential decode's draws), so stop conditions, streaming and page
        release flow through `_append_token` unchanged; rejected-draft KV
        sits in the sequence's own slack pages and is rewritten by the next
        step."""
        _kind, targets_dev, n_acc_dev, ready, drafts, logits, slots = pending
        with self.steptrace.drain("spec") as drain:
            targets = targets_dev.cpu().numpy()
            n_acc = n_acc_dev.cpu().numpy()
            # The targets' readback synchronized: the logits rows have
            # landed.
            rows = {}
            if logits is not None:
                rows = dict(zip(slots, logits.numpy()))
        for seq in ready:
            seq.device_decode_ms += drain.device_ms
        if logits is not None:
            self.stats.logits_steps += 1
            self.stats.spec_logits_steps += 1
        self.stats.spec_steps += 1
        self.stats.spec_last_k = max(
            (s.spec.pending for s in ready if s.spec is not None), default=0)
        count = 0
        emas = []
        for seq in ready:
            if seq.finished or seq.cancelled:
                continue
            i = seq.slot
            if seq.processors:
                count += self._commit_spec_host(seq, drafts[i], rows[i])
            else:
                count += self._commit_spec(
                    seq, [int(t) for t in targets[i, : int(n_acc[i]) + 1]])
            if seq.spec is not None and seq.spec.pending:
                emas.append(seq.spec.ema)
        if emas:
            self.stats.spec_ema = float(np.mean(emas))
        return count

    def _commit_spec(self, seq: _Seq, tokens: list) -> int:
        """Commit verified tokens through the normal append path and update
        the slot's acceptance against its MINED draft length (accidental
        matches on the draft row's zero padding are committed, being correct
        target samples, but never counted as acceptance)."""
        sp = seq.spec
        emitted = 0
        for tok in tokens:
            if seq.finished or seq.cancelled:
                break
            self._append_token(seq, tok)
            emitted += 1
        if sp is not None and sp.pending:
            accepted = min(max(emitted - 1, 0), sp.pending)
            sp.observe(sp.pending, accepted)
            self.stats.spec_proposed += sp.pending
            self.stats.spec_accepted += accepted
        return emitted

    def _commit_spec_host(self, seq: _Seq, draft_row: np.ndarray,
                          logits_rows: np.ndarray) -> int:
        """Host verification leg for logits-processor sequences: apply the
        slot's processors to each raw row exactly as the per-token path does
        (same input_ids prefix, same host_sample (seed, step) key), and
        accept the draft only when it equals the processed sample. One
        processor call per committed token: the same call counts and
        mutation order as sequential decode, so stateful processors (guided
        DFAs, forced responses) stay in step."""
        sp = seq.spec
        input_ids = list(seq.generated)
        k = len(draft_row)
        emitted = 0
        accepted = 0
        for i in range(k + 1):
            try:
                token = self._host_process_sample(seq, logits_rows[i],
                                                  input_ids)
            except Exception as exc:  # noqa: BLE001 -- same contract as
                # the per-token host path in _decode_single
                self._fail_processor_seq(seq, exc)
                break
            self._append_token(seq, token)
            emitted += 1
            if seq.finished or seq.cancelled:
                break
            if not seq.processors:
                # Processors retired mid-chunk (min_tokens met): sequential
                # decode would continue on the DEVICE sampler, whose draws
                # differ from host_sample; stop here so the next iteration
                # takes the device path as sequential decode does.
                break
            input_ids.append(token)
            if i < k and int(draft_row[i]) == token:
                accepted += 1
                continue
            break
        if sp is not None and sp.pending:
            sp.observe(sp.pending, min(accepted, sp.pending))
            self.stats.spec_proposed += sp.pending
            self.stats.spec_accepted += min(accepted, sp.pending)
        return emitted

    def _decode_single(self, ready: list, tables: np.ndarray,
                       want_logprobs: bool, want_logits: bool) -> int:
        """Per-token decode with an immediate readback (block 1, or a batch
        with a logprobs request or a processor slot). With processors the
        raw logits rows of the processor and logprobs slots come back too,
        and those slots' tokens and logprob data are made on the host."""
        slots = ([s.slot for s in ready
                  if s.processors or s.request.sampling.logprobs]
                 if want_logits else None)
        # dispatch, execution and readback in the one runner call: the whole
        # duration is the device window
        with self.steptrace.sync("decode", self.stats.steps) as sc:
            next_tokens = self.runner.decode(
                self._tokens, self._positions, tables, self._kv_lens,
                self._active, self._temp, self._top_p, self._top_k,
                self._seeds, self._steps, want_logprobs=want_logprobs,
                want_logits=want_logits, logits_slots=slots,
                lora_idx=self._lora_idx)
        for seq in ready:
            seq.device_decode_ms += sc.device_ms
        lp_b, tid_b, tlp_b = self.runner.last_decode_sample
        rows = {}
        if want_logits:
            rows = dict(zip(slots, self.runner.last_decode_logits))
            self.stats.logits_steps += 1
        count = 0
        for seq in ready:
            i = seq.slot
            info = ((lp_b[i], tid_b[i], tlp_b[i])
                    if lp_b is not None else None)
            token = int(next_tokens[i])
            if i in rows:
                try:
                    token, info = self._host_sample_slot(seq, rows[i], token)
                except Exception as exc:  # noqa: BLE001 -- same contract
                    # as the speculative host leg (_fail_processor_seq)
                    self._fail_processor_seq(seq, exc)
                    continue
            first = seq.first_deferred and not seq.generated
            seq.first_deferred = False
            self._append_token(
                seq, token, sample_info=info,
                prompt_tokens=seq.prompt_len if first else None)
            count += 1
        return count

    def _timed(self, name: str, fn, *args):
        """fn(*args), its host milliseconds added to stats.host_ms[name]."""
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            ms = (time.perf_counter() - t0) * 1e3
            self.stats.host_ms[name] = self.stats.host_ms.get(name, 0.0) + ms

    def _host_process_sample(self, seq: _Seq, raw_row: np.ndarray,
                             input_ids: list) -> int:
        """The host sampling leg shared by the per-token processor path
        (_host_sample_slot) and the speculative verification leg
        (_commit_spec_host): apply the sequence's processors to a copy of
        the raw logits row, then host_sample keyed by (seed,
        len(input_ids)). ONE definition, so the two paths cannot drift
        apart on processor order or sampling keys."""
        s = seq.request.sampling
        row = raw_row.astype(np.float32).copy()
        for proc in seq.processors:
            self._timed(type(proc).__name__, proc, input_ids, row)
        return self._timed("host_sample", host_sample, row, s.temperature,
                           s.top_p, s.top_k, seq.seed, len(input_ids))

    def _fail_processor_seq(self, seq: _Seq, exc: Exception) -> None:
        """A misbehaving user processor (bad token id, all-banned vocab)
        errors ITS request, not the scheduler thread and every stream."""
        log.warning("logits processor failed for %s: %r",
                    seq.request.request_id, exc)
        seq.finished = True
        seq.emit(EngineOutput(finish_reason="error",
                              error=f"logits processor failed: {exc}"))

    def _host_sample_slot(self, seq: _Seq, raw_row: np.ndarray,
                          device_token: int):
        """Host leg of the logits-processor path: apply the sequence's
        processors to its raw logits row and re-sample; a sequence without
        processors keeps the device-sampled token. Logprob data (when the
        request asks) comes from the RAW distribution (OpenAI semantics:
        logprobs reflect the model, not the processors)."""
        s = seq.request.sampling
        token = device_token
        if seq.processors:
            token = self._host_process_sample(seq, raw_row,
                                              list(seq.generated))
        info = None
        if s.logprobs:
            logp = raw_row.astype(np.float64)
            logp -= logp.max()
            logp -= np.log(np.exp(logp).sum())
            k = min(TOP_LOGPROBS_K, len(logp))
            top_ids = np.argpartition(logp, -k)[-k:]
            top_ids = top_ids[np.argsort(logp[top_ids])[::-1]]
            info = (float(logp[token]), top_ids.astype(np.int32),
                    logp[top_ids].astype(np.float32))
        return token, info

    def _decode_block_for(self, ready: list, want_host: bool,
                          prefill_pending: bool) -> tuple[int, int]:
        """(block, pipeline depth) for this iteration. Per-token (1, 1) when
        a sequence wants logprobs or has logits processors (a readback per
        step). Prefill work or waiting requests keep depth at 1; pure-decode
        phases chain `decode_pipeline` blocks on device-resident tokens. A
        sequence without slack pages fuses only while its token budget
        covers the block."""
        if self.decode_block <= 1 or want_host:
            return 1, 1
        depth = (1 if (prefill_pending or self._waiting)
                 else max(1, self.decode_pipeline))
        while depth >= 1:
            need = self.decode_block * depth
            if all(s.slack_ok
                   or (s.request.sampling.max_tokens - len(s.generated)
                       >= need)
                   for s in ready):
                return self.decode_block, depth
            depth -= 1
        return 1, 1

    def _append_token(self, seq: _Seq, token: int,
                      prompt_tokens: Optional[int] = None,
                      sample_info: Optional[tuple] = None) -> None:
        seq.generated.append(token)
        if len(seq.generated) == 1 and seq.record_id is not None:
            get_recorder().stamp(seq.record_id, "first_token")
            if seq.device_prefill_ms:
                # the device share of the TTFT the timeline just closed
                get_recorder().device(seq.record_id, "prefill",
                                      seq.device_prefill_ms)
        seq.last_token = token
        if seq.spec is not None:
            # Keep the n-gram index and the hash chain current on every
            # commit path (speculative, fused, per-token, prefill's first).
            seq.spec.extend([token])
        request = seq.request
        finish = None
        if not request.stop.ignore_eos and token in request.eos_token_ids:
            finish = "stop"
        elif token in request.stop.stop_token_ids:
            finish = "stop"
        elif len(seq.generated) >= request.sampling.max_tokens:
            finish = "length"
        logprobs = None
        top_logprobs = None
        if request.sampling.logprobs and sample_info is not None:
            lp, top_ids, top_lps = sample_info
            logprobs = [float(lp)]
            n = min(int(request.sampling.top_logprobs or 0), len(top_ids))
            if n > 0:
                top_logprobs = [[[int(i), float(v)]
                                 for i, v in zip(top_ids[:n], top_lps[:n])]]
        if (finish is not None and seq.device_decode_ms
                and seq.record_id is not None):
            # Flush the decode device burn BEFORE the finish frame goes out:
            # the worker closes the timeline as soon as it reads that frame.
            # Zeroed, so the reap cannot count it twice.
            get_recorder().device(seq.record_id, "decode",
                                  seq.device_decode_ms)
            seq.device_decode_ms = 0.0
        seq.emit(EngineOutput(
            token_ids=[token], finish_reason=finish,
            prompt_tokens=prompt_tokens,
            logprobs=logprobs, top_logprobs=top_logprobs,
        ))
        if finish is not None:
            seq.finished = True
        elif seq.processors:
            self._maybe_retire_processors(seq)

    def _maybe_retire_processors(self, seq: _Seq) -> None:
        """min_tokens is the only processor that EXPIRES: once its budget is
        met it is a no-op for the rest of the stream, so a sequence whose
        processors are all met MinTokens drops them and rejoins the fused,
        device-sampled decode path instead of paying a logits readback per
        step for its whole life."""
        if all(isinstance(p, MinTokensProcessor)
               and len(seq.generated) >= p.min_tokens
               for p in seq.processors):
            seq.processors = None

    # -- graceful drain (engine/drain.py) -----------------------------------

    def drain_sweep(self, register_handoff=None) -> dict:
        """Vacate the live sequences for a graceful departure. Scheduler
        thread only (run_in_step): between steps no decode block is in
        flight, so pages can change owner.

        Rung 1, KV handoff: an eligible decode sequence parks its computed
        pages with the worker's transfer table (`register_handoff(seq,
        page_ids, computed_tokens) -> params`) and emits a migrate frame
        carrying kv_transfer_params and its resume state; the frontend's
        Migration re-dispatches it to a peer that pulls the KV and resumes.
        Eligible: decode-ready with committed tokens and no host-sampler
        state (logits processors hold live Python state a handoff cannot
        carry).

        Rung 2, cooperative replay: everything else live (mid-prefill,
        processor slots, waiting, parked) emits a plain migrate; the peer
        replays prompt + generated tokens.

        Prefill-only sequences that already handed pages to a transfer keep
        running (their decode peer is pulling); the drain deadline bounds
        them. Returns {"handoff", "replay", "pending"} request-id lists."""
        self.draining = True
        report: dict = {"handoff": [], "replay": [], "pending": []}

        def replay(seq: _Seq) -> None:
            self.stats.drain_replayed += 1
            report["replay"].append(seq.request.request_id)
            get_recorder().event(seq.record_id, "drain", rung="replay",
                                 tokens_preserved=len(seq.generated))
            seq.emit(EngineOutput(finish_reason="migrate",
                                  error="worker draining"))

        for seq in self._waiting:
            if not seq.cancelled:
                replay(seq)
                seq.cancelled = True
        self._waiting.clear()
        for seq in self._parked:
            # parked bundles reference a pool that is departing: replay
            self._drop_parked(seq.request.request_id)
            if not seq.cancelled:
                replay(seq)
                seq.cancelled = True
        self._parked.clear()
        for seq in self._slots:
            if seq is None or seq.finished or seq.cancelled:
                continue
            rid = seq.request.request_id
            if seq.prefill_only or seq.keep_pages:
                report["pending"].append(rid)
                continue
            params = None
            if (register_handoff is not None and seq.decode_ready
                    and seq.generated and not seq.processors
                    and not seq.first_deferred):
                # KV on the device: positions 0 .. kv_len - 2
                computed = seq.kv_len - 1
                n_pages = -(-computed // self.page_size)
                page_ids = [int(p) for p in seq.block_table[:n_pages]]
                try:
                    params = register_handoff(seq, page_ids, computed)
                except Exception:  # noqa: BLE001 — a failed registration
                    # takes the replay rung
                    log.exception("handoff registration failed for %s", rid)
            seq.finished = True
            if params is None:
                replay(seq)
                continue
            # The transfer owns the pages now: its claim or expiry releases
            # them, exactly once.
            seq.keep_pages = True
            self.stats.drain_handoff += 1
            report["handoff"].append(rid)
            get_recorder().event(seq.record_id, "drain", rung="handoff",
                                 tokens_preserved=len(seq.generated))
            seq.emit(EngineOutput(
                finish_reason="migrate", error="worker draining (kv handoff)",
                kv_transfer_params=params))
        self._reap_finished()
        return report

    def drain_expire(self, reason: str) -> int:
        """The deadline rung: finish every sequence still live with an
        honest in-band error (scheduler thread)."""
        n = 0
        for seq in self._waiting:
            if not seq.cancelled:
                seq.emit(EngineOutput(finish_reason="error", error=reason))
                seq.cancelled = True
                n += 1
        self._waiting.clear()
        for seq in self._parked:
            self._drop_parked(seq.request.request_id)
            if not seq.cancelled:
                seq.emit(EngineOutput(finish_reason="error", error=reason))
                seq.cancelled = True
                n += 1
        self._parked.clear()
        for seq in self._slots:
            if seq is not None and not seq.finished and not seq.cancelled:
                seq.emit(EngineOutput(finish_reason="error", error=reason))
                seq.finished = True
                n += 1
        self.stats.drain_errored += n
        self._reap_finished()
        return n

    def _reap_finished(self) -> None:
        for i, seq in enumerate(self._slots):
            if seq is None or not (seq.finished or seq.cancelled):
                continue
            if seq.device_decode_ms and seq.record_id is not None:
                # the decode device burn, flushed once at the reap
                # (per-step recorder traffic would tax the loop)
                get_recorder().device(seq.record_id, "decode",
                                      seq.device_decode_ms)
            if (seq.stream_started and not seq.stream_done
                    and seq.on_prefill_chunk is not None):
                # A prefill-only sequence died mid-stream (cancel or error
                # before on_prefill_done): fail its streaming transfer, so a
                # waiting puller stops and the parked pages release once.
                try:
                    seq.on_prefill_chunk(seq, None)
                except Exception:  # noqa: BLE001 — the reap must proceed
                    log.exception("stream abort hook failed")
            if not seq.keep_pages:
                # Only blocks whose KV was actually computed may enter the
                # prefix cache (a cancel mid-prefill leaves later blocks
                # unwritten).
                computed = seq.prefill_pos // self.page_size
                self.pool.release(seq.alloc, seq.block_hashes,
                                  computed_blocks=computed)
            if (seq.spec is not None and seq.spec.proposed
                    and seq.record_id is not None):
                # where this request's speculated tokens were won or wasted
                get_recorder().event(seq.record_id, "spec",
                                     proposed=seq.spec.proposed,
                                     accepted=seq.spec.accepted)
            if (seq.spec is not None and not seq.cancelled
                    and self.spec_lookahead is not None):
                # Teach the cross-request lookahead this sequence's
                # block-hash -> continuation chain.
                self.spec_lookahead.record(seq.spec.hasher.block_hashes,
                                           seq.spec.proposer.tokens)
            self._slots[i] = None


class _SubmitHandle:
    """Cancellation handle bridging asyncio-side aborts (a client cancel, a
    deadline watchdog) into the thread; `wake` rouses an idle loop so the
    sequence's pages return within one iteration."""

    def __init__(self, wake: Optional[Callable[[], None]] = None) -> None:
        self.seq: Optional[_Seq] = None
        self._cancelled = False
        self._wake = wake

    def cancel(self) -> None:
        self._cancelled = True
        if self.seq is not None:
            self.seq.cancelled = True
        if self._wake is not None:
            self._wake()
