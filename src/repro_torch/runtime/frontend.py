"""Async serving front-end: per-request token streams over the engine
(port of ``repro/runtime/frontend.py``).

The engine is a synchronous host loop (submit / step / run) built
around one thread touching the pool.  This module puts an asyncio face
on it without changing that contract: ONE pump task drives the engine
inside ``loop.run_in_executor`` (so kernel launches and host syncs never
block the event loop; the pump's thread is the only one that touches the
engine and the card), and every client-visible edge crosses back with
``call_soon_threadsafe``:

  submit()  -> StreamHandle whose ``tokens()`` async-iterates the
               request's tokens as the engine emits them (SSE-style:
               each scheduler sync delivers the >= 1 new tokens) and
               whose ``result()`` awaits the finished Request;
  cancel()  -> enqueued to the pump, takes effect at the next sync;
  tenant()  -> a per-tenant context binding tenant/SLO labels so
               callers don't thread them through every submit.

With an ``SLOScheduler`` attached, submissions go through its
admission-control ladder: a shed request's handle resolves immediately
with ``handle.shed`` True and an empty stream — the rejection IS the
response, matching how an overloaded front door should answer.

Delivery plumbing: the engine's ``stream_cb`` fires in the pump
(executor) thread and forwards token batches onto the handle's
``asyncio.Queue`` via ``call_soon_threadsafe`` — the only thread-safe
way onto a loop — and the pump marks handles done centrally after each
step (covers cancel-before-admission, which never fires the callback).
Backpressure note: queues are unbounded on purpose; tokens are a few
ints per sync and the alternative (blocking the engine thread on a slow
client) would stall every co-resident stream.

All waiting is event-driven for clients (``await`` on queues/events);
the pump itself yields to the loop between engine steps so concurrent
submits/cancels interleave with decode bursts.
"""
from __future__ import annotations

import asyncio
import collections
import dataclasses
from typing import Optional

from repro_torch.runtime.engine import Engine
from repro_torch.runtime.sampling import SamplingParams
from repro_torch.runtime.scheduler import SLOScheduler

_DONE = object()


class StreamHandle:
    """One submitted request as seen by an async client."""

    def __init__(self, loop: asyncio.AbstractEventLoop):
        self._loop = loop
        self._queue: asyncio.Queue = asyncio.Queue()
        self._done = asyncio.Event()
        self.req = None               # engine Request once admitted
        self.ticket = None            # scheduler Ticket when scheduled
        self.shed = False
        self.cancelled = False

    # -- engine-thread side (pump) ------------------------------------------

    def _push_threadsafe(self, toks: list) -> None:
        self._loop.call_soon_threadsafe(self._queue.put_nowait,
                                        list(toks))

    def _finish_threadsafe(self) -> None:
        def _fin():
            self._queue.put_nowait(_DONE)
            self._done.set()
        self._loop.call_soon_threadsafe(_fin)

    # -- client side --------------------------------------------------------

    async def tokens(self):
        """Async-iterate the stream's tokens until it finishes (or is
        cancelled/shed — the stream just ends; inspect ``req`` /
        ``shed`` afterwards)."""
        while True:
            item = await self._queue.get()
            if item is _DONE:
                return
            for tok in item:
                yield tok

    async def result(self):
        """Await completion; returns the finished Request (None when
        the request was shed at admission control)."""
        await self._done.wait()
        return self.req

    @property
    def finished(self) -> bool:
        return self._done.is_set()


@dataclasses.dataclass
class _Submit:
    handle: StreamHandle
    prompt: object
    params: Optional[SamplingParams]
    kw: dict


@dataclasses.dataclass
class _Cancel:
    handle: StreamHandle


class TenantContext:
    """Binds tenant + SLO class labels onto submissions."""

    def __init__(self, frontend: "AsyncFrontend", tenant: str,
                 slo: Optional[str] = None):
        self._fe = frontend
        self.tenant = tenant
        self.slo = slo

    async def submit(self, prompt, params=None, **kw):
        kw.setdefault("tenant", self.tenant)
        if self.slo is not None:
            kw.setdefault("slo", self.slo)
        return await self._fe.submit(prompt, params, **kw)


class AsyncFrontend:
    """Asyncio front door over an Engine (optionally behind an
    SLOScheduler).  Use as an async context manager::

        async with AsyncFrontend(engine, scheduler) as fe:
            h = await fe.submit(prompt, params, tenant="acme")
            async for tok in h.tokens(): ...
            req = await h.result()
    """

    def __init__(self, engine: Engine,
                 scheduler: Optional[SLOScheduler] = None):
        if scheduler is not None and scheduler.engine is not engine:
            raise ValueError("scheduler drives a different engine")
        self.engine = engine
        self.scheduler = scheduler
        self._inbox: collections.deque = collections.deque()
        self._handles: list[StreamHandle] = []
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._task: Optional[asyncio.Task] = None
        self._running = False

    # -- lifecycle ----------------------------------------------------------

    async def __aenter__(self) -> "AsyncFrontend":
        self.start()
        return self

    async def __aexit__(self, *exc) -> None:
        await self.stop()

    def start(self) -> None:
        if self._task is not None:
            raise RuntimeError("frontend already started")
        self._loop = asyncio.get_running_loop()
        self._running = True
        self._task = self._loop.create_task(self._pump())

    async def stop(self, drain: bool = True) -> None:
        """Stop pumping.  ``drain=True`` (default) first cancels every
        live request — including infinite-stream sessions, which never
        end on their own — and lets the engine retire them, so no slot
        is left pinned and every handle resolves."""
        if self._task is None:
            return
        if drain:
            for h in self._handles:
                if not h.finished:
                    self._inbox.append(_Cancel(h))
            while any(not h.finished for h in self._handles):
                await asyncio.sleep(0)
        self._running = False
        await self._task
        self._task = None

    def tenant(self, name: str, slo: Optional[str] = None) -> TenantContext:
        return TenantContext(self, name, slo)

    # -- client API ---------------------------------------------------------

    async def submit(self, prompt,
                     params: Optional[SamplingParams] = None,
                     **kw) -> StreamHandle:
        """Submit a request; resolves once admission control has run
        (so ``handle.shed`` is meaningful on return).  ``kw`` passes
        through to ``SLOScheduler.submit`` (tenant, slo, session,
        max_new, ...) or — without a scheduler — to ``Engine.submit``.
        """
        if self._task is None:
            raise RuntimeError("frontend not started")
        handle = StreamHandle(self._loop)
        self._handles.append(handle)
        submitted = asyncio.Event()
        self._inbox.append((_Submit(handle, prompt, params, kw),
                            submitted))
        await submitted.wait()
        return handle

    async def cancel(self, handle: StreamHandle) -> None:
        """Request cancellation; the stream ends at the engine's next
        scheduler sync (tokens already delivered stand)."""
        handle.cancelled = True
        self._inbox.append(_Cancel(handle))

    # -- pump ---------------------------------------------------------------

    def _stream_cb(self, handle: StreamHandle):
        def cb(req, new_toks):
            handle._push_threadsafe(new_toks)
        return cb

    def _do_submit(self, msg: _Submit) -> None:
        h = msg.handle
        cb = self._stream_cb(h)
        if self.scheduler is not None:
            t = self.scheduler.submit(msg.prompt, msg.params,
                                      stream_cb=cb, **msg.kw)
            h.ticket = t
            if t.shed:
                h.shed = True
                h._finish_threadsafe()
        else:
            kw = dict(msg.kw)
            kw.pop("slo", None)
            h.req = self.engine.submit(msg.prompt, msg.params,
                                       stream_cb=cb, **kw)

    def _pump_once(self) -> bool:
        """One synchronous pump iteration (runs in the executor
        thread): drain the inbox, release + step the engine, resolve
        finished handles."""
        did = False
        while self._inbox:
            msg = self._inbox.popleft()
            if isinstance(msg, _Cancel):
                h = msg.handle
                if h.req is not None:
                    self.engine.cancel(h.req.req_id)
                elif h.ticket is not None and h.ticket.req is not None:
                    self.engine.cancel(h.ticket.req.req_id)
                elif h.ticket is not None and not h.ticket.shed:
                    # still queued in the scheduler: drop it there
                    q = self.scheduler._queues.get(h.ticket.tenant)
                    if q is not None and h.ticket in q:
                        q.remove(h.ticket)
                        self.scheduler._n_queued -= 1
                        self.scheduler._queued_cost -= h.ticket.cost
                        h._finish_threadsafe()
                did = True
            else:
                submit_msg, submitted = msg
                self._do_submit(submit_msg)
                self._loop.call_soon_threadsafe(submitted.set)
                did = True
        if self.scheduler is not None:
            did = self.scheduler.step() or did
        else:
            did = self.engine.step() or did
        for h in self._handles:
            if h.finished:
                continue
            req = h.req or (h.ticket.req if h.ticket is not None
                            else None)
            if req is not None:
                h.req = req
                if req.finished:
                    h._finish_threadsafe()
                    did = True
        return did

    async def _pump(self) -> None:
        loop = self._loop
        while True:
            did = await loop.run_in_executor(None, self._pump_once)
            if not self._running and not self._inbox and not did:
                break
            if not did:
                # idle: yield without burning the executor
                await asyncio.sleep(0.001)
            else:
                await asyncio.sleep(0)
