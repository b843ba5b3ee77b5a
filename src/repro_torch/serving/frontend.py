"""TCP request front-end: a newline-delimited-JSON streaming endpoint over
:class:`~repro_torch.serving.async_engine.AsyncEngine`.

The container has no HTTP framework, so the wire protocol is deliberately
minimal — JSON lines over a plain asyncio TCP socket, one object per line
(it maps 1:1 onto an SSE/HTTP endpoint if one is ever layered on top):

Client -> server (one JSON object per line):

* ``{"prompt": [int...], "max_tokens": 32, "temperature": 0.0,
  "top_p": 1.0, "seed": null, "ignore_eos": false, "deadline_ms": 500}``
  — submit a generation request.  Only ``prompt`` is required;
  ``deadline_ms`` (relative) arms a per-request deadline.
* ``{"cancel": <uid>}`` — cancel an in-flight request by uid (any
  connection may cancel any uid; uids are returned in the ack).
* ``{"type": "stats"}`` — fetch a live metrics snapshot from the engine's
  registry; the reply is one line ``{"type": "stats", "stats": {...}}``
  (the JSON form of every counter / gauge / histogram).  With
  ``"format": "prometheus"`` the reply instead carries the registry's
  Prometheus text exposition in a ``"text"`` field.
* ``{"resume": <uid>, "offset": <n>}`` — reattach to a request after a
  server crash+recovery (the server was relaunched with a
  :class:`~repro_torch.serving.recovery.RecoveryReport`).  ``offset`` is how many
  token events the client already received; the server replays the
  journal-committed suffix it is missing, then — if the request is still
  live — streams new tokens from the recovered engine.  The journal is
  written before delivery, so the replayed suffix plus the live stream is
  exactly-once: no token is ever lost or sent twice.  The ack is
  ``{"uid", "resumed": true, "backlog": <k>}``; an unknown uid, an
  offset past the durable token count, or a uid whose stream another
  connection is actively consuming (each stream has exactly one
  consumer) is a typed protocol error.

Server -> client:

* ack: ``{"uid": <n>}`` on acceptance, or a terminal rejection line
  ``{"uid": -1, "token": -1, "index": -1, "finished": true,
  "finish_reason": "aborted", "error": "overloaded"}`` when the bounded
  queue is full (backpressure) — the client is answered immediately, nothing
  queues unboundedly.
* one event line per :class:`~repro_torch.serving.api.StepOutput`:
  ``{"uid", "token", "index", "finished", "finish_reason"}``.  The last
  line for a request always has ``finished: true``; terminal markers
  (cancelled / deadline / aborted) carry ``token: -1``.

A connection submits requests sequentially (one stream at a time — a
many-client load generator opens one connection per simulated client, see
benchmarks/serving_loadgen.py); **dropping the connection mid-stream cancels
the in-flight request**, freeing its slot and KV blocks immediately.

``FrontendServer`` wraps ``asyncio.start_server``; ``ServeClient`` is the
matching client used by the load generator, ``launch/serve.py``, and the CI
smoke test.

Port of ``repro/serving/frontend.py``, copied with the package renamed:
the wire protocol is the JAX package's.
"""
from __future__ import annotations

import asyncio
import dataclasses
import json
from typing import Dict, List, Optional, Sequence

from repro_torch.serving.api import SamplingParams, StepOutput
from repro_torch.serving.async_engine import AsyncEngine, EngineOverloaded


def encode_output(out: StepOutput) -> bytes:
    return (json.dumps({
        "uid": out.uid, "token": out.token, "index": out.index,
        "finished": out.finished,
        "finish_reason": (out.finish_reason.value
                          if out.finish_reason is not None else None),
    }) + "\n").encode()


def parse_params(msg: Dict, defaults: SamplingParams) -> SamplingParams:
    return dataclasses.replace(
        defaults,
        max_tokens=int(msg.get("max_tokens", defaults.max_tokens)),
        temperature=float(msg.get("temperature", defaults.temperature)),
        top_p=float(msg.get("top_p", defaults.top_p)),
        seed=msg.get("seed", defaults.seed),
        ignore_eos=bool(msg.get("ignore_eos", defaults.ignore_eos)))


class FrontendServer:
    """Serve an :class:`AsyncEngine` over TCP (see module docstring).

    ``port=0`` binds an ephemeral port; the bound port is in ``.port`` after
    :meth:`start`.  ``default_deadline_ms`` arms a deadline for requests that
    do not set their own.  ``recovery`` (a
    :class:`~repro_torch.serving.recovery.RecoveryReport` from replaying the
    predecessor's journal) enables the ``resume`` protocol line: it holds the
    per-uid durable token backlog reconnecting clients replay from."""

    def __init__(self, aeng: AsyncEngine, host: str = "127.0.0.1",
                 port: int = 0,
                 defaults: Optional[SamplingParams] = None,
                 default_deadline_ms: Optional[float] = None,
                 max_line_bytes: int = 1 << 16,
                 max_protocol_errors: int = 8,
                 recovery=None):
        self.aeng = aeng
        self.recovery = recovery
        self.host = host
        self.port = port
        self.defaults = defaults or SamplingParams()
        self.default_deadline_ms = default_deadline_ms
        # line-protocol hardening: lines past max_line_bytes are rejected
        # with a typed error (the stream resyncs at the next newline), and a
        # connection accumulating more than max_protocol_errors poisoned
        # lines is told so and closed — one misbehaving client cannot spin
        # the handler forever
        self.max_line_bytes = max_line_bytes
        self.max_protocol_errors = max_protocol_errors
        self.protocol_errors: Dict[str, int] = {}   # error kind -> count
        # uids whose stream queue a connection is actively pumping: a
        # stream has exactly one consumer, so a resume on a busy uid is a
        # typed protocol error instead of two pumps racing on one queue
        self._pumping: set = set()
        self._server: Optional[asyncio.AbstractServer] = None

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port, limit=self.max_line_bytes)
        self.port = self._server.sockets[0].getsockname()[1]

    async def aclose(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    async def __aenter__(self) -> "FrontendServer":
        await self.start()
        return self

    async def __aexit__(self, exc_type, exc, tb) -> None:
        await self.aclose()

    async def _protocol_error(self, writer: asyncio.StreamWriter,
                              kind: str, state: Dict) -> bool:
        """Answer a poisoned line with a typed error line.  Returns False —
        and closes the conversation with a final ``error budget exhausted``
        line — once this connection has spent its error budget."""
        self.protocol_errors[kind] = self.protocol_errors.get(kind, 0) + 1
        state["errors"] = state.get("errors", 0) + 1
        if state["errors"] > self.max_protocol_errors:
            writer.write(json.dumps(
                {"error": "error budget exhausted", "finished": True}
            ).encode() + b"\n")
            await writer.drain()
            return False
        writer.write(json.dumps({"error": kind}).encode() + b"\n")
        await writer.drain()
        return True

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        state: Dict = {"errors": 0}
        try:
            while True:
                try:
                    line = await reader.readline()
                except ValueError:
                    # line overran the stream limit: readline discarded the
                    # buffered prefix, so the stream resyncs at the next
                    # newline (the tail may surface as one bad-json line,
                    # also charged to the error budget)
                    if not await self._protocol_error(
                            writer, "oversized line", state):
                        return
                    continue
                if not line:
                    return                      # client went away while idle
                try:
                    msg = json.loads(line)
                except json.JSONDecodeError:
                    if not await self._protocol_error(
                            writer, "bad json", state):
                        return
                    continue
                if not isinstance(msg, dict):
                    # valid JSON, wrong shape (e.g. a bare int or list)
                    if not await self._protocol_error(
                            writer, "unknown message type", state):
                        return
                    continue
                if "cancel" in msg:
                    try:
                        uid = int(msg["cancel"])
                    except (TypeError, ValueError):
                        if not await self._protocol_error(
                                writer, "bad cancel", state):
                            return
                        continue
                    self.aeng.cancel(uid)
                    continue
                if msg.get("type") == "stats":
                    # live metrics: snapshot the registry (O(metrics), no
                    # engine locking needed — the registry reads counters
                    # the event loop itself maintains)
                    reg = self.aeng.engine.metrics
                    if msg.get("format") == "prometheus":
                        reply = {"type": "stats", "format": "prometheus",
                                 "text": reg.render_prometheus()}
                    else:
                        reply = {"type": "stats", "stats": reg.snapshot()}
                    writer.write(json.dumps(reply).encode() + b"\n")
                    await writer.drain()
                    continue
                if "resume" in msg:
                    if not await self._serve_resume(msg, reader, writer,
                                                    state):
                        return
                    continue
                if "prompt" not in msg:
                    if not await self._protocol_error(
                            writer, "unknown message type", state):
                        return
                    continue
                if not await self._serve_request(msg, reader, writer, state):
                    return
        except (ConnectionResetError, BrokenPipeError):
            pass
        finally:
            writer.close()

    async def _serve_request(self, msg: Dict, reader: asyncio.StreamReader,
                             writer: asyncio.StreamWriter,
                             state: Dict) -> bool:
        """Serve one submit message to stream completion.  Returns False when
        the connection should close (error budget spent or client gone)."""
        deadline_ms = msg.get("deadline_ms", self.default_deadline_ms)
        try:
            prompt = [int(t) for t in msg["prompt"]]
            params = parse_params(msg, self.defaults)
            deadline_s = (None if deadline_ms is None
                          else float(deadline_ms) / 1e3)
        except (TypeError, ValueError):
            # prompt not int-coercible, or poisoned params fields
            return await self._protocol_error(writer, "bad request", state)
        try:
            req = self.aeng.submit(prompt, params, deadline_s=deadline_s)
        except EngineOverloaded as e:
            # backpressure / load shedding: answer now with a terminal
            # rejection line naming which it was
            from repro_torch.serving.async_engine import EngineSaturated
            writer.write(json.dumps(
                {"uid": -1, "token": -1, "index": -1, "finished": True,
                 "finish_reason": "aborted",
                 "error": ("shedding" if isinstance(e, EngineSaturated)
                           else "overloaded")}
            ).encode() + b"\n")
            await writer.drain()
            return True
        writer.write(json.dumps({"uid": req.uid}).encode() + b"\n")
        await writer.drain()
        return await self._stream_to_client(req.uid, reader, writer, state)

    async def _stream_to_client(self, uid: int, reader: asyncio.StreamReader,
                                writer: asyncio.StreamWriter,
                                state: Dict) -> bool:
        """Pump a live request's stream to the socket while watching it for
        disconnects and in-stream cancels (shared by submit and resume).
        Returns False when the connection should close."""

        async def pump() -> None:
            try:
                async for out in self.aeng.stream(uid):
                    writer.write(encode_output(out))
                    await writer.drain()
                    if out.finished:
                        return
            except (ConnectionResetError, BrokenPipeError):
                # client vanished mid-stream without a clean EOF
                self.aeng.cancel(uid)
                self.aeng.release_stream(uid)
                raise

        # stream events while watching the socket: an EOF mid-stream means
        # the client disconnected — cancel its request (free the slot and
        # blocks immediately); an in-stream line may be an explicit cancel
        self._pumping.add(uid)
        pump_task = asyncio.ensure_future(pump())
        peek: Optional[asyncio.Task] = asyncio.ensure_future(
            reader.readline())
        ok = True
        try:
            while not pump_task.done():
                waiters = {pump_task} | ({peek} if peek is not None else set())
                done, _ = await asyncio.wait(
                    waiters, return_when=asyncio.FIRST_COMPLETED)
                if peek is not None and peek in done:
                    try:
                        line = peek.result()
                    except (ConnectionResetError, BrokenPipeError):
                        # a client that closes with unread streamed tokens
                        # in its buffer resets the connection instead of a
                        # clean FIN — same meaning: the consumer is gone
                        line = b""
                    except ValueError:
                        # oversized line mid-stream: typed error, resync
                        if not await self._protocol_error(
                                writer, "oversized line", state):
                            ok = False
                            break
                        peek = asyncio.ensure_future(reader.readline())
                        continue
                    if not line:                # disconnect: cancel + bail
                        self.aeng.cancel(uid)
                        pump_task.cancel()
                        self.aeng.release_stream(uid)
                        return False
                    try:
                        inner = json.loads(line)
                    except json.JSONDecodeError:
                        inner = {}
                    if not isinstance(inner, dict):
                        inner = {}
                    if "cancel" in inner:
                        try:
                            self.aeng.cancel(int(inner["cancel"]))
                        except (TypeError, ValueError):
                            if not await self._protocol_error(
                                    writer, "bad cancel", state):
                                ok = False
                                break
                    peek = asyncio.ensure_future(reader.readline())
            if ok:
                await pump_task
            else:
                # error budget spent mid-stream: the consumer is being
                # dropped — end its request like a disconnect
                self.aeng.cancel(uid)
                pump_task.cancel()
                self.aeng.release_stream(uid)
            return ok
        finally:
            self._pumping.discard(uid)
            # unwind the peek fully before _handle's next readline() — an
            # abandoned cancelled task still holds the stream's read waiter
            for t in (peek, pump_task):
                if t is None:
                    continue
                if not t.done():
                    t.cancel()
                await asyncio.gather(t, return_exceptions=True)

    async def _serve_resume(self, msg: Dict, reader: asyncio.StreamReader,
                            writer: asyncio.StreamWriter,
                            state: Dict) -> bool:
        """Reattach a client to a request at a token offset (see module
        docstring).  The durable backlog comes from the live request object
        when the uid is still in flight (its forced-prefix ``output_tokens``
        are a superset of everything any client was ever sent — the journal
        is written before delivery), or — once it finished — from the
        journal's live folded state (kept current by the writer, so it also
        covers requests that finished *after* a relaunch) with the recovery
        report's replay-time snapshot as the journal-less fallback."""
        try:
            uid = int(msg["resume"])
            offset = int(msg.get("offset", 0))
        except (TypeError, ValueError):
            return await self._protocol_error(writer, "bad resume", state)
        eng = self.aeng.engine
        req = eng._requests.get(uid)
        rec = self.recovery
        if req is not None:
            if uid in self._pumping:
                # another connection is actively consuming this stream (the
                # original submitter, or an earlier resume): adopting the
                # queue here would drop its events and split tokens between
                # two pumps — reject instead of racing
                return await self._protocol_error(
                    writer, "resume uid busy", state)
            # Live request.  Synchronous block — no awaits — so the snapshot
            # and the queue wiring are atomic w.r.t. the host loop's commits:
            # every token is either in the snapshot or will arrive queued.
            snapshot = list(req.output_tokens)
            if offset < 0 or offset > len(snapshot):
                return await self._protocol_error(
                    writer, "bad resume offset", state)
            # reserve the stream before the first await so a concurrent
            # resume on the same uid hits the busy guard, not the queue
            self._pumping.add(uid)
            try:
                if uid not in self.aeng._streams:
                    self.aeng.adopt_stream(uid)
                else:
                    # a queue adopted at recovery already holds events the
                    # snapshot also covers — drop those, keep the rest in
                    # order (no consumer is attached: the busy guard above
                    # rejected the case where one is)
                    q = self.aeng._streams[uid]
                    keep = []
                    while not q.empty():
                        out = q.get_nowait()
                        if out.finished or out.index >= len(snapshot):
                            keep.append(out)
                    for out in keep:
                        q.put_nowait(out)
                writer.write(json.dumps(
                    {"uid": uid, "resumed": True,
                     "backlog": len(snapshot) - offset}).encode() + b"\n")
                for i in range(offset, len(snapshot)):
                    writer.write((json.dumps(
                        {"uid": uid, "token": snapshot[i], "index": i,
                         "finished": False, "finish_reason": None}) + "\n"
                    ).encode())
                await writer.drain()
                return await self._stream_to_client(uid, reader, writer,
                                                    state)
            finally:
                self._pumping.discard(uid)
        # Not live: resume from durable state.  Prefer the journal's folded
        # state — the writer applies every record as it goes out, so it
        # knows about requests that finished after the relaunch, which the
        # replay-time recovery snapshot cannot.
        if eng.journal is not None and uid in eng.journal.state.reqs:
            e = eng.journal.state.reqs[uid]
            backlog = list(e["toks"])
            reason = e["reason"] if e["done"] else None
        elif rec is not None and uid in rec.committed:
            backlog = rec.committed[uid]
            reason = rec.finished.get(uid)
        else:
            return await self._protocol_error(
                writer, "unknown resume uid", state)
        if reason is None:
            # journaled as live but no longer in the engine and not in
            # finished — the replay was skipped or the request was reaped
            # without a terminal record; nothing durable left to stream
            return await self._protocol_error(
                writer, "resume uid not recovered", state)
        if offset < 0 or offset > len(backlog):
            return await self._protocol_error(
                writer, "bad resume offset", state)
        writer.write(json.dumps(
            {"uid": uid, "resumed": True,
             "backlog": len(backlog) - offset}).encode() + b"\n")
        # finished request: replay the missing suffix.  STOP/LENGTH carry the
        # finished flag on the final real token (like the live stream did);
        # the externally-ended reasons get a terminal marker event.
        on_token = reason in ("stop", "length")
        for i in range(offset, len(backlog)):
            last = on_token and i == len(backlog) - 1
            writer.write((json.dumps(
                {"uid": uid, "token": backlog[i], "index": i,
                 "finished": last,
                 "finish_reason": reason if last else None}) + "\n"
            ).encode())
        if not on_token or offset == len(backlog):
            writer.write((json.dumps(
                {"uid": uid, "token": -1, "index": len(backlog),
                 "finished": True, "finish_reason": reason}) + "\n"
            ).encode())
        await writer.drain()
        return True


class ServeClient:
    """Minimal client for the JSON-lines endpoint (the load generator's and
    the CI smoke test's request path — and the reference for third-party
    clients)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.host, self.port = host, port
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None

    async def connect(self) -> "ServeClient":
        self._reader, self._writer = await asyncio.open_connection(
            self.host, self.port)
        return self

    async def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            try:
                await self._writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError):
                pass
            self._writer = None

    async def __aenter__(self) -> "ServeClient":
        return await self.connect()

    async def __aexit__(self, exc_type, exc, tb) -> None:
        await self.close()

    async def _send(self, obj: Dict) -> None:
        self._writer.write(json.dumps(obj).encode() + b"\n")
        await self._writer.drain()

    async def send_raw(self, data: bytes) -> None:
        """Write raw bytes on the wire — the chaos harness's malformed /
        oversized line injector (a well-behaved client has no use for it)."""
        self._writer.write(data)
        await self._writer.drain()

    async def _recv(self) -> Dict:
        line = await self._reader.readline()
        if not line:
            raise ConnectionError("server closed the connection")
        return json.loads(line)

    async def stats(self, format: Optional[str] = None) -> Dict:
        """Fetch a live metrics snapshot (``{"type": "stats"}`` message).
        ``format="prometheus"`` asks for the text exposition instead; the
        returned dict then carries it under ``"text"``."""
        msg: Dict = {"type": "stats"}
        if format is not None:
            msg["format"] = format
        await self._send(msg)
        return await self._recv()

    async def resume(self, uid: int, offset: int = 0,
                     on_event=None) -> List[Dict]:
        """Reattach to a request after a server crash+recovery: replays the
        journal-committed tokens from ``offset`` (how many token events this
        client already has) and streams to completion.  Returns every event
        line (ack excluded) — concatenated after the client's first ``offset``
        events this is the exactly-once full stream.  A typed error line
        (unknown uid / bad offset) is returned as a single-element list."""
        await self._send({"resume": int(uid), "offset": int(offset)})
        ack = await self._recv()
        if "error" in ack:
            return [ack]
        events: List[Dict] = []
        while True:
            out = await self._recv()
            events.append(out)
            if on_event is not None:
                on_event(out)
            if out.get("finished"):
                return events

    async def request(self, prompt: Sequence[int],
                      deadline_ms: Optional[float] = None,
                      cancel_after: Optional[int] = None,
                      on_event=None,
                      **params) -> List[Dict]:
        """Submit one request and consume its stream to the end.  Returns
        every event line (the ack excluded); the last has ``finished: true``.
        ``params`` are protocol fields (max_tokens / temperature / ...);
        ``cancel_after=k`` sends an explicit cancel once ``k`` tokens have
        streamed (exercises mid-flight cancellation); ``on_event`` is called
        with each event dict as it arrives (per-token streaming)."""
        msg = {"prompt": list(map(int, prompt)), **params}
        if deadline_ms is not None:
            msg["deadline_ms"] = deadline_ms
        await self._send(msg)
        ack = await self._recv()
        if ack.get("finished"):
            if on_event is not None:
                on_event(ack)
            return [ack]                        # rejected (backpressure)
        uid = ack["uid"]
        events: List[Dict] = []
        seen = 0
        while True:
            out = await self._recv()
            events.append(out)
            if on_event is not None:
                on_event(out)
            if out.get("finished"):
                return events
            seen += 1
            if cancel_after is not None and seen >= cancel_after:
                await self._send({"cancel": uid})
                cancel_after = None              # send it once
