"""Request journal: an append-only, fsync'd, checksummed write-ahead log.

Durability layer for the serving engine (the supervisor makes it survive
*in-process* faults; this makes accepted work survive the **process**
dying).  Every externally visible request transition is appended as one
checksummed record *before* the effect is observable to a client:

* ``submit``  — written (and fsync'd) before ``submit`` returns, so an
  acked uid is durable.  Carries prompt, sampling params, and the
  deadline converted to wall-clock (``time.time``) so it survives the
  process-local monotonic clock.
* ``admit``   — advisory (reconstructible), rides the next commit fsync.
* ``tokens``  — one record per committed engine step batching every
  ``{uid: [token, ...]}`` the step produced; journaled *before* the
  per-request callbacks fire, so the journal is always a superset of
  what any client saw (the resume protocol's exactly-once invariant).
* ``finish`` / ``cancel`` / ``shed`` — terminal records (stop/length/
  deadline/error finishes, external cancels, load sheds + admission
  rejections respectively).
* ``snap``    — compaction snapshot: "reset this uid to exactly this
  state"; replays idempotently even when pre-compaction segments
  survive alongside it.
* ``recover`` / ``shutdown`` — markers: a recovery replayed N requests;
  the process drained and closed cleanly.

Framing is line-oriented and torn-tail tolerant: each record is
``"%08x %s\n" % (crc32(payload), payload)`` with an ASCII compact-JSON
payload, so a record never contains a newline and a SIGKILL mid-write
can only damage the final line of the final segment.  The reader
accepts a journal whose tail fails crc/parse (the torn record is
reported, every record before it applies); a damaged record anywhere
*else* raises :class:`JournalCorruption` — never a silent skip.

Segments rotate at ``segment_bytes``; rotation triggers compaction once
enough requests have finished since the last one: live requests are
snapshotted into the fresh segment and the sealed segments are deleted
(file + directory fsyncs ordered so a crash at any point leaves either
the old segments, both, or the snapshot — all of which replay to the
same live set).  A writer always opens a *new* segment, never appends
to an existing file; a torn tail left by a crashed predecessor is
truncated away (file + dir fsync) *before* the new segment opens, so
the damage is never buried in a non-final segment where a later read
would report it as corruption.

``load_state`` folds a journal directory into a :class:`JournalState`;
``serving/recovery.py`` replays that state into a cold engine.

Port of ``repro/serving/journal.py``, copied with the package renamed: the
two packages read each other's journals.
"""
from __future__ import annotations

import json
import os
import pathlib
import time
import zlib
from typing import Dict, Iterable, List, Optional, Tuple

from .api import FinishReason, GenerationRequest, SamplingParams

__all__ = [
    "Journal", "JournalState", "JournalCorruption", "TornTail",
    "load_state", "read_records", "segment_paths",
]

SEGMENT_PREFIX = "journal-"
SEGMENT_SUFFIX = ".wal"


class JournalCorruption(Exception):
    """A record *before* the journal tail failed its checksum or parse —
    data loss that torn-tail tolerance cannot explain away."""


class TornTail:
    """Where and why the final record of the final segment was rejected."""

    def __init__(self, path: str, offset: int, why: str):
        self.path, self.offset, self.why = path, offset, why

    def __repr__(self) -> str:
        return f"TornTail({self.path!r}, offset={self.offset}, {self.why!r})"


# ---------------------------------------------------------------------------
# record framing


def encode_record(rec: dict) -> bytes:
    payload = json.dumps(rec, separators=(",", ":"), sort_keys=True)
    body = payload.encode("ascii")
    return b"%08x %s\n" % (zlib.crc32(body) & 0xFFFFFFFF, body)


def decode_line(line: bytes) -> dict:
    """Parse one framed line (sans trailing newline).  Raises ValueError on
    any damage — the caller decides whether that means torn tail or
    corruption."""
    if len(line) < 10 or line[8:9] != b" ":
        raise ValueError("short or unframed record")
    try:
        crc = int(line[:8], 16)
    except ValueError:
        raise ValueError("bad checksum field")
    body = line[9:]
    if zlib.crc32(body) & 0xFFFFFFFF != crc:
        raise ValueError("checksum mismatch")
    rec = json.loads(body)
    if not isinstance(rec, dict) or "t" not in rec:
        raise ValueError("payload is not a record object")
    return rec


def segment_paths(journal_dir) -> List[pathlib.Path]:
    d = pathlib.Path(journal_dir)
    if not d.is_dir():
        return []
    segs = [p for p in d.iterdir()
            if p.name.startswith(SEGMENT_PREFIX)
            and p.name.endswith(SEGMENT_SUFFIX)]
    return sorted(segs, key=lambda p: p.name)


def _segment_seq(path: pathlib.Path) -> int:
    return int(path.name[len(SEGMENT_PREFIX):-len(SEGMENT_SUFFIX)])


def read_records(journal_dir) -> Tuple[List[dict], Optional[TornTail]]:
    """Read every record in segment order.  A damaged final line of the
    final segment is tolerated and reported as :class:`TornTail`; damage
    anywhere else raises :class:`JournalCorruption`."""
    records: List[dict] = []
    torn: Optional[TornTail] = None
    segs = segment_paths(journal_dir)
    for si, seg in enumerate(segs):
        data = seg.read_bytes()
        offset = 0
        while offset < len(data):
            nl = data.find(b"\n", offset)
            last_chunk = nl < 0 or nl == len(data) - 1
            line = data[offset:] if nl < 0 else data[offset:nl]
            try:
                rec = decode_line(line)
            except ValueError as e:
                final_seg = si == len(segs) - 1
                if final_seg and last_chunk:
                    torn = TornTail(str(seg), offset, str(e))
                    break
                raise JournalCorruption(
                    f"{seg}: damaged record at byte {offset} before the "
                    f"journal tail ({e})") from e
            records.append(rec)
            if nl < 0:
                break                  # valid record, only the newline torn
            offset = nl + 1
    return records, torn


# ---------------------------------------------------------------------------
# replay state


class JournalState:
    """The journal folded into per-request state, in submit order.

    Replay is idempotent by construction: ``submit`` is first-wins,
    ``admit``/terminal records are monotone flags, ``snap`` overwrites,
    and ``tokens`` appends — the only non-idempotent record — is applied
    exactly once because each committed step journals its batch exactly
    once (re-reading the same directory always yields the same state).
    """

    def __init__(self):
        self.reqs: Dict[int, dict] = {}        # uid -> entry, insertion order
        self.records = 0
        self.finished = 0
        self.recoveries = 0
        self.clean_shutdown = False
        self.torn: Optional[TornTail] = None

    def _entry(self, uid: int) -> dict:
        e = self.reqs.get(uid)
        if e is None:
            e = {"uid": uid, "prompt": [], "params": {}, "deadline_wall": None,
                 "toks": [], "admitted": False, "done": False, "reason": None,
                 "n_final": None}
            self.reqs[uid] = e
        return e

    def apply(self, rec: dict) -> None:
        self.records += 1
        t = rec["t"]
        if t != "shutdown":
            self.clean_shutdown = False
        if t == "submit":
            if rec["u"] not in self.reqs:
                e = self._entry(rec["u"])
                e["prompt"] = list(rec["p"])
                e["params"] = dict(rec.get("sp", {}))
                e["deadline_wall"] = rec.get("dl")
        elif t == "snap":
            e = self._entry(rec["u"])
            e.update(prompt=list(rec["p"]), params=dict(rec.get("sp", {})),
                     deadline_wall=rec.get("dl"), toks=list(rec.get("k", [])),
                     admitted=False, done=False, reason=None, n_final=None)
        elif t == "admit":
            self._entry(rec["u"])["admitted"] = True
        elif t == "tokens":
            for uid, toks in rec["k"].items():
                e = self._entry(int(uid))
                if not e["done"]:
                    e["toks"].extend(toks)
        elif t in ("finish", "cancel", "shed"):
            e = self._entry(rec["u"])
            if not e["done"]:
                e["done"] = True
                e["reason"] = rec.get("r")
                e["n_final"] = rec.get("n")
                self.finished += 1
        elif t == "recover":
            self.recoveries += 1
        elif t == "shutdown":
            self.clean_shutdown = True
        # unknown record types are skipped (forward compatibility): their
        # checksum already proved they are intact, not damage

    def live(self) -> List[dict]:
        """Unfinished requests in original submit order — the recovery
        resubmission order (the scheduler admits FIFO by arrival)."""
        return [e for e in self.reqs.values() if not e["done"]]

    def max_uid(self) -> int:
        return max(self.reqs, default=-1)

    def committed_tokens(self, uid: int) -> List[int]:
        e = self.reqs.get(uid)
        return [] if e is None else list(e["toks"])


def load_state(journal_dir) -> JournalState:
    records, torn = read_records(journal_dir)
    state = JournalState()
    for rec in records:
        state.apply(rec)
    state.torn = torn
    return state


# ---------------------------------------------------------------------------
# writer


def _fsync_dir(path: pathlib.Path) -> None:
    fd = os.open(str(path), os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class Journal:
    """Append-only writer over a journal directory.

    Opens a fresh segment (never appends to an existing file) numbered
    after every segment already present, and folds the existing segments
    into :attr:`state` so compaction knows the full live set even right
    after a crash-recovery reopen.  ``append*`` buffers; :meth:`commit`
    writes the batch, flushes, and fsyncs once — the engine calls it
    once per committed step and once per accepted submit.
    """

    def __init__(self, journal_dir, segment_bytes: int = 1 << 20,
                 fsync: bool = True, compact_min_finished: int = 32):
        if segment_bytes < 1:
            raise ValueError(f"segment_bytes={segment_bytes} must be >= 1")
        self.dir = pathlib.Path(journal_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.segment_bytes = segment_bytes
        self.fsync = fsync
        self.compact_min_finished = compact_min_finished
        self.state = load_state(self.dir)
        if self.state.torn is not None:
            self._repair_torn_tail(self.state.torn)
        self._finished_at_compact = self.state.finished
        self.appended = 0                      # records written by *this* writer
        self.commits = 0                       # fsync batches
        self.compactions = 0
        self._pending: List[dict] = []
        self._file = None
        self._bytes = 0
        self._seq = max((_segment_seq(p) for p in segment_paths(self.dir)),
                        default=0)
        self._open_segment()

    # -- low-level -----------------------------------------------------------

    def _repair_torn_tail(self, torn: TornTail) -> None:
        """Truncate the crashed predecessor's damaged final record.

        ``read_records`` tolerates damage only in the *final* segment; this
        writer is about to open a newer one, which would bury the torn line
        mid-journal and turn every later read into
        :class:`JournalCorruption`.  Every byte before ``torn.offset``
        already replayed into :attr:`state`, so cutting there loses nothing
        durable — the torn record never finished its fsync."""
        fd = os.open(torn.path, os.O_RDWR)
        try:
            os.ftruncate(fd, torn.offset)
            if self.fsync:
                os.fsync(fd)
        finally:
            os.close(fd)
        if self.fsync:
            _fsync_dir(self.dir)

    def _open_segment(self) -> None:
        self._seq += 1
        path = self.dir / f"{SEGMENT_PREFIX}{self._seq:08d}{SEGMENT_SUFFIX}"
        self._file = open(path, "xb")
        self._bytes = 0
        if self.fsync:
            _fsync_dir(self.dir)       # the new name itself must be durable

    def append(self, rec: dict) -> None:
        self._pending.append(rec)

    def commit(self) -> None:
        """Write the buffered batch, flush, fsync, then rotate/compact at
        the (record-aligned) segment boundary."""
        if not self._pending or self._file is None:
            return
        batch = self._pending
        self._pending = []
        for rec in batch:
            data = encode_record(rec)
            self._file.write(data)
            self._bytes += len(data)
            self.state.apply(rec)
            self.appended += 1
        self._file.flush()
        if self.fsync:
            os.fsync(self._file.fileno())
        self.commits += 1
        if self._bytes >= self.segment_bytes:
            self._rotate()

    def _rotate(self) -> None:
        sealed = segment_paths(self.dir)
        self._file.close()
        if (self.state.finished - self._finished_at_compact
                >= self.compact_min_finished):
            self._compact(sealed)
        else:
            self._open_segment()

    def _compact(self, sealed: List[pathlib.Path]) -> None:
        """Snapshot the live set into a fresh segment, then delete the
        sealed ones.  ``snap`` semantics ("reset uid to exactly this")
        make the crash windows safe: old+snapshot replays to the same
        live state as snapshot alone."""
        self._open_segment()
        for e in self.state.live():
            self.append({"t": "snap", "u": e["uid"], "p": e["prompt"],
                         "sp": e["params"], "dl": e["deadline_wall"],
                         "k": e["toks"]})
        if not self._pending:
            # nothing live: the new segment stays empty, old ones still go
            self._file.flush()
        else:
            batch, self._pending = self._pending, []
            for rec in batch:
                data = encode_record(rec)
                self._file.write(data)
                self._bytes += len(data)
                self.appended += 1
            self._file.flush()
        if self.fsync:
            os.fsync(self._file.fileno())
        for p in sealed:
            p.unlink()
        if self.fsync:
            _fsync_dir(self.dir)
        self._finished_at_compact = self.state.finished
        self.compactions += 1

    def close(self) -> None:
        if self._file is None:
            return
        self.commit()
        self._file.close()
        self._file = None

    # -- record emitters ------------------------------------------------------

    def log_submit(self, req: GenerationRequest,
                   now_mono: Optional[float] = None) -> None:
        """Append + fsync a submit record (durable before the uid is acked).
        The deadline is re-based to wall-clock so a recovery in a fresh
        process (fresh monotonic epoch) can re-arm the remaining time."""
        dl = None
        if req.deadline is not None:
            base = now_mono if now_mono is not None else time.perf_counter()
            dl = time.time() + max(0.0, req.deadline - base)
        p = req.params
        self.append({"t": "submit", "u": req.uid, "p": list(req.prompt),
                     "sp": {"mt": p.max_tokens, "tp": p.temperature,
                            "pp": p.top_p, "sd": p.seed,
                            "ie": bool(p.ignore_eos)},
                     "dl": dl})
        self.commit()

    def log_admit(self, uid: int) -> None:
        self.append({"t": "admit", "u": uid})       # rides the next commit

    def log_tokens(self, batch: Dict[int, List[int]]) -> None:
        if batch:
            self.append({"t": "tokens",
                         "k": {str(u): t for u, t in batch.items()}})

    def log_terminal(self, uid: int, reason: Optional[FinishReason],
                     n: int) -> None:
        t = ("cancel" if reason == FinishReason.CANCELLED else
             "shed" if reason == FinishReason.ABORTED else "finish")
        self.append({"t": t, "u": uid,
                     "r": reason.name.lower() if reason is not None else None,
                     "n": n})

    def log_recover(self, resumed: int, forced_tokens: int) -> None:
        self.append({"t": "recover", "n": resumed, "k": forced_tokens})
        self.commit()

    def log_shutdown(self) -> None:
        """Clean-drain marker; the next reader knows nothing was in flight."""
        self.append({"t": "shutdown"})
        self.commit()


def params_from_journal(sp: dict) -> SamplingParams:
    return SamplingParams(max_tokens=int(sp.get("mt", 32)),
                          temperature=float(sp.get("tp", 0.0)),
                          top_p=float(sp.get("pp", 1.0)),
                          seed=sp.get("sd"),
                          ignore_eos=bool(sp.get("ie", False)))
