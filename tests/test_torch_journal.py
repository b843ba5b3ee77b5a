"""The port's request journal and recovery (``repro_torch.serving.journal``
/ ``recovery``), held to the contract of tests/test_journal.py, whose cases
are repeated here.  Across packages: a journal the port writes under a
``FakeClock`` loads through the JAX ``load_state`` to the same state, and
the other way round; a replay through the port's engine resumes with the
committed tokens forced as prefix."""
import json
import zlib

import pytest

from repro_torch.serving.api import (FinishReason, GenerationRequest,
                                     SamplingParams)
from repro_torch.serving.journal import (Journal, JournalCorruption, TornTail,
                                         encode_record, load_state, read_records,
                                         segment_paths)


def scripted_journal(d, n_reqs=3, toks_per=4, finish=(0,), **kw):
    """Write a deterministic little workload: n_reqs submits, admits,
    token batches, and terminal records for the uids in `finish`."""
    j = Journal(d, **kw)
    for u in range(n_reqs):
        req = GenerationRequest(uid=u, prompt=[10 + u, 11 + u, 12 + u],
                                params=SamplingParams(max_tokens=8))
        j.log_submit(req)
        j.log_admit(u)
    for i in range(toks_per):
        j.log_tokens({u: [100 * u + i] for u in range(n_reqs)})
        j.commit()
    for u in finish:
        j.log_terminal(u, FinishReason.LENGTH, toks_per)
    j.commit()
    return j


class TestFraming:
    def test_roundtrip(self, tmp_path):
        j = scripted_journal(tmp_path)
        j.close()
        records, torn = read_records(tmp_path)
        assert torn is None
        assert records == [r for r in records]  # parsed, in order
        st = load_state(tmp_path)
        assert sorted(st.reqs) == [0, 1, 2]
        assert st.committed_tokens(1) == [100, 101, 102, 103]
        assert st.reqs[0]["done"] and st.reqs[0]["reason"] == "length"
        assert not st.reqs[1]["done"]

    def test_record_is_one_ascii_line(self):
        data = encode_record({"t": "tokens", "k": {"3": [1, 2]}})
        assert data.endswith(b"\n") and data.count(b"\n") == 1
        crc, body = data[:-1].split(b" ", 1)
        assert int(crc, 16) == zlib.crc32(body) & 0xFFFFFFFF
        json.loads(body)

    def test_writer_never_appends_to_existing_segment(self, tmp_path):
        scripted_journal(tmp_path).close()
        first = {p.name: p.read_bytes() for p in segment_paths(tmp_path)}
        j2 = Journal(tmp_path)
        j2.log_shutdown()
        j2.close()
        # the original segment is byte-identical; the new writer's records
        # went to a strictly newer file
        for p in segment_paths(tmp_path):
            if p.name in first:
                assert p.read_bytes() == first[p.name]
        assert len(segment_paths(tmp_path)) > len(first)


class TestTornTail:
    """SIGKILL mid-write can only damage the final line of the final
    segment.  Property: truncating the journal at EVERY byte offset
    yields either a previous consistent state (a record-prefix of the
    full journal) or a cleanly detected torn record — never corruption,
    never an invented record."""

    def test_truncation_sweep_every_offset(self, tmp_path):
        j = scripted_journal(tmp_path, n_reqs=2, toks_per=3)
        j.close()
        segs = segment_paths(tmp_path)
        assert len(segs) == 1
        data = segs[0].read_bytes()
        full_records, _ = read_records(tmp_path)
        # state after each record-prefix, as serialized fingerprints
        def fingerprint(recs):
            from repro_torch.serving.journal import JournalState
            st = JournalState()
            for r in recs:
                st.apply(r)
            return json.dumps(st.reqs, sort_keys=True, default=str)
        prefixes = {fingerprint(full_records[:k])
                    for k in range(len(full_records) + 1)}

        for cut in range(len(data) + 1):
            segs[0].write_bytes(data[:cut])
            records, torn = read_records(tmp_path)
            # never more records than the full journal, always a prefix
            assert records == full_records[:len(records)]
            st = load_state(tmp_path)
            assert fingerprint(records) in prefixes
            # torn is reported iff the cut leaves a partial record: cuts
            # at a record boundary, or that tear only a complete record's
            # trailing newline, read clean — anything else is TornTail
            clean_cut = (cut == 0 or data[:cut].endswith(b"\n")
                         or data[cut:cut + 1] == b"\n")
            if clean_cut:
                assert torn is None, (cut, torn)
                assert st.torn is None
            else:
                assert isinstance(torn, TornTail), cut
                assert torn.path == str(segs[0])
        segs[0].write_bytes(data)  # restore

    def test_damage_before_tail_raises(self, tmp_path):
        j = scripted_journal(tmp_path)
        j.close()
        seg = segment_paths(tmp_path)[0]
        data = bytearray(seg.read_bytes())
        # flip a byte inside the FIRST record's payload
        first_nl = data.index(b"\n")
        data[first_nl - 2] ^= 0xFF
        seg.write_bytes(bytes(data))
        with pytest.raises(JournalCorruption):
            read_records(tmp_path)

    def test_reopen_after_torn_tail_repairs_the_segment(self, tmp_path):
        """The double-crash sequence the journal exists for: a crash
        leaves a torn tail, the relaunch writer opens a newer segment on
        top (so the damage would no longer be in the *final* segment),
        then a second relaunch reads the directory again.  The reopen
        must truncate the torn record away, or that second read reports
        JournalCorruption and the journal is permanently unreadable."""
        j = scripted_journal(tmp_path, n_reqs=2, toks_per=3)
        j.close()
        seg = segment_paths(tmp_path)[0]
        data = seg.read_bytes()
        seg.write_bytes(data[:-3])              # SIGKILL mid-record
        st = load_state(tmp_path)
        assert st.torn is not None              # tolerated while final
        j2 = Journal(tmp_path)                  # relaunch writer
        assert j2.state.torn is not None        # reported to recovery...
        _, torn = read_records(tmp_path)
        assert torn is None                     # ...but repaired on disk
        assert seg.read_bytes() == data[:j2.state.torn.offset]
        j2.log_submit(GenerationRequest(uid=50, prompt=[1],
                                        params=SamplingParams()))
        j2.close()
        st2 = load_state(tmp_path)              # second relaunch reads clean
        assert st2.torn is None
        assert 50 in st2.reqs
        # the repaired journal replays to the same pre-torn record prefix
        for u in (0, 1):
            assert st2.committed_tokens(u) == st.committed_tokens(u)
        Journal(tmp_path).close()               # a third writer still opens

    def test_torn_tail_in_earlier_segment_raises(self, tmp_path):
        # two segments; truncate the FIRST mid-record — that damage is not
        # explainable by a crashed writer (writers open fresh segments), so
        # it must raise, not be skipped
        j = scripted_journal(tmp_path)
        j.close()
        j2 = Journal(tmp_path)
        j2.log_shutdown()
        j2.close()
        segs = segment_paths(tmp_path)
        assert len(segs) >= 2
        data = segs[0].read_bytes()
        segs[0].write_bytes(data[:len(data) - 3])
        with pytest.raises(JournalCorruption):
            read_records(tmp_path)


class TestReplayIdempotence:
    def test_reload_is_stable(self, tmp_path):
        j = scripted_journal(tmp_path, n_reqs=3, toks_per=5, finish=(0, 2))
        j.close()
        a, b = load_state(tmp_path), load_state(tmp_path)
        assert json.dumps(a.reqs, sort_keys=True) == \
            json.dumps(b.reqs, sort_keys=True)
        assert a.records == b.records and a.finished == b.finished

    def test_terminal_records_are_monotone(self, tmp_path):
        """tokens after a terminal record must not resurrect the request
        (replay after recovery can interleave old records with new)."""
        j = Journal(tmp_path)
        req = GenerationRequest(uid=7, prompt=[1], params=SamplingParams())
        j.log_submit(req)
        j.log_tokens({7: [5, 6]})
        j.log_terminal(7, FinishReason.STOP, 2)
        j.log_tokens({7: [9]})        # late batch after the terminal
        j.log_terminal(7, FinishReason.CANCELLED, 3)   # duplicate terminal
        j.commit()
        j.close()
        st = load_state(tmp_path)
        e = st.reqs[7]
        assert e["toks"] == [5, 6] and e["reason"] == "stop"
        assert st.finished == 1

    def test_submit_is_first_wins(self, tmp_path):
        j = Journal(tmp_path)
        j.log_submit(GenerationRequest(uid=1, prompt=[1, 2],
                                       params=SamplingParams()))
        j.log_submit(GenerationRequest(uid=1, prompt=[9, 9, 9],
                                       params=SamplingParams()))
        j.close()
        assert load_state(tmp_path).reqs[1]["prompt"] == [1, 2]


class TestRotationCompaction:
    def test_rotation_opens_new_segments(self, tmp_path):
        j = Journal(tmp_path, segment_bytes=128,
                    compact_min_finished=10 ** 9)   # rotate, never compact
        for u in range(8):
            j.log_submit(GenerationRequest(uid=u, prompt=[u] * 4,
                                           params=SamplingParams()))
        j.close()
        assert len(segment_paths(tmp_path)) > 1
        st = load_state(tmp_path)
        assert sorted(st.reqs) == list(range(8))

    def test_compaction_preserves_live_set_and_deletes_sealed(self, tmp_path):
        j = Journal(tmp_path, segment_bytes=256, compact_min_finished=1)
        for u in range(12):
            j.log_submit(GenerationRequest(uid=u, prompt=[u] * 4,
                                           params=SamplingParams()))
            j.log_tokens({u: [u, u + 1]})
            if u % 2 == 0:
                j.log_terminal(u, FinishReason.LENGTH, 2)
            j.commit()
        before = {u: e for u, e in j.state.reqs.items() if not e["done"]}
        assert j.compactions >= 1
        j.close()
        st = load_state(tmp_path)
        live_after = {e["uid"]: e for e in st.live()}
        assert sorted(live_after) == sorted(before)
        for u, e in before.items():
            assert live_after[u]["toks"] == e["toks"]
            assert live_after[u]["prompt"] == e["prompt"]

    def test_clean_shutdown_marker(self, tmp_path):
        j = scripted_journal(tmp_path, finish=(0, 1, 2))
        j.log_shutdown()
        j.close()
        assert load_state(tmp_path).clean_shutdown
        # any record after the marker voids it
        j2 = Journal(tmp_path)
        j2.log_submit(GenerationRequest(uid=99, prompt=[1],
                                        params=SamplingParams()))
        j2.close()
        assert not load_state(tmp_path).clean_shutdown

    def test_deadline_rebased_to_wall_clock(self, tmp_path):
        import time
        j = Journal(tmp_path)
        req = GenerationRequest(uid=0, prompt=[1], params=SamplingParams(),
                                deadline=time.perf_counter() + 5.0)
        j.log_submit(req)
        j.close()
        dl = load_state(tmp_path).reqs[0]["deadline_wall"]
        assert dl is not None
        remaining = dl - time.time()
        assert 3.0 < remaining <= 5.5


class TestReconcile:
    def test_reconcile_raises_on_unaccounted_uid(self):
        """reconcile promises 'raises ValueError on any accounting hole':
        a resumed uid the engine has never heard of must raise, not slip
        out in the summary dict callers ignore (stub engine — reconcile
        only touches stats()/_requests/_submit_ts/sched._arrival)."""
        from repro_torch.serving.recovery import RecoveryReport, reconcile

        class _Eng:
            _requests = {}
            _submit_ts = {}
            sched = type("S", (), {"_arrival": {}})()

            def stats(self):
                return type("St", (), {"requests_submitted": 5})()

        rep = RecoveryReport(resumed=[7], finished={}, committed={7: [1]},
                             forced_tokens=1, replay_ms=0.0,
                             torn_tail=False, clean_shutdown=False)
        with pytest.raises(ValueError, match="never heard of"):
            reconcile(rep, _Eng())
        # a uid the engine did accept (and may since have reaped) is fine
        eng = _Eng()
        eng._submit_ts = {7: 0.0}
        summary = reconcile(rep, eng)
        assert summary["unaccounted_uids"] == []


# ---------------------------------------------------------------------------
# across packages, and replay through the port's engine

SCFG = dict(max_batch=3, max_len=48, kv_block_size=4, prefill_chunk=4)


def _state_view(state):
    return (state.reqs, state.records, state.finished, state.recoveries,
            state.clean_shutdown, state.torn is None)


@pytest.fixture(scope="module")
def lm():
    import torch
    from repro_torch.models import build_model, get_config
    cfg = get_config("qwen1.5-0.5b").reduced(layers=2).replace(
        compute_dtype="float32", param_dtype="float32")
    return cfg, build_model(cfg, gen=torch.Generator().manual_seed(0),
                            device="cpu")


def _prompts(n):
    import numpy as np
    rng = np.random.default_rng(9)
    return [rng.integers(0, 64, int(rng.integers(5, 14))).tolist()
            for _ in range(n)]


class TestAgainstJaxJournal:
    def test_port_engine_journal_loads_in_jax(self, lm, tmp_path):
        """A journal the port's engine writes under a ``FakeClock`` (some
        requests finished, some cancelled, some still live) loads through
        the JAX ``load_state`` to the port's state."""
        from repro.serving.journal import load_state as jload_state
        from repro_torch.serving.engine import Engine, ServeConfig
        from repro_torch.serving.telemetry import FakeClock

        cfg, model = lm
        eng = Engine(cfg, model, ServeConfig(**SCFG, journal_dir=str(tmp_path)),
                     clock=FakeClock())
        reqs = [eng.submit(p, SamplingParams(max_tokens=6, ignore_eos=True))
                for p in _prompts(5)]
        for _ in range(9):
            eng.step()
        eng.cancel(reqs[-1].uid)
        eng.step()
        eng.journal.close()
        mine = load_state(tmp_path)
        assert any(e["done"] for e in mine.reqs.values())
        assert any(not e["done"] for e in mine.reqs.values())
        assert _state_view(jload_state(tmp_path)) == _state_view(mine)

    def test_jax_journal_loads_in_the_port(self, tmp_path):
        """The other way: the JAX writer's segments (same records) are the
        port's bytes, and load to the same state."""
        from repro.serving.api import FinishReason as JFinishReason
        from repro.serving.api import GenerationRequest as JRequest
        from repro.serving.api import SamplingParams as JSamplingParams
        from repro.serving.journal import Journal as JJournal
        from repro.serving.journal import load_state as jload_state

        for d, (J, R, SP, FR) in (
                ("jax", (JJournal, JRequest, JSamplingParams, JFinishReason)),
                ("port", (Journal, GenerationRequest, SamplingParams,
                          FinishReason))):
            j = J(tmp_path / d)
            for u in range(3):
                j.log_submit(R(uid=u, prompt=[5, 6, u],
                               params=SP(max_tokens=4, temperature=0.5,
                                         seed=u, ignore_eos=True)))
                j.log_admit(u)
            j.log_tokens({0: [1, 2], 2: [9]})
            j.commit()
            j.log_terminal(0, FR.LENGTH, 2)
            j.log_terminal(1, FR.CANCELLED, 0)
            j.commit()
            j.close()
        jseg = [p.read_bytes() for p in segment_paths(tmp_path / "jax")]
        pseg = [p.read_bytes() for p in segment_paths(tmp_path / "port")]
        assert jseg == pseg
        assert _state_view(load_state(tmp_path / "jax")) == \
            _state_view(jload_state(tmp_path / "jax"))

    def test_replay_resumes_with_committed_tokens_forced(self, lm, tmp_path):
        """Kill the process's engine mid-run (journal left without its
        clean-shutdown record), replay into a cold engine on the same
        directory: every unfinished request resumes with its committed
        tokens as prefix and ends with the uninterrupted run's tokens."""
        from repro_torch.serving.engine import Engine, ServeConfig
        from repro_torch.serving.recovery import replay_journal

        cfg, model = lm
        prompts = _prompts(4)
        sp = SamplingParams(max_tokens=7, ignore_eos=True)
        base = Engine(cfg, model, ServeConfig(**SCFG))
        want = [base.submit(p, sp) for p in prompts]
        for _ in base.stream():
            pass
        scfg = ServeConfig(**SCFG, journal_dir=str(tmp_path))
        eng = Engine(cfg, model, scfg)
        for p in prompts:
            eng.submit(p, sp)
        for _ in range(8):
            eng.step()
        eng.journal.close()                      # the crash: no shutdown
        committed = load_state(tmp_path)
        assert not committed.clean_shutdown
        cold = Engine(cfg, model, scfg)
        report = replay_journal(cold)
        assert report.resumed and report.forced_tokens > 0
        live = {uid: list(cold._requests[uid].output_tokens)
                for uid in report.resumed}
        for uid, toks in live.items():
            assert toks == committed.committed_tokens(uid)
        for _ in cold.stream():
            pass
        final = load_state(tmp_path)
        for r in want:
            assert final.reqs[r.uid]["toks"] == list(r.output_tokens)
            assert final.reqs[r.uid]["done"]
