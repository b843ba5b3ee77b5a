"""The port's checkpoints (``repro_torch/checkpoint``) against the JAX
package's (``repro/checkpoint/ckpt.py``).

Every case of ``tests/test_checkpoint.py`` on the port (round trip bitwise,
``LATEST`` and gc, shape mismatch, no ``.tmp`` left, a crash in the pointer
window, fsync order, async save and wait, snapshot semantics; the reshard
case becomes a load onto another device), then the two packages on one
format: a JAX-saved reduced qwen3-0.6b ``TrainState`` (zstd and plain)
loads into the port with equal leaves and equal logits, a port-saved state
loads with JAX's ``load_checkpoint``, the streamed payload's bytes are
``msgpack.packb``'s, bf16 leaves round-trip.  Last, the launcher on the
CPU: SIGTERM after its first step saves and exits 0, and the resumed run
ends bitwise equal to an uninterrupted one.  Every comparison is exact:
the format moves bytes.
"""
import io
import json
import os
import pathlib
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

import repro.checkpoint.ckpt as jckpt
from repro.core import quant as JQ
from repro.models import build_model as jbuild, get_config as jget
from repro.nn.module import flatten_with_paths as jflat
from repro.training import optimizer as JO, schedule as JSch, trainer as JTr
import repro_torch.checkpoint.ckpt as ckpt_mod
from repro_torch import bridge
from repro_torch.checkpoint import (CheckpointManager, load_checkpoint,
                                    save_checkpoint)
from repro_torch.checkpoint import _msgpack
from repro_torch.checkpoint.ckpt import latest_step
from repro_torch.core import quant as TQ
from repro_torch.models import get_config
from repro_torch.nn.module import count_params, flatten_with_paths, tree_bytes
from repro_torch.training import optimizer as TO, schedule as TSch, trainer as TTr

ROOT = pathlib.Path(__file__).resolve().parents[1]


def tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(8, 16, generator=g),
                       "b": torch.arange(4, dtype=torch.float32)},
            "step": torch.tensor(7, dtype=torch.int32)}


def _assert_trees_equal(a, b):
    fa, fb = flatten_with_paths(a), flatten_with_paths(b)
    assert list(fa) == list(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, k
        assert torch.equal(fa[k], fb[k]), k


class TestRoundtrip:
    def test_save_load_exact(self, tmp_path):
        t = tree()
        save_checkpoint(tmp_path, 10, t, extra={"loader": {"step": 3}})
        t2, extra, step = load_checkpoint(tmp_path, t)
        assert step == 10 and extra["loader"]["step"] == 3
        _assert_trees_equal(t, t2)

    def test_latest_pointer_and_gc(self, tmp_path):
        t = tree()
        for s in (1, 2, 3, 4):
            save_checkpoint(tmp_path, s, t, keep_last_k=2)
        assert latest_step(tmp_path) == 4
        dirs = sorted(p.name for p in pathlib.Path(tmp_path).iterdir()
                      if p.is_dir())
        assert dirs == ["step_00000003", "step_00000004"]

    def test_shape_mismatch_raises(self, tmp_path):
        save_checkpoint(tmp_path, 1, tree())
        bad = {"params": {"w": torch.zeros(9, 16), "b": torch.zeros(4)},
               "step": torch.tensor(0, dtype=torch.int32)}
        with pytest.raises(ValueError, match="params/w"):
            load_checkpoint(tmp_path, bad)
        with pytest.raises(KeyError, match="params/c"):
            load_checkpoint(tmp_path, {"params": {"c": torch.zeros(1)}})

    def test_atomic_no_tmp_left(self, tmp_path):
        save_checkpoint(tmp_path, 5, tree())
        assert not list(pathlib.Path(tmp_path).glob("*.tmp"))

    def test_crash_in_pointer_window_keeps_old_latest(self, tmp_path,
                                                      monkeypatch):
        """A crash between writing LATEST.tmp and the os.replace must leave
        the previous pointer intact and restorable."""
        t = tree()
        save_checkpoint(tmp_path, 1, t)
        real_replace = os.replace

        def dying_replace(src, dst):
            if str(dst).endswith("LATEST"):
                raise OSError("simulated crash in the pointer window")
            return real_replace(src, dst)

        monkeypatch.setattr(ckpt_mod.os, "replace", dying_replace)
        with pytest.raises(OSError):
            save_checkpoint(tmp_path, 2, tree(seed=1))
        monkeypatch.undo()
        assert latest_step(tmp_path) == 1
        t2, _, step = load_checkpoint(tmp_path, t)
        assert step == 1
        _assert_trees_equal(t, t2)

    def test_pointer_durability_ordering(self, tmp_path, monkeypatch):
        """The LATEST publish fsyncs the pointer's bytes before the rename
        and the parent directory after it."""
        events = []
        real_fsync, real_replace = os.fsync, os.replace
        fd_paths = {}
        real_open = os.open

        def spy_open(path, *a, **kw):
            fd = real_open(path, *a, **kw)
            fd_paths[fd] = str(path)
            return fd

        def spy_fsync(fd):
            events.append(("fsync", fd_paths.get(fd, "")))
            return real_fsync(fd)

        def spy_replace(src, dst):
            if str(dst).endswith("LATEST"):
                events.append(("replace", str(dst)))
            return real_replace(src, dst)

        monkeypatch.setattr(ckpt_mod.os, "open", spy_open)
        monkeypatch.setattr(ckpt_mod.os, "fsync", spy_fsync)
        monkeypatch.setattr(ckpt_mod.os, "replace", spy_replace)
        save_checkpoint(tmp_path, 3, tree())
        kinds = [k for k, _ in events]
        assert "replace" in kinds
        i = kinds.index("replace")
        assert "fsync" in kinds[:i]
        dir_syncs_after = [p for k, p in events[i + 1:]
                           if k == "fsync" and p == str(tmp_path)]
        assert dir_syncs_after


class TestAsync:
    def test_async_save_then_wait(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), save_every=10)
        assert mgr.should_save(10) and not mgr.should_save(11)
        mgr.save_async(10, tree())
        mgr.wait()
        assert latest_step(tmp_path) == 10

    def test_snapshot_semantics(self, tmp_path):
        """Mutating the live tree after save_async must not corrupt the
        save: a tensor updated in place, as the optimizer updates, and a
        numpy array (the JAX test's leaf)."""
        mgr = CheckpointManager(str(tmp_path))
        t = {"w": torch.ones(4), "a": np.ones((3,), np.float32)}
        mgr.save_async(1, t)
        t["w"].mul_(-1)  # mutate after snapshot
        t["a"][:] = -1
        mgr.wait()
        t2, _, _ = load_checkpoint(tmp_path, {"w": torch.zeros(4),
                                              "a": torch.zeros(3)})
        assert torch.equal(t2["w"], torch.ones(4))
        assert torch.equal(t2["a"], torch.ones(3))

    def test_writer_error_surfaces_on_wait(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path / "file"))
        (tmp_path / "file").write_text("not a directory")
        mgr.save_async(1, tree())
        with pytest.raises(OSError):
            mgr.wait()


class TestReshard:
    def test_restore_onto_another_device(self, tmp_path):
        """Leaves land on ``device``, else on the template's device (CPU for
        a shape-only ``meta`` template)."""
        t = tree()
        save_checkpoint(tmp_path, 3, t)
        meta = {"params": {k: v.to("meta") for k, v in t["params"].items()},
                "step": t["step"].to("meta")}
        t2, _, _ = load_checkpoint(tmp_path, meta)
        assert t2["params"]["w"].device.type == "cpu"
        _assert_trees_equal(t, t2)
        t3, _, _ = load_checkpoint(tmp_path, t, device="meta")
        assert t3["params"]["w"].device.type == "meta"
        assert t3["params"]["w"].shape == (8, 16)


# -- the tree helpers (repro/nn/module.py:59-84) ---------------------------------

def test_tree_helpers_match_jax_names_and_counts():
    nt = JO.Moment8(np.zeros((2, 3), np.int8), np.ones((2,), np.float32))
    jtree = {"b": [np.zeros(2), (np.ones(3, np.int32), nt)], "a": {"z": np.ones(4)},
             "c": None}
    ttree = {"b": [torch.zeros(2, dtype=torch.float64),
                   (torch.ones(3, dtype=torch.int32),
                    TO.Moment8(torch.zeros(2, 3, dtype=torch.int8), torch.ones(2)))],
             "a": {"z": torch.ones(4, dtype=torch.float64)}, "c": None}
    want = jflat(jtree)
    got = flatten_with_paths(ttree)
    assert list(got) == list(want) == ["a/z", "b/0", "b/1/0", "b/1/1/code",
                                       "b/1/1/scale"]
    from repro.nn.module import count_params as jcount, tree_bytes as jbytes
    assert count_params(ttree) == jcount(jtree) == 4 + 2 + 3 + 6 + 2
    assert tree_bytes(ttree) == jbytes(jtree)


# -- the two packages on one format ----------------------------------------------

def _jax_state(state_dtype):
    """A reduced qwen3-0.6b QAT TrainState with every leaf drawn from a seed
    (moments and int8 codes too) and both steps at 1."""
    cfg = jget("qwen3-0.6b").reduced().with_quant(JQ.QAT)
    model = jbuild(cfg)
    opt = JO.AdamW(JO.AdamWConfig(state_dtype=state_dtype))
    state = JTr.init_train_state(model.init(jax.random.PRNGKey(0)), opt)
    rng = np.random.default_rng(0)

    def draw(x):
        x = np.asarray(x)
        if x.ndim == 0:
            return jnp.asarray(np.ones((), x.dtype))
        if x.dtype == np.int8:
            return jnp.asarray(rng.integers(-127, 128, x.shape).astype(np.int8))
        return jnp.asarray(rng.standard_normal(x.shape).astype(x.dtype) * 0.05)

    return cfg, model, jax.tree_util.tree_map(draw, state)


def _port_state(state_dtype):
    cfg = get_config("qwen3-0.6b").reduced().with_quant(TQ.QAT)
    model = bridge.build_model(cfg, gen=torch.Generator().manual_seed(3),
                               device="cpu")
    opt = TO.AdamW(TO.AdamWConfig(state_dtype=state_dtype))
    return cfg, model, opt, TTr.init_train_state(model, opt)


@pytest.mark.parametrize("state_dtype,compressed", [("float32", True),
                                                    ("float32", False),
                                                    ("int8_blockwise", True)])
def test_jax_saved_train_state_loads_into_port(tmp_path, monkeypatch,
                                               state_dtype, compressed):
    jcfg, jmodel, jstate = _jax_state(state_dtype)
    if not compressed:   # the JAX writer as it runs without zstandard
        monkeypatch.setattr(jckpt, "zstandard", None)
    jckpt.save_checkpoint(str(tmp_path), 1, jstate, extra={"loader": {"step": 1}})
    name = "arrays.msgpack.zst" if compressed else "arrays.msgpack"
    assert (tmp_path / "step_00000001" / name).exists()
    monkeypatch.undo()

    cfg, model, _, state = _port_state(state_dtype)
    tmpl = bridge.train_state_to_jax(cfg, state, device="meta")
    assert len(flatten_with_paths(tmpl)) == (47 if state_dtype == "float32" else 75)
    loaded, extra, step = load_checkpoint(tmp_path, tmpl)
    bridge.load_train_state(cfg, loaded, state)
    assert (step, extra, state.step, state.opt_state.step) == \
        (1, {"loader": {"step": 1}}, 1, 1)
    want = jflat(jstate)
    got = flatten_with_paths(bridge.train_state_to_jax(cfg, state))
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    # the logits of the loaded student: bitwise the bridge's model of the
    # same params, and JAX's within the model parity tests' tolerance
    toks = np.random.default_rng(1).integers(0, 268, (2, 16)).astype(np.int32)
    ref = bridge.jax_params_to_torch(cfg, jax.tree_util.tree_map(np.asarray,
                                                                 jstate.params),
                                     device="cpu")
    with torch.no_grad():
        got_logits = model.apply(torch.from_numpy(toks))[0]
        assert torch.equal(got_logits, ref.apply(torch.from_numpy(toks))[0])
    want_logits = np.asarray(jmodel.apply(jstate.params, jnp.asarray(toks))[0])
    np.testing.assert_allclose(got_logits.numpy(), want_logits, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("state_dtype", ["float32", "int8_blockwise"])
def test_port_saved_train_state_loads_in_jax(tmp_path, state_dtype):
    cfg, model, opt, state = _port_state(state_dtype)
    step = TTr.make_train_step(model, opt, lambda s: TSch.constant(s, 1e-3))
    rng = np.random.default_rng(0)
    b = {"tokens": torch.from_numpy(rng.integers(0, 268, (2, 16)).astype(np.int32)),
         "labels": torch.from_numpy(rng.integers(0, 268, (2, 16)).astype(np.int32))}
    state, _ = step(state, b)
    mine = bridge.train_state_to_jax(cfg, state)
    save_checkpoint(tmp_path, 1, mine, extra={"loader": {"step": 1}})
    jcfg = jget("qwen3-0.6b").reduced().with_quant(JQ.QAT)
    opt_j = JO.AdamW(JO.AdamWConfig(state_dtype=state_dtype))
    tmpl = jax.eval_shape(lambda: JTr.init_train_state(
        jbuild(jcfg).init(jax.random.PRNGKey(0)), opt_j))
    jstate, extra, s = jckpt.load_checkpoint(str(tmp_path), tmpl)
    assert (s, extra, int(jstate.step), int(jstate.opt_state.step)) == \
        (1, {"loader": {"step": 1}}, 1, 1)
    got, want = jflat(jstate), flatten_with_paths(mine)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), want[k].numpy(), err_msg=k)


def test_train_state_map_refuses_other_trees():
    cfg, _, _, state = _port_state("float32")
    tree8 = bridge.train_state_to_jax(cfg, _port_state("int8_blockwise")[3])
    with pytest.raises(ValueError, match="Moment8"):
        bridge.load_train_state(cfg, tree8, state)
    t = bridge.train_state_to_jax(cfg, state)
    del t.params["final_norm"]
    with pytest.raises(KeyError, match="final_norm.scale"):
        bridge.load_train_state(cfg, t, state)


@pytest.mark.parametrize("sizes", [[3], [0, 1, 31, 32, 255, 256, 65535, 65536],
                                   list(range(20))])
def test_msgpack_bytes_equal_packb(sizes):
    rng = np.random.default_rng(len(sizes))
    payload = {("k" * (i * 41 % 300)) + f"/{i}":
               rng.integers(0, 256, n, dtype=np.uint8).tobytes()
               for i, n in enumerate(sizes)}
    buf = io.BytesIO()
    _msgpack.write_map(buf, list(payload.items()))
    want = msgpack.packb(payload)
    assert buf.getvalue() == want
    assert _msgpack.packed_size([(k, len(v)) for k, v in payload.items()]) == len(want)
    got = _msgpack.read_map(want)
    assert {k: bytes(v) for k, v in got.items()} == msgpack.unpackb(want)
    two = io.BytesIO()
    _msgpack.write_map(two, [("a/b", b"\0" * 3), ("c", b"")])
    assert two.getvalue().startswith(bytes.fromhex("82a3612f62c403"))
    with pytest.raises(ValueError, match="not a map"):
        _msgpack.read_map(msgpack.packb([1, 2]))


def test_plain_payload_file_is_packb_of_the_leaves(tmp_path, monkeypatch):
    monkeypatch.setattr(ckpt_mod, "zstandard", None)
    t = tree()
    save_checkpoint(tmp_path, 1, t)
    raw = (tmp_path / "step_00000001" / "arrays.msgpack").read_bytes()
    flat = flatten_with_paths(t)
    assert raw == msgpack.packb({k: v.numpy().tobytes() for k, v in flat.items()})
    manifest = json.loads((tmp_path / "step_00000001" / "manifest.json").read_text())
    assert manifest["leaves"]["step"] == {"shape": [], "dtype": "int32"}
    # a zstd checkpoint without zstandard raises, naming the file
    monkeypatch.undo()
    save_checkpoint(tmp_path, 2, t)
    monkeypatch.setattr(ckpt_mod, "zstandard", None)
    with pytest.raises(ImportError, match="arrays.msgpack.zst"):
        load_checkpoint(tmp_path, t)


def test_bf16_leaves_round_trip(tmp_path):
    g = torch.Generator().manual_seed(4)
    t = {"h": torch.randn(3, 5, generator=g).to(torch.bfloat16),
         "s": torch.tensor(1.5, dtype=torch.bfloat16)}
    save_checkpoint(tmp_path, 1, t)
    manifest = json.loads((tmp_path / "step_00000001" / "manifest.json").read_text())
    assert manifest["leaves"]["h"]["dtype"] == "bfloat16"
    t2, _, _ = load_checkpoint(tmp_path, t)
    _assert_trees_equal(t, t2)
    with pytest.raises(TypeError):
        t["h"].numpy()                      # numpy has no bf16: raw bytes only
    # the JAX package reads the same bits
    jt, _, _ = jckpt.load_checkpoint(str(tmp_path), {"h": jnp.zeros((3, 5), jnp.bfloat16),
                                                     "s": jnp.zeros((), jnp.bfloat16)})
    np.testing.assert_array_equal(np.asarray(jt["h"]).view(np.uint16),
                                  t["h"].view(torch.int16).numpy().view(np.uint16))
    jckpt.save_checkpoint(str(tmp_path), 2, jt)
    t3, _, _ = load_checkpoint(tmp_path, t)
    _assert_trees_equal(t, t3)


# -- the launcher on the CPU -------------------------------------------------------

LAUNCH = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "qwen3-0.6b",
          "--reduced", "--device", "cpu", "--steps", "4", "--batch", "8",
          "--seq", "64", "--log-every", "1"]


def _env():
    # one intra-op thread: the three runs compute alike, and beside the
    # test workers they do not oversubscribe the cores
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _run(ckpt_dir):
    out = subprocess.run(LAUNCH + ["--ckpt-dir", str(ckpt_dir)], env=_env(),
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True, timeout=240)
    assert out.returncode == 0, out.stdout
    return out.stdout


def _final(ckpt_dir, step=4):
    cfg, _, _, state = _port_state("float32")
    tmpl = bridge.train_state_to_jax(cfg, state, device="meta")
    return load_checkpoint(ckpt_dir, tmpl, step=step)


def test_launcher_sigterm_then_resume_is_bitwise(tmp_path):
    """Run 1 is uninterrupted; run 2 gets SIGTERM after its first step line
    and must save and exit 0; run 3 resumes run 2's directory with the same
    ``--steps`` (the lr schedule depends on it) and must end where run 1
    ended, bit for bit, loader state included."""
    out1 = _run(tmp_path / "a")
    assert out1.count("step ") == 4 and out1.strip().endswith("done")
    proc = subprocess.Popen(LAUNCH + ["--ckpt-dir", str(tmp_path / "b")],
                            env=_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines = []
    try:
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("step "):
                proc.send_signal(signal.SIGTERM)
                break
        rest, _ = proc.communicate(timeout=240)
    finally:
        if proc.poll() is None:
            proc.kill()
    out2 = "".join(lines) + rest
    assert proc.returncode == 0, out2
    assert "[sigterm] emergency checkpoint" in out2 and "done" not in out2
    k = latest_step(tmp_path / "b")
    assert 1 <= k < 4
    out3 = _run(tmp_path / "b")
    assert f"[resume] from step {k}" in out3 and out3.strip().endswith("done")
    assert [ln.split()[1] for ln in out3.splitlines() if ln.startswith("step ")] \
        == [str(i) for i in range(k, 4)]
    a, extra_a, _ = _final(tmp_path / "a")
    b, extra_b, _ = _final(tmp_path / "b")
    assert extra_a == extra_b == {"loader": {"step": 4}}
    _assert_trees_equal(a, b)
    assert int(a.step) == int(a.opt_state.step) == 4


def test_launcher_prints_straggler_flags_and_restores_sigterm(tmp_path, capsys,
                                                              monkeypatch):
    """The watchdog's flags are printed as the JAX launcher prints them, and
    an in-process run leaves the caller's SIGTERM handler as it found it."""
    from repro_torch.distributed.elastic import StragglerReport, StepWatchdog
    from repro_torch.launch import train as launch_train

    class FlagEveryStep(StepWatchdog):
        def stop(self):
            super().stop()
            return StragglerReport(self._step, 9.0, 1.0, 0.1, 2.0)

    monkeypatch.setattr(launch_train, "StepWatchdog", FlagEveryStep)
    before = signal.getsignal(signal.SIGTERM)
    launch_train.main(["--arch", "qwen3-0.6b", "--reduced", "--device", "cpu",
                       "--steps", "2", "--batch", "2", "--seq", "16",
                       "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "[straggler] step 1: 9.000s (median 1.000s)" in out
    assert "[straggler] step 2: 9.000s (median 1.000s)" in out
    assert signal.getsignal(signal.SIGTERM) is before
    assert latest_step(tmp_path) == 2


def test_launcher_layers_cuts_the_depth(tmp_path):
    """``--layers`` keeps the config's width and cuts its depth: the saved
    train state stacks one layer (qwen3-0.6b reduced has two), and a count
    the pattern does not divide raises (jamba's pattern has eight)."""
    from repro_torch.launch import train as launch_train
    launch_train.main(["--arch", "qwen3-0.6b", "--reduced", "--layers", "1",
                       "--device", "cpu", "--steps", "1", "--batch", "2",
                       "--seq", "16", "--ckpt-dir", str(tmp_path / "a")])
    cfg = get_config("qwen3-0.6b").reduced(layers=1).with_quant(TQ.QAT)
    model = bridge.build_model(cfg, device="cpu")
    state = TTr.init_train_state(model, TO.AdamW(TO.AdamWConfig()))
    loaded, _, step = load_checkpoint(tmp_path / "a",
                                      bridge.train_state_to_jax(cfg, state, device="meta"))
    assert step == 1
    assert loaded.params["stack"]["pos0"]["attn"]["wq"]["w"].shape[0] == 1
    with pytest.raises(ValueError, match="not a multiple of the pattern length"):
        launch_train.main(["--arch", "jamba-1.5-large-398b", "--reduced",
                           "--layers", "4", "--device", "cpu", "--steps", "1",
                           "--ckpt-dir", str(tmp_path / "b")])
