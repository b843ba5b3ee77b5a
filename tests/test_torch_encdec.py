"""Port vs JAX: the encoder-decoder family (whisper-medium, ``models/encdec.py``)
on its reduced fp32 config, on the CPU.  The helpers here serve the VLM
family's file too (tests/test_torch_vlm.py), which runs the same checks on
llama-3.2-vision-11b.

Params come from the JAX ``init`` through ``repro_torch.bridge``, inputs
from numpy seeds.  Tolerances, as tests/test_torch_moe_configs.py's: logits
rtol/atol 1e-4 with argmax equal (fp32 summation order); an FP step's
metrics rtol 1e-4 and its updated leaves rtol 1e-4 atol 1e-5 (a QAT step's
more loosely, for the reason ``check_train_and_distill_steps`` gives);
greedy tokens exactly; parameters, train states and checkpoints leaf for
leaf.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.checkpoint.ckpt as jckpt
from repro.core import quant as JQ
from repro.core.distill import DistillConfig as JDistillConfig
from repro.models import build_model as jbuild
from repro.models import get_config as jget
from repro.serving.api import SamplingParams as JSamplingParams
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import ServeConfig as JServeConfig
from repro.serving.engine import convert_to_packed as jconvert
from repro.training import optimizer as JO, schedule as JSch, trainer as JTr
from repro_torch import bridge
from repro_torch.bridge import _jax_tree, jax_params_from_torch, jax_params_to_torch
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.core import quant as TQ
from repro_torch.core.distill import DistillConfig
from repro_torch.models import EncDecLM, build_model, get_config
from repro_torch.models.encdec import sinusoidal_positions
from repro_torch.nn.module import flatten_with_paths
from repro_torch.serving import Engine, SamplingParams, ServeConfig
from repro_torch.training import optimizer as TO, schedule as TSch, trainer as TTr

WHISPER, VISION = "whisper-medium", "llama-3.2-vision-11b"
# layers of the reduced config (None: JAX's reduced() depth; the VLM is cut
# to one repeat of its five-layer pattern)
LAYERS = {WHISPER: None, VISION: 5}
MEMORY_KEY = {WHISPER: "frames", VISION: "image_embeds"}
PROMPTS = [[5, 9, 3], [13, 1, 6, 2], [7, 7, 1, 4, 2]]


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jflat(tree):
    return {"/".join(str(getattr(k, "key", getattr(k, "name", k))) for k in path): v
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def cfgs(name, **kw):
    return (jget(name).reduced(layers=LAYERS[name]).replace(**kw),
            get_config(name).reduced(layers=LAYERS[name]).replace(**kw))


def memory(cfg, seed, b=2):
    """The model's memory input: frames [b, encoder_seq, d] or image
    embeddings [b, num_image_tokens, d]."""
    t = cfg.encoder_seq if cfg.n_encoder_layers else cfg.num_image_tokens
    return np.random.default_rng(seed).standard_normal((b, t, cfg.d_model)).astype(
        np.float32)


def japply(jm, p, toks, mem, distill_layer=None):
    if jm.cfg.n_encoder_layers:
        return jm.apply(p, jnp.asarray(mem), jnp.asarray(toks), distill_layer=distill_layer)
    return jm.apply(p, jnp.asarray(toks), memory=jnp.asarray(mem),
                    distill_layer=distill_layer)


def tapply(model, toks, mem, distill_layer=None):
    toks, mem = torch.from_numpy(toks).long(), torch.from_numpy(mem)
    if isinstance(model, EncDecLM):
        return model.apply(mem, toks, distill_layer=distill_layer)
    return model.apply(toks, memory=mem, distill_layer=distill_layer)


def jcache(jm, p, b, n, mem):
    key = "frames" if jm.cfg.n_encoder_layers else "memory"
    return jm.init_cache(p, b, n, jnp.float32, **{key: jnp.asarray(mem)})


def tcache(model, b, n, mem):
    key = "frames" if isinstance(model, EncDecLM) else "memory"
    return model.init_cache(b, n, torch.float32, "cpu", **{key: torch.from_numpy(mem)})


def batch(cfg, seed, b=4, s=16):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, 268, (b, s)).astype(np.int32),
            "labels": rng.integers(0, 268, (b, s)).astype(np.int32),
            "loss_mask": (rng.uniform(size=(b, s)) < 0.7).astype(np.float32),
            MEMORY_KEY[cfg.name]: memory(cfg, seed + 1, b)}


# -- the checks both families run --------------------------------------------------

def check_param_counts_and_full_shapes(name):
    """``param_count`` equals JAX's (full and reduced), and the full config
    built on the meta device holds JAX's ``init`` tree leaf for leaf in
    shape and dtype (``jax.eval_shape``: nothing is allocated)."""
    for j, t in ((jget(name), get_config(name)), cfgs(name)):
        assert t.param_count() == j.param_count()
    jc, tc = jget(name), get_config(name)
    want = jflat(jax.eval_shape(lambda: jbuild(jc).init(jax.random.PRNGKey(0))))
    model = build_model(tc, device="meta")
    got = jflat(_jax_tree(tc, {k: _Shape(tuple(v.shape), v.dtype)
                               for k, v in model.state_dict().items()},
                          lambda rows: _Shape((len(rows),) + rows[0].shape,
                                              rows[0].dtype)))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert (got[k].shape, str(got[k].dtype).split(".")[1]) == \
            (tuple(v.shape), str(v.dtype)), k


class _Shape:
    """A leaf of shape and dtype alone (a tree leaf to ``jax.tree_util``)."""

    def __init__(self, shape, dtype):
        self.shape, self.dtype = shape, dtype


def check_forward(name):
    """FP logits and the distill layer's qkv states against JAX."""
    jcfg, tcfg = cfgs(name)
    jm = jbuild(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    model = jax_params_to_torch(tcfg, np_tree(params), device="cpu")
    toks = np.random.default_rng(0).integers(0, jcfg.vocab, (2, 9)).astype(np.int32)
    mem = memory(jcfg, 1)
    dl = TTr.default_distill_layer(tcfg)
    assert dl == JTr.default_distill_layer(jcfg)
    jl, js, _ = japply(jm, params, toks, mem, dl)
    with torch.no_grad():
        tl, ts, _ = tapply(model, toks, mem, dl)
    want, got = np.asarray(jl), tl.numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-4, atol=1e-4)
    return jm, params, model, toks, mem, want


def check_decode(name):
    """``init_cache`` with the memory seeds every cross cache; incremental
    ``decode_step`` over the prompt equals JAX's step by step and the full
    forward's rows, each within 1e-4; the seeded caches equal JAX's."""
    jm, params, model, toks, mem, full = check_forward(name)
    jc = jcache(jm, params, 2, 12, mem)
    with torch.no_grad():
        tc = tcache(model, 2, 12, mem)
    jcross = [leaf for path, leaf in jflat(jc).items() if "xattn" in path]
    tcross = [layer["xattn"][k] for layer in tc if "xattn" in layer for k in ("k", "v")]
    assert jcross and len(tcross) == sum(leaf.shape[0] for leaf in jcross)
    assert tcross[0].shape[2] == mem.shape[1]
    for t in range(toks.shape[1]):
        jl, jc = jm.decode_step(params, jnp.asarray(toks[:, t]), jc, jnp.asarray(t))
        with torch.no_grad():
            tl, _ = model.decode_step(torch.from_numpy(toks[:, t]).long(), tc,
                                      torch.tensor([t, t]))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(tl.numpy(), full[:, t], rtol=1e-4, atol=1e-4)
    for path, leaf in jflat(jc).items():
        if "xattn" in path:
            rows = [layer["xattn"][path.split("/")[-1]] for layer in tc if "xattn" in layer]
            np.testing.assert_allclose(torch.stack(rows).numpy(), np.asarray(leaf),
                                       rtol=1e-4, atol=1e-5, err_msg=path)


def check_train_and_distill_steps(name):
    """One CE step and one distillation step (CE + logits KD + attention-
    relation KD at the default layer; an FP teacher), each from JAX's init,
    each for an FP and a QAT student, against JAX's jitted steps.  The FP
    student's metrics are held within rtol 1e-4 and its updated leaves
    within rtol 1e-4, atol 1e-5.  The QAT student's are held more loosely,
    for a cause the FP student rules out: the two sides' fp32 differences
    (~1e-6) round a few int8 activation codes of the QAT forward either way
    (one code moves an activation by γ/127; in the VLM's CE step one token
    of layer 2 flips, and attention carries it to 15 of 64 tokens, moving
    the loss by 1.8e-4 and grad_norm by 2.2e-4, relative; in its distill
    step the relation loss at layer 3 reads those tokens, and loss_ad moves
    by 1.4e-3, grad_norm by 8.5e-4, where the FP student's agree to 1e-6).
    So its metrics are held within rtol 2e-3; and as AdamW's first step moves an element
    by about lr·sign(g), an element whose gradient a flip turns over moves
    by 2·lr more or less, so each QAT leaf element is within 2·lr, and 99%
    of all of them within the FP tolerance (whisper: 0.13% leave it after
    the CE step)."""
    jt, tt = cfgs(name)
    tparams = jbuild(jt).init(jax.random.PRNGKey(0))
    teacher = jax_params_to_torch(tt, np_tree(tparams), device="cpu")
    dl = TTr.default_distill_layer(tt)
    jd, td = JDistillConfig(distill_layer=dl), DistillConfig(distill_layer=dl)
    jopt, topt = JO.AdamW(JO.AdamWConfig()), TO.AdamW(TO.AdamWConfig())
    lr = 1e-4
    jlr, tlr = (lambda s: JSch.constant(s, lr)), (lambda s: TSch.constant(s, lr))
    for quant in (False, True):
        js, ts = (jt.with_quant(JQ.QAT), tt.with_quant(TQ.QAT)) if quant else (jt, tt)
        for kind, b in (("train", batch(tt, 3)), ("distill", batch(tt, 5))):
            what = f"{'QAT' if quant else 'FP'} {kind} step"
            sparams = jbuild(js).init(jax.random.PRNGKey(1))
            student = jax_params_to_torch(ts, np_tree(sparams), device="cpu")
            jb = {k: jnp.asarray(v) for k, v in b.items()}
            tb = {k: torch.from_numpy(v) for k, v in b.items()}
            if kind == "train":
                jstate, jm = jax.jit(JTr.make_train_step(jbuild(js), jopt, jlr))(
                    JTr.init_train_state(sparams, jopt), jb)
                _, tm = TTr.make_train_step(student, topt, tlr)(
                    TTr.init_train_state(student, topt), tb)
            else:
                jstate, jm = jax.jit(JTr.make_distill_step(
                    jbuild(js), jbuild(jt), jopt, jlr, jd))(
                    JTr.init_train_state(sparams, jopt), jb, tparams)
                _, tm = TTr.make_distill_step(student, teacher, topt, tlr, td)(
                    TTr.init_train_state(student, topt), tb)
                assert float(tm["loss_ad"]) > 0
            assert set(jm) <= set(tm)
            for k in jm:
                np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                           rtol=2e-3 if quant else 1e-4,
                                           atol=1e-7, err_msg=f"{what} {k}")
            want = jflat(jstate.params)
            got = flatten_with_paths(jax_params_from_torch(ts, student))
            assert sorted(got) == sorted(want)
            off = n = 0
            for k in want:
                w, g = np.asarray(want[k]), got[k]
                if not quant:
                    np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5,
                                               err_msg=f"{what} {k}")
                    continue
                assert np.abs(g - w).max() <= 2 * lr + 1e-6, f"{what} {k}"
                off += int((~np.isclose(g, w, rtol=1e-4, atol=1e-5)).sum())
                n += w.size
            assert off <= 1e-2 * n, f"{what}: {off} of {n} elements"


def check_round_trips(name, tmp_path):
    """JAX params -> port -> JAX params is the identity (bf16 parameters come
    back as their fp32 values); every tensor's rank in JAX's tree, which
    decides weight decay, is JAX's; a port train state with 8-bit moments,
    saved, loads in JAX leaf for leaf, and JAX's save of it loads back into
    a fresh port state equal to the first."""
    jcfg, tcfg = cfgs(name, param_dtype="bfloat16")
    params = np_tree(jbuild(jcfg).init(jax.random.PRNGKey(5)))
    back = jflat(jax_params_from_torch(tcfg, jax_params_to_torch(tcfg, params,
                                                                 device="cpu")))
    want = jflat(params)
    assert sorted(back) == sorted(want)
    for k, w in want.items():
        w = w.astype(np.float32) if w.dtype == jnp.bfloat16 else w
        assert back[k].dtype == w.dtype, k
        np.testing.assert_array_equal(back[k], w, err_msg=k)

    _, tcfg = cfgs(name)
    cfg = tcfg.with_quant(TQ.QAT)
    jcfg = jget(name).reduced(layers=LAYERS[name]).with_quant(JQ.QAT)
    model = build_model(cfg, gen=torch.Generator().manual_seed(3), device="cpu")
    opt = TO.AdamW(TO.AdamWConfig(state_dtype="int8_blockwise"))
    state = TTr.init_train_state(model, opt)
    ranks = TTr.jax_ranks(state.params)
    jparams = jbuild(jcfg).init(jax.random.PRNGKey(0))
    jranks = {k: v.ndim for k, v in jflat(jparams).items()}
    named = jflat(_jax_tree(cfg, {n: n for n in ranks}, lambda rows: rows[0]))
    mine_ranks = {path: ranks[key] for path, key in named.items()}
    assert mine_ranks == jranks
    step = TTr.make_train_step(model, opt, lambda s: TSch.constant(s, 1e-3))
    b = {k: torch.from_numpy(v) for k, v in batch(tcfg, 7, b=2).items()}
    state, _ = step(state, b)
    mine = bridge.train_state_to_jax(cfg, state)
    save_checkpoint(tmp_path / "a", 1, mine, extra={"loader": {"step": 1}})
    jopt = JO.AdamW(JO.AdamWConfig(state_dtype="int8_blockwise"))
    tmpl = jax.eval_shape(lambda: JTr.init_train_state(jparams, jopt))
    jstate, extra, s = jckpt.load_checkpoint(str(tmp_path / "a"), tmpl)
    want = flatten_with_paths(mine)
    got = jflat(jstate)
    assert sorted(got) == sorted(want) and (s, int(jstate.step)) == (1, 1)
    assert any(k.endswith("/code") for k in want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), want[k].numpy(), err_msg=k)
    jckpt.save_checkpoint(str(tmp_path / "b"), 1, jstate, extra=extra)
    fresh = build_model(cfg, gen=torch.Generator().manual_seed(9), device="cpu")
    state2 = TTr.init_train_state(fresh, opt)
    loaded, _, _ = load_checkpoint(tmp_path / "b",
                                   bridge.train_state_to_jax(cfg, state2, device="meta"))
    bridge.load_train_state(cfg, loaded, state2)
    again = flatten_with_paths(bridge.train_state_to_jax(cfg, state2))
    assert list(again) == list(want)
    for k in want:
        assert torch.equal(again[k], want[k]), k


def packed(name):
    """(JAX packed cfg, params, port packed cfg, model): JAX's
    ``convert_to_packed`` of a PRNGKey(0) QAT init, through the bridge."""
    jcfg, tcfg = cfgs(name)
    jcfg = jcfg.with_quant(JQ.QAT)
    pcfg, pparams = jconvert(jcfg, jbuild(jcfg).init(jax.random.PRNGKey(0)))
    tcfg = tcfg.with_quant(TQ.PACKED)
    return pcfg, pparams, tcfg, jax_params_to_torch(tcfg, np_tree(pparams), device="cpu")


def serve(eng, sp, prompts=PROMPTS):
    reqs = [eng.submit(p, sp) for p in prompts]
    for _ in eng.stream():
        pass
    return [list(r.output_tokens) for r in reqs]


def check_engine(name, prefill_chunk):
    """The port's engine (auto layout: contiguous) against JAX's
    ``Engine(paged=False)``, greedy, token for token."""
    pcfg, pparams, tcfg, model = packed(name)
    kw = dict(max_batch=2, max_len=24, prefill_chunk=prefill_chunk)
    want = serve(JEngine(pcfg, pparams, JServeConfig(paged=False, **kw)),
                 JSamplingParams(max_tokens=5, ignore_eos=True))
    eng = Engine(tcfg, model, ServeConfig(**kw))
    assert not eng.paged and eng.attn_impl == "gather" and eng._ring is None
    got = serve(eng, SamplingParams(max_tokens=5, ignore_eos=True))
    assert got == want
    eng._ensure_state()
    cross = [layer["xattn"] for layer in eng._cache if "xattn" in layer]
    assert cross and all(c["k"].shape[2] == 1 and not c["k"].any() for c in cross)
    return tcfg, model, got


def check_launchers(name, capsys):
    """The serve launcher serves the family on the contiguous cache; the
    train launcher refuses it, naming the missing input."""
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch_train
    argv = ["--arch", name, "--reduced", "--packed", "--device", "cpu",
            "--requests", "3", "--max-tokens", "4", "--prompt-len", "6",
            "--max-batch", "2"]
    with pytest.raises(SystemExit) as ei:
        launch_serve.main(argv)
    assert ei.value.code == 0
    out = capsys.readouterr().out
    assert "[kv-cache] contiguous" in out and "[attn]" not in out
    with pytest.raises(ValueError, match="makes no frames or image_embeds"):
        launch_train.main(["--arch", name, "--reduced", "--device", "cpu",
                           "--steps", "1"])


# -- whisper-medium ------------------------------------------------------------------

def test_param_counts_and_full_config_shapes():
    check_param_counts_and_full_shapes(WHISPER)


@pytest.mark.parametrize("length,dim,atol", [(16, 128, 1e-6), (1500, 1024, 2.5e-4)])
def test_sinusoidal_positions_match_jax(length, dim, atol):
    """At the reduced config's encoder length and width, and at whisper's
    (1500 x 1024).  The sines themselves agree; the frequencies are fp32
    ``exp``s, which XLA and PyTorch round apart by one ulp in 51 of 512,
    and at position 1500 one ulp of the argument (1.2e-4) moves a sine by
    as much: hence 2.5e-4 there."""
    from repro.models.encdec import sinusoidal_positions as jsin
    np.testing.assert_allclose(sinusoidal_positions(length, dim).numpy(),
                               np.asarray(jsin(length, dim)), rtol=0, atol=atol)


def test_encode_matches_jax():
    jcfg, tcfg = cfgs(WHISPER)
    jm = jbuild(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    model = jax_params_to_torch(tcfg, np_tree(params), device="cpu")
    frames = memory(jcfg, 2)
    want = np.asarray(jm.encode(params, jnp.asarray(frames)))
    with torch.no_grad():
        got = model.encode(torch.from_numpy(frames)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the encoder attends both ways: a later frame moves the first output
    frames2 = frames.copy()
    frames2[:, -1] += 1.0
    with torch.no_grad():
        moved = model.encode(torch.from_numpy(frames2)).numpy()
    assert np.abs(moved[:, 0] - got[:, 0]).max() > 1e-4
    assert [b.spec.mixer for b in model.decoder.stack.layers] == ["attn_cross"] * 2
    assert not any(b.attn.causal for b in model.encoder.layers)


def test_apply_matches_jax():
    check_forward(WHISPER)


def test_decode_with_frames_matches_jax():
    check_decode(WHISPER)


def test_train_and_distill_steps_match_jax():
    check_train_and_distill_steps(WHISPER)


def test_params_and_train_state_round_trip(tmp_path):
    check_round_trips(WHISPER, tmp_path)


@pytest.mark.parametrize("prefill_chunk", [0, 4])
def test_engine_matches_jax_contiguous(prefill_chunk):
    check_engine(WHISPER, prefill_chunk)


def test_auto_layout_serves_where_jax_raises():
    """JAX's engine reads the config's pattern ([attn]), picks the paged
    pools and fails on its first step (``EncDecLM`` has no
    ``decode_chunk``); the port's reads the decoder's (attn_cross), serves
    on the contiguous cache, and refuses ``paged=True`` naming the mixer."""
    pcfg, pparams, tcfg, model = packed(WHISPER)
    kw = dict(max_batch=2, max_len=24, prefill_chunk=4)
    jeng = JEngine(pcfg, pparams, JServeConfig(**kw))
    assert jeng.paged
    with pytest.raises(AttributeError, match="decode_chunk"):
        serve(jeng, JSamplingParams(max_tokens=4, ignore_eos=True), PROMPTS[:2])
    want = serve(JEngine(pcfg, pparams, JServeConfig(paged=False, **kw)),
                 JSamplingParams(max_tokens=4, ignore_eos=True), PROMPTS[:2])
    eng = Engine(tcfg, model, ServeConfig(**kw))
    assert not eng.paged
    assert serve(eng, SamplingParams(max_tokens=4, ignore_eos=True), PROMPTS[:2]) == want
    with pytest.raises(ValueError, match="attn_cross"):
        Engine(tcfg, model, ServeConfig(paged=True, **kw))


def test_convert_to_packed_packs_encoder_and_decoder():
    """The port's ``convert_to_packed``: every BitLinear of the encoder and
    the decoder packed layer by layer, ``frontend.w`` and the norms
    copied; the packed model decodes over frames."""
    from repro_torch.serving.engine import convert_to_packed
    _, tcfg = cfgs(WHISPER)
    qcfg = tcfg.with_quant(TQ.QAT)
    qat = build_model(qcfg, gen=torch.Generator().manual_seed(0), device="cpu")
    pcfg, pm = convert_to_packed(qcfg, qat)
    sd, qsd = pm.state_dict(), qat.state_dict()
    assert torch.equal(sd["frontend.w"], qsd["frontend.w"])
    assert torch.equal(sd["enc_norm.scale"], qsd["enc_norm.scale"])
    for key in qsd:
        if key.endswith(".w") and key != "frontend.w" and "norm" not in key:
            assert key + "_packed" in sd and key[:-1] + "delta" in sd, key
    frames = torch.from_numpy(memory(tcfg, 4))
    with torch.no_grad():
        cache = pm.init_cache(2, 4, torch.float32, "cpu", frames=frames)
        logits, _ = pm.decode_step(torch.tensor([3, 1]), cache,
                                   torch.zeros(2, dtype=torch.int32))
    assert logits.shape == (2, tcfg.vocab) and bool(torch.isfinite(logits).all())
    assert cache[0]["xattn"]["k"].shape[2] == tcfg.encoder_seq


def test_launchers(capsys):
    check_launchers(WHISPER, capsys)
