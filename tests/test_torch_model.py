"""Port vs JAX: the packed student model end to end on reduced configs.

The JAX params (``init`` with PRNGKey(0), converted by the JAX
``convert_to_packed``) go through ``repro_torch.bridge`` into the port, and
the two ``decode_chunk`` / ``decode_step`` paths run a short sequence of
steps on the same paged pools.  Tolerance 1e-4 on fp32 logits of O(1): the
projections are exact integer products, so what remains is fp32 summation
order in attention and norms (~1e-6 here); the largest difference that could
appear is an int8 activation code flipping at a .5 boundary after such a
difference upstream, which would move a logit by ~1e-3 — none does for
these seeds.  Greedy (argmax) tokens must agree exactly.
"""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitlinear as JB
from repro.core import quant as JQ
from repro.models import build_model as jbuild
from repro.models import get_config as jget
from repro.serving.engine import convert_to_packed as jconvert
from repro_torch.bridge import jax_params_to_torch
from repro_torch.core import quant as TQ
from repro_torch.models import build_model, get_config
from repro_torch.nn.module import resolve_device
from repro_torch.serving.engine import convert_to_packed

CONFIGS = ["qwen3-0.6b", "qwen1.5-0.5b"]
ROOT = Path(__file__).resolve().parents[1]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module", params=CONFIGS)
def packed_pair(request):
    """(JAX packed cfg, JAX packed params, port cfg, port model)."""
    name = request.param
    jcfg = jget(name).reduced().with_quant(JQ.QAT)
    qat = jbuild(jcfg).init(jax.random.PRNGKey(0))
    pcfg, pparams = jconvert(jcfg, qat)
    tcfg = get_config(name).reduced().with_quant(TQ.PACKED)
    model = jax_params_to_torch(tcfg, _np_tree(pparams), device="cpu")
    return pcfg, pparams, tcfg, model, qat


def test_configs_match_jax_field_for_field():
    for name in CONFIGS:
        for full in (True, False):
            jc, tc = jget(name), get_config(name)
            if not full:
                jc, tc = jc.reduced(), tc.reduced()
            jd, td = jc.__dict__, tc.__dict__
            assert set(jd) == set(td)
            for k in jd:
                if k == "quant":
                    assert jd[k].__dict__ == td[k].__dict__
                elif k != "pattern":
                    assert jd[k] == td[k], (name, k)
            assert str(tc.policy().compute_dtype).endswith(
                str(jc.policy().compute_dtype))


def test_forward_logits_match_jax(packed_pair):
    pcfg, pparams, tcfg, model, _ = packed_pair
    toks = np.random.default_rng(0).integers(0, pcfg.vocab, (2, 9)).astype(np.int32)
    want = np.asarray(jbuild(pcfg).apply(pparams, jnp.asarray(toks))[0])
    with torch.no_grad():
        got = model(torch.from_numpy(toks).long()).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("attn_impl", ["gather", "fused"])
def test_decode_chunk_and_step_match_jax(packed_pair, attn_impl):
    """A chunk of 5 prompt tokens per row (one row mid-prompt at a block
    straddle), then three decode steps, on the same paged pools."""
    pcfg, pparams, tcfg, model, _ = packed_pair
    jm = jbuild(pcfg)
    B, bs, L, T = 2, 4, 4, 5
    n_blocks = 1 + B * L
    rng = np.random.default_rng(1)
    bt = np.arange(1, n_blocks, dtype=np.int32).reshape(B, L)
    jcache = jm.init_cache(pparams, n_blocks, bs, jnp.float32)
    tcache = model.init_cache(n_blocks, bs, torch.float32)
    # a resident prefix for row 1 (positions 0..2) laid down by a first chunk
    steps = [(np.array([0, 0]), np.array([T, 3]))]
    steps.append((np.array([T, 3]), np.array([1, T])))
    for start, lens in steps:
        toks = rng.integers(0, pcfg.vocab, (B, T)).astype(np.int32)
        lj, jcache = jm.decode_chunk(pparams, jnp.asarray(toks), jcache,
                                     jnp.asarray(start, jnp.int32),
                                     jnp.asarray(lens, jnp.int32),
                                     jnp.asarray(bt), attn_impl="gather")
        with torch.no_grad():
            lt, _ = model.decode_chunk(torch.from_numpy(toks).long(), tcache,
                                       torch.from_numpy(start).int(),
                                       torch.from_numpy(lens).int(),
                                       torch.from_numpy(bt), attn_impl=attn_impl)
        for b in range(B):
            np.testing.assert_allclose(lt.numpy()[b, :lens[b]],
                                       np.asarray(lj)[b, :lens[b]],
                                       rtol=1e-4, atol=1e-4)
    pos = np.array([T + 1, 3 + T])
    for _ in range(3):
        tok = rng.integers(0, pcfg.vocab, (B,)).astype(np.int32)
        lj, jcache = jm.decode_step(pparams, jnp.asarray(tok), jcache,
                                    jnp.asarray(pos, jnp.int32),
                                    block_tables=jnp.asarray(bt),
                                    attn_impl="gather")
        with torch.no_grad():
            lt, _ = model.decode_step(torch.from_numpy(tok).long(), tcache,
                                      torch.from_numpy(pos).int(),
                                      torch.from_numpy(bt), attn_impl=attn_impl)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_array_equal(lt.numpy().argmax(-1),
                                      np.asarray(lj).argmax(-1))
        pos = pos + 1
    # the pools hold the same K/V (trash block excluded)
    for layer in range(tcfg.n_layers):
        np.testing.assert_allclose(
            tcache[layer]["attn"]["k"].numpy()[1:],
            np.asarray(jcache["pos0"]["attn"]["k"][layer])[1:],
            rtol=1e-5, atol=1e-5)


def test_convert_to_packed_matches_jax(packed_pair):
    """The port's convert_to_packed on the same QAT ``w``: packed bytes equal
    bitwise, delta to 2 ulp (fp32 absmean summed in another order).  The JAX
    ``convert_to_packed`` returns its PRNGKey(0) init template for
    repeat-stacked leaves instead of converting them (ROADMAP Queue C), so
    the QAT params here come from PRNGKey(0), where the two coincide, and
    every layer is also held to the JAX per-layer conversion."""
    pcfg, pparams, tcfg, _, qat = packed_pair
    qcfg = get_config(tcfg.name).reduced().with_quant(TQ.QAT)
    qmodel = jax_params_to_torch(qcfg, _np_tree(qat), device="cpu")
    _, packed = convert_to_packed(qcfg, qmodel)
    state = packed.state_dict()
    reps = pcfg.repeats
    for path in ("attn/wq", "attn/wk", "attn/wv", "attn/wo", "mlp/up",
                 "mlp/gate", "mlp/down"):
        mod, lin = path.split("/")
        jp = pparams["stack"]["pos0"][mod][lin]
        for r in range(reps):
            key = f"stack.layers.{r}.{mod}.{lin}"
            w = np.asarray(qat["stack"]["pos0"][mod][lin]["w"][r])
            per_layer = JB.convert_linear_params_fp_to_packed(jnp.asarray(w))
            for want in (np.asarray(jp["w_packed"][r]),
                         np.asarray(per_layer["w_packed"])):
                np.testing.assert_array_equal(state[key + ".w_packed"].numpy(), want)
            np.testing.assert_allclose(state[key + ".delta"].numpy(),
                                       np.asarray(jp["delta"][r]),
                                       rtol=2.5e-7, atol=0)


def test_bridge_rejects_mismatched_trees(packed_pair):
    pcfg, pparams, tcfg, _, _ = packed_pair
    tree = _np_tree(pparams)
    del tree["final_norm"]
    with pytest.raises(KeyError, match="differ"):
        jax_params_to_torch(tcfg, tree, device="cpu")


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the card-less case")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="cuda"):
        build_model(get_config("qwen3-0.6b").reduced())


def test_port_imports_neither_jax_nor_the_jax_package():
    """Import every module of repro_torch, and chip_smoke.py, in a fresh
    interpreter where ``jax`` and ``repro`` cannot be imported."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "sys.path.insert(0, sys.argv[1])\n"
        "import chip_smoke\n"
        "bad = [n for n in sys.modules if n == 'jax' or n.startswith('jax.')\n"
        "       or n == 'repro' or n.startswith('repro.')]\n"
        "assert not [n for n in bad if sys.modules[n] is not None], bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)],
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
