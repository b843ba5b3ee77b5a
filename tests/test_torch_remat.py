"""``remat_policy`` on the port's ``Stack`` (``nothing``, ``dots``, ``none``)
against each other and against the JAX package.

On the CPU the three policies give bitwise equal losses and gradients: each
recomputes the same operations in the same order.  What each saves is read
from the backward with a ``TorchDispatchMode`` count: on the plain QAT route
``dots`` keeps the projections' ``aten.mm`` outputs, so its backward runs
``none``'s mm count, and recomputes attention, so its ``bmm`` count is
``nothing``'s (reduced qwen3-0.6b, 2 layers: mm 44 / 30 / 30, bmm 12 / 12 /
8; ``nothing`` recomputes all 14 projections' exact products, the last of
each block too, since a ``torch.autograd.Function`` saves its inputs only
after its forward has run).  On the kernel route JAX's policy saves nothing more than ``nothing``
(``jax.ad_checkpoint.print_saved_residuals``: the ``pallas_call`` inside the
``custom_vjp`` is not a ``dot_general``), and neither does the port's.  The
reduced qwen3-0.6b CE step under ``dots`` is held to JAX's ``dots`` step as
``tests/test_torch_train.py`` holds the default one: metrics rtol 1e-5,
parameters rtol 1e-4, atol 1e-5.
"""
import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.core import quant as JQ
from repro.models import build_model as jbuild, get_config as jget
from repro.training import optimizer as JO, schedule as JSch, trainer as JTr
from repro_torch.bridge import jax_params_from_torch, jax_params_to_torch
from repro_torch.core import quant as TQ
from repro_torch.core.distill import softmax_cross_entropy
from repro_torch.models import build_model, get_config
from repro_torch.nn.transformer import Stack
from repro_torch.training import optimizer as TO, schedule as TSch, trainer as TTr

POLICIES = ("nothing", "dots", "none")
MM, BMM = torch.ops.aten.mm.default, torch.ops.aten.bmm.default


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func] += 1
        return func(*args, **(kwargs or {}))


def _cfg(policy, use_kernel):
    q = TQ.QuantConfig(mode="qat", use_kernel=use_kernel)
    return get_config("qwen3-0.6b").reduced().with_quant(q).replace(
        remat=True, remat_policy=policy)


def _backward(policy, use_kernel):
    model = build_model(_cfg(policy, use_kernel), gen=torch.Generator().manual_seed(0),
                        device="cpu")
    toks = torch.randint(0, 268, (2, 16), generator=torch.Generator().manual_seed(1))
    logits, _, _ = model.apply(toks)
    loss = softmax_cross_entropy(logits, torch.roll(toks, -1, 1))
    with _Count() as count:
        loss.backward()
    return loss.detach(), {k: p.grad for k, p in model.named_parameters()}, count.ops


@pytest.mark.parametrize("use_kernel", [False, True])
def test_policies_equal_and_what_dots_saves(use_kernel):
    runs = {p: _backward(p, use_kernel) for p in POLICIES}
    loss, grads, _ = runs["nothing"]
    for p in ("dots", "none"):
        assert torch.equal(runs[p][0], loss), p
        assert set(runs[p][1]) == set(grads)
        for k in grads:
            assert torch.equal(runs[p][1][k], grads[k]), (p, k)
    ops = {p: runs[p][2] for p in POLICIES}
    assert ops["nothing"][MM] > ops["none"][MM] and ops["nothing"][BMM] > ops["none"][BMM]
    if use_kernel:   # JAX saves nothing more on the kernel route
        assert ops["dots"] == ops["nothing"]
    else:
        assert ops["dots"][MM] == ops["none"][MM]
        assert ops["dots"][BMM] == ops["nothing"][BMM]
        assert (ops["nothing"][MM], ops["dots"][MM], ops["none"][MM]) == (44, 30, 30)


def test_unknown_policy_raises():
    with pytest.raises(ValueError, match="'everything'"):
        build_model(_cfg("everything", False), device="cpu")


def test_no_remat_under_no_grad():
    """Evaluation (no autograd) runs the blocks directly under any policy."""
    model = build_model(_cfg("dots", False), gen=torch.Generator().manual_seed(0),
                        device="cpu")
    assert isinstance(model.stack, Stack) and model.stack.remat
    toks = torch.zeros((1, 8), dtype=torch.long)
    with torch.no_grad(), _Count() as count:
        model.apply(toks)
    assert not any("checkpoint" in str(op) for op in count.ops)


def test_dots_ce_step_matches_jax():
    jcfg = jget("qwen3-0.6b").reduced().with_quant(JQ.QAT).replace(
        remat=True, remat_policy="dots")
    tcfg = get_config("qwen3-0.6b").reduced().with_quant(TQ.QAT).replace(
        remat=True, remat_policy="dots")
    jmodel = jbuild(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    student = jax_params_to_torch(tcfg, jax.tree_util.tree_map(np.asarray, params),
                                  device="cpu")
    rng = np.random.default_rng(0)
    b = {"tokens": rng.integers(0, 268, (4, 16)).astype(np.int32),
         "labels": rng.integers(0, 268, (4, 16)).astype(np.int32),
         "loss_mask": (rng.uniform(size=(4, 16)) < 0.7).astype(np.float32)}
    jopt, topt = JO.AdamW(JO.AdamWConfig()), TO.AdamW(TO.AdamWConfig())
    jstep = jax.jit(JTr.make_train_step(jmodel, jopt, lambda s: JSch.constant(s, 1e-4)))
    tstep = TTr.make_train_step(student, topt, lambda s: TSch.constant(s, 1e-4))
    jstate, jm = jstep(JTr.init_train_state(params, jopt),
                       {k: jnp.asarray(v) for k, v in b.items()})
    _, tm = tstep(TTr.init_train_state(student, topt),
                  {k: torch.from_numpy(v) for k, v in b.items()})
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, atol=2e-7,
                                   err_msg=k)
    got = jax_params_from_torch(tcfg, student)
    for path, want in jax.tree_util.tree_leaves_with_path(jstate.params):
        leaf = got
        for p in path:
            leaf = leaf[p.key]
        np.testing.assert_allclose(leaf, np.asarray(want), rtol=1e-4, atol=1e-5,
                                   err_msg=jax.tree_util.keystr(path))
