"""Port vs JAX: a decode step of the dense and MoE configs that had none
against JAX (qwen2.5-3b, mistral-large-123b, grok-1-314b), reduced, fp32,
on the CPU.

Params come from the JAX ``init`` (PRNGKey(0)) through
``repro_torch.bridge``; both packages decode the same seeded tokens on
their contiguous caches: four prompt tokens a row, one per step, then one
decode step from each greedy token.  Each step's logits are held at the fp32
tolerance of ``tests/test_torch_dense_configs.py`` (rtol/atol 1e-4:
summation order only), the greedy tokens exactly, and the caches after the
last step at the same tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import build_model as jbuild
from repro.models import get_config as jget
from repro_torch.bridge import jax_params_to_torch
from repro_torch.models import get_config

NAMES = ["qwen2.5-3b", "mistral-large-123b", "grok-1-314b"]
B, MAX_LEN, PROMPT = 2, 16, 4


@pytest.mark.parametrize("name", NAMES)
def test_decode_steps_match_jax(name):
    jc, tc = jget(name).reduced(), get_config(name).reduced()
    jm = jbuild(jc)
    params = jm.init(jax.random.PRNGKey(0))
    model = jax_params_to_torch(tc, jax.tree_util.tree_map(np.asarray, params),
                                device="cpu")
    jcache = jm.init_cache(params, B, MAX_LEN, jnp.float32)
    tcache = model.init_cache(B, MAX_LEN, torch.float32, torch.device("cpu"))
    step = jax.jit(jm.decode_step)
    prompt = np.random.default_rng(7).integers(0, jc.vocab, (B, PROMPT)).astype(np.int32)
    tok = prompt[:, 0]
    for pos in range(PROMPT + 1):
        index = np.full((B,), pos, np.int32)
        lj, jcache = step(params, jnp.asarray(tok), jcache, jnp.asarray(index))
        with torch.no_grad():
            lt, tcache = model.decode_step(torch.from_numpy(tok).long(), tcache,
                                           torch.from_numpy(index))
        lj, lt = np.asarray(lj), lt.numpy()
        np.testing.assert_allclose(lt, lj, rtol=1e-4, atol=1e-4, err_msg=f"{name} {pos}")
        greedy = lt.argmax(-1)
        np.testing.assert_array_equal(greedy, lj.argmax(-1))
        tok = (prompt[:, pos + 1] if pos + 1 < PROMPT else greedy).astype(np.int32)
    # the caches hold the same K/V after the last step: the port's layer l is
    # JAX's pattern position l % P, repeat l // P
    period = len(jc.resolved_pattern())
    for li, layer in enumerate(tcache):
        for part, tensors in layer.items():
            for k, t in tensors.items():
                want = np.asarray(jcache[f"pos{li % period}"][part][k])[li // period]
                np.testing.assert_allclose(t.numpy(), want, rtol=1e-4, atol=1e-4,
                                           err_msg=f"{name} layer {li} {part}.{k}")
