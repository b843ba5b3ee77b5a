"""Port vs JAX: the VLM family (llama-3.2-vision-11b: a ``cross`` layer every
fifth layer over precomputed image embeddings) on its reduced fp32 config
cut to one repeat of its five-layer pattern, on the CPU; the checks are
tests/test_torch_encdec.py's, with its tolerances.

Serving holds the JAX engine's contract: requests carry no image, so every
cross cache is one zero position and each cross layer adds exactly zero
(ROADMAP Queue C); the tests here show that both engines serve the same
tokens, that those are the tokens of a memory-less decode, and that a
seeded memory would have changed them.
"""
import numpy as np
import pytest
import torch

from test_torch_encdec import (PROMPTS, VISION, check_decode, check_engine,
                               check_forward, check_launchers,
                               check_param_counts_and_full_shapes,
                               check_round_trips, check_train_and_distill_steps,
                               memory)


def test_param_counts_and_full_config_shapes():
    check_param_counts_and_full_shapes(VISION)


def test_apply_matches_jax():
    _, _, model, toks, mem, _ = check_forward(VISION)
    assert [b.spec.mixer for b in model.stack.layers] == ["attn"] * 4 + ["cross"]
    # the image reaches the logits, and only through the cross layer
    other = memory(model.cfg, 9)
    with torch.no_grad():
        a = model.apply(torch.from_numpy(toks).long(), memory=torch.from_numpy(mem))[0]
        b = model.apply(torch.from_numpy(toks).long(), memory=torch.from_numpy(other))[0]
    assert float((a - b).abs().max()) > 1e-3


def test_decode_with_memory_matches_jax():
    check_decode(VISION)


def test_train_and_distill_steps_match_jax():
    check_train_and_distill_steps(VISION)


def test_params_and_train_state_round_trip(tmp_path):
    check_round_trips(VISION, tmp_path)


@pytest.mark.parametrize("prefill_chunk", [0, 4])
def test_engine_matches_jax_contiguous(prefill_chunk):
    check_engine(VISION, prefill_chunk)


def test_engines_serve_without_the_image():
    """Both engines build their caches without memory: the cross layer
    attends one zero key and value, so its output is exactly zero and the
    served tokens are those of a memory-less greedy decode; the same decode
    over a seeded image memory gives other logits."""
    tcfg, model, served = check_engine(VISION, 4)
    cross = model.stack.layers[4]
    with torch.no_grad():
        empty = cross.init_cache(2, 8, torch.float32)
        y, _ = cross.xattn.decode(torch.randn(2, 1, tcfg.d_model), empty["xattn"],
                                  torch.zeros(2, dtype=torch.int32))
    assert not y.any()

    def greedy(mem):
        out = []
        for prompt in PROMPTS:
            with torch.no_grad():
                cache = model.init_cache(1, 24, torch.float32, "cpu", memory=mem)
                toks, logits = list(prompt), None
                for t in range(len(prompt) + 4):
                    logits, _ = model.decode_step(torch.tensor([toks[t]]), cache,
                                                  torch.tensor([t]))
                    if t >= len(prompt) - 1:
                        toks.append(int(logits.argmax(-1)))
            out.append((toks[len(prompt):len(prompt) + 5], logits))
        return out

    bare = greedy(None)
    assert [t for t, _ in bare] == served
    image = greedy(torch.from_numpy(memory(tcfg, 11, b=1)))
    assert all(float((a - b).abs().max()) > 1e-4 for (_, a), (_, b) in zip(bare, image))


def test_launchers(capsys):
    check_launchers(VISION, capsys)
