"""The port's copy of ``eval/metrics.py`` (accuracy, BLEU, ROUGE-N/L/Lsum
for Table 2) against the JAX package's on token lists drawn from a seed:
equal floats, since both run the same Python arithmetic."""
import numpy as np
import pytest

from repro.eval import metrics as JM
from repro_torch.eval import metrics as TM
from repro_torch import eval as teval


def _pair(seed, vocab=12):
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, vocab, int(rng.integers(1, 40))).tolist()
    # a candidate sharing some of the reference, so n-grams overlap
    cand = [t if rng.uniform() < 0.6 else int(rng.integers(0, vocab)) for t in ref]
    cand = cand[:int(rng.integers(1, len(cand) + 1))] + \
        rng.integers(0, vocab, int(rng.integers(0, 6))).tolist()
    return cand, ref


@pytest.mark.parametrize("seed", range(12))
def test_metrics_equal_jax(seed):
    cand, ref = _pair(seed)
    assert TM.bleu(cand, ref) == JM.bleu(cand, ref)
    for n in (1, 2, 3):
        assert TM.rouge_n(cand, ref, n) == JM.rouge_n(cand, ref, n)
    assert TM.rouge_l(cand, ref) == JM.rouge_l(cand, ref)
    for sep in (None, 0, 3):
        assert TM.rouge_scores(cand, ref, sep) == JM.rouge_scores(cand, ref, sep)
    pred = np.random.default_rng(seed).integers(0, 3, 25).tolist()
    gold = np.random.default_rng(seed + 100).integers(0, 3, 25).tolist()
    assert TM.accuracy(pred, gold) == JM.accuracy(pred, gold)


@pytest.mark.parametrize("cand,ref", [([], [1, 2]), ([1, 2], []), ([], []),
                                      ([5, 5, 5], [5, 5, 5]), ([1], [2]),
                                      ([1, 2, 3, 4, 5], [1, 2, 3, 4, 5, 6, 7])])
def test_edge_cases_equal_jax(cand, ref):
    assert TM.bleu(cand, ref) == JM.bleu(cand, ref)
    assert TM.rouge_scores(cand, ref, 0) == JM.rouge_scores(cand, ref, 0)
    assert TM.rouge_scores(cand, ref) == JM.rouge_scores(cand, ref)


def test_accuracy_checks_lengths():
    assert TM.accuracy([], []) == JM.accuracy([], []) == 0.0
    with pytest.raises(ValueError, match="3 predictions for 2 labels"):
        TM.accuracy([1, 2, 3], [1, 2])
    with pytest.raises(AssertionError):
        JM.accuracy([1, 2, 3], [1, 2])
    assert teval.__all__ == ["accuracy", "bleu", "rouge_n", "rouge_l", "rouge_scores"]
