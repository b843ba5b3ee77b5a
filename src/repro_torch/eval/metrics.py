"""Evaluation metrics implemented from scratch (offline container):
accuracy, BLEU [PRWZ02], ROUGE-1/2/L/Lsum [Lin04] over token id sequences.

A copy of ``repro/eval/metrics.py`` (pure Python, no array library), so the
port never imports the JAX package; ``accuracy`` raises ``ValueError`` on
sequences of different lengths where the original asserts."""
from __future__ import annotations

import collections
import math
from typing import Dict, List, Sequence


def accuracy(pred: Sequence[int], gold: Sequence[int]) -> float:
    if len(pred) != len(gold):
        raise ValueError(f"accuracy: {len(pred)} predictions for "
                         f"{len(gold)} labels")
    if not pred:
        return 0.0
    return sum(int(p == g) for p, g in zip(pred, gold)) / len(pred)


def _ngrams(seq: Sequence[int], n: int) -> collections.Counter:
    return collections.Counter(tuple(seq[i:i + n]) for i in range(len(seq) - n + 1))


def bleu(candidate: Sequence[int], reference: Sequence[int],
         max_n: int = 4) -> float:
    """Sentence BLEU with uniform weights and brevity penalty."""
    if not candidate or not reference:
        return 0.0
    log_precisions = []
    for n in range(1, max_n + 1):
        c_ng = _ngrams(candidate, n)
        r_ng = _ngrams(reference, n)
        overlap = sum((c_ng & r_ng).values())
        total = max(sum(c_ng.values()), 1)
        # +1 smoothing for n>1 (standard smoothed sentence BLEU)
        if n == 1:
            p = overlap / total
        else:
            p = (overlap + 1) / (total + 1)
        if p == 0:
            return 0.0
        log_precisions.append(math.log(p))
    bp = 1.0 if len(candidate) > len(reference) else \
        math.exp(1 - len(reference) / max(len(candidate), 1))
    return bp * math.exp(sum(log_precisions) / max_n)


def rouge_n(candidate: Sequence[int], reference: Sequence[int],
            n: int = 1) -> float:
    """ROUGE-N F1."""
    c_ng, r_ng = _ngrams(candidate, n), _ngrams(reference, n)
    overlap = sum((c_ng & r_ng).values())
    if overlap == 0:
        return 0.0
    p = overlap / max(sum(c_ng.values()), 1)
    r = overlap / max(sum(r_ng.values()), 1)
    return 2 * p * r / (p + r)


def _lcs(a: Sequence[int], b: Sequence[int]) -> int:
    dp = [0] * (len(b) + 1)
    for x in a:
        prev = 0
        for j, y in enumerate(b, 1):
            cur = dp[j]
            dp[j] = prev + 1 if x == y else max(dp[j], dp[j - 1])
            prev = cur
    return dp[-1]


def rouge_l(candidate: Sequence[int], reference: Sequence[int]) -> float:
    """ROUGE-L F1 from the longest common subsequence."""
    if not candidate or not reference:
        return 0.0
    l = _lcs(candidate, reference)
    if l == 0:
        return 0.0
    p, r = l / len(candidate), l / len(reference)
    return 2 * p * r / (p + r)


def rouge_scores(candidate: Sequence[int], reference: Sequence[int],
                 sep: int | None = None) -> Dict[str, float]:
    """ROUGE-1/2/L plus ROUGE-Lsum (sentence-split on `sep` when given)."""
    out = {
        "rouge1": rouge_n(candidate, reference, 1),
        "rouge2": rouge_n(candidate, reference, 2),
        "rougeL": rouge_l(candidate, reference),
    }
    if sep is not None:
        def split(seq):
            sents, cur = [], []
            for t in seq:
                if t == sep:
                    if cur:
                        sents.append(cur)
                    cur = []
                else:
                    cur.append(t)
            if cur:
                sents.append(cur)
            return sents
        c_sents, r_sents = split(candidate), split(reference)
        if c_sents and r_sents:
            l = sum(_lcs(c, r) for c, r in zip(c_sents, r_sents))
            p = l / max(sum(len(c) for c in c_sents), 1)
            r = l / max(sum(len(x) for x in r_sents), 1)
            out["rougeLsum"] = 0.0 if l == 0 else 2 * p * r / (p + r)
        else:
            out["rougeLsum"] = 0.0
    else:
        out["rougeLsum"] = out["rougeL"]
    return out
