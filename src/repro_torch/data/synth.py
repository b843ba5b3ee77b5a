"""Synthetic-but-learnable task families standing in for the paper's datasets.

The container is offline (no GLUE / CNNDM / FALCON), so each dataset is
replaced by a generator with the same *interface* and a latent rule a small
model can learn — which is what the BitDistill ablations need: a task where
FP16-SFT converges well, naive BitNet-SFT underperforms, and distillation
closes the gap.

* ``corpus``      — order-1 Markov chain over a 64-symbol alphabet (stage-2
                    continual pre-training corpus, FALCON stand-in).
* ``mnli-syn``    — 3-class: premise/hypothesis segments; label from the
                    overlap fraction of their symbol sets (entail / neutral /
                    contradict thresholds).
* ``qnli-syn``    — 2-class: does the "answer" segment contain the "question"
                    trigram?
* ``sst2-syn``    — 2-class: majority vote of positive vs negative sentiment
                    symbols.
* ``cnndm-syn``   — summarization: the target is the first token of every
                    "sentence" (extractive lead summary), an LM-learnable copy
                    rule scored with our BLEU/ROUGE.

Every example is rendered LM-style: [BOS] prompt [SEP] answer [EOS], with a
loss mask covering only the answer span (and a classification answer being a
single label token) — the same recipe the paper uses for Qwen fine-tuning.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.data.tokenizer import ByteTokenizer

ALPHABET = 64  # symbols live in byte range [0, 64)


@dataclasses.dataclass(frozen=True)
class TaskSpec:
    name: str
    kind: str            # "corpus" | "classification" | "summarization"
    n_classes: int = 0
    seq_len: int = 128


def _markov_matrix(rng: np.random.Generator, n: int = ALPHABET) -> np.ndarray:
    m = rng.dirichlet(np.full(n, 0.3), size=n)  # peaked rows -> learnable
    return m


class SyntheticTask:
    def __init__(self, spec: TaskSpec, tokenizer: Optional[ByteTokenizer] = None,
                 seed: int = 0):
        self.spec = spec
        self.tok = tokenizer or ByteTokenizer()
        self.seed = seed
        self._markov = _markov_matrix(np.random.default_rng(seed + 7))

    # -- generators ----------------------------------------------------------

    def sample(self, rng: np.random.Generator, seq_len: Optional[int] = None
               ) -> Tuple[List[int], List[int]]:
        """returns (prompt_ids, answer_ids) sized to fit ``seq_len``."""
        kind = self.spec.kind
        budget = seq_len or self.spec.seq_len
        if kind == "corpus":
            return [], self._sample_corpus(rng, budget)
        if kind == "classification":
            return self._sample_classification(rng, budget)
        if kind == "summarization":
            return self._sample_summarization(rng, budget)
        raise ValueError(kind)

    def _sample_corpus(self, rng, budget) -> List[int]:
        n = budget
        out = np.empty(n, np.int64)
        out[0] = rng.integers(ALPHABET)
        for i in range(1, n):
            out[i] = rng.choice(ALPHABET, p=self._markov[out[i - 1]])
        return out.tolist()

    def _sample_classification(self, rng, budget) -> Tuple[List[int], List[int]]:
        name = self.spec.name
        L = max(8, (budget - 8) // 2)
        if name.startswith("mnli"):
            a = rng.integers(0, ALPHABET, L)
            overlap = rng.uniform()
            if overlap < 1 / 3:           # contradiction: disjoint symbols
                b = (a + 1 + rng.integers(0, ALPHABET - 1, L)) % ALPHABET
                label = 2
            elif overlap < 2 / 3:         # neutral: half shared
                b = a.copy()
                idx = rng.permutation(L)[: L // 2]
                b[idx] = rng.integers(0, ALPHABET, len(idx))
                label = 1
            else:                          # entailment: subsequence
                b = a[rng.permutation(L)][: L] if L <= len(a) else a
                b = np.sort(rng.permutation(a)[:L])
                label = 0
            prompt = a.tolist() + [self.tok.sep_id] + b.tolist()
        elif name.startswith("qnli"):
            q = rng.integers(0, ALPHABET, 3)
            ans = rng.integers(0, ALPHABET, 2 * L)
            label = int(rng.uniform() < 0.5)
            if label == 1:                 # answer contains question trigram
                pos = rng.integers(0, 2 * L - 3)
                ans[pos:pos + 3] = q
            else:
                # ensure trigram absent
                for i in range(2 * L - 2):
                    if np.array_equal(ans[i:i + 3], q):
                        ans[i] = (ans[i] + 1) % ALPHABET
            prompt = q.tolist() + [self.tok.sep_id] + ans.tolist()
        elif name.startswith("sst2"):
            pos_syms = np.arange(0, ALPHABET // 2)
            neg_syms = np.arange(ALPHABET // 2, ALPHABET)
            label = int(rng.uniform() < 0.5)
            n_major = L // 2 + 1 + rng.integers(0, L // 4)
            major = pos_syms if label == 1 else neg_syms
            minor = neg_syms if label == 1 else pos_syms
            seq = np.concatenate([rng.choice(major, n_major),
                                  rng.choice(minor, L - min(n_major, L))])[:L]
            prompt = rng.permutation(seq).tolist()
        else:
            raise ValueError(name)
        return prompt, [self.tok.label_token(label)]

    def _sample_summarization(self, rng, budget) -> Tuple[List[int], List[int]]:
        n_sent = 4 + int(rng.integers(0, 3))
        sent_len = max(4, (budget - 16) // (n_sent + 1))
        doc, summary = [], []
        for _ in range(n_sent):
            s = rng.integers(0, ALPHABET, sent_len)
            doc.extend(s.tolist())
            doc.append(self.tok.sep_id)
            summary.append(int(s[0]))
        return doc, summary

    # -- LM rendering -----------------------------------------------------------

    def render(self, rng: np.random.Generator, seq_len: int
               ) -> Dict[str, np.ndarray]:
        """-> {tokens[S], labels[S], loss_mask[S], label(for eval)}  (padded)."""
        prompt, answer = self.sample(rng, seq_len)
        tok = self.tok
        # truncate the PROMPT (never the answer) to fit the window
        overhead = 2 + (1 if prompt else 0) + len(answer)   # bos, sep, ans, eos
        prompt = prompt[:max(0, seq_len + 1 - overhead)]
        ids = [tok.bos_id] + prompt + ([tok.sep_id] if prompt else []) + answer + [tok.eos_id]
        ids = ids[:seq_len + 1]
        n_ans = min(len(answer) + 1, max(1, len(ids) - 1))  # answer + eos
        x = np.full(seq_len, tok.pad_id, np.int32)
        y = np.full(seq_len, tok.pad_id, np.int32)
        m = np.zeros(seq_len, np.float32)
        inp, tgt = ids[:-1], ids[1:]
        L = min(len(inp), seq_len)
        x[:L] = inp[:L]
        y[:L] = tgt[:L]
        ans_start = max(0, L - n_ans)
        if self.spec.kind == "corpus":
            m[:L] = 1.0
        else:
            m[ans_start:L] = 1.0
        out = {"tokens": x, "labels": y, "loss_mask": m}
        if self.spec.kind == "classification":
            out["class_label"] = np.int32(answer[0] - tok.label_base)
            out["answer_pos"] = np.int32(ans_start)
        return out


TASKS: Dict[str, TaskSpec] = {
    "corpus": TaskSpec("corpus", "corpus"),
    "mnli-syn": TaskSpec("mnli-syn", "classification", n_classes=3),
    "qnli-syn": TaskSpec("qnli-syn", "classification", n_classes=2),
    "sst2-syn": TaskSpec("sst2-syn", "classification", n_classes=2),
    "cnndm-syn": TaskSpec("cnndm-syn", "summarization"),
}


def get_task(name: str, seed: int = 0) -> SyntheticTask:
    return SyntheticTask(TASKS[name], seed=seed)
