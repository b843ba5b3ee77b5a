"""Byte-level tokenizer with special tokens (offline-friendly substrate)."""
from __future__ import annotations

import dataclasses
from typing import List


@dataclasses.dataclass(frozen=True)
class ByteTokenizer:
    """ids 0..255 = raw bytes; specials appended after."""
    pad_id: int = 256
    bos_id: int = 257
    eos_id: int = 258
    sep_id: int = 259
    label_base: int = 260          # label_base + k = class-k answer token
    n_labels: int = 8

    @property
    def vocab_size(self) -> int:
        return self.label_base + self.n_labels

    def encode(self, text: str) -> List[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids) -> str:
        return bytes(i for i in ids if 0 <= i < 256).decode("utf-8", errors="replace")

    def label_token(self, k: int) -> int:
        if not 0 <= k < self.n_labels:
            raise ValueError(f"label {k} outside [0, {self.n_labels})")
        return self.label_base + k
