"""Byte-level tokenizer (vocab 256) — self-contained, no external deps."""
from __future__ import annotations

import numpy as np


class ByteTokenizer:
    vocab_size = 256

    def encode(self, text: str) -> np.ndarray:
        return np.frombuffer(text.encode("utf-8", errors="replace"), dtype=np.uint8
                             ).astype(np.int32)

    def decode(self, tokens) -> str:
        arr = np.asarray(tokens, dtype=np.uint8)
        return arr.tobytes().decode("utf-8", errors="replace")
