"""Byte-level tokenizer (no external vocab files needed offline)."""
from __future__ import annotations

import numpy as np

PAD, BOS, EOS = 0, 1, 2
OFFSET = 3


class ByteTokenizer:
    vocab_size = 256 + OFFSET

    def encode(self, text: str, max_len: int | None = None,
               add_bos: bool = True) -> np.ndarray:
        ids = [BOS] if add_bos else []
        ids += [b + OFFSET for b in text.encode("utf-8")]
        ids.append(EOS)
        if max_len is not None:
            ids = ids[:max_len] + [PAD] * max(0, max_len - len(ids))
        return np.asarray(ids, np.int32)

    def decode(self, ids) -> str:
        bs = bytes(int(i) - OFFSET for i in ids
                   if OFFSET <= int(i) < 256 + OFFSET)
        return bs.decode("utf-8", errors="replace")
