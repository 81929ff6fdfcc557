"""Byte-level tokenizer (substrate; no external vocab files).

A copy of ``repro.data.tokenizer`` (the port imports nothing of ``repro``)."""
from __future__ import annotations

from typing import List

PAD, BOS, EOS = 0, 1, 2
N_SPECIAL = 3


class ByteTokenizer:
    """Bytes + 3 specials; ids [0, 259). Models with larger vocabs simply
    never see the upper ids from this tokenizer."""

    vocab_size = 256 + N_SPECIAL

    def encode(self, text: str, add_bos: bool = True,
               add_eos: bool = False) -> List[int]:
        ids = [b + N_SPECIAL for b in text.encode("utf-8")]
        if add_bos:
            ids = [BOS] + ids
        if add_eos:
            ids = ids + [EOS]
        return ids

    def decode(self, ids) -> str:
        data = bytes(int(i) - N_SPECIAL for i in ids
                     if int(i) >= N_SPECIAL)
        return data.decode("utf-8", errors="replace")
