"""Grapheme vocabulary (port of ``utils/vocab.py``).

The grapheme table is a text file of ``<symbol> <index>`` lines with ``<b>``
(blank) at index 0.  Unknown symbols map to ``<unk>`` when present.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence

BLANK_SYMBOL = "<b>"
UNK_SYMBOL = "<unk>"
BLANK_ID = 0


class Vocabulary:
    def __init__(self, index2word: dict, word2index: dict):
        self.index2word = index2word
        self.word2index = word2index

    def __len__(self) -> int:
        return len(self.index2word)

    @classmethod
    def from_file(cls, path: str) -> "Vocabulary":
        index2word, word2index = {}, {}
        with open(path, "r", encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                word, index = line.split(" ")
                index = int(index)
                index2word[index] = word
                word2index[word] = index
        return cls(index2word, word2index)

    @classmethod
    def from_symbols(cls, symbols: Iterable[str]) -> "Vocabulary":
        """``<b>`` at index 0, then ``symbols`` in order."""
        words = [BLANK_SYMBOL] + list(symbols)
        index2word = dict(enumerate(words))
        word2index = {w: i for i, w in index2word.items()}
        return cls(index2word, word2index)

    def save(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as fh:
            for index in sorted(self.index2word):
                fh.write(f"{self.index2word[index]} {index}\n")

    def encode(self, text: Sequence[str]) -> List[int]:
        unk = self.word2index.get(UNK_SYMBOL, BLANK_ID)
        return [self.word2index.get(unit, unk) for unit in text]

    def decode(self, ids: Sequence[int]) -> List[str]:
        return [self.index2word[int(i)] for i in ids]
