"""Text preprocessing for the port: the WordPiece tokenizer and the
deterministic synthetic vocabulary, copied from ``tpuserve/text.py`` so the
token ids are identical (``tests/test_torch_bert.py`` checks them).

- Basic tokenization: NFD accent stripping, optional lowercasing, punctuation
  splitting, CJK isolation, whitespace split.
- WordPiece: greedy longest-match-first against a vocab, "##" continuations,
  [UNK] fallback.

Tokenization runs on the host (pure Python, per request); only the int32
(ids, mask) arrays it yields cross to the device.
"""

from __future__ import annotations

import unicodedata

import numpy as np

PAD, UNK, CLS, SEP, MASK = "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"
SPECIALS = (PAD, UNK, CLS, SEP, MASK)


def _is_punct(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF or 0xF900 <= cp <= 0xFAFF
    )


def basic_tokenize(text: str, lower: bool = True) -> list[str]:
    """Whitespace/punctuation/CJK split with accent stripping."""
    if lower:
        text = text.lower()
    text = unicodedata.normalize("NFD", text)
    out: list[str] = []
    word: list[str] = []

    def flush() -> None:
        if word:
            out.append("".join(word))
            word.clear()

    for ch in text:
        if unicodedata.category(ch) == "Mn":  # combining accent
            continue
        if ch.isspace():
            flush()
        elif _is_punct(ch) or _is_cjk(ord(ch)):
            flush()
            out.append(ch)
        elif ch == "\x00" or unicodedata.category(ch) == "Cc":
            flush()
        else:
            word.append(ch)
    flush()
    return out


class WordPieceTokenizer:
    """BERT-scheme tokenizer: basic split + greedy WordPiece."""

    def __init__(self, vocab: dict[str, int], lower: bool = True,
                 max_word_chars: int = 100) -> None:
        self.vocab = vocab
        self.lower = lower
        self.max_word_chars = max_word_chars
        for tok in SPECIALS:
            if tok not in vocab:
                raise ValueError(f"vocab is missing special token {tok}")
        self.pad_id = vocab[PAD]
        self.unk_id = vocab[UNK]
        self.cls_id = vocab[CLS]
        self.sep_id = vocab[SEP]
        self.inv = {i: t for t, i in vocab.items()}

    @classmethod
    def from_vocab_file(cls, path: str, lower: bool = True) -> "WordPieceTokenizer":
        """Standard BERT vocab.txt: one token per line, id = line index."""
        vocab: dict[str, int] = {}
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                tok = line.rstrip("\n")
                if tok:
                    vocab[tok] = i
        return cls(vocab, lower=lower)

    def wordpiece(self, word: str) -> list[str]:
        """Greedy longest-match-first split of one basic token."""
        if len(word) > self.max_word_chars:
            return [UNK]
        pieces: list[str] = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                piece = word[start:end]
                if start > 0:
                    piece = "##" + piece
                if piece in self.vocab:
                    cur = piece
                    break
                end -= 1
            if cur is None:
                return [UNK]
            pieces.append(cur)
            start = end
        return pieces

    def tokenize(self, text: str) -> list[str]:
        out: list[str] = []
        for word in basic_tokenize(text, self.lower):
            out.extend(self.wordpiece(word))
        return out

    def encode(self, text: str, max_len: int) -> tuple[np.ndarray, np.ndarray]:
        """Text -> ([CLS] pieces [SEP], mask), truncated+padded to max_len."""
        ids = [self.cls_id]
        ids += [self.vocab.get(t, self.unk_id) for t in self.tokenize(text)]
        ids = ids[: max_len - 1] + [self.sep_id]
        n = len(ids)
        arr = np.full((max_len,), self.pad_id, np.int32)
        arr[:n] = ids
        mask = np.zeros((max_len,), np.int32)
        mask[:n] = 1
        return arr, mask

    def n_tokens(self, text: str) -> int:
        """Sequence length encode() would need (incl. [CLS]/[SEP])."""
        return len(self.tokenize(text)) + 2


def synthetic_vocab(size: int = 8192, seed: int = 0) -> dict[str, int]:
    """Deterministic dev vocab: specials, ASCII chars (+## variants), common
    English subwords, then filler tokens up to `size`.

    Guarantees every ASCII string tokenizes without [UNK] (char fallback)."""
    toks: list[str] = list(SPECIALS)
    chars = [chr(c) for c in range(33, 127)] + list("0123456789")
    seen = set(toks)
    for c in [chr(c) for c in range(97, 123)] + [chr(c) for c in range(48, 58)] + chars:
        for t in (c, "##" + c):
            if t not in seen:
                seen.add(t)
                toks.append(t)
    common = (
        "the of and to in is was for on as with by at from it an be this that "
        "are or his her which not has had have but were they one all we can "
        "##s ##ed ##ing ##ly ##er ##est ##tion ##ment ##ness ##able ##ful "
        "time year day man world life hand part child eye woman place work "
        "week case point company number group problem fact model serve image "
        "text token batch size test run fast slow good new old high low"
    ).split()
    for t in common:
        if t not in seen:
            seen.add(t)
            toks.append(t)
    # The UNK-free guarantee needs every char+## piece above; never truncate
    # below them — clamp size up instead.
    size = max(size, len(toks))
    rng = np.random.default_rng(seed)
    letters = "abcdefghijklmnopqrstuvwxyz"
    while len(toks) < size:
        n = int(rng.integers(2, 6))
        t = "".join(letters[int(i)] for i in rng.integers(0, 26, n))
        if rng.random() < 0.5:
            t = "##" + t
        if t not in seen:
            seen.add(t)
            toks.append(t)
    return {t: i for i, t in enumerate(toks[:size])}
