"""Text preprocessing for the port: the WordPiece tokenizer and the
deterministic synthetic vocabulary, copied from ``tpuserve/text.py`` so the
token ids are identical (``tests/test_torch_bert.py`` checks them), and
CLIP's byte-level BPE for SD 1.5 prompts (``CLIPBPETokenizer``).

- Basic tokenization: NFD accent stripping, optional lowercasing, punctuation
  splitting, CJK isolation, whitespace split.
- WordPiece: greedy longest-match-first against a vocab, "##" continuations,
  [UNK] fallback.

Tokenization runs on the host (pure Python, per request); only the int32
(ids, mask) arrays it yields cross to the device.
"""

from __future__ import annotations

import json
import re
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


# -- CLIP's byte-level BPE ------------------------------------------------------

BOS, EOS = "<|startoftext|>", "<|endoftext|>"
# The slow CLIPTokenizer reads at most this many merges (the published
# merges.txt's 48,894 after its "#version" line).
MAX_MERGES = 49152 - 256 - 2
_SPECIAL = re.compile(f"({re.escape(BOS)}|{re.escape(EOS)})")
# The pre-split's contractions, in the pattern's order; after lower-casing
# the pattern's IGNORECASE lets only U+017F (long s) stand for "s".
_CONTRACTIONS = (("s",), ("t",), ("r", "e"), ("v", "e"), ("m",), ("l", "l"), ("d",))
_FOLD = {"\u017f": "s"}


def bytes_to_unicode() -> dict[int, str]:
    """GPT-2/CLIP's reversible map of the 256 byte values onto printable
    characters: the printable Latin-1 bytes map to themselves, the other
    68 to U+0100 onwards, in byte order."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("\u00a1"), ord("\u00ac") + 1))
          + list(range(ord("\u00ae"), ord("\u00ff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


def _is_clip_control(ch: str) -> bool:
    if ch in "\t\n\r":
        return False
    return unicodedata.category(ch).startswith("C")


def _is_clip_whitespace(ch: str) -> bool:
    return ch in " \t\n\r" or unicodedata.category(ch) == "Zs"


def _is_clip_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF or 0x20000 <= cp <= 0x2A6DF
            or 0x2A700 <= cp <= 0x2B73F or 0x2B740 <= cp <= 0x2B81F
            or 0x2B820 <= cp <= 0x2CEAF or 0xF900 <= cp <= 0xFAFF
            or 0x2F800 <= cp <= 0x2FA1F)


def clip_clean(text: str) -> str:
    """The cleanup of the slow ``CLIPTokenizer`` without ``ftfy`` (its
    ``BasicTokenizer(strip_accents=False, do_split_on_punc=False)``): drop
    NUL, U+FFFD and control/format characters, whitespace to spaces, spaces
    around CJK ideographs, NFC, split on whitespace, lower-case each word,
    rejoin with single spaces."""
    out = []
    for ch in text:
        if ch == "\x00" or ch == "\ufffd" or _is_clip_control(ch):
            continue
        if _is_clip_whitespace(ch):
            out.append(" ")
        elif _is_clip_cjk(ord(ch)):
            out.extend((" ", ch, " "))
        else:
            out.append(ch)
    words = unicodedata.normalize("NFC", "".join(out)).split()
    return " ".join(w.lower() for w in words)


def _char_class(ch: str) -> str:
    """The pre-split's class of one character: ``"L"`` for ``\\p{L}``,
    ``"N"`` for ``\\p{N}``, ``"S"`` for what no branch matches (whitespace,
    and U+0345, which the pattern's IGNORECASE folds out of both the letter
    class and its complement), ``"O"`` for the rest (marks, punctuation,
    symbols)."""
    cat = unicodedata.category(ch)
    if cat[0] == "L":
        return "L"
    if cat[0] == "N":
        return "N"
    if ch.isspace() or ch == "\u0345":
        return "S"
    return "O"


def clip_presplit(text: str) -> list[str]:
    """``re.findall`` of the slow ``CLIPTokenizer``'s pattern
    ``<\\|startoftext\\|>|<\\|endoftext\\|>|'s|'t|'re|'ve|'m|'ll|'d|[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+``
    (IGNORECASE) over cleaned text, without the ``regex`` module: at each
    position the first branch that matches wins — the two special tokens,
    the contractions, a run of letters, ONE number character, a run of
    anything else that is not whitespace; where none matches, the scan
    moves on one character. Python's ``re`` has no ``\\p{L}``; the classes
    come from ``unicodedata.category``."""
    pieces: list[str] = []
    i, n = 0, len(text)
    while i < n:
        ch = text[i]
        if ch == "<" and text.startswith((BOS, EOS), i):
            tok = BOS if text.startswith(BOS, i) else EOS
            pieces.append(tok)
            i += len(tok)
            continue
        if ch == "'":
            hit = 0
            for tail in _CONTRACTIONS:
                seg = text[i + 1:i + 1 + len(tail)]
                if len(seg) == len(tail) and all(_FOLD.get(c, c.lower()) == t
                                                 for c, t in zip(seg, tail)):
                    hit = 1 + len(tail)
                    break
            if hit:
                pieces.append(text[i:i + hit])
                i += hit
                continue
        cls = _char_class(ch)
        if cls == "S":
            i += 1
            continue
        j = i + 1
        if cls != "N":
            while j < n and _char_class(text[j]) == cls:
                j += 1
        pieces.append(text[i:j])
        i = j
    return pieces


class CLIPBPETokenizer:
    """Byte-pair tokenizer for CLIP-family artifacts (SD 1.5 prompts), the
    counterpart of ``tpuserve/text.py``'s, which wraps
    ``transformers.CLIPTokenizer``: the slow tokenizer as it runs without
    ``ftfy``, written out in pure Python (no ``transformers``, no
    ``regex``), behind the WordPiece ``encode(text, max_len) -> (ids,
    mask)`` contract.

    ``vocab.json`` maps tokens to ids; ``merges.txt`` holds one merge per
    line after its ``#version`` line, ranked by order (at most
    ``MAX_MERGES``). A prompt is split at ``<|startoftext|>`` /
    ``<|endoftext|>`` (each its own id), every other span cleaned
    (``clip_clean``) and pre-split (``clip_presplit``); each piece's UTF-8
    bytes go through ``bytes_to_unicode`` and are merged lowest rank first,
    the last symbol carrying ``</w>``, with a cache per piece. A piece
    missing from the vocabulary takes ``<|endoftext|>``'s id (the unknown
    token). ``encode`` frames BOS + pieces + EOS, truncates the pieces so
    EOS stays last, and pads with EOS (``pad_id``).

    Character classes come from this Python's ``unicodedata``; the
    ``regex`` module carries its own tables, so a character whose category
    a later Unicode version changed would split differently."""

    def __init__(self, vocab_file: str, merges_file: str) -> None:
        with open(vocab_file, encoding="utf-8") as f:
            self.encoder: dict[str, int] = json.load(f)
        with open(merges_file, encoding="utf-8") as f:
            lines = f.read().strip().split("\n")[1:MAX_MERGES + 1]
        merges = [tuple(line.split()) for line in lines]
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.byte_encoder = bytes_to_unicode()
        self.cache: dict[str, str] = {BOS: BOS, EOS: EOS}
        # Special tokens a vocabulary lacks are appended after it, BOS first.
        self.vocab = dict(self.encoder)
        for tok in (BOS, EOS):
            if tok not in self.vocab:
                self.vocab[tok] = len(self.vocab)
        self.bos_id = self.vocab[BOS]
        self.eos_id = self.vocab[EOS]
        self.pad_id = self.eos_id  # CLIP pads with EOS

    def bpe(self, token: str) -> str:
        """One pre-split piece (byte-mapped) -> its merged symbols, joined by
        spaces; the last symbol ends in ``</w>``."""
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        if len(word) == 1:
            return token + "</w>"
        ranks = self.bpe_ranks
        while len(word) > 1:
            pairs = set(zip(word, word[1:]))
            bigram = min(pairs, key=lambda pair: ranks.get(pair, float("inf")))
            if bigram not in ranks:
                break
            first, second = bigram
            merged: list[str] = []
            i = 0
            while i < len(word):
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def tokenize(self, text: str) -> list[str]:
        out: list[str] = []
        for span in _SPECIAL.split(text):
            if not span:
                continue
            if span in (BOS, EOS):
                out.append(span)
                continue
            for piece in clip_presplit(clip_clean(span)):
                mapped = "".join(self.byte_encoder[b] for b in piece.encode("utf-8"))
                out.extend(self.bpe(mapped).split(" "))
        return out

    def _ids(self, text: str) -> list[int]:
        unk = self.vocab.get(EOS)
        return [self.vocab.get(t, unk) for t in self.tokenize(text)]

    def encode(self, text: str, max_len: int) -> tuple[np.ndarray, np.ndarray]:
        """Text -> (BOS ids EOS + EOS-padding, mask), fixed max_len."""
        ids = [self.bos_id] + self._ids(text)[: max_len - 2] + [self.eos_id]
        n = len(ids)
        arr = np.full((max_len,), self.pad_id, np.int32)
        arr[:n] = ids
        mask = np.zeros((max_len,), np.int32)
        mask[:n] = 1
        return arr, mask

    def n_tokens(self, text: str) -> int:
        return len(self._ids(text)) + 2
