"""CLIP's byte-level BPE in the port (``tpuserve_torch.text.CLIPBPETokenizer``,
pure Python) against ``transformers.CLIPTokenizer`` (the slow tokenizer,
which the reference's ``tpuserve.text.CLIPBPETokenizer`` wraps). The port
reproduces it as it runs without ``ftfy`` (its ``BasicTokenizer`` cleanup);
where ``ftfy`` is installed transformers cleans with it instead, and the
file skips.

- On ``tests/test_sd15.py``'s tiny files: ids, masks, ``n_tokens`` and the
  special ids equal transformers' and the reference wrapper's.
- On the chip smoke's seeded CLIP-shaped files (``chip_smoke.clip_bpe_files``:
  49,408 entries, 48,894 merges): ids and masks equal over 600 seeded texts —
  accents, CJK, digits, contractions, emoji, punctuation runs, control and
  odd whitespace characters, special tokens in the text, over-length
  prompts and the empty string.
- The pre-split without ``regex``: every code point's class equals the
  ``regex`` pattern's, and ``clip_presplit`` equals ``regex.findall`` on
  every cleaned text.
- SD 1.5 with ``bpe_vocab``/``bpe_merges``: the text tower is sized from the
  BPE vocabulary and a prompt's ids equal the reference model's.
"""

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest

from tpuserve_torch import text as ttext

if importlib.util.find_spec("ftfy") is not None:
    pytest.skip("transformers' CLIPTokenizer cleans text with ftfy when it is installed",
                allow_module_level=True)

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_sd15 import _write_tiny_bpe  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MAX_LEN = 77
PATTERN = (r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]"""
           r"""|[^\s\p{L}\p{N}]+""")

# Pieces the seeded texts are drawn from.
LETTERS = list("abcdefghijklmnopqrstuvwxyz") * 3 + list("ABCDEFGHIJKLMNOPQRSTUVWXYZ")
ACCENTS = list("éèêëàâäçñüöôîïÅØßÆœ") + [
    "e\u0301", "a\u0308", "n\u0303",   # decomposed: NFC composes them
    "\u0130",                          # I with dot: lower() gives i + U+0307
    "\u017f",                          # long s: the pattern's 's matches it
    "\u0345",                          # ypogegrammeni: no branch matches it
    "\u0915\u093f"]                    # Devanagari consonant + vowel sign (Mc)
CJK = list("中文字日本語漢字한국어カタカナひらがな")
DIGITS = list("0123456789") + ["١٢٣", "Ⅻ", "½", "²"]
EMOJI = ["😀", "🎨", "👍🏽", "❤️", "🇫🇷", "👩‍💻", "✨"]
PUNCT = list("!?.,;:-_()[]{}'\"/\\@#$%^&*+=~`|<>…—“”«»¿¡")
ODD = ["\t", "\n", "\r", "\u00a0", "\u3000", "\u2028", "\x00", "\ufffd", "\u200b",
       "\x07", "\ufeff", "\u0085"]
WORDS = ("the a lighthouse cliff dusk oil painting it's we're they've I'm you'll he'd "
         "don't IT'S ''s 's <|endoftext|> <|startoftext|> <|StartOfText|> ... !!! ?!").split()


def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def seeded_texts(n: int, seed: int = 0) -> list[str]:
    """``n`` texts: the empty string, then mixes of words and characters of
    every kind above, some long enough to be truncated at 77 ids."""
    rng = np.random.default_rng(seed)
    kinds = [LETTERS, ACCENTS, CJK, DIGITS, EMOJI, PUNCT, ODD, [" "] * 4]
    weights = np.array([8, 2, 2, 2, 1, 2, 1, 4], float)
    weights /= weights.sum()
    out = [""]
    while len(out) < n:
        parts = []
        for _ in range(int(rng.integers(1, 60 if rng.random() < 0.8 else 400))):
            if rng.random() < 0.3:
                parts.append(" " + WORDS[int(rng.integers(len(WORDS)))] + " ")
            else:
                kind = kinds[int(rng.choice(len(kinds), p=weights))]
                parts.append(kind[int(rng.integers(len(kind)))])
        out.append("".join(parts))
    return out


def hf(vocab: str, merges: str):
    from transformers import CLIPTokenizer

    return CLIPTokenizer(vocab_file=vocab, merges_file=merges)


def hf_encode(tok, text: str, max_len: int = MAX_LEN) -> tuple[list, list]:
    out = tok(text, padding="max_length", truncation=True, max_length=max_len)
    return out["input_ids"], out["attention_mask"]


# -- the tiny files ------------------------------------------------------------

TINY_TEXTS = ["a cat", "", "A CAT a  cat\tcat", "cats at a cat!!", "ca t", "a " * 50,
              "<|startoftext|>a<|endoftext|>", "<|StartOfText|> cat", "x y z", "at'sat"]


@pytest.mark.parametrize("text", TINY_TEXTS)
def test_tiny_files_ids_and_masks_equal_transformers(tmp_path, text):
    from tpuserve.text import CLIPBPETokenizer as RefBPE

    vocab, merges = _write_tiny_bpe(tmp_path)
    port, ref, tok = ttext.CLIPBPETokenizer(vocab, merges), RefBPE(vocab, merges), hf(vocab, merges)
    ids, mask = port.encode(text, 8)
    want_ids, want_mask = hf_encode(tok, text, 8)
    assert ids.dtype == np.int32 and mask.dtype == np.int32
    assert ids.tolist() == want_ids and mask.tolist() == want_mask
    ref_ids, ref_mask = ref.encode(text, 8)
    assert np.array_equal(ids, ref_ids) and np.array_equal(mask, ref_mask)
    assert port.n_tokens(text) == ref.n_tokens(text)
    assert (port.pad_id, port.bos_id, port.eos_id) == (ref.pad_id, ref.bos_id, ref.eos_id)
    assert port.vocab == ref.vocab


def test_tiny_files_contract(tmp_path):
    """The reference's own contract test, on the port: BOS + merged pieces
    + EOS, EOS-padded to the fixed length."""
    port = ttext.CLIPBPETokenizer(*_write_tiny_bpe(tmp_path))
    ids, mask = port.encode("a cat", 8)
    assert list(ids[:4]) == [0, 2, 3, 1]
    assert list(mask) == [1, 1, 1, 1, 0, 0, 0, 0]
    assert ids[4:].tolist() == [port.pad_id] * 4


# -- the smoke's 49,408-entry files ------------------------------------------------

@pytest.fixture(scope="module")
def clip_files(tmp_path_factory):
    vocab, merges = chip_smoke().clip_bpe_files(tmp_path_factory.mktemp("clip_bpe"))
    return str(vocab), str(merges)


@pytest.fixture(scope="module")
def tokenizers(clip_files):
    return ttext.CLIPBPETokenizer(*clip_files), hf(*clip_files)


def test_smoke_files_are_clip_shaped(clip_files):
    """49,408 entries: the 256 byte symbols, the same with ``</w>``, one
    token per merge, then BOS 49406 and EOS 49407; 48,894 merges, each of
    two tokens that exist before it."""
    cs = chip_smoke()
    vocab = json.loads(Path(clip_files[0]).read_text(encoding="utf-8"))
    lines = Path(clip_files[1]).read_text(encoding="utf-8").strip().split("\n")
    assert len(vocab) == cs.CLIP_VOCAB == 49408 and len(lines) == cs.CLIP_MERGES + 1 == 48895
    assert lines[0].startswith("#version")
    assert sorted(vocab.values()) == list(range(49408))
    inv = {i: t for t, i in vocab.items()}
    syms = list(ttext.bytes_to_unicode().values())
    assert [inv[i] for i in range(256)] == syms
    assert [inv[256 + i] for i in range(256)] == [s + "</w>" for s in syms]
    assert (inv[49406], inv[49407]) == ("<|startoftext|>", "<|endoftext|>")
    for k, line in enumerate(lines[1:]):
        a, b = line.split()
        assert not a.endswith("</w>")
        assert vocab[a] < 512 + k and vocab[b] < 512 + k and vocab[a + b] == 512 + k


CHUNKS = 6
TEXTS_PER_CHUNK = 100


@pytest.mark.parametrize("chunk", range(CHUNKS))
def test_smoke_files_ids_and_masks_equal_transformers(tokenizers, chunk):
    port, tok = tokenizers
    texts = seeded_texts(CHUNKS * TEXTS_PER_CHUNK)[chunk::CHUNKS]
    truncated = 0
    for text in texts:
        ids, mask = port.encode(text, MAX_LEN)
        want_ids, want_mask = hf_encode(tok, text)
        assert ids.tolist() == want_ids and mask.tolist() == want_mask, repr(text)
        assert port.n_tokens(text) == len(tok(text)["input_ids"]), repr(text)
        truncated += port.n_tokens(text) > MAX_LEN
    assert truncated > 0  # over-length prompts are among them


def test_smoke_files_special_ids_and_vocab(tokenizers):
    port, tok = tokenizers
    assert (port.bos_id, port.eos_id, port.pad_id) == (49406, 49407, 49407)
    assert (port.bos_id, port.eos_id, port.pad_id) == (
        tok.bos_token_id, tok.eos_token_id, tok.pad_token_id)
    assert port.vocab == dict(tok.get_vocab())


# -- the pre-split without `regex` --------------------------------------------------

def test_every_code_point_splits_as_the_regex_pattern_does():
    """Each character's class (letter run, single number, other run, or
    skipped) equals what the ``regex`` pattern's branches match, for every
    code point the cleanup lets through."""
    import unicodedata

    regex = pytest.importorskip("regex")
    letter = regex.compile(r"[\p{L}]", regex.IGNORECASE)
    number = regex.compile(r"[\p{N}]", regex.IGNORECASE)
    other = regex.compile(r"[^\s\p{L}\p{N}]", regex.IGNORECASE)
    bad = []
    for cp in range(0x110000):
        ch = chr(cp)
        if unicodedata.category(ch)[0] == "C":
            continue  # the cleanup drops control, format and unassigned
        want = ("L" if letter.fullmatch(ch) else "N" if number.fullmatch(ch)
                else "O" if other.fullmatch(ch) else "S")
        if ttext._char_class(ch) != want:
            bad.append(hex(cp))
    assert not bad, bad[:20]


def test_presplit_equals_regex_findall():
    regex = pytest.importorskip("regex")
    pat = regex.compile(PATTERN, regex.IGNORECASE)
    for text in seeded_texts(600, seed=1) + [t * 3 for t in WORDS]:
        clean = ttext.clip_clean(text)
        assert ttext.clip_presplit(clean) == pat.findall(clean), repr(text)


# -- SD 1.5 with the BPE ------------------------------------------------------------

def test_sd15_sizes_the_text_tower_from_the_bpe_and_encodes_as_the_reference(clip_files):
    from tpuserve.config import ModelConfig as JaxModelConfig
    from tpuserve.models import build as jax_build
    from tpuserve_torch.config import ModelConfig
    from tpuserve_torch.models import build

    opts = {"steps": 2, "text_layers": 1, "text_d_model": 16, "text_heads": 2, "unet_ch": 8,
            "unet_mults": [1, 2], "unet_res": 1, "unet_attn_levels": [0, 1], "unet_heads": 2,
            "vae_ch": 8, "vae_mults": [1, 2], "bpe_vocab": clip_files[0],
            "bpe_merges": clip_files[1]}
    kw = dict(name="sd", family="sd15", dtype="float32", batch_buckets=[1], image_size=32,
              options=opts)
    port = build(ModelConfig(parallelism="single", **kw))
    ref = jax_build(JaxModelConfig(**kw))
    assert port.vocab_size == ref.text_encoder.vocab_size == 49408
    import torch

    with torch.device("meta"):
        emb = port.build_module().text.token_embed.embedding
    assert tuple(emb.shape) == (49408, 16)
    body = json.dumps({"prompt": "A lighthouse on a cliff at dusk, oil painting 🎨 中文",
                       "negative_prompt": "blurry, low-quality", "seed": 9}).encode()
    got, want = port.host_decode(body, "application/json"), ref.host_decode(body,
                                                                          "application/json")
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
