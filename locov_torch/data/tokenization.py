"""Host-side WordPiece tokenizer + vectorized MLM masking.

The port's own copy of ``locov_tpu/data/tokenization.py``; its native
fast path (``locov_torch/native/wordpiece.cpp``) is built into
``build/native/`` (``locov_torch/utils/native.py``). From-scratch replacement for HF's ``BertTokenizer`` plus the reference's
per-token python MLM loops (``transf_models.py:26-68``): lowercasing /
punctuation-splitting basic tokenizer, greedy-longest-match WordPiece,
and a numpy-vectorized masking pass reproducing the exact probability
cascade (prob < p_mlm selects; renormalized prob < p_mask replaces with
[MASK] and ALSO flips special_tokens_mask — that flip matters because
the grounding caption mask excludes special tokens).

The vocab file is a plain one-token-per-line ``vocab.txt`` (standard
bert-base-uncased format); no network access is required or attempted.
"""
from __future__ import annotations

import unicodedata
from typing import Dict, List, Sequence

import numpy as np

PAD, UNK, CLS, SEP, MASK = "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"


def _is_whitespace(ch):
    return ch in " \t\n\r" or unicodedata.category(ch) == "Zs"


def _is_control(ch):
    if ch in "\t\n\r":
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punct(ch):
    cp = ord(ch)
    if ((33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96)
            or (123 <= cp <= 126)):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp):
    return ((0x4E00 <= cp <= 0x9FFF) or (0x3400 <= cp <= 0x4DBF)
            or (0x20000 <= cp <= 0x2A6DF) or (0x2A700 <= cp <= 0x2B73F)
            or (0x2B740 <= cp <= 0x2B81F) or (0x2B820 <= cp <= 0x2CEAF)
            or (0xF900 <= cp <= 0xFAFF) or (0x2F800 <= cp <= 0x2FA1F))


class WordPieceTokenizer:
    def __init__(self, vocab: Dict[str, int], lowercase: bool = True,
                 max_chars_per_word: int = 100):
        self.vocab = vocab
        self.inv_vocab = {v: k for k, v in vocab.items()}
        self.lowercase = lowercase
        self.max_chars_per_word = max_chars_per_word
        self.pad_id = vocab[PAD]
        self.unk_id = vocab[UNK]
        self.cls_id = vocab[CLS]
        self.sep_id = vocab[SEP]
        self.mask_id = vocab[MASK]

    @classmethod
    def from_vocab_file(cls, path: str, lowercase: bool = True):
        vocab = {}
        with open(path, "r", encoding="utf-8") as f:
            for i, line in enumerate(f):
                tok = line.rstrip("\n")
                if tok:
                    vocab[tok] = i
        return cls(vocab, lowercase)

    def __len__(self):
        return len(self.vocab)

    # -- basic tokenization --------------------------------------------
    def _clean(self, text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    def basic_tokenize(self, text: str) -> List[str]:
        text = self._clean(text)
        # CJK chars get surrounded by spaces
        spaced = []
        for ch in text:
            if _is_cjk(ord(ch)):
                spaced.extend([" ", ch, " "])
            else:
                spaced.append(ch)
        tokens = "".join(spaced).split()
        out = []
        for tok in tokens:
            if self.lowercase:
                tok = tok.lower()
                tok = "".join(c for c in unicodedata.normalize("NFD", tok)
                              if unicodedata.category(c) != "Mn")
            # split on punctuation
            cur = []
            for ch in tok:
                if _is_punct(ch):
                    if cur:
                        out.append("".join(cur))
                        cur = []
                    out.append(ch)
                else:
                    cur.append(ch)
            if cur:
                out.append("".join(cur))
        return out

    # -- wordpiece ------------------------------------------------------
    def wordpiece(self, word: str) -> List[str]:
        if len(word) > self.max_chars_per_word:
            return [UNK]
        pieces = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [UNK]
            pieces.append(cur)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[str]:
        out = []
        for word in self.basic_tokenize(text):
            out.extend(self.wordpiece(word))
        return out

    # -- native fast path ----------------------------------------------
    _native_lib = None

    def _native(self):
        """Lazy-build/load the C++ tokenizer (ASCII fast path; see
        native/wordpiece.cpp). Returns a handle or None."""
        if getattr(self, "_native_handle", None) is not None:
            return self._native_handle
        if getattr(self, "_native_failed", False):
            return None
        import ctypes
        import subprocess
        from ..utils import native
        try:
            lib = native.load("wordpiece")
            lib.wp_create.restype = ctypes.c_void_p
            lib.wp_create.argtypes = [
                ctypes.POINTER(ctypes.c_char_p)] + [ctypes.c_int] * 7
            lib.wp_encode.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32)]
            inv = sorted(self.vocab, key=self.vocab.get)
            arr = (ctypes.c_char_p * len(inv))(
                *[t.encode("utf-8") for t in inv])
            handle = lib.wp_create(
                arr, len(inv), int(self.lowercase), self.pad_id,
                self.unk_id, self.cls_id, self.sep_id,
                self.max_chars_per_word)
            WordPieceTokenizer._native_lib = lib
            self._native_handle = handle
            return handle
        except (OSError, subprocess.CalledProcessError):
            self._native_failed = True
            return None

    def encode(self, text: str, max_length: int):
        """[CLS] tokens [SEP], truncated to max_length, padded with PAD.
        Returns (ids, attention_mask, special_tokens_mask) numpy arrays.
        ASCII inputs take the native C++ path; anything else falls back
        to the pure-Python tokenizer (identical output)."""
        handle = self._native()
        if handle is not None and text.isascii():
            import ctypes
            ids = np.empty(max_length, np.int32)
            attn = np.empty(max_length, np.int32)
            special = np.empty(max_length, np.int32)
            p = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
            rc = WordPieceTokenizer._native_lib.wp_encode(
                ctypes.c_void_p(handle), text.encode("utf-8"),
                max_length, p(ids), p(attn), p(special))
            if rc == 0:
                return ids, attn, special
        ids = [self.vocab.get(t, self.unk_id) for t in self.tokenize(text)]
        ids = [self.cls_id] + ids[:max_length - 2] + [self.sep_id]
        n = len(ids)
        arr = np.full(max_length, self.pad_id, np.int32)
        arr[:n] = ids
        attn = np.zeros(max_length, np.int32)
        attn[:n] = 1
        special = np.ones(max_length, np.int32)  # PAD counts as special
        special[1:n - 1] = 0
        special[0] = 1
        return arr, attn, special

    def encode_batch(self, texts: Sequence[str], max_length: int):
        ids = np.stack([self.encode(t, max_length)[0] for t in texts])
        attn = np.zeros_like(ids)
        special = np.ones_like(ids)
        for i, t in enumerate(texts):
            _, a, s = self.encode(t, max_length)
            attn[i], special[i] = a, s
        return ids, attn, special


def apply_mlm_masking(input_ids: np.ndarray, attention_mask: np.ndarray,
                      special_tokens_mask: np.ndarray, mask_token_id: int,
                      vocab_size: int, rng: np.random.RandomState,
                      mlm_prob: float = 0.15, prob_mask: float = 0.9,
                      prob_noise: float = 0.0, enabled: bool = True):
    """Vectorized port of the reference's MLM loop
    (transf_models.py:35-58). Returns (masked_ids, target_ids, mlm_mask,
    new_special_tokens_mask). The [MASK]-replacement also sets
    special_tokens_mask=1 (transf_models.py:53) — preserved here."""
    target_ids = input_ids.copy()
    ids = input_ids.copy()
    special = special_tokens_mask.copy()
    if not enabled:
        return ids, target_ids, np.zeros_like(ids), special

    eligible = (special == 0) & (attention_mask == 1)
    prob = rng.rand(*ids.shape)
    selected = eligible & (prob < mlm_prob)
    sub_prob = np.where(selected, prob / mlm_prob, 1.0)
    do_mask = selected & (sub_prob < prob_mask)
    do_noise = selected & ~do_mask & (sub_prob < prob_mask + prob_noise)

    ids = np.where(do_mask, mask_token_id, ids)
    special = np.where(do_mask, 1, special)
    if prob_noise > 0:
        noise = rng.randint(0, vocab_size, size=ids.shape)
        ids = np.where(do_noise, noise, ids)
    mlm_mask = selected.astype(np.int32)
    return ids, target_ids, mlm_mask, special


def build_tiny_vocab(words: Sequence[str]) -> Dict[str, int]:
    """Test helper: a minimal vocab covering the given words plus
    single characters as ##-continuations."""
    vocab = {PAD: 0, UNK: 1, CLS: 2, SEP: 3, MASK: 4}
    for w in words:
        for tok in (w, w.lower()):
            if tok not in vocab:
                vocab[tok] = len(vocab)
    for c in "abcdefghijklmnopqrstuvwxyz0123456789.,!?'\"-":
        for tok in (c, "##" + c):
            if tok not in vocab:
                vocab[tok] = len(vocab)
    return vocab
