"""CLIP byte-level BPE tokenizer: the port's own copy of
``plip_tpu.tokenizer.bpe``, which it does not import.

Implements the exact tokenization contract the reference inherits from its two
dependencies (see SURVEY.md §2.2 N2):

- OpenAI ``clip.tokenize(texts, truncate=True)`` semantics, exercised at
  the reference's
  ``reproducibility/embedders/plip.py:65``: ``[SOT] + bpe(text)
  + [EOT]``, zero-padded to a fixed 77-token context, truncation keeps the
  first 75 content tokens and forces the last slot to EOT.
- HF ``CLIPProcessor(text=..., max_length=77, padding="max_length",
  truncation=True)`` semantics, exercised at the reference's ``plip.py:57-58``.
  Both paths produce identical pooled text features because the text tower
  pools at the (first) EOT position and attention is causal, so pad values
  after EOT never influence the output.

The tokenizer is pure host-side Python/NumPy and always emits **static-shape**
``int32 [batch, context_length]`` arrays, one shape per context length.
"""

from __future__ import annotations

import html
from functools import lru_cache
from typing import Dict, Iterable, List, Sequence, Tuple, Union

import numpy as np
import regex as re

try:  # real ftfy wins when installed (the reference gets it via `clip`) …
    import ftfy

    _HAS_FTFY = True
except ImportError:
    _HAS_FTFY = False

# … otherwise the vendored deterministic subset keeps the canonical cleaning
# semantics the checkpoint was trained with (mojibake/width/quotes/NFC) —
# see textfix.py for the documented divergences.
from .textfix import fix_text as _fix_text_minimal

# The token-splitting pattern used by both OpenAI CLIP's SimpleTokenizer and
# HF's CLIPTokenizer (case-insensitive).
_PAT = re.compile(
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
    re.IGNORECASE,
)

SOT_TOKEN = "<|startoftext|>"
EOT_TOKEN = "<|endoftext|>"
DEFAULT_CONTEXT_LENGTH = 77


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """Map every byte 0..255 to a printable unicode char (GPT-2/CLIP table).

    Printable ASCII + two latin-1 ranges map to themselves; the remaining
    bytes map to 256+n codepoints so that no byte is whitespace/control.
    """
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(2**8):
        if b not in bs:
            bs.append(b)
            cs.append(2**8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word: Tuple[str, ...]) -> set:
    """Set of adjacent symbol pairs in a word (tuple of symbols)."""
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def basic_clean(text: str) -> str:
    """ftfy-fix + double HTML unescape + strip — OpenAI clip's basic_clean
    (the contract at the reference's `reproducibility/embedders/plip.py:65`)."""
    text = ftfy.fix_text(text) if _HAS_FTFY else _fix_text_minimal(text)
    text = html.unescape(html.unescape(text))
    return text.strip()


def whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class CLIPBPETokenizer:
    """Byte-level BPE with the CLIP ``</w>`` end-of-word convention.

    Parameters
    ----------
    vocab: token string -> id. Must contain ``<|startoftext|>`` and
        ``<|endoftext|>``.
    merges: ordered list of merge pairs ``(a, b)``; earlier = higher priority.
    """

    def __init__(self, vocab: Dict[str, int], merges: Sequence[Tuple[str, str]]):
        self.encoder = dict(vocab)
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.cache: Dict[str, str] = {SOT_TOKEN: SOT_TOKEN, EOT_TOKEN: EOT_TOKEN}
        self.sot_token = self.encoder[SOT_TOKEN]
        self.eot_token = self.encoder[EOT_TOKEN]

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    def bpe(self, token: str) -> str:
        """Apply BPE merges to one pre-split token (space-joined result)."""
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"

        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        result = " ".join(word)
        self.cache[token] = result
        return result

    def encode(self, text: str) -> List[int]:
        """Text -> BPE ids (no SOT/EOT framing, no padding)."""
        bpe_tokens: List[int] = []
        text = whitespace_clean(basic_clean(text)).lower()
        for token in re.findall(_PAT, text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            bpe_tokens.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return bpe_tokens

    def decode(self, ids: Iterable[int]) -> str:
        text = "".join(self.decoder[int(i)] for i in ids)
        raw = bytearray(self.byte_decoder[c] for c in text)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")

    def tokenize(
        self,
        texts: Union[str, Sequence[str]],
        context_length: int = DEFAULT_CONTEXT_LENGTH,
        truncate: bool = True,
        pad_value: int = 0,
    ) -> np.ndarray:
        """Batch of texts -> static-shape ``int32 [B, context_length]``.

        Matches OpenAI ``clip.tokenize``: zero padding, truncation replaces the
        final slot with EOT. ``truncate=False`` raises on overflow, as the
        original does.
        """
        if isinstance(texts, str):
            texts = [texts]
        out = np.full((len(texts), context_length), pad_value, dtype=np.int32)
        for row, text in enumerate(texts):
            ids = [self.sot_token] + self.encode(text) + [self.eot_token]
            if len(ids) > context_length:
                if not truncate:
                    raise RuntimeError(
                        f"Input {text!r} is too long for context length {context_length}"
                    )
                ids = ids[:context_length]
                ids[-1] = self.eot_token
            out[row, : len(ids)] = ids
        return out

    def __call__(self, texts, **kw) -> np.ndarray:
        return self.tokenize(texts, **kw)
