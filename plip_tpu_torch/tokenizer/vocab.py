"""Vocabulary loading / training / serialization for the CLIP BPE tokenizer:
the port's own copy of ``plip_tpu.tokenizer.vocab``. It resolves the
vocabulary in the same order (``PLIP_TPU_VOCAB``, then a packaged asset, then
the synthetic vocabulary), so both packages tokenize alike.

The reference loads its vocab two ways, both of which we support natively:

1. OpenAI format — a single gzipped text file (``bpe_simple_vocab_16e6.txt.gz``)
   holding merge rules; the vocab is derived deterministically from the merges
   (how ``clip.simple_tokenizer.SimpleTokenizer`` builds it). Used via
   ``clip.load`` (the reference's ``reproducibility/embedders/factory.py:21``).
2. HF format — ``vocab.json`` + ``merges.txt``, used via
   ``CLIPProcessor.from_pretrained`` (the reference's ``plip.py:27``).

Because this build environment has **no network access and no shipped CLIP
vocab asset**, we additionally provide:

- :func:`train_bpe` — a real byte-level BPE trainer (the same algorithm the
  original vocab was produced with), so domain vocabs can be built offline.
- :func:`synthetic_vocab` — a deterministic 49,408-token vocabulary (byte
  tokens + BPE merges trained on an embedded corpus + filler slots) that keeps
  every model shape identical to the real checkpoint. Tests use it to verify
  our tokenizer is *algorithm-exact* against HF's ``CLIPTokenizer`` loading
  the same files.
"""

from __future__ import annotations

import collections
import gzip
import json
import os
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import regex as re

from .bpe import (
    CLIPBPETokenizer,
    EOT_TOKEN,
    SOT_TOKEN,
    _PAT,
    basic_clean,
    bytes_to_unicode,
    whitespace_clean,
)

CLIP_VOCAB_SIZE = 49408  # 256 bytes ×2 (+</w>) + 48894 merges + SOT/EOT
# OpenAI's simple_tokenizer slices the merges file as
# ``merges[1 : 49152 - 256 - 2 + 1]`` → exactly 48894 merge rules (its 49152
# constant counts the 256 byte tokens once; the vocab table then counts them
# twice — plain and ``</w>`` — so 512 + 48894 + 2 = 49408 rows).
OPENAI_MERGE_COUNT = 49152 - 256 - 2  # 48894

# ---------------------------------------------------------------------------
# Loaders
# ---------------------------------------------------------------------------


def vocab_from_merges(merges: Sequence[Tuple[str, str]]) -> Dict[str, int]:
    """Derive the token->id map from merge rules (OpenAI convention).

    Order: 256 byte chars, 256 byte chars + ``</w>``, one token per merge,
    then SOT and EOT.
    """
    base = list(bytes_to_unicode().values())
    tokens = base + [v + "</w>" for v in base]
    tokens += ["".join(m) for m in merges]
    tokens += [SOT_TOKEN, EOT_TOKEN]
    return {t: i for i, t in enumerate(tokens)}


def load_openai_bpe(path: str) -> CLIPBPETokenizer:
    """Load an OpenAI-format gzipped merges file (``*.txt.gz`` or plain)."""
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rb") as f:
        lines = f.read().decode("utf-8").split("\n")
    # Line 0 is a version comment; the real file is truncated to exactly
    # 48894 merges, mirroring clip.simple_tokenizer's
    # ``merges[1 : 49152 - 256 - 2 + 1]``. Slicing with a larger constant
    # would overflow the 49408-row embedding table and shift the EOT id
    # (silently wrong text embeddings — JAX clamps out-of-range gathers).
    merge_lines = lines[1 : OPENAI_MERGE_COUNT + 1]
    merges = [tuple(l.split()) for l in merge_lines if l.strip()]
    return CLIPBPETokenizer(vocab_from_merges(merges), merges)


def load_hf_vocab(vocab_json: str, merges_txt: str) -> CLIPBPETokenizer:
    """Load HF-format ``vocab.json`` + ``merges.txt``."""
    with open(vocab_json, "r", encoding="utf-8") as f:
        vocab = json.load(f)
    with open(merges_txt, "r", encoding="utf-8") as f:
        lines = f.read().split("\n")
    start = 1 if lines and lines[0].startswith("#version") else 0
    merges = [tuple(l.split()) for l in lines[start:] if l.strip()]
    return CLIPBPETokenizer(vocab, merges)


# ---------------------------------------------------------------------------
# Savers (both interchange formats)
# ---------------------------------------------------------------------------


def save_hf_format(tok: CLIPBPETokenizer, out_dir: str) -> Tuple[str, str]:
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    vocab_path, merges_path = out / "vocab.json", out / "merges.txt"
    with open(vocab_path, "w", encoding="utf-8") as f:
        json.dump(tok.encoder, f, ensure_ascii=False)
    ordered = sorted(tok.bpe_ranks.items(), key=lambda kv: kv[1])
    with open(merges_path, "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n")
        for (a, b), _ in ordered:
            f.write(f"{a} {b}\n")
    return str(vocab_path), str(merges_path)


def save_openai_format(tok: CLIPBPETokenizer, path: str) -> str:
    ordered = sorted(tok.bpe_ranks.items(), key=lambda kv: kv[1])
    body = "#version: bpe\n" + "\n".join(f"{a} {b}" for (a, b), _ in ordered)
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(body.encode("utf-8"))
    return str(path)


# ---------------------------------------------------------------------------
# BPE training (byte-level, </w> convention — the algorithm that produced the
# original CLIP vocab)
# ---------------------------------------------------------------------------


def train_bpe(corpus: str, num_merges: int) -> List[Tuple[str, str]]:
    """Learn up to ``num_merges`` merge rules from raw text."""
    byte_enc = bytes_to_unicode()
    word_freq: collections.Counter = collections.Counter()
    text = whitespace_clean(basic_clean(corpus)).lower()
    for token in re.findall(_PAT, text):
        mapped = "".join(byte_enc[b] for b in token.encode("utf-8"))
        word = tuple(mapped[:-1]) + (mapped[-1] + "</w>",)
        word_freq[word] += 1

    merges: List[Tuple[str, str]] = []
    words = {w: f for w, f in word_freq.items()}
    for _ in range(num_merges):
        pair_freq: collections.Counter = collections.Counter()
        for word, freq in words.items():
            for i in range(len(word) - 1):
                pair_freq[(word[i], word[i + 1])] += freq
        if not pair_freq:
            break
        # Deterministic tie-break: frequency desc, then lexicographic.
        best = max(pair_freq.items(), key=lambda kv: (kv[1], kv[0]))[0]
        if pair_freq[best] < 2:
            break
        merges.append(best)
        a, b = best
        merged = a + b
        new_words = {}
        for word, freq in words.items():
            out: List[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == a and word[i + 1] == b:
                    out.append(merged)
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            new_words[tuple(out)] = new_words.get(tuple(out), 0) + freq
        words = new_words
    return merges


# ---------------------------------------------------------------------------
# Synthetic default vocabulary (shape-compatible stand-in for the real one)
# ---------------------------------------------------------------------------

_EMBEDDED_CORPUS = """
an h&e image patch of adipose tissue background debris lymphocytes mucus
smooth muscle normal colon mucosa cancer-associated stroma colorectal
adenocarcinoma epithelium tumor a photo of a histopathology slide showing
benign malignant epithelial cells this is an image of breast colon lung
prostate kidney liver pancreas skin bladder thyroid stained section with
nuclei mitotic figures glandular structures invasive carcinoma in situ
squamous cell adenoma polyp biopsy specimen magnification microscopy
pathology language and image pretraining contrastive dual encoder the quick
brown fox jumps over the lazy dog zero shot classification linear probing
retrieval fine tuning training validation test dataset embedding vector
similarity cosine text caption tweet medical twitter openpath kather pannuke
digestpath wsss4luad tiles patches whole slide images gigapixel resolution
"""


def synthetic_merges(num_merges: int = 4096) -> List[Tuple[str, str]]:
    return train_bpe(_EMBEDDED_CORPUS, num_merges)


def synthetic_vocab(total_size: int = CLIP_VOCAB_SIZE) -> CLIPBPETokenizer:
    """Deterministic stand-in vocab with the real CLIP vocab size.

    Layout mirrors the OpenAI convention, then pads with filler tokens (never
    producible by BPE) up to ``total_size`` so embedding tables match the
    real checkpoint shape exactly.
    """
    merges = synthetic_merges()
    base = list(bytes_to_unicode().values())
    tokens = base + [v + "</w>" for v in base]
    tokens += ["".join(m) for m in merges]
    n_fill = total_size - len(tokens) - 2
    tokens += [f"<filler_{i}>" for i in range(n_fill)]
    tokens += [SOT_TOKEN, EOT_TOKEN]
    assert len(tokens) == total_size
    vocab = {t: i for i, t in enumerate(tokens)}
    return CLIPBPETokenizer(vocab, merges)


# ---------------------------------------------------------------------------
# Default resolution
# ---------------------------------------------------------------------------

_ASSET_DIR = Path(__file__).resolve().parent.parent / "assets"


def default_tokenizer() -> CLIPBPETokenizer:
    """Resolve the tokenizer: env override > packaged asset > synthetic.

    ``PLIP_TPU_VOCAB`` may point at either an OpenAI ``.txt(.gz)`` merges file
    or a directory containing HF ``vocab.json``/``merges.txt``.
    """
    override = os.environ.get("PLIP_TPU_VOCAB")
    candidates = [override] if override else []
    candidates += [
        str(_ASSET_DIR / "bpe_simple_vocab_16e6.txt.gz"),
        str(_ASSET_DIR),
    ]
    for cand in candidates:
        if cand is None or not os.path.exists(cand):
            continue
        if os.path.isdir(cand):
            vj, mt = os.path.join(cand, "vocab.json"), os.path.join(cand, "merges.txt")
            if os.path.exists(vj) and os.path.exists(mt):
                return load_hf_vocab(vj, mt)
        else:
            return load_openai_bpe(cand)
    return synthetic_vocab()
