"""Deterministic ``ftfy.fix_text`` equivalent (vendored, no deps): the port's own
copy of ``plip_tpu.tokenizer.textfix``.

Why this exists: the checkpoint's training-time tokenization runs
``ftfy.fix_text`` on every caption via ``clip.tokenize``
(the reference's `reproducibility/embedders/plip.py:65` →
``clip.simple_tokenizer.basic_clean``). ftfy is a large heuristic library that
is not installed in offline environments; without it, mojibake/fullwidth/curly
inputs tokenize differently than the checkpoint was trained with. This module
vendors ftfy's default fixer pipeline (round 4 widened it from the round-1
"common tables" subset to all of ftfy 6.x's default passes):

1.  **HTML entity unescape** (ftfy ``unescape_html="auto"``): entities with a
    trailing ``;`` expand in place. (``basic_clean`` additionally
    double-unescapes afterwards, matching OpenAI clip — so semicolon-less
    entities still expand one level up.)
2.  **Terminal escape removal** (ANSI CSI sequences, ftfy's regex).
3.  **Mojibake repair** — spans of characters that are STRUCTURALLY a UTF-8
    byte sequence mis-decoded through windows-1252/latin-1/windows-1251/
    MacRoman/cp437 are re-encoded and decoded as UTF-8 (``"schÃ¶n"`` →
    ``"schön"``, ``"â€œxâ€\x9d"`` → ``"“x”"``, 1251 ``"РїСЂРёРІРµС‚"`` →
    ``"привет"``), applied iteratively so double-encoded text heals.
    Sloppy-codec convention: bytes the source codepage leaves undefined pass
    through as their raw codepoint (ftfy's ``sloppy-windows-125x``). A repair
    is accepted only if the span is a complete valid UTF-8 unit, it shrinks
    the non-ASCII count, and it introduces no control/unassigned/surrogate
    characters (cheap stand-in for ftfy's trained badness model).
4.  **C1 controls** → their windows-1252 characters (ftfy
    ``fix_c1_controls``), for stray C1 codepoints no mojibake span explains.
5.  **Surrogate repair** (ftfy ``fix_surrogates``): UTF-16 surrogate pairs
    appearing as two codepoints combine; lone surrogates become U+FFFD.
6.  **Curly quotes → ASCII** (ftfy ``uncurl_quotes``).
7.  **Latin ligatures → letter pairs** (ftfy ``fix_latin_ligatures``).
8.  **Unicode line/paragraph separators → newline** (``fix_line_breaks``).
9.  **Character width** (full ftfy table, built from NFKC over the
    Halfwidth/Fullwidth Forms block): fullwidth ASCII/punctuation →
    halfwidth, ideographic space → space, halfwidth katakana → fullwidth
    (voiced-sound marks map to the COMBINING marks so ``ｶﾞ`` NFC-composes
    to ``ガ``, as in ftfy).
10. **Control-char removal** (ftfy's exact table: C0 except ``\\t\\n\\f\\r``,
    DEL, deprecated format chars U+206A-206F, U+FEFF, interlinear
    annotation U+FFF9-FFFC).
11. **NFC normalization** (ftfy's default ``normalization="NFC"``).

Remaining documented divergences from real ftfy (exotic by design — plain
text is never altered): no ``restore_byte_a0`` /
``replace_lossy_sequences`` / ``decode_inconsistent_utf8`` (mojibake whose
bytes were THEMSELVES corrupted — e.g. a lost 0xA0 byte — stays broken
rather than guessed); the badness model is the conservative acceptance rule
in (3) plus a script guard on two-letter spans (see ``_repair_span``), so
ambiguous short spans that ftfy's trained heuristics would flip (e.g.
isolated ``"Ã"`` with no continuation char, or same-script pairs like
``"Рі"``) pass through unchanged;
``uncurl_quotes`` follows the table (ftfy 6 is table-based too).
"""

from __future__ import annotations

import html
import re
import unicodedata

# --- translation table: quotes, ligatures, line breaks, width -------------

_QUOTES = {
    "‘": "'", "’": "'", "‚": "'", "‛": "'",
    "“": '"', "”": '"', "„": '"', "‟": '"',
    "′": "'", "″": '"',
}
_LIGATURES = {
    "ﬀ": "ff", "ﬁ": "fi", "ﬂ": "fl",
    "ﬃ": "ffi", "ﬄ": "ffl", "ﬅ": "st", "ﬆ": "st",
    "Ĳ": "IJ", "ĳ": "ij",
}
_LINE_BREAKS = {" ": "\n", " ": "\n", "\x85": "\n"}

# Character width: the whole Halfwidth/Fullwidth Forms block through NFKC
# (ftfy builds its WIDTH_MAP the same way), plus ideographic space. The
# halfwidth voiced-sound marks map to COMBINING marks so a preceding kana
# composes under the final NFC (ftfy special-cases these identically).
_WIDTH = {}
for _cp in range(0xFF01, 0xFFEF):
    _c = chr(_cp)
    _n = unicodedata.normalize("NFKC", _c)
    if _n != _c:
        _WIDTH[_c] = _n
_WIDTH["　"] = " "
_WIDTH["ﾞ"] = "゙"  # halfwidth voiced mark -> combining
_WIDTH["ﾟ"] = "゚"  # halfwidth semi-voiced mark -> combining

_TRANSLATE = str.maketrans({**_QUOTES, **_LIGATURES, **_LINE_BREAKS, **_WIDTH})

# ftfy's control-character table (fixes.remove_control_chars): C0 minus
# \t \n \f \r, DEL, deprecated format characters, ZWNBSP/BOM, interlinear
# annotation characters.
_CONTROL_CHARS = {}
for _cp in (*range(0x00, 0x09), 0x0B, *range(0x0E, 0x20), 0x7F,
            *range(0x206A, 0x2070), 0xFEFF, *range(0xFFF9, 0xFFFD)):
    _CONTROL_CHARS[_cp] = None

# --- mojibake repair -------------------------------------------------------

# char -> byte maps per source codepage, "sloppy" convention: bytes the
# codepage leaves undefined decode to their raw codepoint (how mojibake text
# actually carries them; ftfy's sloppy-windows-125x codecs).


def _sloppy_map(encoding: str) -> dict:
    m = {}
    for b in range(256):
        try:
            m[bytes([b]).decode(encoding)] = b
        except UnicodeDecodeError:
            m[chr(b)] = b
    return m


# priority order = ftfy's CHARMAP_ENCODINGS (latin-1 handled by the 1252
# sloppy map's superset behavior EXCEPT where 1252 redefines 0x80-0x9F, so
# keep both)
_ENCODINGS = [
    ("sloppy-windows-1252", _sloppy_map("cp1252")),
    ("latin-1", {chr(b): b for b in range(256)}),
    ("sloppy-windows-1251", _sloppy_map("cp1251")),
    ("macroman", _sloppy_map("macroman")),
    ("cp437", _sloppy_map("cp437")),
]

# Mojibake span detector: every byte of a UTF-8 multibyte sequence is
# >= 0x80, so a mis-decoded sequence is a run of characters that map to
# high bytes under at least one source codepage. Runs of length >= 2 are
# candidates; structural validity is enforced by the UTF-8 decode.
_HIGH_CHARS = sorted(
    {c for _, m in _ENCODINGS for c, b in m.items() if b >= 0x80}
)
_SPAN_RE = re.compile("[" + re.escape("".join(_HIGH_CHARS)) + "]{2,}")

_NONASCII = re.compile(r"[^\x00-\x7f]")
_BAD_CATEGORIES = ("Cc", "Cn", "Co", "Cs")


def _introduces_junk(candidate: str) -> bool:
    return any(
        ord(c) > 0x7F and unicodedata.category(c) in _BAD_CATEGORIES
        for c in candidate
    )


def _script(c: str) -> str:
    try:
        return unicodedata.name(c).split(" ", 1)[0]
    except ValueError:
        return ""


def _repair_span(span: str) -> str:
    """Try each source codepage; accept the first (priority order) whose
    re-encoded bytes decode as complete valid UTF-8, shrink the non-ASCII
    count, and introduce no junk characters.

    Two-char ALL-LETTER spans are plausible real text (``"Рі"`` — Ukrainian
    R+i — whose cp1251 bytes happen to form valid UTF-8 for ``"г"``), so
    they repair only when the candidate is a letter of a DIFFERENT script:
    cross-script flips like ``"Гј"`` → ``"ü"`` are overwhelmingly mojibake,
    same-script flips (``"Рі"`` → ``"г"``) and letter→symbol flips
    (``"Ві"`` → ``"³"``) are left alone. This is the cheap stand-in for
    ftfy's trained badness model (ADVICE r4)."""
    n_bad = len(_NONASCII.findall(span))
    two_letters = len(span) == 2 and all(
        unicodedata.category(c).startswith("L") for c in span
    )
    for _, charmap in _ENCODINGS:
        try:
            raw = bytes(charmap[c] for c in span)
        except KeyError:
            continue
        try:
            candidate = raw.decode("utf-8")
        except UnicodeDecodeError:
            continue
        if two_letters and not (
            len(candidate) == 1
            and unicodedata.category(candidate).startswith("L")
            and _script(candidate) not in (_script(span[0]), _script(span[1]))
        ):
            continue
        if (len(_NONASCII.findall(candidate)) < n_bad
                and not _introduces_junk(candidate)):
            return candidate
    return span


def _fix_encoding(text: str) -> str:
    for _ in range(3):  # double/triple-encoded mojibake heals iteratively
        fixed = _SPAN_RE.sub(lambda m: _repair_span(m.group()), text)
        if fixed == text:
            return fixed
        text = fixed
    return text


# --- the small fixers -------------------------------------------------------

_ENTITY_RE = re.compile(r"&(?:#\d{1,7}|#[xX][0-9A-Fa-f]{1,6}|[A-Za-z][0-9A-Za-z]{1,31});")
_TERMINAL_ESCAPE_RE = re.compile(r"\x1b\[((?:\d|;)*)([a-zA-Z])")
_C1_RE = re.compile("[\x80-\x9f]")
_C1_MAP = {}
for _b in range(0x80, 0xA0):
    try:
        _C1_MAP[chr(_b)] = bytes([_b]).decode("cp1252")
    except UnicodeDecodeError:
        pass  # the five undefined bytes stay as-is (sloppy convention)

_SURROGATE_PAIR_RE = re.compile(
    "[\ud800-\udbff][\udc00-\udfff]|[\ud800-\udfff]"
)


def _fix_surrogates(text: str) -> str:
    def join(m):
        s = m.group()
        if len(s) == 2:
            hi, lo = ord(s[0]), ord(s[1])
            return chr(0x10000 + ((hi - 0xD800) << 10) + (lo - 0xDC00))
        return "�"

    return _SURROGATE_PAIR_RE.sub(join, text)


def fix_text(text: str) -> str:
    """Deterministic ftfy.fix_text equivalent (see module docstring for the
    pass list and the remaining divergences)."""
    if _ENTITY_RE.search(text):
        text = _ENTITY_RE.sub(lambda m: html.unescape(m.group()), text)
    if "\x1b" in text:
        text = _TERMINAL_ESCAPE_RE.sub("", text)
    text = _fix_encoding(text)
    if _C1_RE.search(text):
        text = "".join(_C1_MAP.get(c, c) for c in text)
    if _SURROGATE_PAIR_RE.search(text):
        text = _fix_surrogates(text)
    text = text.translate(_TRANSLATE)
    text = text.translate(_CONTROL_CHARS)
    return unicodedata.normalize("NFC", text)
