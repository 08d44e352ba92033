"""ftfy-equivalent text repair for web-scraped captions.

Pure-Python port of ``colxlip_tpu/data/textfix.py`` (kept line for line: the
tokenizer's ids must match the JAX package's exactly, and importing the JAX
package would pull in jax).

The reference's tokenizer chains ``ftfy.fix_text`` in ``basic_clean``
(open_clip tokenizer, imported at reference factory.py:31) before BPE.
Web-scraped caption corpora (CC3M/CC12M/YFCC) are full of mojibake — UTF-8
bytes that were wrongly decoded as cp1252/Latin-1 somewhere in the scrape
pipeline — and ftfy repairs them; without the repair, tokenization diverges
from the reference on those samples (a silent parity tax on training AND
eval). ftfy itself is not installable offline, so this module implements the
subset of its default fixer pipeline that affects CLIP tokenization:

  1. HTML entity unescape when the text looks escaped (unescape_html='auto')
  2. terminal/ANSI escape removal
  3. **mojibake repair** (fix_encoding): re-encode through sloppy-cp1252 /
     Latin-1 and decode as UTF-8, accepted only when the whole segment
     round-trips cleanly — applied iteratively, so double-encoded text
     ("Ã¢â‚¬â„¢") also repairs; mixed clean/mojibake strings repair
     per whitespace segment
  4. UTF-16 surrogate-pair recombination (fix_surrogates)
  5. Latin ligature expansion (ﬁ→fi), fullwidth→ASCII character width,
     curly-quote uncurling (ftfy defaults: fix_latin_ligatures,
     fix_character_width, uncurl_quotes)
  6. line-break normalization to \\n, control/format char removal
  7. NFC normalization

Each transform mirrors the documented behavior of ftfy 6.x's defaults (the
version the reference environment resolves). Divergences are conservative:
the mojibake heuristic requires a full clean UTF-8 round-trip of the
segment, so plausible-but-unlikely repairs ftfy's badness scorer might
accept are left untouched rather than risk corrupting clean text.
"""
from __future__ import annotations

import html
import re
import unicodedata

# ---------------------------------------------------------------------------
# sloppy-cp1252: cp1252 with the five unmapped bytes (0x81 0x8D 0x8F 0x90
# 0x9D) passing through as the corresponding C1 control codepoints — ftfy's
# "sloppy-windows-1252" codec, which is what real-world wrong decodes produce
# (browsers and Python's whatwg-aligned cp1252 both behave this way).
# ---------------------------------------------------------------------------
_SLOPPY_HOLES = {0x81, 0x8D, 0x8F, 0x90, 0x9D}
_CP1252_DECODE = {}
for _b in range(256):
    if _b in _SLOPPY_HOLES:
        _CP1252_DECODE[_b] = chr(_b)
    else:
        _CP1252_DECODE[_b] = bytes([_b]).decode("cp1252")
_CP1252_ENCODE = {c: b for b, c in _CP1252_DECODE.items()}


def _encode_sloppy_cp1252(text: str) -> bytes | None:
    out = bytearray()
    for ch in text:
        b = _CP1252_ENCODE.get(ch)
        if b is None:
            return None
        out.append(b)
    return bytes(out)


def _encode_latin1(text: str) -> bytes | None:
    try:
        return text.encode("latin-1")
    except UnicodeEncodeError:
        return None


# Mojibake-sequence detector (ftfy's UTF8_DETECTOR_RE approach): runs of
# chars whose byte values under sloppy-cp1252 (or, for the C1 controls a
# latin-1 wrong decode produces, their codepoints) form STRUCTURALLY VALID
# UTF-8 sequences. Substituting just the matches repairs strings that mix
# clean non-ASCII with mojibake ("l'humanit\xc3\xa9") where a whole-string
# round-trip cannot.
def _byte_of(ch: str):
    b = _CP1252_ENCODE.get(ch)
    if b is not None:
        return b
    o = ord(ch)
    return o if o < 0x100 else None


def _char_class(byte_range) -> str:
    chars = set()
    for b in byte_range:
        chars.add(_CP1252_DECODE[b])   # cp1252 wrong decode
        chars.add(chr(b))              # latin-1 wrong decode (C1 controls)
    return "".join(re.escape(c) for c in sorted(chars))


_CONT = _char_class(range(0x80, 0xC0))
_UTF8_SEQ = re.compile(
    "(?:[%s][%s]|[%s][%s]{2}|[%s][%s]{3})+" % (
        _char_class(range(0xC2, 0xE0)), _CONT,
        _char_class(range(0xE0, 0xF0)), _CONT,
        _char_class(range(0xF0, 0xF5)), _CONT,
    )
)

# Plausibility gate on DECODED text (the role of ftfy's badness scorer):
# a structurally valid decode can still be a false positive on legitimate
# text — e.g. German '\xdf' + curly quote decodes to an NKo letter — so a
# repair is only accepted when every decoded char lands in a script/symbol
# range that plausibly appears in web captions.
_PLAUSIBLE_RANGES = (
    (0x20, 0x7E),      # ASCII
    (0x80, 0x9F),      # C1 controls: multi-round mojibake intermediates
                       # (consumed by the next decode round; any leftovers
                       # are stripped by _remove_control_chars at the end)
    (0xA0, 0x24F),     # Latin-1 supplement + Latin extended A/B
    (0x2B0, 0x2FF),   # spacing modifiers (cp1252 has U+02C6, U+02DC)
    (0x300, 0x36F),    # combining diacritics
    (0x370, 0x5FF),    # Greek, Cyrillic supplements start, Armenian, Hebrew
    (0x600, 0x6FF),    # Arabic
    (0x900, 0x97F),    # Devanagari
    (0xE00, 0xE7F),    # Thai
    (0x1E00, 0x1FFF),  # Latin ext additional, Greek extended
    (0x2000, 0x206F),  # general punctuation (curly quotes, dashes)
    (0x20A0, 0x20CF),  # currency
    (0x2100, 0x214F),  # letterlike (TM)
    (0x2190, 0x22FF),  # arrows, math
    (0x2500, 0x27BF),  # shapes, misc symbols, dingbats
    (0x3000, 0x30FF),  # CJK punctuation, kana
    (0x3400, 0x9FFF),  # CJK
    (0xAC00, 0xD7AF),  # Hangul
    (0xF900, 0xFAFF),  # CJK compat
    (0xFE0E, 0xFE0F),  # variation selectors (emoji)
    (0xFF01, 0xFF60),  # fullwidth forms
    (0x1F000, 0x1FAFF),  # emoji
    (0x200D, 0x200D),  # ZWJ
)


def _plausible(s: str) -> bool:
    return all(
        any(a <= ord(c) <= b for a, b in _PLAUSIBLE_RANGES) or c in "\t\n"
        for c in s
    )


def _repair_match(m: "re.Match") -> str:
    seq = m.group()
    data = bytes(_byte_of(c) for c in seq)
    try:
        fixed = data.decode("utf-8")
    except UnicodeDecodeError:   # overlong/surrogate/out-of-range encodings
        return seq
    return fixed if _plausible(fixed) else seq


def fix_encoding(text: str) -> str:
    """Repair UTF-8-decoded-as-cp1252/Latin-1 mojibake (ftfy fix_encoding):
    substitute every structurally-valid-and-plausible UTF-8-as-cp1252 run.
    Clean text (even non-ASCII) passes through: legitimate chars only form
    matches in rare lead+continuation adjacencies, and those are then
    rejected by the plausibility gate unless the decode looks like real
    language."""
    if not _UTF8_SEQ.search(text):
        return text
    return _UTF8_SEQ.sub(_repair_match, text)


# ---------------------------------------------------------------------------
# the character-level fixes (ftfy defaults that change tokenization)
# ---------------------------------------------------------------------------
_LIGATURES = {
    "Ĳ": "IJ", "ĳ": "ij",
    "ﬀ": "ff", "ﬁ": "fi", "ﬂ": "fl",
    "ﬃ": "ffi", "ﬄ": "ffl", "ﬅ": "st", "ﬆ": "st",
}
_UNCURL = {
    "‘": "'", "’": "'", "‚": "'", "‛": "'",
    "“": '"', "”": '"', "„": '"', "‟": '"',
}
_LINE_BREAKS = {
    "\r\n": "\n", "\r": "\n",
    "\u2028": "\n", "\u2029": "\n", "\x85": "\n",
}
_TERMINAL_ESCAPE = re.compile(r"\x1b\[[\x30-\x3f]*[\x20-\x2f]*[\x40-\x7e]")
_ENTITY_HINT = re.compile(r"&(#\d+|#[xX][0-9a-fA-F]+|[a-zA-Z][a-zA-Z0-9]*);")
_SURROGATE_PAIR = re.compile("[\ud800-\udbff][\udc00-\udfff]")
_LONE_SURROGATE = re.compile("[\ud800-\udfff]")

_CHAR_FIX = str.maketrans({**_LIGATURES, **_UNCURL})


def fix_surrogates(text: str) -> str:
    if not _LONE_SURROGATE.search(text):
        return text
    text = _SURROGATE_PAIR.sub(
        lambda m: chr(0x10000 + ((ord(m.group()[0]) - 0xD800) << 10)
                      + (ord(m.group()[1]) - 0xDC00)),
        text,
    )
    return _LONE_SURROGATE.sub("�", text)


def _fix_character_width(text: str) -> str:
    """Fullwidth/halfwidth forms -> ASCII (ftfy fix_character_width: NFKC
    limited to the width-variant blocks, keeping other NFKC changes out)."""
    if not any("！" <= c <= "￮" for c in text):
        return text
    return "".join(
        unicodedata.normalize("NFKC", c) if "！" <= c <= "￮" else c
        for c in text
    )


# candidates for control removal: Cc plus the Cf ranges. Gates the per-char
# category() scan, which is too slow for the per-caption hot path.
_CONTROL_HINT = re.compile(
    "[\x00-\x08\x0b-\x1f\x7f-\x9f\u00ad\u0600-\u0605\u061c\u06dd"
    "\u070f\u08e2\u180e\u200b\u200e\u200f\u202a-\u202e\u2060-\u2064"
    "\u2066-\u206f\ufeff\ufff9-\ufffb\U000110bd\U000110cd"
    "\U0001bca0-\U0001bca3\U0001d173-\U0001d17a\U000e0001"
    "\U000e0020-\U000e007f]")


def _remove_control_chars(text: str) -> str:
    """Drop Cc (except \\t \\n) and ignorable Cf chars (ZWSP, BOM,
    directional marks) like ftfy's remove_control_chars. ZWJ/ZWNJ stay —
    they are meaningful joiners (emoji sequences, Indic scripts)."""
    if not _CONTROL_HINT.search(text):
        return text
    return "".join(
        c for c in text
        if c in "\t\n\u200c\u200d"
        or unicodedata.category(c) not in ("Cc", "Cf")
    )


# clean printable ASCII without '&' (entities): fix_text is an exact no-op
# on it — the overwhelmingly common case on caption corpora (hot path)
_ASCII_NOOP = re.compile(r"^[\x20-\x25\x27-\x7e\t\n]*$")


def fix_text(text: str, max_passes: int = 5) -> str:
    """The ftfy.fix_text equivalent.

    Encoding repair runs to convergence FIRST (like ftfy's internal
    fix_encoding loop): multi-round mojibake leaves C1 control characters
    as intermediate artifacts, so control removal or NFC before convergence
    would destroy the bytes later rounds need. Char-level fixes follow.
    """
    if _ASCII_NOOP.match(text):
        return text
    if "&" in text and _ENTITY_HINT.search(text):
        text = html.unescape(text)
    if "\x1b" in text:
        text = _TERMINAL_ESCAPE.sub("", text)
    for _ in range(max_passes):
        fixed = fix_encoding(text)
        if fixed == text:
            break
        text = fixed
    text = fix_surrogates(text)
    text = text.translate(_CHAR_FIX)
    text = _fix_character_width(text)
    for src, dst in _LINE_BREAKS.items():
        if src in text:
            text = text.replace(src, dst)
    text = _remove_control_chars(text)
    return unicodedata.normalize("NFC", text)
