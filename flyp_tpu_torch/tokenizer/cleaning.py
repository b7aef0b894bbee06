"""Caption text cleaning with ftfy semantics.

The reference tokenizer unconditionally runs ``ftfy.fix_text`` on every
caption before BPE (`clip/tokenizer.py:50-60,129-131`), so
real-world captions (LAION mojibake, curly quotes, decomposed accents,
HTML entities) must clean identically here or token ids diverge from the
reference.  This module exposes one function, :func:`fix_text`:

- when ftfy is installed (declared in ``pyproject.toml``) it IS
  ``ftfy.fix_text`` — exact by construction;
- otherwise a dependency-free fallback reproduces ftfy's default pipeline
  on the caption domain, in ftfy's documented fix order
  (``ftfy.fix_text_segment``): HTML unescape (auto), terminal-escape
  removal, encoding (mojibake) repair, C1-control decoding, Latin-ligature
  expansion, character-width normalization, quote uncurling, line-break
  normalization, control-char removal, NFC normalization.

The fallback's mojibake repair is deliberately more conservative than
ftfy's badness-scored search: it only rewrites when the *entire* string
round-trips sloppy-windows-1252 -> UTF-8 and shrinks, which covers the
common single- and double-encoded caption cases and never touches clean
text.  Golden fixtures generated from real ftfy behavior pin the fallback
in ``tests/test_tokenizer.py``.
"""

from __future__ import annotations

import html
import re
import unicodedata

try:  # pragma: no cover - exercised when the declared dependency is present
    import ftfy as _ftfy

    HAVE_FTFY = True
except Exception:  # pragma: no cover
    _ftfy = None
    HAVE_FTFY = False


# --- fallback pieces (ftfy.fixes equivalents on the caption domain) --------

_TERMINAL_ESCAPE_RE = re.compile(r"\x1b\[[0-9;]*[a-zA-Z]")

# Windows-1252's 0x80-0x9F graphic characters (the bytes Latin-1 leaves as C1
# controls).  Used both to *encode* sloppily (char -> byte) for mojibake
# repair and to *decode* stray C1 controls the way ftfy's fix_c1_controls does.
_CP1252_EXTRA = {
    0x80: "€", 0x82: "‚", 0x83: "ƒ", 0x84: "„",
    0x85: "…", 0x86: "†", 0x87: "‡", 0x88: "ˆ",
    0x89: "‰", 0x8a: "Š", 0x8b: "‹", 0x8c: "Œ",
    0x8e: "Ž", 0x91: "‘", 0x92: "’", 0x93: "“",
    0x94: "”", 0x95: "•", 0x96: "–", 0x97: "—",
    0x98: "˜", 0x99: "™", 0x9a: "š", 0x9b: "›",
    0x9c: "œ", 0x9e: "ž", 0x9f: "Ÿ",
}
_CP1252_BACK = {ch: b for b, ch in _CP1252_EXTRA.items()}

_CURLY_QUOTES = {"‘": "'", "’": "'", "“": '"', "”": '"'}

_LIGATURES = {
    "Ĳ": "IJ", "ĳ": "ij",
    "ﬀ": "ff", "ﬁ": "fi", "ﬂ": "fl",
    "ﬃ": "ffi", "ﬄ": "ffl", "ﬅ": "st", "ﬆ": "st",
}

_LINE_BREAKS = {
    # NB: no "\x85" (NEL) entry \u2014 _fix_c1_controls runs first (ftfy's fix
    # order) and maps every C1 control through cp1252, so 0x85 becomes "\u2026"
    # before line-break translation could ever see it.
    "\r\n": "\n", "\r": "\n",
    "\u2028": "\n", "\u2029": "\n",
    "\v": "\n", "\f": "\n",
}

# ftfy's CONTROL_CHARS table: C0 controls except \t \n \f \r, DEL, interlinear
# annotation chars, BOM/ZWNBSP, and the FFF9-FFFB annotation block.
_CONTROL_CHARS = frozenset(
    [chr(c) for c in range(0x00, 0x09)]
    + ["\x0b"]
    + [chr(c) for c in range(0x0E, 0x20)]
    + ["\x7f"]
    + [chr(c) for c in range(0x206A, 0x2070)]
    + ["\ufeff"]
    + [chr(c) for c in range(0xFFF9, 0xFFFC)]
)


def _sloppy_cp1252_bytes(text: str) -> bytes | None:
    """Encode as sloppy-windows-1252: cp1252 graphics where defined, raw
    Latin-1 bytes otherwise; None when any char has no single-byte form."""
    out = bytearray()
    for ch in text:
        b = _CP1252_BACK.get(ch)
        if b is not None:
            out.append(b)
            continue
        o = ord(ch)
        if o < 0x100:
            out.append(o)
        else:
            return None
    return bytes(out)


def _fix_encoding_once(text: str) -> str:
    if text.isascii():
        return text
    raw = _sloppy_cp1252_bytes(text)
    if raw is None:
        return text
    try:
        decoded = raw.decode("utf-8")
    except UnicodeDecodeError:
        return text
    # A genuine multi-byte UTF-8 sequence always shrinks; requiring it keeps
    # clean Latin-1 text (which is valid ASCII-only UTF-8 never) untouched.
    if len(decoded) < len(text):
        return decoded
    return text


def _fix_encoding(text: str) -> str:
    for _ in range(3):  # double-encoded mojibake needs two passes
        fixed = _fix_encoding_once(text)
        if fixed == text:
            return text
        text = fixed
    return text


def _fix_c1_controls(text: str) -> str:
    if any(0x80 <= ord(c) <= 0x9F for c in text):
        return "".join(_CP1252_EXTRA.get(ord(c), c) if 0x80 <= ord(c) <= 0x9F else c for c in text)
    return text


def _fix_character_width(text: str) -> str:
    # NFKC on the Halfwidth and Fullwidth Forms block only (ftfy's WIDTH_MAP).
    return "".join(
        unicodedata.normalize("NFKC", c) if 0xFF01 <= ord(c) <= 0xFFEE else c for c in text
    )


def _translate(text: str, table: dict) -> str:
    for src, dst in table.items():
        if src in text:
            text = text.replace(src, dst)
    return text


def _fix_text_fallback(text: str) -> str:
    if "<" not in text:  # ftfy's unescape_html="auto" heuristic
        text = html.unescape(text)
    text = _TERMINAL_ESCAPE_RE.sub("", text)
    text = _fix_encoding(text)
    text = _fix_c1_controls(text)
    text = _translate(text, _LIGATURES)
    text = _fix_character_width(text)
    text = _translate(text, _CURLY_QUOTES)
    text = _translate(text, _LINE_BREAKS)
    text = "".join(c for c in text if c not in _CONTROL_CHARS)
    return unicodedata.normalize("NFC", text)


def fix_text(text: str) -> str:
    """``ftfy.fix_text`` when installed, the faithful fallback otherwise."""
    if HAVE_FTFY:
        return _ftfy.fix_text(text)
    return _fix_text_fallback(text)
