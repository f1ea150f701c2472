"""The cxxnet ``k = v`` config dialect.

This module reimplements the exact tokenizer semantics of the reference
config reader (reference: src/utils/config.h:20-189) because the dialect
*is* the compatibility surface: existing ``.conf`` files must parse
identically.

Dialect rules (mirroring ConfigReaderBase::GetNextToken):

  * tokens are separated by spaces / tabs / newlines
  * ``#`` skips the rest of the line (comment)
  * ``"..."`` is a single-line quoted token; ``\\`` escapes the next char;
    a newline inside raises an error
  * ``'...'`` is a multi-line quoted token with the same escape rule
  * ``=`` is always its own token, even when glued to neighbours
  * a config entry is the token triple  NAME ``=`` VALUE on one line
    (quoted values may span lines); the first malformed or
    newline-interrupted triple stops parsing — the remainder of the file
    is ignored, exactly as the reference's ``Next()`` stops returning
    entries (a warning is emitted where the reference is silent)

Entries are returned in file order — order matters downstream
(iterator sectioning, netconfig mode, later-wins layer params).

This is the port's own copy of ``cxxnet_tpu/config.py`` (the port imports
nothing of the JAX package); keep the two in step.
"""

from __future__ import annotations

import io
import warnings
from typing import Iterator, List, Tuple

ConfigEntry = Tuple[str, str]


class ConfigError(ValueError):
    """Raised on malformed config input."""


def _tokenize(text: str) -> Iterator[Tuple[str, bool]]:
    """Yield ``(token, newline_before)`` pairs from ``text``.

    Mirrors reference src/utils/config.h:97-140 (GetNextToken) including
    quoted-string and comment handling. ``newline_before`` is True when a
    newline (or a comment, which consumes one) was skipped before the
    token started — the reference uses this flag to reject entries broken
    across lines.
    """
    i = 0
    n = len(text)
    tok: List[str] = []
    new_line = False

    def flush():
        if tok:
            out = "".join(tok)
            tok.clear()
            return out
        return None

    while i < n:
        ch = text[i]
        if ch == "#":
            # comment: skip to end of line, counts as a newline break
            out = flush()
            if out is not None:
                yield out, new_line
                new_line = False
            new_line = True
            while i < n and text[i] not in "\r\n":
                i += 1
        elif ch == '"' or ch == "'":
            if tok:
                raise ConfigError("ConfigReader: token followed directly by string")
            quote = ch
            i += 1
            s: List[str] = []
            closed = False
            while i < n:
                c = text[i]
                if c == "\\":
                    if i + 1 < n:
                        s.append(text[i + 1])
                    i += 2
                    continue
                if c == quote:
                    closed = True
                    i += 1
                    break
                if quote == '"' and c in "\r\n":
                    raise ConfigError("ConfigReader: unterminated string")
                s.append(c)
                i += 1
            if not closed:
                raise ConfigError("ConfigReader: unterminated string")
            yield "".join(s), new_line
            new_line = False
            continue
        elif ch == "=":
            out = flush()
            if out is not None:
                yield out, new_line
                new_line = False
            yield "=", new_line
            new_line = False
            i += 1
            continue
        elif ch in " \t\r\n":
            out = flush()
            if out is not None:
                yield out, new_line
                new_line = False
            if ch in "\r\n":
                new_line = True
            i += 1
            continue
        else:
            tok.append(ch)
            i += 1
            continue
        i += 1
    out = flush()
    if out is not None:
        yield out, new_line


def parse_string(text: str) -> List[ConfigEntry]:
    """Parse config text into an ordered list of ``(name, value)`` pairs.

    Mirrors the NAME = VALUE triple structure enforced by
    ConfigReaderBase::Next (reference src/utils/config.h:40-49): the name,
    ``=`` and value must appear on one line; the first malformed triple
    silently terminates parsing (we add a warning for debuggability).
    """
    toks = list(_tokenize(text))
    out: List[ConfigEntry] = []
    i = 0
    while i < len(toks):
        name, _ = toks[i]
        if name == "=":
            break
        if i + 2 >= len(toks):
            break
        eq, eq_nl = toks[i + 1]
        val, val_nl = toks[i + 2]
        if eq != "=" or eq_nl or val == "=" or val_nl:
            break
        out.append((name, val))
        i += 3
    if i < len(toks):
        warnings.warn(
            "ConfigReader: stopped at malformed entry near %r; the rest of "
            "the input is ignored (reference-compatible behavior)"
            % ([t for t, _ in toks[i : i + 3]],),
            stacklevel=2)
    return out


def parse_file(path: str) -> List[ConfigEntry]:
    """Parse a config file into ordered ``(name, value)`` pairs."""
    with io.open(path, "r", encoding="utf-8", errors="replace") as f:
        return parse_string(f.read())


def parse_cli_overrides(args: List[str]) -> List[ConfigEntry]:
    """Parse trailing ``k=v`` command-line overrides.

    Mirrors reference src/cxxnet_main.cpp:67-72: each argument of the form
    ``name=value`` becomes an entry appended after the file entries (so it
    wins for scalar keys that are read last-one-wins).
    """
    out: List[ConfigEntry] = []
    for a in args:
        if "=" in a:
            name, val = a.split("=", 1)
            if name and val:
                out.append((name, val))
    return out
