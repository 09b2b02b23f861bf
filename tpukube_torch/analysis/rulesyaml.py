"""A narrow YAML reader for PrometheusRule documents, so the rules-file
cross-check runs where no YAML library is installed.

It reads the subset ``deploy/prometheus-rules.yaml`` is written in:

  * block mappings of plain keys and block sequences (a ``- `` item
    may open a mapping on its own line, and a sequence may sit at its
    parent key's indentation);
  * plain scalars, resolved as PyYAML's ``safe_load`` resolves them
    (``core.config``'s resolver), and one-line quoted scalars;
  * ``>`` / ``|`` block scalars with ``-`` / ``+`` / clip chomping,
    folded exactly as PyYAML's scanner folds them (a more-indented line
    keeps its line breaks);
  * full-line and trailing comments, and ``---`` between documents.

Anything else — flow collections, anchors, aliases, tags, multi-line
plain scalars, explicit indentation indicators, complex keys, a line
indented where no node may start, a key given twice — raises
``ValueError`` naming the line. The reader never skips what it cannot
read: a cross-check over a document it read only in part would pass on
nothing.
"""

from __future__ import annotations

import re
from typing import Any, Optional

from tpukube_torch.core.config import _y_plain, _y_quoted

_BLOCK_HEADER = re.compile(r"([>|])([-+]?)[ \t]*(?:#.*)?")
# a comment starts at '#' after whitespace (or at the text's start)
_COMMENT = re.compile(r"(?:^|[ \t])#")
_INDICATORS = "{[&*!%@`,]}"


def _indent(raw: str) -> int:
    return len(raw) - len(raw.lstrip(" "))


def _blank(raw: str) -> bool:
    s = raw.strip()
    return not s or s.startswith("#")


class _Doc:
    """One document's lines and a cursor over them."""

    def __init__(self, lines: list[str], first: int, ends_nl: bool,
                 where: str):
        self.lines = lines
        self.first = first      # 1-based number of lines[0] in the file
        self.ends_nl = ends_nl  # the last line ends with a line break
        self.where = where
        self.i = 0

    def _err(self, msg: str, i: Optional[int] = None) -> ValueError:
        n = self.first + (self.i if i is None else i)
        return ValueError(f"{self.where}:{n}: {msg}")

    def _skip(self) -> None:
        while self.i < len(self.lines) and _blank(self.lines[self.i]):
            self.i += 1

    def _at(self) -> Optional[tuple[int, str]]:
        """(indent, content) of the next non-blank line, or None."""
        self._skip()
        if self.i >= len(self.lines):
            return None
        raw = self.lines[self.i]
        if "\t" in raw[:_indent(raw) + 1]:
            raise self._err("a tab in the indentation")
        return _indent(raw), raw.lstrip(" ")

    def root(self) -> Any:
        at = self._at()
        if at is None:
            return None
        value = self._node(at[0])
        if self._at() is not None:
            raise self._err("a line outside the document's structure")
        return value

    # -- nodes -------------------------------------------------------------
    def _node(self, col: int) -> Any:
        ind, content = self._at()
        if _is_item(content):
            return self._seq(ind)
        if self._split_key(content) is None:
            raise self._err("a multi-line plain scalar or a bare value")
        return self._map(ind)

    def _seq(self, col: int) -> list:
        out: list = []
        while True:
            at = self._at()
            if at is None or at[0] < col:
                return out
            ind, content = at
            if ind > col:
                raise self._err("a line indented where no node may start")
            if not _is_item(content):
                return out
            body = content[1:]
            pad = len(body) - len(body.lstrip(" "))
            body = body.lstrip(" ")
            if not body or body.startswith("#"):
                self.i += 1
                out.append(self._nested(col, seq_at_col=False))
            elif _is_item(body):
                raise self._err("a sequence nested on one line")
            elif self._split_key(body) is not None:
                # "- key: value" opens a mapping at the key's column
                self.lines[self.i] = " " * (col + 1 + pad) + body
                out.append(self._map(col + 1 + pad))
            else:
                out.append(self._value(body, col))

    def _map(self, col: int) -> dict:
        out: dict = {}
        while True:
            at = self._at()
            if at is None or at[0] < col:
                return out
            ind, content = at
            if ind > col:
                raise self._err("a line indented where no node may start")
            if _is_item(content):
                return out
            split = self._split_key(content)
            if split is None:
                raise self._err("a multi-line plain scalar or a bare value")
            key, rest = split
            if key in out:
                raise self._err(f"key {key!r} given twice")
            out[key] = self._value(rest, col)

    def _split_key(self, content: str) -> Optional[tuple[Any, str]]:
        """(key, the text after ``key:``) when ``content`` is a mapping
        entry; None when it is not one."""
        m = _COMMENT.search(content)
        text = content[:m.start()] if m else content
        for j, ch in enumerate(text):
            if ch == ":" and (j + 1 == len(text) or text[j + 1] in " \t"):
                raw_key = text[:j].strip()
                break
        else:
            return None
        if not raw_key or raw_key[0] in _INDICATORS + "'\"?|>#-":
            raise self._err(f"a key form the reader does not support "
                            f"({raw_key!r})")
        key = _y_plain(raw_key, self._where())
        if not isinstance(key, str):
            raise self._err(f"a key that is not a string ({raw_key!r})")
        return key, content[j + 1:]

    def _where(self) -> str:
        return f"{self.where}:{self.first + self.i}"

    def _nested(self, col: int, seq_at_col: bool) -> Any:
        """The node under a key (or item) with no value on its line: a
        more-indented node, an indentless sequence, or a null."""
        at = self._at()
        if at is not None and at[0] > col:
            return self._node(at[0])
        if seq_at_col and at is not None and at[0] == col \
                and _is_item(at[1]):
            return self._seq(col)
        return None

    def _value(self, text: str, col: int) -> Any:
        """The value after ``key:`` (or ``- ``) on the current line; the
        cursor moves past what it reads."""
        text = text.strip(" ")
        if not text or text.startswith("#"):
            self.i += 1
            return self._nested(col, seq_at_col=True)
        if text[0] in ">|":
            return self._block_scalar(text, col)
        if text[0] in "'\"":
            value, rest = _y_quoted(text, self._where())
            if rest.strip() and not rest.strip().startswith("#"):
                raise self._err(f"text after a quoted scalar ({rest!r})")
            self.i += 1
            return value
        m = _COMMENT.search(text)
        plain = (text[:m.start()] if m else text).strip()
        if plain[:2] in ("- ", "? ", ": ") or plain in ("-", "?", ":"):
            raise self._err("a block indicator inside a value")
        if plain[0] in _INDICATORS:
            raise self._err(f"{plain[0]!r} starts a form the reader does "
                            f"not support (flow collections, anchors, "
                            f"aliases, tags)")
        if re.search(r":[ \t]|:$", plain):
            raise self._err("a mapping inside a plain scalar")
        self.i += 1
        at = self._at()
        if at is not None and at[0] > col and not (
                _is_item(at[1]) or self._split_key(at[1]) is not None):
            raise self._err("a multi-line plain scalar")
        return _y_plain(plain, self._where())

    def _block_scalar(self, header: str, col: int) -> str:
        """A ``>``/``|`` scalar, read line for line as PyYAML's scanner
        (``scan_block_scalar``) reads it."""
        m = _BLOCK_HEADER.fullmatch(header)
        if m is None:
            raise self._err(f"a block scalar header the reader does not "
                            f"support ({header!r})")
        folded, chomp = m.group(1) == ">", m.group(2)
        self.i += 1
        lines, n = self.lines, len(self.lines)
        j = self.i
        while j < n and not lines[j].strip(" "):
            j += 1
        if j == n or _indent(lines[j]) <= col:
            raise self._err("an empty block scalar")
        indent = _indent(lines[j])
        if any(len(lines[k]) > indent for k in range(self.i, j)):
            raise self._err("a leading blank line indented past the text")

        def breaks_from(i: int) -> tuple[list[str], int]:
            out = []
            while i < n and not lines[i].strip(" ") and \
                    len(lines[i]) <= indent:
                out.append("\n")
                i += 1
            return out, i

        def line_break(i: int) -> str:
            return "\n" if i + 1 < n or self.ends_nl else ""

        breaks, i = breaks_from(self.i)
        chunks: list[str] = []
        brk = ""
        while i < n and _indent(lines[i]) >= indent:
            chunks.extend(breaks)
            text = lines[i][indent:]
            if "\t" in lines[i][:indent]:
                raise self._err("a tab in a block scalar's indentation", i)
            leading_non_space = text[:1] not in (" ", "\t")
            chunks.append(text)
            brk = line_break(i)
            breaks, i = breaks_from(i + 1)
            if i < n and _indent(lines[i]) >= indent:
                nxt = lines[i][indent:indent + 1]
                if folded and brk == "\n" and leading_non_space \
                        and nxt not in (" ", "\t"):
                    if not breaks:
                        chunks.append(" ")
                else:
                    chunks.append(brk)
        if chomp != "-":
            chunks.append(brk)
        if chomp == "+":
            chunks.extend(breaks)
        self.i = i
        return "".join(chunks)


def _is_item(content: str) -> bool:
    return content == "-" or content.startswith(("- ", "-\t"))


def load_all(text: str, where: str = "<rules>") -> list[Any]:
    """Every document of ``text``, as ``yaml.safe_load_all`` would give
    them for the subset above; ``ValueError`` on anything outside it."""
    ends_nl = text.endswith("\n")
    lines = text.split("\n")
    if ends_nl:
        lines.pop()
    lines = [ln.rstrip("\r") for ln in lines]
    for n, ln in enumerate(lines, 1):
        if ln.startswith(("%", "...")):
            raise ValueError(f"{where}:{n}: directives and document ends "
                             f"are not supported")
        if ln.startswith("---") and ln.rstrip(" ") != "---" and \
                not re.fullmatch(r"---[ \t]+#.*", ln):
            raise ValueError(f"{where}:{n}: content on a --- line is not "
                             f"supported")
    starts = [n for n, ln in enumerate(lines)
              if ln.startswith("---")]
    segments = []
    prev = 0
    for s in starts:
        segments.append((prev, s))
        prev = s + 1
    segments.append((prev, len(lines)))
    docs = []
    for k, (lo, hi) in enumerate(segments):
        body = lines[lo:hi]
        if k == 0 and all(_blank(ln) for ln in body):
            continue  # comments before the first --- (or an empty stream)
        doc = _Doc(body, lo + 1, ends_nl or hi < len(lines), where)
        docs.append(doc.root())
    return docs
