"""YAML + CLI-override config system (the port's own copy of
llm_guided_asr_tpu/utils/config.py).

A YAML file is the base, ``--key value`` flags override top-level keys,
``--key_conf sub=val`` (or ``--key_conf '{yaml}'``) patches nested dicts;
the resolved config is dumped to ``<output_dir>/config.yaml``, the one
artifact needed to rebuild the model at inference.

The port reads and writes YAML itself (:func:`load_yaml`,
:func:`dump_yaml`, :func:`loads_yaml`, :func:`dumps_yaml`), with the
standard library only.  It covers the subset that ``yaml.safe_dump``
writes and ESPnet configs use: block mappings and sequences (nested,
sequences of sequences, a sequence at its key's indent), flow sequences and
mappings, plain, single- and double-quoted scalars over several lines
(folded as YAML folds them; double quotes with every escape), comments,
and one document.  Plain scalars resolve as PyYAML's YAML 1.1 resolver
resolves them, since the JAX package's configs come from it: ``1e-3`` is a
string (a float needs a dot and a signed exponent), ``1.0e-3`` a float,
``yes``/``no``/``on``/``off`` booleans, ``017`` octal, ``0x1f`` hex, ``0o7``
a string, ``~``/``null``/empty None.  Anchors, aliases, tags, block
scalars (``|``, ``>``), directives, several documents, complex keys,
timestamps and the merge key raise :class:`YAMLUnsupported` naming the
line; malformed text raises :class:`YAMLError`.
"""

from __future__ import annotations

import copy
import dataclasses
import logging
import math
import re
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# YAML: scalar resolution (PyYAML's YAML 1.1 implicit resolvers)
# ---------------------------------------------------------------------------

class YAMLError(ValueError):
    """Malformed YAML (where PyYAML raises a YAMLError)."""


class YAMLUnsupported(YAMLError):
    """Valid YAML outside the subset the port reads."""


_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)
# first characters for which each resolver is tried (PyYAML keys them so)
_FIRST = {"bool": "yYnNtTfFoO", "float": "-+0123456789.", "int": "-+0123456789",
          "null": "~nN", "timestamp": "0123456789"}


def _sexagesimal(value: str, cast):
    digits = [cast(part) for part in value.split(":")]
    digits.reverse()
    base, out = 1, 0
    for d in digits:
        out += d * base
        base *= 60
    return out


def _construct_int(value: str) -> int:
    value = value.replace("_", "")
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == "0":
        return 0
    if value.startswith("0b"):
        return sign * int(value[2:], 2)
    if value.startswith("0x"):
        return sign * int(value[2:], 16)
    if value[0] == "0":
        return sign * int(value, 8)
    if ":" in value:
        return sign * _sexagesimal(value, int)
    return sign * int(value)


def _construct_float(value: str) -> float:
    value = value.replace("_", "").lower()
    sign = -1.0 if value[0] == "-" else 1.0
    if value[0] in "+-":
        value = value[1:]
    if value == ".inf":
        return sign * math.inf
    if value == ".nan":
        return math.nan
    if ":" in value:
        return sign * _sexagesimal(value, float)
    return sign * float(value)


_TIMESTAMP_SENTINEL = object()


def _resolve_plain(text: str):
    """A plain scalar's value as PyYAML's SafeLoader constructs it; the
    timestamp sentinel where it would construct a date."""
    first = text[:1]
    if first == "" or (first in _FIRST["null"] and _NULL.match(text)):
        return None
    if first in _FIRST["bool"] and _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if first in _FIRST["float"] and _FLOAT.match(text):
        return _construct_float(text)
    if first in _FIRST["int"] and _INT.match(text):
        return _construct_int(text)
    if first in _FIRST["timestamp"] and _TIMESTAMP.match(text):
        return _TIMESTAMP_SENTINEL
    return text


# ---------------------------------------------------------------------------
# YAML: reader
# ---------------------------------------------------------------------------

_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t", "n": "\n",
            "v": "\x0b", "f": "\x0c", "r": "\r", "e": "\x1b", " ": " ", '"': '"',
            "/": "/", "\\": "\\", "N": "\x85", "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_ESCAPE_CODES = {"x": 2, "u": 4, "U": 8}
_UNSUPPORTED_START = {"&": "anchors", "*": "aliases", "!": "tags", "|": "block scalars",
                      ">": "block scalars", "%": "directives", "?": "complex keys"}
_RESERVED_START = "@`"
_FLOW_INDICATORS = ",[]{}"
_DOC_MARKER = re.compile(r"^(?:---|\.\.\.)(?:[ \t]|$)")


class _Reader:
    """Recursive descent over the document's lines.  A block node is read
    from the line at ``self.i``; a sequence entry's dash and a mapping
    key are blanked out of their line, so that what follows them is read
    as a node starting at its own column."""

    def __init__(self, text: str, name: str = "<yaml>"):
        self.name = name
        text = text.replace("\r\n", "\n")
        if text.startswith("\ufeff"):
            text = text[1:]
        for ch in "\r\x85\u2028\u2029":
            if ch in text:
                self.unsupported(text[: text.index(ch)].count("\n") + 1,
                                 f"line break character {ch!r}")
        self.lines = text.split("\n")
        self.i = 0

    # -- errors -----------------------------------------------------------
    def error(self, line: int, msg: str) -> YAMLError:
        return YAMLError(f"{self.name}:{line}: {msg}")

    def unsupported(self, line: int, what: str):
        raise YAMLUnsupported(f"{self.name}:{line}: {what} are outside the YAML subset "
                              f"the port reads" if what.endswith("s") else
                              f"{self.name}:{line}: {what} is outside the YAML subset "
                              f"the port reads")

    # -- lines --------------------------------------------------------------
    @staticmethod
    def _indent(line: str) -> int:
        return len(line) - len(line.lstrip(" "))

    def _is_blank(self, line: str) -> bool:
        s = line.strip(" \t")
        return s == "" or s.startswith("#")

    def _next_content(self) -> Optional[int]:
        """Index of the next line with content (not blank, not a comment)."""
        j = self.i
        while j < len(self.lines) and self._is_blank(self.lines[j]):
            j += 1
        return j if j < len(self.lines) else None

    def _check_tabs(self, j: int):
        line = self.lines[j]
        ind = self._indent(line)
        if line[ind:ind + 1] == "\t":
            raise self.error(j + 1, "a tab in the indentation")

    # -- document -------------------------------------------------------------
    def document(self):
        j = self._next_content()
        if j is not None and self.lines[j].startswith("%"):
            self.unsupported(j + 1, "directives")
        if j is not None and re.match(r"^---(?:[ \t]|$)", self.lines[j]):
            self.lines[j] = "   " + self.lines[j][3:]
        value = self.node(parent=-1, inline=False)
        j = self._next_content()
        if j is not None:
            line = self.lines[j]
            if _DOC_MARKER.match(line):
                rest = self.lines[j][3:].strip()
                k = j + 1
                while k < len(self.lines) and self._is_blank(self.lines[k]):
                    k += 1
                if line.startswith("...") and (rest == "" or rest.startswith("#")) and \
                        k == len(self.lines):
                    return value
                self.unsupported(j + 1, "several documents")
            raise self.error(j + 1, f"unexpected content {line.strip()!r}")
        return value

    # -- block nodes --------------------------------------------------------
    def node(self, parent: int, inline: bool, seq_at_parent: bool = False):
        """The node whose first line is the next content line, which must
        be indented past ``parent`` (or, with ``seq_at_parent``, a sequence
        entry at ``parent``).  ``inline``: the node starts on its key's
        line, so it is a scalar or a flow collection.  None when there is
        no such line (an empty value)."""
        j = self._next_content()
        if j is None:
            self.i = len(self.lines)
            return None
        if inline and j != self.i:
            inline = False  # the value starts on a later line
        self._check_tabs(j)
        line = self.lines[j]
        ind = self._indent(line)
        is_seq = self._is_seq_entry(line, ind)
        if ind <= parent and not (seq_at_parent and ind == parent and is_seq):
            return None
        self.i = j
        if inline:
            return self.inline_value(j, ind, parent)
        if is_seq:
            return self.sequence(ind)
        if self._mapping_key(j, ind) is not None or self._is_explicit_key(line, ind):
            return self.mapping(ind)
        return self.inline_value(j, ind, parent)

    @staticmethod
    def _is_seq_entry(line: str, ind: int) -> bool:
        return line[ind:ind + 1] == "-" and line[ind + 1:ind + 2] in ("", " ", "\t")

    @staticmethod
    def _is_explicit_key(line: str, ind: int) -> bool:
        return line[ind:ind + 1] == "?" and line[ind + 1:ind + 2] in ("", " ", "\t")

    def sequence(self, ind: int) -> list:
        out = []
        while True:
            j = self._next_content()
            if j is None:
                break
            line = self.lines[j]
            lind = self._indent(line)
            if lind < ind or _DOC_MARKER.match(line):
                break
            if lind > ind or not self._is_seq_entry(line, lind):
                if lind == ind and (self._mapping_key(j, lind) is not None
                                    or self._is_explicit_key(line, lind)):
                    break  # a sequence at its key's indent ends at the next key
                raise self.error(j + 1, f"expected a sequence entry, found {line.strip()!r}")
            self.lines[j] = line[:ind] + " " + line[ind + 1:]
            self.i = j
            out.append(self.node(parent=ind, inline=False))
        return out

    def _mapping_key(self, j: int, ind: int) -> Optional[Tuple[Any, int]]:
        """(key, column after its ':') when line ``j`` holds a block
        mapping entry at ``ind``, else None."""
        line = self.lines[j]
        s = line[ind:]
        if s[:1] in ("'", '"'):
            end, key = self._quoted_on_line(j, ind)
            if end is None:
                return None
            k = end
            while k < len(line) and line[k] == " ":
                k += 1
            if line[k:k + 1] == ":" and line[k + 1:k + 2] in ("", " ", "\t"):
                return key, k + 1
            return None
        if s[:1] in "[{#" or s[:1] in _RESERVED_START:
            return None
        if s[:1] in "-?:" and s[1:2] in ("", " ", "\t"):
            return None
        k = ind
        while k < len(line):
            if line[k] == ":" and line[k + 1:k + 2] in ("", " ", "\t"):
                text = line[ind:k].rstrip(" \t")
                if s[:1] in _UNSUPPORTED_START and s[:1] != "?":
                    self.unsupported(j + 1, _UNSUPPORTED_START[s[:1]])
                key = _resolve_plain(text)
                if key is _TIMESTAMP_SENTINEL:
                    self.unsupported(j + 1, "timestamps")
                if text == "<<":
                    self.unsupported(j + 1, "merge keys")
                return key, k + 1
            if line[k] == "#" and k > ind and line[k - 1] in " \t":
                return None
            k += 1
        return None

    def _quoted_on_line(self, j: int, col: int):
        """(end column, value) of a quoted scalar that closes on line j."""
        line = self.lines[j]
        q = line[col]
        k = col + 1
        while k < len(line):
            if q == "'" and line[k] == "'":
                if line[k + 1:k + 2] == "'":
                    k += 2
                    continue
                return k + 1, line[col + 1:k].replace("''", "'")
            if q == '"' and line[k] == "\\":
                k += 2
                continue
            if q == '"' and line[k] == '"':
                return k + 1, _unescape(line[col + 1:k], lambda m: self.error(j + 1, m))
            k += 1
        return None, None

    def mapping(self, ind: int) -> dict:
        out: Dict[Any, Any] = {}
        while True:
            j = self._next_content()
            if j is None:
                break
            line = self.lines[j]
            lind = self._indent(line)
            if lind < ind or _DOC_MARKER.match(line):
                break
            if lind > ind:
                raise self.error(j + 1, f"unexpected indentation: {line.strip()!r}")
            if self._is_explicit_key(line, ind):
                out.update([self._explicit_entry(j, ind)])
                continue
            found = self._mapping_key(j, ind)
            if found is None:
                if self._is_seq_entry(line, lind):
                    break  # the end of a sequence nested at its key's indent
                raise self.error(j + 1, f"expected 'key: value', found {line.strip()!r}")
            key, col = found
            if isinstance(key, (list, dict)):
                self.unsupported(j + 1, "complex keys")
            self.lines[j] = " " * col + line[col:]
            self.i = j
            out[key] = self.node(parent=ind, inline=True, seq_at_parent=True)
        return out

    def _explicit_entry(self, j: int, ind: int) -> Tuple[Any, Any]:
        """'? key' then ': value' at the same indent (how safe_dump writes
        an empty or a multi-line key); the key must be a scalar."""
        line = self.lines[j]
        self.lines[j] = line[:ind] + " " + line[ind + 1:]
        self.i = j
        key = self.node(parent=ind, inline=False)
        if isinstance(key, (list, dict)):
            self.unsupported(j + 1, "complex keys")
        k = self._next_content()
        if k is None:
            return key, None
        nxt = self.lines[k]
        if self._indent(nxt) == ind and nxt[ind] == ":" and nxt[ind + 1:ind + 2] in ("", " ", "\t"):
            self.lines[k] = nxt[:ind] + " " + nxt[ind + 1:]
            self.i = k
            return key, self.node(parent=ind, inline=False)
        return key, None

    # -- scalars and flow collections ----------------------------------------
    def inline_value(self, j: int, col: int, parent: int):
        """A scalar or a flow collection starting at (j, col); continuation
        lines of a plain scalar must be indented past ``parent``."""
        line = self.lines[j]
        ch = line[col]
        if ch in _UNSUPPORTED_START and not (ch == "?" and line[col + 1:col + 2] not in
                                             ("", " ", "\t")):
            self.unsupported(j + 1, _UNSUPPORTED_START[ch])
        if ch in _RESERVED_START:
            raise self.error(j + 1, f"a plain scalar cannot start with {ch!r}")
        if ch in "[{" or ch in "'\"":
            cur = _Cursor(self, j, col)
            value = cur.flow_node() if ch in "[{" else cur.quoted()
            cur.skip_space(allow_newline=False)
            if not cur.at_eol() and not cur.at_comment():
                raise self.error(cur.j + 1, f"unexpected text after a value: "
                                            f"{cur.rest().strip()!r}")
            self.i = cur.j + 1
            return value
        if ch in "]}," or (ch in "-:" and line[col + 1:col + 2] in ("", " ", "\t")):
            raise self.error(j + 1, f"unexpected {line[col:].strip()!r}")
        return self.plain(j, col, parent)

    def plain(self, j: int, col: int, parent: int):
        chunks: List[str] = []
        first = True
        breaks = 0
        k = j
        while k < len(self.lines):
            line = self.lines[k]
            if not first:
                s = line.strip(" ")
                if s == "":
                    breaks += 1
                    k += 1
                    continue
                ind = self._indent(line)
                if ind <= parent or s.startswith("#") or line[ind] == "\t":
                    break
                col = ind
                if _DOC_MARKER.match(line):
                    break
            text, comment = self._plain_text(k, col)
            if not first:
                chunks.append("\n" * breaks if breaks else " ")
            chunks.append(text)
            breaks = 0
            first = False
            k += 1
            if comment:
                break
        self.i = k
        return self._resolved(j, "".join(chunks))

    def _resolved(self, j: int, text: str):
        """A plain scalar's value; the resolutions the subset leaves out raise."""
        value = _resolve_plain(text)
        if value is _TIMESTAMP_SENTINEL:
            self.unsupported(j + 1, "timestamps")
        if text in ("=", "<<"):
            self.unsupported(j + 1, f"the plain scalar {text!r}")
        return value

    def _plain_text(self, j: int, col: int) -> Tuple[str, bool]:
        """The plain text of line j from col (to a comment or the end),
        and whether a comment ended it."""
        line = self.lines[j]
        k = col
        while k < len(line):
            if line[k] == "#" and k > col and line[k - 1] in " \t":
                return line[col:k].rstrip(" \t"), True
            if line[k] == ":" and line[k + 1:k + 2] in ("", " ", "\t"):
                raise self.error(j + 1, "mapping values are not allowed here")
            k += 1
        return line[col:].rstrip(" \t"), False


def _unescape(s: str, error) -> str:
    out = []
    k = 0
    while k < len(s):
        c = s[k]
        if c != "\\":
            out.append(c)
            k += 1
            continue
        e = s[k + 1:k + 2]
        if e in _ESCAPES:
            out.append(_ESCAPES[e])
            k += 2
        elif e in _ESCAPE_CODES:
            n = _ESCAPE_CODES[e]
            code = s[k + 2:k + 2 + n]
            if len(code) != n or not all(ch in "0123456789abcdefABCDEF" for ch in code):
                raise error(f"bad escape \\{e}{code}")
            out.append(chr(int(code, 16)))
            k += 2 + n
        else:
            raise error(f"unknown escape \\{e}")
    return "".join(out)


class _Cursor:
    """Character position over the reader's lines, for quoted scalars and
    flow collections, which may run over several lines."""

    def __init__(self, reader: _Reader, j: int, col: int):
        self.r, self.j, self.col = reader, j, col

    @property
    def line(self) -> str:
        return self.r.lines[self.j]

    def peek(self, n: int = 0) -> str:
        return self.line[self.col + n:self.col + n + 1]

    def rest(self) -> str:
        return self.line[self.col:]

    def at_eol(self) -> bool:
        return self.col >= len(self.line)

    def at_comment(self) -> bool:
        return self.peek() == "#" and (self.col == 0 or self.line[self.col - 1] in " \t")

    def error(self, msg: str) -> YAMLError:
        return self.r.error(self.j + 1, msg)

    def next_line(self):
        if self.j + 1 >= len(self.r.lines):
            raise self.error("unexpected end of the document")
        self.j, self.col = self.j + 1, 0

    def skip_space(self, allow_newline: bool = True) -> int:
        """Skip spaces (and, in flow context, comments and line breaks);
        returns the line breaks crossed."""
        breaks = 0
        while True:
            while self.peek() in (" ", "\t") and self.peek() != "":
                self.col += 1
            if allow_newline and (self.at_eol() or self.at_comment()):
                self.next_line()
                breaks += 1
                continue
            return breaks

    # -- quoted scalars ---------------------------------------------------
    def quoted(self) -> str:
        q = self.peek()
        start = self.j + 1
        self.col += 1
        chunks: List[str] = []
        while True:
            # the text of this line up to the closing quote or the line's end
            k = self.col
            line = self.line
            seg = []
            closed = False
            escaped_break = False
            while k < len(line):
                c = line[k]
                if q == "'" and c == "'":
                    if line[k + 1:k + 2] == "'":
                        seg.append("'")
                        k += 2
                        continue
                    closed = True
                    break
                if q == '"' and c == '"':
                    closed = True
                    break
                if q == '"' and c == "\\":
                    if k + 1 == len(line):
                        escaped_break = True
                        k += 1
                        break
                    e = line[k + 1]
                    n = _ESCAPE_CODES.get(e, 0)
                    seg.append(("\0ESC", line[k:k + 2 + n]))
                    k += 2 + n
                    continue
                seg.append(c)
                k += 1
            text = self._render(seg)
            if closed:
                chunks.append(text)
                self.col = k + 1
                return "".join(chunks)
            # a line break inside the scalar: trailing white space goes,
            # one break folds to a space, n + 1 breaks to n newlines
            if not escaped_break:
                text = self._rstrip_unescaped(seg)
            chunks.append(text)
            breaks = 0
            while True:
                if self.j + 1 >= len(self.r.lines):
                    raise self.r.error(start, "a quoted scalar is not closed")
                self.next_line()
                if _DOC_MARKER.match(self.line):
                    raise self.error("a document separator inside a quoted scalar")
                s = self.line.lstrip(" \t")
                self.col = len(self.line) - len(s)
                if s == "":
                    breaks += 1
                    continue
                break
            if escaped_break:
                chunks.append("\n" * breaks)
            else:
                chunks.append("\n" * breaks if breaks else " ")

    def _render(self, seg) -> str:
        return "".join(_unescape(s[1], self.error) if isinstance(s, tuple) else s for s in seg)

    def _rstrip_unescaped(self, seg) -> str:
        while seg and seg[-1] in (" ", "\t"):
            seg.pop()
        return self._render(seg)

    # -- flow collections -----------------------------------------------------
    def flow_node(self):
        c = self.peek()
        if c == "[":
            return self.flow_seq()
        if c == "{":
            return self.flow_map()
        if c in ("'", '"'):
            return self.quoted()
        if c in _UNSUPPORTED_START and c != "?":
            self.r.unsupported(self.j + 1, _UNSUPPORTED_START[c])
        return self.flow_plain()

    def flow_plain(self):
        """A plain scalar in a flow collection: it ends at a flow indicator,
        ': ' or a comment, and folds over line breaks."""
        chunks: List[str] = []
        breaks = 0
        while True:
            line = self.line
            k = self.col
            while k < len(line):
                c = line[k]
                if c in _FLOW_INDICATORS or (c == ":" and line[k + 1:k + 2] in
                                             ("", " ", "\t", ",", "[", "]", "{", "}")):
                    break
                if c == "#" and k > 0 and line[k - 1] in " \t":
                    break
                k += 1
            text = line[self.col:k].rstrip(" \t")
            if text:
                if chunks:
                    chunks.append("\n" * breaks if breaks else " ")
                chunks.append(text)
            self.col = k
            if k < len(line):
                break  # an indicator or a comment
            # the line ended: the scalar goes on at the next line with text,
            # unless that line starts with an indicator or a comment
            m = self.j + 1
            while m < len(self.r.lines) and self.r.lines[m].strip(" \t") == "":
                m += 1
            if m >= len(self.r.lines):
                break
            nxt = self.r.lines[m].lstrip(" \t")
            if nxt[:1] in _FLOW_INDICATORS or nxt[:1] == "#" or \
                    (nxt[:1] == ":" and nxt[1:2] in ("", " ", "\t", ",", "[", "]", "{", "}")):
                break
            breaks = m - self.j - 1
            self.j, self.col = m, len(self.r.lines[m]) - len(nxt)
        return self.r._resolved(self.j, "".join(chunks))

    def _flow_entry(self, closer: str):
        """One entry of a flow collection: (key, value, is_pair)."""
        if self.peek() == "?" and self.peek(1) in ("", " ", "\t"):
            self.col += 1  # an explicit key: '? key : value'
            self.skip_space()
        if self.peek() == ":" and self.peek(1) in ("", " ", "\t", ",", closer):
            key = None
        else:
            key = self.flow_node()
            self.skip_space()
        if self.peek() == ":":
            self.col += 1
            self.skip_space()
            if self.peek() in (",", closer):
                return key, None, True
            value = self.flow_node()
            self.skip_space()
            return key, value, True
        return key, None, False

    def flow_seq(self) -> list:
        self.col += 1
        out = []
        while True:
            self.skip_space()
            if self.peek() == "]":
                self.col += 1
                return out
            key, value, pair = self._flow_entry("]")
            if pair:
                if isinstance(key, (list, dict)):
                    self.r.unsupported(self.j + 1, "complex keys")
                out.append({key: value})
            else:
                out.append(key)
            self.skip_space()
            if self.peek() == ",":
                self.col += 1
            elif self.peek() != "]":
                raise self.error(f"expected ',' or ']' in a flow sequence, "
                                 f"found {self.rest().strip()!r}")

    def flow_map(self) -> dict:
        self.col += 1
        out: Dict[Any, Any] = {}
        while True:
            self.skip_space()
            if self.peek() == "}":
                self.col += 1
                return out
            key, value, _ = self._flow_entry("}")
            if isinstance(key, (list, dict)):
                self.r.unsupported(self.j + 1, "complex keys")
            out[key] = value
            self.skip_space()
            if self.peek() == ",":
                self.col += 1
            elif self.peek() != "}":
                raise self.error(f"expected ',' or '}}' in a flow mapping, "
                                 f"found {self.rest().strip()!r}")


def loads_yaml(text: str, name: str = "<yaml>"):
    """The value of one YAML document (the subset above), as
    ``yaml.safe_load`` constructs it."""
    return _Reader(text, name).document()


# ---------------------------------------------------------------------------
# YAML: writer
# ---------------------------------------------------------------------------

_PLAIN_OK = re.compile(r"^[A-Za-z0-9_./+()<>=@,-]+(?: [A-Za-z0-9_./+()<>=@,-]+)*$")


def _printable(c: str) -> bool:
    o = ord(c)
    return (c in "\t\n" or 0x20 <= o <= 0x7E or 0xA0 <= o <= 0xD7FF
            or 0xE000 <= o <= 0xFFFD and o != 0xFEFF or 0x10000 <= o <= 0x10FFFF)


_WRITE_ESCAPES = {"\0": "\\0", "\x07": "\\a", "\x08": "\\b", "\t": "\\t", "\n": "\\n",
                  "\x0b": "\\v", "\x0c": "\\f", "\r": "\\r", "\x1b": "\\e", '"': '\\"',
                  "\\": "\\\\", "\x85": "\\N", "\xa0": "\\_", "\u2028": "\\L",
                  "\u2029": "\\P"}


def _quote(s: str) -> str:
    out = []
    for c in s:
        if c in _WRITE_ESCAPES:
            out.append(_WRITE_ESCAPES[c])
        elif _printable(c):
            out.append(c)
        elif ord(c) <= 0xFF:
            out.append(f"\\x{ord(c):02X}")
        elif ord(c) <= 0xFFFF:
            out.append(f"\\u{ord(c):04X}")
        else:
            out.append(f"\\U{ord(c):08X}")
    return '"' + "".join(out) + '"'


def _scalar(value) -> str:
    if value is None:
        return "null"
    if value is True:
        return "true"
    if value is False:
        return "false"
    if isinstance(value, int):
        return str(int(value))
    if isinstance(value, float):
        if math.isnan(value):
            return ".nan"
        if math.isinf(value):
            return ".inf" if value > 0 else "-.inf"
        text = repr(float(value)).lower()
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)  # YAML 1.1's float needs the dot
        return text
    if isinstance(value, str):
        if (value and _PLAIN_OK.match(value) and value[0] not in "-@<=,>"
                and _resolve_plain(value) == value and value not in ("=", "<<")):
            return value
        return _quote(value)
    raise TypeError(f"cannot write a {type(value).__name__} as YAML: {value!r}")


def _emit(value, indent: int, out: List[str]):
    pad = " " * indent
    if isinstance(value, dict):
        for k, v in value.items():
            if isinstance(k, (dict, list, tuple)):
                raise TypeError(f"cannot write a {type(k).__name__} mapping key as YAML")
            key = _scalar(k)
            if isinstance(v, dict) and v:
                out.append(f"{pad}{key}:")
                _emit(v, indent + 2, out)
            elif isinstance(v, (list, tuple)) and v:
                out.append(f"{pad}{key}:")
                _emit(v, indent + 2, out)
            else:
                out.append(f"{pad}{key}: {_inline(v)}")
    elif isinstance(value, (list, tuple)):
        for v in value:
            if isinstance(v, (dict, list, tuple)) and v:
                sub: List[str] = []
                _emit(v, indent + 2, sub)
                out.append(f"{pad}- {sub[0][indent + 2:]}")
                out.extend(sub[1:])
            else:
                out.append(f"{pad}- {_inline(v)}")
    else:
        out.append(pad + _inline(value))


def _inline(value) -> str:
    if isinstance(value, dict):
        return "{}"
    if isinstance(value, (list, tuple)):
        return "[]"
    return _scalar(value)


def dumps_yaml(config) -> str:
    """YAML text that ``yaml.safe_load`` (and :func:`loads_yaml`) read back
    as ``config``: block style, keys in their order, strings plain where
    that reads back as the same string and double-quoted otherwise."""
    out: List[str] = []
    if isinstance(config, (dict, list, tuple)) and config:
        _emit(config, 0, out)
    else:
        out.append(_inline(config))
    return "\n".join(out) + "\n"


def load_yaml(path: Union[str, Path]) -> Dict[str, Any]:
    with open(path, encoding="utf-8") as f:
        out = loads_yaml(f.read(), str(path))
    if out is None:
        return {}
    if not isinstance(out, dict):
        raise ValueError(f"{path} must contain a mapping at top level")
    return out


def dump_yaml(config: Dict[str, Any], path: Union[str, Path]):
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        f.write(dumps_yaml(config))


# ---------------------------------------------------------------------------
# CLI overrides
# ---------------------------------------------------------------------------

def _parse_value(s: str) -> Any:
    """YAML-parse a CLI value string ('true'->True, '3'->3, '[1,2]'->list...);
    malformed YAML stays the string.  A bare '-' (the stdout/stdin
    convention) stays a string."""
    if s == "-":
        return s
    try:
        return loads_yaml(s, "<cli>")
    except YAMLUnsupported:
        raise
    except YAMLError:
        return s


def parse_cli_overrides(args: Sequence[str]) -> Dict[str, Any]:
    """['--a', '1', '--b_conf', 'x=2', '--b_conf', 'y=3'] -> {'a':1,'b_conf':{'x':2,'y':3}}."""
    out: Dict[str, Any] = {}
    i = 0
    args = list(args)
    while i < len(args):
        a = args[i]
        if not a.startswith("--"):
            raise ValueError(f"expected --flag, got {a!r}")
        key = a[2:].replace("-", "_")
        if "=" in key:
            key, val = key.split("=", 1)
            vals = [val]
            i += 1
        else:
            vals = []
            i += 1
            while i < len(args) and not args[i].startswith("--"):
                vals.append(args[i])
                i += 1
        if key.endswith("_conf") and vals and all("=" in v for v in vals):
            sub = out.setdefault(key, {})
            if not isinstance(sub, dict):
                sub = {}
                out[key] = sub
            for v in vals:
                sk, sv = v.split("=", 1)
                sub[sk] = _parse_value(sv)
        elif not vals:
            out[key] = True
        elif len(vals) == 1:
            val = _parse_value(vals[0])
            if key in out and key.endswith("data_path_and_name_and_type"):
                # repeated triple flags append (abs_task.py action='append')
                prev = out[key] if isinstance(out[key], list) else [out[key]]
                out[key] = prev + [val]
            else:
                out[key] = val
        else:
            out[key] = [_parse_value(v) for v in vals]
    return out


def merge_configs(base: Dict[str, Any], override: Dict[str, Any]) -> Dict[str, Any]:
    out = copy.deepcopy(base)
    for k, v in override.items():
        if k.endswith("_conf") and isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = {**out[k], **v}
        else:
            out[k] = v
    return out


def build_config(cmd: Sequence[str], defaults: Optional[Dict[str, Any]] = None
                 ) -> Dict[str, Any]:
    """--config <yaml> plus arbitrary --key overrides -> resolved config dict."""
    cmd = list(cmd)
    config: Dict[str, Any] = copy.deepcopy(defaults or {})
    # peel off --config flags first (may appear multiple times, later wins base)
    rest: List[str] = []
    i = 0
    while i < len(cmd):
        if cmd[i] == "--config":
            config = merge_configs(config, load_yaml(cmd[i + 1]))
            i += 2
        elif cmd[i].startswith("--config="):
            config = merge_configs(config, load_yaml(cmd[i].split("=", 1)[1]))
            i += 1
        else:
            rest.append(cmd[i])
            i += 1
    return merge_configs(config, parse_cli_overrides(rest))


# ---------------------------------------------------------------------------
# token lists, conf dicts, data triples
# ---------------------------------------------------------------------------

def read_token_list(token_list: Union[str, Path, Sequence[str]]) -> List[str]:
    """A token-list file (one token a line, blank lines skipped) or a
    sequence of tokens -> list of tokens."""
    if isinstance(token_list, (str, Path)):
        with open(token_list, encoding="utf-8") as f:
            return [line.rstrip("\n") for line in f if line.rstrip("\n") != ""]
    return list(token_list)


def filter_known_fields(cls, d: dict, where: str = "") -> dict:
    """The keys of ``d`` that are fields of the dataclass ``cls``; the rest
    are dropped with a warning that names them (a mistyped component-conf
    key must not vanish silently)."""
    known = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(k for k in d if k not in known)
    if unknown:
        logger.warning(f"ignoring unknown {where or cls.__name__} key(s): {unknown} "
                       f"(known: {sorted(known)})")
    return {k: v for k, v in d.items() if k in known}


def normalize_triples(value) -> List[tuple]:
    """data_path_and_name_and_type entries -> [(path, name, type), ...].

    Accepts YAML lists of 3-lists and the reference's CLI form
    'path,name,type' (possibly a single string or a list of strings)."""
    if value is None:
        return []
    if isinstance(value, str):
        value = [value]
    out = []
    for item in value:
        if isinstance(item, str):
            parts = item.split(",")
            if len(parts) != 3:
                raise ValueError(f"expected 'path,name,type', got {item!r}")
            out.append(tuple(p.strip() for p in parts))
        else:
            t = tuple(item)
            if len(t) != 3:
                raise ValueError(f"expected a (path, name, type) triple, got {item!r}")
            out.append(t)
    return out
