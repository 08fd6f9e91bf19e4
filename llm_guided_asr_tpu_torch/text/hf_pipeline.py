"""The pieces of a Hugging Face ``tokenizer.json`` pipeline, read with the
standard library only (the port's stand-in for the ``tokenizers`` library
behind the JAX package's ``transformers.AutoTokenizer``).

A fast tokenizer encodes in four steps after its added tokens are split
off: the normalizer rewrites each remaining piece, the pre-tokenizer cuts
it into words, the model turns each word into tokens, and the
post-processor adds the template's special tokens.  Decoding runs the
decoder chain over the tokens and joins what it returns.  Each builder
here reads one section of the JSON and returns a plain function; a type
or option this module does not compute raises ``NotImplementedError``
naming it.  What is read:

- normalizers ``NFC``, ``Prepend``, ``Replace`` (a string pattern) and
  ``Sequence``;
- pre-tokenizers ``ByteLevel`` (with and without GPT-2's regex,
  ``add_prefix_space``), ``Split`` (a string or a regex, every
  ``behavior``, ``invert``), ``Metaspace`` (``replacement``,
  ``prepend_scheme`` first/always/never or the older
  ``add_prefix_space``, ``split``) and ``Sequence``;
- the ``BPE`` model (``byte_fallback``, ``fuse_unk``, ``ignore_merges``,
  an unk token or none) and ``WordLevel``;
- post-processors ``TemplateProcessing``, ``ByteLevel`` and ``Sequence``;
- decoders ``ByteLevel``, ``Metaspace``, ``Replace``, ``ByteFallback``,
  ``Fuse``, ``Strip`` and ``Sequence``.

Regexes are the library's Oniguruma patterns.  Python's ``re`` lacks
``\\p{L}`` and ``\\p{N}`` and takes more characters for ``\\s``, so a
pattern is rewritten with explicit classes built once from
``unicodedata``: letters (Lu, Ll, Lt, Lm, Lo), numbers (Nd, Nl, No) and
Unicode's White_Space set.  A piece is a ``(text, at_start)`` pair, where
``at_start`` says that it begins at offset 0 of the input (Metaspace's
``first`` scheme reads it).
"""

from __future__ import annotations

import functools
import re
import sys
import unicodedata
from typing import Callable, Dict, List, Optional, Sequence, Tuple

Piece = Tuple[str, bool]

# Unicode's White_Space property: what Oniguruma's \s matches (Python's
# also takes U+001C..U+001F)
WHITE_SPACE = "\t\n\x0b\x0c\r \x85\xa0\u1680\u2000-\u200a\u2028\u2029\u202f\u205f\u3000"
# GPT-2's pattern, ByteLevel's own regex (use_regex)
GPT2_PATTERN = r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"


def unsupported(what: str, value) -> NotImplementedError:
    return NotImplementedError(f"tokenizer.json {what} {value!r} is not supported by the "
                               f"port's tokenizer")


# ---------------------------------------------------------------------------
# regexes
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _category_classes() -> Dict[str, str]:
    """{'L': letters, 'N': numbers}: the code points whose general category
    starts with the letter, each as the inside of a character class."""
    ranges: Dict[str, List[List[int]]] = {"L": [], "N": []}
    for cp in range(sys.maxunicode + 1):
        major = unicodedata.category(chr(cp))[0]
        if major in ranges:
            spans = ranges[major]
            if spans and spans[-1][1] == cp - 1:
                spans[-1][1] = cp
            else:
                spans.append([cp, cp])
    esc = lambda cp: f"\\U{cp:08x}"  # noqa: E731
    return {k: "".join(esc(a) if a == b else f"{esc(a)}-{esc(b)}" for a, b in spans)
            for k, spans in ranges.items()}


def _class_body(name: str) -> str:
    if name in ("L", "N"):
        return _category_classes()[name]
    raise unsupported("regex class", f"\\p{{{name}}}")


@functools.lru_cache(maxsize=None)
def compile_oniguruma(pattern: str) -> "re.Pattern":
    """An Oniguruma pattern of a tokenizer.json as a Python regex:
    ``\\p{L}``, ``\\p{N}`` (and ``\\P{..}``), ``\\s`` and ``\\S`` become
    explicit classes; everything else is read by ``re`` as it is."""
    out, i, in_class = [], 0, False
    while i < len(pattern):
        c = pattern[i]
        if c == "\\" and i + 1 < len(pattern):
            nxt = pattern[i + 1]
            if nxt in "pP" and pattern[i + 2:i + 3] == "{":
                end = pattern.index("}", i)
                body = _class_body(pattern[i + 3:end])
                if in_class:
                    if nxt == "P":
                        raise unsupported("regex", pattern)
                    out.append(body)
                else:
                    out.append(f"[{'^' if nxt == 'P' else ''}{body}]")
                i = end + 1
                continue
            if nxt in "sS":
                if in_class:
                    if nxt == "S":
                        raise unsupported("regex", pattern)
                    out.append(WHITE_SPACE)
                else:
                    out.append(f"[{'^' if nxt == 'S' else ''}{WHITE_SPACE}]")
                i += 2
                continue
            out.append(pattern[i:i + 2])
            i += 2
            continue
        if c == "[" and not in_class:
            in_class = True
        elif c == "]" and in_class:
            in_class = False
        out.append(c)
        i += 1
    return re.compile("".join(out))


def _find_matches(pattern, text: str) -> List[Tuple[int, int, bool]]:
    """(start, end, is_match) segments covering ``text`` in order: the
    library's ``find_matches``.  An empty string pattern matches nothing
    and cuts the text into one-character segments."""
    if text == "":
        return [(0, 0, False)]
    if pattern == "":
        return [(i, i + 1, False) for i in range(len(text))]
    segments, prev = [], 0
    for m in pattern.finditer(text):
        start, end = m.span()
        if prev != start:
            segments.append((prev, start, False))
        segments.append((start, end, True))
        prev = end
    if prev != len(text):
        segments.append((prev, len(text), False))
    return segments


def _split_offsets(segments, behavior: str) -> List[Tuple[int, int]]:
    """The library's SplitDelimiterBehavior over (start, end, is_match)."""
    if behavior == "Removed":
        return [(s, e) for s, e, m in segments if not m]
    if behavior == "Isolated":
        return [(s, e) for s, e, _ in segments]
    acc: List[List[int]] = []
    previous_match = False
    if behavior == "MergedWithPrevious":
        for s, e, m in segments:
            if m and not previous_match and acc:
                acc[-1][1] = e
            else:
                acc.append([s, e])
            previous_match = m
    elif behavior == "MergedWithNext":
        for s, e, m in reversed(segments):
            if m and not previous_match and acc:
                acc[-1][0] = s
            else:
                acc.append([s, e])
            previous_match = m
        acc.reverse()
    elif behavior == "Contiguous":
        for s, e, m in segments:
            if m == previous_match and acc:
                acc[-1][1] = e
            else:
                acc.append([s, e])
            previous_match = m
    else:
        raise unsupported("Split behavior", behavior)
    return [(s, e) for s, e in acc]


def split_pieces(pieces: Sequence[Piece], pattern, behavior: str, invert: bool = False
                 ) -> List[Piece]:
    out: List[Piece] = []
    for text, at_start in pieces:
        segments = _find_matches(pattern, text)
        if invert:
            segments = [(s, e, not m) for s, e, m in segments]
        for s, e in _split_offsets(segments, behavior):
            if e > s:
                out.append((text[s:e], at_start and s == 0))
    return out


def _pattern(spec) -> object:
    """A Split pattern: ``{"String": s}`` (literal; "" cuts characters) or
    ``{"Regex": r}``."""
    if "String" in spec:
        return "" if spec["String"] == "" else re.compile(re.escape(spec["String"]))
    if "Regex" in spec:
        return compile_oniguruma(spec["Regex"])
    raise unsupported("pattern", spec)


BEHAVIORS = ("Removed", "Isolated", "MergedWithPrevious", "MergedWithNext", "Contiguous")


def _chain(steps: Sequence[Callable]) -> Callable:
    """A ``Sequence`` section: each step's output is the next one's input."""
    def run(x):
        for step in steps:
            x = step(x)
        return x

    return run


# ---------------------------------------------------------------------------
# byte-level alphabet
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's table: every byte as a printable character."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


@functools.lru_cache(maxsize=None)
def unicode_to_bytes() -> Dict[str, int]:
    return {c: b for b, c in bytes_to_unicode().items()}


def to_byte_chars(text: str) -> str:
    table = bytes_to_unicode()
    return "".join(table[b] for b in text.encode("utf-8"))


# ---------------------------------------------------------------------------
# normalizers: str -> str
# ---------------------------------------------------------------------------

def build_normalizer(spec: Optional[Dict]) -> Optional[Callable[[str], str]]:
    if spec is None:
        return None
    kind = spec.get("type")
    if kind == "NFC":
        return lambda s: unicodedata.normalize("NFC", s)
    if kind == "Prepend":
        prepend = spec["prepend"]
        return lambda s: prepend + s if s else s
    if kind == "Replace":
        pattern = spec["pattern"]
        if "String" not in pattern:
            raise unsupported("Replace pattern", pattern)
        old, new = pattern["String"], spec["content"]
        return lambda s: s.replace(old, new)
    if kind == "Sequence":
        return _chain([build_normalizer(n) for n in spec["normalizers"]])
    raise unsupported("normalizer", kind)


# ---------------------------------------------------------------------------
# pre-tokenizers: [Piece] -> [Piece]
# ---------------------------------------------------------------------------

def _prepend_scheme(spec: Dict) -> str:
    if "prepend_scheme" in spec:
        scheme = spec["prepend_scheme"]
    else:  # files written before the scheme existed
        scheme = "always" if spec.get("add_prefix_space", True) else "never"
    if scheme not in ("first", "always", "never"):
        raise unsupported("Metaspace prepend_scheme", scheme)
    return scheme


def build_pre_tokenizer(spec: Optional[Dict]) -> Callable[[List[Piece]], List[Piece]]:
    if spec is None:
        return lambda pieces: pieces
    kind = spec.get("type")
    if kind == "Sequence":
        return _chain([build_pre_tokenizer(p) for p in spec["pretokenizers"]])
    if kind == "Split":
        pattern = _pattern(spec["pattern"])
        behavior = spec["behavior"]
        if behavior not in BEHAVIORS:
            raise unsupported("Split behavior", behavior)
        invert = bool(spec.get("invert", False))
        return lambda pieces: split_pieces(pieces, pattern, behavior, invert)
    if kind == "ByteLevel":
        prefix = bool(spec.get("add_prefix_space", True))
        regex = compile_oniguruma(GPT2_PATTERN) if spec.get("use_regex", True) else None

        def byte_level(pieces):
            out = []
            for text, at_start in pieces:
                if prefix and not text.startswith(" "):
                    text = " " + text
                subs = [(text, at_start)] if regex is None else split_pieces(
                    [(text, at_start)], regex, "Isolated")
                out.extend((to_byte_chars(t), a) for t, a in subs)
            return out

        return byte_level
    if kind == "Metaspace":
        rep = spec.get("replacement", "▁")
        scheme = _prepend_scheme(spec)
        split = bool(spec.get("split", True))
        rep_pattern = re.compile(re.escape(rep))

        def metaspace(pieces):
            out = []
            for text, at_start in pieces:
                text = text.replace(" ", rep)
                if not text.startswith(rep) and (scheme == "always"
                                                 or (scheme == "first" and at_start)):
                    text = rep + text
                if split:
                    out.extend(split_pieces([(text, at_start)], rep_pattern, "MergedWithNext"))
                elif text:
                    out.append((text, at_start))
            return out

        return metaspace
    raise unsupported("pre_tokenizer", kind)


# ---------------------------------------------------------------------------
# models: word -> tokens
# ---------------------------------------------------------------------------

class BPEModel:
    """The library's BPE: characters (a character outside the vocabulary
    as its ``<0xNN>`` byte tokens with ``byte_fallback``, else as the unk
    token, consecutive unks fused with ``fuse_unk``, else dropped when the
    model has no unk token), then merges applied lowest rank first, the
    leftmost of equal ranks first.  With ``ignore_merges`` a word that is
    itself in the vocabulary is one token."""

    def __init__(self, spec: Dict):
        if spec.get("dropout") is not None:
            raise unsupported("BPE dropout", spec["dropout"])
        for key in ("continuing_subword_prefix", "end_of_word_suffix"):
            if spec.get(key):  # None and "" both mean no affix
                raise unsupported(f"BPE {key}", spec[key])
        self.vocab: Dict[str, int] = dict(spec["vocab"])
        self.unk = spec.get("unk_token")
        self.byte_fallback = bool(spec.get("byte_fallback", False))
        self.fuse_unk = bool(spec.get("fuse_unk", False))
        self.ignore_merges = bool(spec.get("ignore_merges", False))
        merges = [tuple(m.split(" ")) if isinstance(m, str) else tuple(m)
                  for m in spec.get("merges", [])]
        self.merge_rank = {pair: rank for rank, pair in enumerate(merges)}

    def _unk_symbol(self) -> str:
        if self.unk not in self.vocab:
            raise ValueError(f"the BPE unk token {self.unk!r} is not in the vocabulary")
        return self.unk

    def symbols(self, word: str) -> List[str]:
        out: List[str] = []
        pending_unk = False
        for ch in word:
            if ch in self.vocab:
                if pending_unk:
                    out.append(self._unk_symbol())
                    pending_unk = False
                out.append(ch)
                continue
            if self.byte_fallback:
                codes = [f"<0x{b:02X}>" for b in ch.encode("utf-8")]
                if all(c in self.vocab for c in codes):
                    out.extend(codes)
                    continue
            if self.unk is not None:
                if pending_unk and not self.fuse_unk:
                    out.append(self._unk_symbol())
                pending_unk = True
        if pending_unk:
            out.append(self._unk_symbol())
        return out

    def __call__(self, word: str) -> List[str]:
        if self.ignore_merges and word in self.vocab:
            return [word]
        symbols = self.symbols(word)
        while len(symbols) > 1:
            best = None
            for i in range(len(symbols) - 1):
                rank = self.merge_rank.get((symbols[i], symbols[i + 1]))
                if rank is not None and (best is None or rank < best[0]):
                    best = (rank, i)
            if best is None:
                break
            i = best[1]
            symbols[i:i + 2] = [symbols[i] + symbols[i + 1]]
        return symbols


class WordLevelModel:
    def __init__(self, spec: Dict):
        self.vocab: Dict[str, int] = dict(spec["vocab"])
        self.unk = spec.get("unk_token")

    def __call__(self, word: str) -> List[str]:
        if word in self.vocab:
            return [word]
        if self.unk is None or self.unk not in self.vocab:
            raise ValueError(f"{word!r} is not in the vocabulary and the model has no unk token")
        return [self.unk]


def build_model(spec: Dict):
    kind = spec.get("type")
    if kind == "BPE":
        return BPEModel(spec)
    if kind == "WordLevel":
        return WordLevelModel(spec)
    raise unsupported("model type", kind)


# ---------------------------------------------------------------------------
# post-processors: ids -> ids (add_special_tokens=True)
# ---------------------------------------------------------------------------

def build_post_processor(spec: Optional[Dict]) -> Callable[[List[int]], List[int]]:
    """The single-sequence template; ``ByteLevel`` only trims offsets."""
    if spec is None:
        return lambda ids: ids
    kind = spec.get("type")
    if kind == "ByteLevel":
        return lambda ids: ids
    if kind == "Sequence":
        return _chain([build_post_processor(p) for p in spec["processors"]])
    if kind == "TemplateProcessing":
        specials = {name: list(tok["ids"]) for name, tok in spec["special_tokens"].items()}
        parts = []
        for piece in spec["single"]:
            if "Sequence" in piece:
                if piece["Sequence"]["id"] != "A":
                    raise unsupported("TemplateProcessing single piece", piece)
                parts.append(None)
            elif "SpecialToken" in piece:
                parts.append(specials[piece["SpecialToken"]["id"]])
            else:
                raise unsupported("TemplateProcessing piece", piece)

        def template(ids):
            out = []
            for part in parts:
                out.extend(ids if part is None else part)
            return out

        return template
    raise unsupported("post_processor", kind)


def template_processing(single: Sequence[Tuple[str, int]]) -> Dict:
    """A TemplateProcessing spec of special tokens around $A:
    ``single`` lists (token or "$A", id) in order."""
    pieces, specials = [], {}
    for token, tid in single:
        if token == "$A":
            pieces.append({"Sequence": {"id": "A", "type_id": 0}})
        else:
            pieces.append({"SpecialToken": {"id": token, "type_id": 0}})
            specials[token] = {"id": token, "ids": [tid], "tokens": [token]}
    return {"type": "TemplateProcessing", "single": pieces, "special_tokens": specials}


# ---------------------------------------------------------------------------
# decoders: decode_chain [str] -> [str]
# ---------------------------------------------------------------------------

def _byte_level_decode(tokens: List[str]) -> List[str]:
    table = unicode_to_bytes()
    out = bytearray()
    for t in tokens:
        if all(c in table for c in t):
            out.extend(table[c] for c in t)
        else:
            out.extend(t.encode("utf-8"))
    return [out.decode("utf-8", errors="replace")]


def _byte_fallback_decode(tokens: List[str]) -> List[str]:
    out: List[str] = []
    pending = bytearray()

    def flush():
        if pending:
            try:
                out.append(pending.decode("utf-8"))
            except UnicodeDecodeError:
                out.extend("�" for _ in pending)
            pending.clear()

    for t in tokens:
        if len(t) == 6 and t.startswith("<0x") and t.endswith(">"):
            try:
                pending.append(int(t[3:5], 16))
                continue
            except ValueError:
                pass
        flush()
        out.append(t)
    flush()
    return out


def _strip(content: str, start: int, stop: int) -> Callable[[List[str]], List[str]]:
    def run(tokens):
        out = []
        for t in tokens:
            lo = 0
            while lo < min(start, len(t)) and t[lo] == content:
                lo += 1
            hi = len(t)
            for _ in range(stop):
                if hi > lo and t[hi - 1] == content:
                    hi -= 1
                else:
                    break
            out.append(t[lo:hi])
        return out

    return run


def build_decoder(spec: Optional[Dict]) -> Optional[Callable[[List[str]], List[str]]]:
    if spec is None:
        return None
    kind = spec.get("type")
    if kind == "ByteLevel":
        return _byte_level_decode
    if kind == "ByteFallback":
        return _byte_fallback_decode
    if kind == "Fuse":
        return lambda tokens: ["".join(tokens)]
    if kind == "Replace":
        pattern = spec["pattern"]
        if "String" not in pattern:
            raise unsupported("Replace pattern", pattern)
        old, new = pattern["String"], spec["content"]
        return lambda tokens: [t.replace(old, new) for t in tokens]
    if kind == "Strip":
        content = spec["content"]
        if len(content) != 1:
            raise unsupported("Strip content", content)
        return _strip(content, int(spec.get("start", 0)), int(spec.get("stop", 0)))
    if kind == "Metaspace":
        rep = spec.get("replacement", "▁")
        scheme = _prepend_scheme(spec)
        # every replacement character of the first token is dropped unless
        # the scheme never prepends one; elsewhere each becomes a space
        return lambda tokens: [
            t.replace(rep, "" if i == 0 and scheme != "never" else " ")
            for i, t in enumerate(tokens)]
    if kind == "Sequence":
        return _chain([build_decoder(d) for d in spec["decoders"]])
    raise unsupported("decoder", kind)
