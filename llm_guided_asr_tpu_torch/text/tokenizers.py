"""Tokenizers and token-id conversion (counterpart of llm_guided_asr_tpu/text/tokenizers.py).

Rebuild of espnet2/text/: char_tokenizer.py, word_tokenizer.py,
hugging_face_tokenizer.py, token_id_converter.py,
hugging_face_token_id_converter.py, build_tokenizer.py.  ``bpe``
(sentencepiece) raises, as in the JAX package, which has no sentencepiece
either.

The JAX package wraps ``transformers.AutoTokenizer``; the port reads the
checkpoint directory's ``tokenizer.json``, ``tokenizer_config.json`` and
``special_tokens_map.json`` itself (:class:`LLMTokenizer`), with the
standard library only, and computes what ``AutoTokenizer`` computes, token
for token and id for id, for the kinds that Llama-2 (a ``Prepend``/
``Replace`` normalizer or a ``Metaspace`` pre-tokenizer, byte fallback),
Llama-3 (a ``Split`` regex and ``ByteLevel``, ``ignore_merges``, a
template post-processor) and Qwen-2.5 (``NFC``, the same split with single
digits) ship, and for plain BPE and WordLevel files.  The pipeline's
pieces are in text/hf_pipeline.py; every type they do not read raises
``NotImplementedError`` naming it, so nothing is tokenized differently in
silence.

What the ``transformers`` classes add on top of the file is copied too:
the special tokens' defaults of ``PreTrainedTokenizerFast``,
``LlamaTokenizerFast`` and ``Qwen2TokenizerFast`` (and their slow names),
special tokens of the config that the file lacks registered as added
tokens, a lone ``ByteLevel`` pre-tokenizer's ``add_prefix_space`` set from
the config, ``LlamaTokenizerFast`` rebuilding its post-processor from
``add_bos_token``/``add_eos_token``, and ``clean_up_tokenization_spaces``.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

from llm_guided_asr_tpu_torch.text import hf_pipeline as hp

_SPECIAL_NAMES = ("bos_token", "eos_token", "pad_token", "unk_token")
# the special tokens' defaults of each class's __init__ (transformers 4.57)
_CLASS_DEFAULTS = {
    "PreTrainedTokenizerFast": {},
    "LlamaTokenizerFast": {"unk_token": "<unk>", "bos_token": "<s>", "eos_token": "</s>"},
    "Qwen2TokenizerFast": {"unk_token": "<|endoftext|>", "eos_token": "<|endoftext|>",
                           "pad_token": "<|endoftext|>"},
}
_CLASS_ALIASES = {"LlamaTokenizer": "LlamaTokenizerFast", "Qwen2Tokenizer": "Qwen2TokenizerFast"}


def _token_content(entry) -> Optional[str]:
    """A special-token entry of tokenizer_config.json: a string or an
    AddedToken dict with ``content``."""
    if isinstance(entry, dict):
        return entry.get("content")
    return entry


def clean_up_tokenization(text: str) -> str:
    """transformers' ``clean_up_tokenization``: spaces before punctuation
    and English contractions removed."""
    for old, new in ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","), (" ' ", "'"),
                     (" n't", "n't"), (" 'm", "'m"), (" 's", "'s"), (" 've", "'ve"),
                     (" 're", "'re")):
        text = text.replace(old, new)
    return text


class LLMTokenizer:
    """A Hugging Face fast tokenizer read from its directory; the methods
    the JAX package's callers use of ``AutoTokenizer``."""

    def __init__(self, tokenizer_json: Dict, config: Dict):
        cls = config.get("tokenizer_class") or "PreTrainedTokenizerFast"
        cls = _CLASS_ALIASES.get(cls, cls)
        if cls not in _CLASS_DEFAULTS:
            raise hp.unsupported("tokenizer_class", cls)
        if config.get("split_special_tokens"):
            raise hp.unsupported("tokenizer_config split_special_tokens", True)
        model = tokenizer_json.get("model") or {}
        self.model = hp.build_model(model)
        self.vocab: Dict[str, int] = dict(model["vocab"])
        self.normalizer = hp.build_normalizer(tokenizer_json.get("normalizer"))
        if cls == "LlamaTokenizerFast" and config.get("add_prefix_space") is not None:
            raise hp.unsupported("tokenizer_config add_prefix_space (a rebuild from the "
                                 "sentencepiece model)", config["add_prefix_space"])
        pre = tokenizer_json.get("pre_tokenizer")
        if pre is not None and pre.get("type") == "ByteLevel":
            # PreTrainedTokenizerFast.__init__ sets a lone ByteLevel's
            # add_prefix_space to the config's (False by default)
            pre = {**pre, "add_prefix_space": bool(config.get("add_prefix_space", False))}
        self.pre_tokenizer = hp.build_pre_tokenizer(pre)
        self.decoder = hp.build_decoder(tokenizer_json.get("decoder"))
        self.clean_up_spaces = bool(config.get("clean_up_tokenization_spaces", False))

        self.added: Dict[str, int] = {}
        self.special_ids = set()
        for tok in tokenizer_json.get("added_tokens", []):
            if tok.get("lstrip") or tok.get("rstrip") or tok.get("single_word"):
                raise hp.unsupported("added token flags of", tok["content"])
            if tok.get("normalized") and self.normalizer is not None:
                raise hp.unsupported("normalized added token", tok["content"])
            self.added[tok["content"]] = tok["id"]
            if tok.get("special"):
                self.special_ids.add(tok["id"])
        specials = dict(_CLASS_DEFAULTS[cls])
        for name in _SPECIAL_NAMES:
            if name in config:
                specials[name] = _token_content(config[name])
        for name in _SPECIAL_NAMES:
            setattr(self, name, specials.get(name))
        extra = [_token_content(t) for t in config.get("additional_special_tokens") or []]
        # special tokens the file lacks become added tokens (the model's id
        # where the vocabulary has them, else the next free one)
        for content in [specials.get(n) for n in _SPECIAL_NAMES] + extra:
            if content is None or content in self.added:
                self._mark_special(content)
                continue
            tid = self.vocab.get(content, len(self))
            self.added[content] = tid
            self.special_ids.add(tid)
        # what convert_ids_to_tokens skips: the config's special tokens
        # (decode skips the file's special added tokens instead)
        self.all_special_ids = {self._token_id(c) for c in
                                [specials.get(n) for n in _SPECIAL_NAMES] + extra
                                if c is not None} - {None}
        self.id_to_token: Dict[int, str] = {i: t for t, i in self.vocab.items()}
        self.id_to_token.update({i: t for t, i in self.added.items()})
        self._added_re = (re.compile("|".join(re.escape(t) for t in sorted(
            self.added, key=len, reverse=True))) if self.added else None)

        post = tokenizer_json.get("post_processor")
        if cls == "LlamaTokenizerFast":
            # LlamaTokenizerFast.update_post_processor
            single = []
            if config.get("add_bos_token", True):
                single.append((self.bos_token, self.bos_token_id))
            single.append(("$A", None))
            if config.get("add_eos_token", False):
                single.append((self.eos_token, self.eos_token_id))
            if any(t is None for t, _ in single):
                raise ValueError("add_bos_token/add_eos_token set but the token is None")
            post = hp.template_processing(single)
        self.post_processor = hp.build_post_processor(post)

    def _mark_special(self, content: Optional[str]) -> None:
        if content is not None and content in self.added:
            self.special_ids.add(self.added[content])

    @classmethod
    def from_pretrained(cls, path: Union[str, Path]) -> "LLMTokenizer":
        """A local checkpoint directory; nothing is looked up on a hub."""
        path = Path(path)
        if not (path / "tokenizer.json").is_file():
            raise FileNotFoundError(f"{path} holds no tokenizer.json (only a local directory "
                                    f"is read; nothing is downloaded)")
        config = {}
        for name in ("special_tokens_map.json", "tokenizer_config.json"):
            if (path / name).is_file():
                config.update(json.loads((path / name).read_text(encoding="utf-8")))
        tok = json.loads((path / "tokenizer.json").read_text(encoding="utf-8"))
        return cls(tok, config)

    # -- ids --------------------------------------------------------------
    def _token_id(self, token: str) -> Optional[int]:
        if token in self.added:
            return self.added[token]
        return self.vocab.get(token)

    @property
    def unk_token_id(self) -> Optional[int]:
        return None if self.unk_token is None else self._token_id(self.unk_token)

    @property
    def bos_token_id(self) -> Optional[int]:
        return None if self.bos_token is None else self.convert_tokens_to_ids(self.bos_token)

    @property
    def eos_token_id(self) -> Optional[int]:
        return None if self.eos_token is None else self.convert_tokens_to_ids(self.eos_token)

    @property
    def pad_token_id(self) -> Optional[int]:
        return None if self.pad_token is None else self.convert_tokens_to_ids(self.pad_token)

    @property
    def vocab_size(self) -> int:
        """The model's vocabulary, added tokens not counted."""
        return len(self.vocab)

    def __len__(self) -> int:
        """The vocabulary with the added tokens (``len(AutoTokenizer)``)."""
        return len(set(self.vocab) | set(self.added))

    def get_vocab(self) -> Dict[str, int]:
        """token -> id of the vocabulary and the added tokens
        (``AutoTokenizer.get_vocab``)."""
        return {**self.vocab, **self.added}

    def convert_tokens_to_ids(self, tokens: Union[str, Sequence[str]]):
        """A token (or a list of them) -> id(s); an unknown token -> unk."""
        if isinstance(tokens, str):
            i = self._token_id(tokens)
            return self.unk_token_id if i is None else i
        return [self.convert_tokens_to_ids(t) for t in tokens]

    def convert_ids_to_tokens(self, ids: Union[int, Sequence[int]],
                              skip_special_tokens: bool = False):
        """An id (or a list) -> token(s); None for an id outside the
        vocabulary.  ``skip_special_tokens`` drops the config's special
        tokens, as transformers does."""
        if not hasattr(ids, "__iter__"):
            return self.id_to_token.get(int(ids))
        return [self.id_to_token.get(int(i)) for i in ids
                if not (skip_special_tokens and int(i) in self.all_special_ids)]

    # -- text -> tokens -----------------------------------------------------
    def _split_added(self, text: str) -> List[Tuple[str, bool, int]]:
        """(piece, is an added token, start offset) in order: added tokens
        matched leftmost, longest first, before the normalizer sees the
        text."""
        if self._added_re is None:
            return [(text, False, 0)] if text else []
        out, start = [], 0
        for m in self._added_re.finditer(text):
            if m.start() > start:
                out.append((text[start:m.start()], False, start))
            out.append((m.group(), True, m.start()))
            start = m.end()
        if start < len(text):
            out.append((text[start:], False, start))
        return out

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for piece, is_added, offset in self._split_added(text):
            if is_added:
                out.append(piece)
                continue
            if self.normalizer is not None:
                piece = self.normalizer(piece)
            for word, _ in self.pre_tokenizer([(piece, offset == 0)] if piece else []):
                out.extend(self.model(word))
        return out

    def __call__(self, text: str, add_special_tokens: bool = True) -> Dict[str, List[int]]:
        """``{"input_ids": [...]}``, the post-processor's special tokens
        added with ``add_special_tokens``."""
        ids = self.convert_tokens_to_ids(self.tokenize(text))
        if add_special_tokens:
            ids = self.post_processor(ids)
        return {"input_ids": ids}

    # -- ids -> text ----------------------------------------------------
    def convert_tokens_to_string(self, tokens: Iterable[str]) -> str:
        tokens = list(tokens)
        if self.decoder is None:
            return " ".join(tokens)
        return "".join(self.decoder(tokens))

    def decode(self, ids: Iterable[int], skip_special_tokens: bool = False) -> str:
        """``skip_special_tokens`` drops the added tokens marked special."""
        tokens = [self.id_to_token.get(int(i)) for i in ids
                  if not (skip_special_tokens and int(i) in self.special_ids)]
        text = self.convert_tokens_to_string(t for t in tokens if t is not None)
        return clean_up_tokenization(text) if self.clean_up_spaces else text


class AbsTokenizer:
    def text2tokens(self, line: str) -> List[str]:
        raise NotImplementedError

    def tokens2text(self, tokens: Iterable[str]) -> str:
        raise NotImplementedError


class CharTokenizer(AbsTokenizer):
    """espnet2/text/char_tokenizer.py: one token a character, ' ' as
    ``space_symbol``, non-linguistic symbols kept whole (or removed)."""

    def __init__(self, non_linguistic_symbols: Optional[Iterable[str]] = None,
                 space_symbol: str = "<space>", remove_non_linguistic_symbols: bool = False):
        self.space_symbol = space_symbol
        self.non_linguistic_symbols = set(non_linguistic_symbols or [])
        self.remove_non_linguistic_symbols = remove_non_linguistic_symbols

    def text2tokens(self, line: str) -> List[str]:
        tokens = []
        while line:
            for sym in self.non_linguistic_symbols:
                if line.startswith(sym):
                    if not self.remove_non_linguistic_symbols:
                        tokens.append(sym)
                    line = line[len(sym):]
                    break
            else:
                ch = line[0]
                tokens.append(self.space_symbol if ch == " " else ch)
                line = line[1:]
        return tokens

    def tokens2text(self, tokens: Iterable[str]) -> str:
        return "".join(" " if t == self.space_symbol else t for t in tokens)


class WordTokenizer(AbsTokenizer):
    """espnet2/text/word_tokenizer.py: split on ``delimiter`` (white space
    when None)."""

    def __init__(self, delimiter: Optional[str] = None):
        self.delimiter = delimiter

    def text2tokens(self, line: str) -> List[str]:
        return line.split(self.delimiter)

    def tokens2text(self, tokens: Iterable[str]) -> str:
        return (self.delimiter or " ").join(tokens)


class HuggingFaceTokenizer(AbsTokenizer):
    """text <-> tokens with an LLM's tokenizer (hugging_face_tokenizer.py),
    read from a local directory on first use."""

    def __init__(self, model_name_or_path: Union[str, Path]):
        self.model = model_name_or_path
        self._tok: Optional[LLMTokenizer] = None

    @property
    def tokenizer(self) -> LLMTokenizer:
        if self._tok is None:
            self._tok = LLMTokenizer.from_pretrained(self.model)
        return self._tok

    def text2tokens(self, line: str) -> List[str]:
        return self.tokenizer.tokenize(line)

    def tokens2text(self, tokens: Iterable[str]) -> str:
        return self.tokenizer.convert_tokens_to_string(list(tokens)).strip()


class TokenIDConverter:
    """A token list <-> ids, with the unk fallback (token_id_converter.py)."""

    def __init__(self, token_list: Union[Path, str, Sequence[str]], unk_symbol: str = "<unk>"):
        from llm_guided_asr_tpu_torch.utils.config import read_token_list

        self.token_list = read_token_list(token_list)
        self.token2id: Dict[str, int] = {}
        for i, t in enumerate(self.token_list):
            if t in self.token2id:
                raise RuntimeError(f"duplicated token: {t}")
            self.token2id[t] = i
        self.unk_symbol = unk_symbol
        if unk_symbol not in self.token2id:
            raise RuntimeError(f"unk symbol {unk_symbol!r} not in token list")
        self.unk_id = self.token2id[unk_symbol]

    def get_num_vocabulary_size(self) -> int:
        return len(self.token_list)

    def ids2tokens(self, ids: Iterable[int]) -> List[str]:
        return [self.token_list[int(i)] for i in ids]

    def tokens2ids(self, tokens: Iterable[str]) -> List[int]:
        return [self.token2id.get(t, self.unk_id) for t in tokens]


class HuggingFaceTokenIDConverter:
    """ids <-> tokens with an LLM's tokenizer (hugging_face_token_id_converter.py)."""

    def __init__(self, model_name_or_path: Union[str, Path, LLMTokenizer]):
        self.tokenizer = (model_name_or_path if isinstance(model_name_or_path, LLMTokenizer)
                          else LLMTokenizer.from_pretrained(model_name_or_path))

    def get_num_vocabulary_size(self) -> int:
        return self.tokenizer.vocab_size

    def ids2tokens(self, ids: Iterable[int]) -> List[str]:
        return self.tokenizer.convert_ids_to_tokens([int(i) for i in ids])

    def tokens2ids(self, tokens: Iterable[str]) -> List[int]:
        return self.tokenizer.convert_tokens_to_ids(list(tokens))


def build_tokenizer(token_type: str, bpemodel: Optional[str] = None,
                    non_linguistic_symbols: Optional[Iterable[str]] = None,
                    space_symbol: str = "<space>", delimiter: Optional[str] = None,
                    g2p: Optional[str] = None) -> AbsTokenizer:
    """espnet2/text/build_tokenizer.py dispatch."""
    if token_type == "char":
        return CharTokenizer(non_linguistic_symbols, space_symbol)
    if token_type == "word":
        return WordTokenizer(delimiter)
    if token_type in ("hugging_face", "whisper"):
        if bpemodel is None:
            raise ValueError(f"token_type={token_type} requires bpemodel (a local tokenizer "
                             f"directory)")
        return HuggingFaceTokenizer(bpemodel)
    if token_type == "phn":
        from llm_guided_asr_tpu_torch.text.phoneme import PhonemeTokenizer

        return PhonemeTokenizer(g2p or "rule_en", non_linguistic_symbols)
    if token_type == "bpe":
        raise NotImplementedError("sentencepiece is not available in this environment; "
                                  "use token_type=hugging_face or char")
    raise ValueError(f"unknown token_type: {token_type}")
