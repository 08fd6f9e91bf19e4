"""Tokenizers and token-id conversion (counterpart of llm_guided_asr_tpu/text/tokenizers.py,
the Hugging Face half and the token-list converter).

The JAX package wraps ``transformers.AutoTokenizer``; the port reads the
checkpoint directory's ``tokenizer.json``, ``tokenizer_config.json`` and
``special_tokens_map.json`` itself (:class:`LLMTokenizer`), with the
standard library only.  It reads exactly the kinds the repository holds
and computes what ``AutoTokenizer`` computes for them, token for token:

- a ``BPE`` model with rank-ordered merges (no dropout, no subword prefix
  or suffix, no byte fallback), no normalizer and no pre-tokenizer;
- a ``WordLevel`` model behind a ``Split("", "isolated")`` pre-tokenizer
  (one piece per character).

Added and special tokens are matched in the raw text first (leftmost,
longest); the text between them goes through the pre-tokenizer and the
model.  Without a decoder, ``decode`` joins the tokens with spaces, as the
``tokenizers`` library does.  Every other model, normalizer,
pre-tokenizer, post-processor or decoder type raises
``NotImplementedError`` naming it: nothing is tokenized differently in
silence.  Byte-level (Llama-3) and Metaspace (Llama-2) files are among
those not read yet.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

_SPECIAL_NAMES = ("bos_token", "eos_token", "pad_token", "unk_token")


def _unsupported(what: str, value) -> NotImplementedError:
    return NotImplementedError(f"tokenizer.json {what} {value!r} is not supported by the port's "
                               f"tokenizer (BPE without pre-tokenizer, or WordLevel with "
                               f"Split('', 'isolated'))")


def _token_content(entry) -> Optional[str]:
    """A special-token entry of tokenizer_config.json: a string or an
    AddedToken dict with ``content``."""
    if isinstance(entry, dict):
        return entry.get("content")
    return entry


class LLMTokenizer:
    """A Hugging Face fast tokenizer read from its directory; the methods
    the JAX package's callers use of ``AutoTokenizer``."""

    def __init__(self, tokenizer_json: Dict, config: Dict):
        cls = config.get("tokenizer_class", "PreTrainedTokenizerFast")
        if cls != "PreTrainedTokenizerFast":
            raise _unsupported("tokenizer_class", cls)
        model = tokenizer_json.get("model") or {}
        self.model_type = model.get("type")
        if self.model_type not in ("BPE", "WordLevel"):
            raise _unsupported("model type", self.model_type)
        for key in ("normalizer", "post_processor", "decoder"):
            if tokenizer_json.get(key) is not None:
                raise _unsupported(key, tokenizer_json[key].get("type"))
        pre = tokenizer_json.get("pre_tokenizer")
        if self.model_type == "BPE":
            if pre is not None:
                raise _unsupported("pre_tokenizer", pre.get("type"))
            for key in ("dropout", "continuing_subword_prefix", "end_of_word_suffix"):
                if model.get(key) is not None:
                    raise _unsupported(f"BPE {key}", model[key])
            for key in ("byte_fallback", "fuse_unk", "ignore_merges"):
                if model.get(key):
                    raise _unsupported(f"BPE {key}", model[key])
            merges = [tuple(m.split(" ")) if isinstance(m, str) else tuple(m)
                      for m in model.get("merges", [])]
            self.merge_rank = {pair: rank for rank, pair in enumerate(merges)}
        else:
            split = {"type": "Split", "pattern": {"String": ""}, "behavior": "Isolated",
                     "invert": False}
            if pre is None or any(pre.get(k) != v for k, v in split.items()):
                raise _unsupported("pre_tokenizer", pre)
            self.merge_rank = {}
        self.vocab: Dict[str, int] = dict(model["vocab"])
        self.model_unk = model.get("unk_token")
        self.added: Dict[str, int] = {}
        self.special_ids = set()
        for tok in tokenizer_json.get("added_tokens", []):
            if tok.get("lstrip") or tok.get("rstrip") or tok.get("single_word"):
                raise _unsupported("added token flags of", tok["content"])
            self.added[tok["content"]] = tok["id"]
            if tok.get("special"):
                self.special_ids.add(tok["id"])
        self.id_to_token: Dict[int, str] = {i: t for t, i in self.vocab.items()}
        self.id_to_token.update({i: t for t, i in self.added.items()})
        # longest first: the leftmost-longest match of the added vocabulary
        self._added_by_length = sorted(self.added, key=len, reverse=True)
        if config.get("clean_up_tokenization_spaces"):
            raise _unsupported("tokenizer_config clean_up_tokenization_spaces", True)
        for name in _SPECIAL_NAMES:
            setattr(self, name, _token_content(config.get(name)))

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

    def convert_tokens_to_ids(self, tokens: Union[str, Sequence[str]]):
        """A token (or a list of them) -> id(s); an unknown token -> unk."""
        if isinstance(tokens, str):
            i = self._token_id(tokens)
            return self.unk_token_id if i is None else i
        return [self.convert_tokens_to_ids(t) for t in tokens]

    def convert_ids_to_tokens(self, ids: Union[int, Sequence[int]],
                              skip_special_tokens: bool = False):
        """An id (or a list) -> token(s); None for an id outside the vocabulary."""
        if not hasattr(ids, "__iter__"):
            return self.id_to_token.get(int(ids))
        return [self.id_to_token.get(int(i)) for i in ids
                if not (skip_special_tokens and int(i) in self.special_ids)]

    # -- text -> tokens -----------------------------------------------------
    def _split_added(self, text: str) -> List[Tuple[str, bool]]:
        """(piece, is an added token) in order: added tokens matched leftmost,
        longest first, before the model sees the text."""
        out: List[Tuple[str, bool]] = []
        start = pos = 0
        while pos < len(text):
            match = next((t for t in self._added_by_length if text.startswith(t, pos)), None)
            if match is None:
                pos += 1
                continue
            if pos > start:
                out.append((text[start:pos], False))
            out.append((match, True))
            pos = start = pos + len(match)
        if start < len(text):
            out.append((text[start:], False))
        return out

    def _bpe(self, word: str) -> List[str]:
        """Characters (unknown ones as the unk token), then merges applied
        lowest rank first, leftmost first among equal ranks."""
        symbols = [ch if ch in self.vocab else self._unk_piece(ch) for ch in word]
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

    def _unk_piece(self, piece: str) -> str:
        if self.model_unk is None or self.model_unk not in self.vocab:
            raise ValueError(f"{piece!r} is not in the vocabulary and the model has no unk token")
        return self.model_unk

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for piece, is_added in self._split_added(text):
            if is_added:
                out.append(piece)
            elif self.model_type == "BPE":
                out.extend(self._bpe(piece))
            else:  # WordLevel over one-character pieces
                out.extend(ch if ch in self.vocab else self._unk_piece(ch) for ch in piece)
        return out

    def __call__(self, text: str, add_special_tokens: bool = True) -> Dict[str, List[int]]:
        """``{"input_ids": [...]}``.  No post-processor is read, so
        ``add_special_tokens`` adds nothing, as for these files in
        transformers."""
        return {"input_ids": self.convert_tokens_to_ids(self.tokenize(text))}

    # -- ids -> text ----------------------------------------------------
    def convert_tokens_to_string(self, tokens: Iterable[str]) -> str:
        return " ".join(tokens)

    def decode(self, ids: Iterable[int], skip_special_tokens: bool = False) -> str:
        tokens = self.convert_ids_to_tokens([int(i) for i in ids], skip_special_tokens)
        return self.convert_tokens_to_string(t for t in tokens if t is not None)


class HuggingFaceTokenizer:
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
