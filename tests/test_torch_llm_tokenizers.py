"""The port's reader of the LLM tokenizer kinds against transformers'
AutoTokenizer, token for token and id for id: the Llama-3 byte-level,
Qwen-2.5 byte-level and Llama-2 Metaspace fixtures that
tests/parity/make_tiny_tokenizers.py writes, pre-tokenizer variants built
in memory with the tokenizers library, the regex classes on non-ASCII
text, and the guided prompt and CTC-to-LLM map against the JAX package's
on the byte-level fixture."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from tokenizers import Regex, Tokenizer, decoders, models, pre_tokenizers
from transformers import AutoTokenizer, PreTrainedTokenizerFast

from llm_guided_asr_tpu.models.llm.prompt import build_ctc_to_llm_map as j_ctc_map
from llm_guided_asr_tpu.models.llm.prompt import split_template as j_split_template
from llm_guided_asr_tpu_torch.models.llm.prompt import build_ctc_to_llm_map, split_template
from llm_guided_asr_tpu_torch.text import hf_pipeline
from llm_guided_asr_tpu_torch.text.tokenizers import HuggingFaceTokenizer, LLMTokenizer

torch.set_num_threads(1)

PARITY = Path(__file__).resolve().parent / "parity"
KINDS = ("bytelevel", "qwen", "metaspace", "metaspace_legacy")
WORDS = ["It's", "they'D", "WE'LL", "i'm", "you're", "'ve", "don't", "THE", "The", "hello",
         "world", "((HYP))", '"', "->", "!!", "?", "...", "x"]
DIGITS = ["1", "12", "123", "1234", "12345", "123456", "1234567", "٣", "½", "Ⅻ"]
SPACES = ["\n", "\n\n", "\r\n", "  ", "   ", "\t", " \n ", "　", "\x1c", "\xa0"]
NON_ASCII = ["café", "São", "Ærøskøbing", "naïve", "straße", "é", "ǅ", "中文", "日本語のテキスト",
             "😀", "👍🏽", "🇩🇪", "é"]
SPECIAL = ["<s>", "</s>", "<unk>", "<|begin_of_text|>", "<|im_end|>", "<0x41>"]
TEMPLATE = 'Words: ((BIAS)) then fix: ((HYP)) then reply: "'


def seeded_texts(n=120, seed=0):
    rng = np.random.default_rng(seed)
    pool = WORDS + DIGITS + SPACES + NON_ASCII + SPECIAL
    seps = [" ", "", "  ", "\n"]
    texts = ["", " ", "hello world", TEMPLATE, "ŉ" * 3]
    for _ in range(n):
        k = int(rng.integers(1, 8))
        texts.append("".join(pool[int(rng.integers(len(pool)))] + seps[int(rng.integers(4))]
                             for _ in range(k)))
    return texts


def assert_same(port, hf, texts, seed=0):
    for text in texts:
        tokens = port.tokenize(text)
        assert tokens == hf.tokenize(text), repr(text)
        assert port.convert_tokens_to_ids(tokens) == hf.convert_tokens_to_ids(tokens), repr(text)
        for special in (True, False):
            ids = port(text, add_special_tokens=special)["input_ids"]
            assert ids == hf(text, add_special_tokens=special)["input_ids"], repr(text)
            for skip in (False, True):
                assert port.decode(ids, skip_special_tokens=skip) == hf.decode(
                    ids, skip_special_tokens=skip), repr(text)
        assert port.convert_tokens_to_string(tokens) == hf.convert_tokens_to_string(tokens)
    # arbitrary id sequences: byte pieces that are not valid UTF-8, specials
    rng = np.random.default_rng(seed)
    for _ in range(100):
        ids = rng.integers(0, len(hf), int(rng.integers(1, 12))).tolist()
        for skip in (False, True):
            assert port.decode(ids, skip_special_tokens=skip) == hf.decode(
                ids, skip_special_tokens=skip), ids
        tokens = hf.convert_ids_to_tokens(ids)
        assert port.convert_tokens_to_string(tokens) == hf.convert_tokens_to_string(tokens)


@pytest.mark.parametrize("kind", KINDS)
def test_fixture_matches_auto_tokenizer(kind):
    d = PARITY / f"tiny_llm_{kind}"
    hf = AutoTokenizer.from_pretrained(d)
    port = LLMTokenizer.from_pretrained(d)
    for name in ("bos_token_id", "eos_token_id", "pad_token_id", "unk_token_id", "vocab_size"):
        assert getattr(port, name) == getattr(hf, name), name
    assert len(port) == len(hf)
    assert_same(port, hf, seeded_texts(seed=KINDS.index(kind)), seed=KINDS.index(kind))
    every = list(range(len(hf) + 2))
    assert port.convert_ids_to_tokens(every) == hf.convert_ids_to_tokens(every)
    assert port.convert_ids_to_tokens(every, skip_special_tokens=True) == \
        hf.convert_ids_to_tokens(every, skip_special_tokens=True)
    names = ["zzqq", '"', "<s>", "<0xE4>", "Ġthe", "▁the"]
    assert port.convert_tokens_to_ids(names) == hf.convert_tokens_to_ids(names)


def test_fixtures_reach_the_paths_they_are_for():
    """Byte fallback, fused unks, digit runs and template tokens occur."""
    meta = LLMTokenizer.from_pretrained(PARITY / "tiny_llm_metaspace")
    assert "<0xE4>" in meta.tokenize("中文")
    assert meta("ok")["input_ids"][0] == meta.bos_token_id
    legacy = LLMTokenizer.from_pretrained(PARITY / "tiny_llm_metaspace_legacy")
    assert legacy("ok")["input_ids"][-1] == legacy.eos_token_id
    llama3 = LLMTokenizer.from_pretrained(PARITY / "tiny_llm_bytelevel")
    assert [w for w, _ in llama3.pre_tokenizer([("1234567", True)])] == ["123", "456", "7"]
    assert llama3("x")["input_ids"][0] == llama3.bos_token_id
    qwen = LLMTokenizer.from_pretrained(PARITY / "tiny_llm_qwen")
    assert [w for w, _ in qwen.pre_tokenizer([("123", True)])] == ["1", "2", "3"]
    assert qwen.bos_token_id is None and qwen.eos_token == "<|im_end|>"
    assert qwen.decode(qwen("😀")["input_ids"][:1]) == "�"


def _byte_model():
    alphabet = pre_tokenizers.ByteLevel.alphabet()
    vocab = {c: i for i, c in enumerate(sorted(alphabet))}
    for merged in ("Ġt", "he", "Ġthe", "ĠĠ", "ll", "llo"):
        vocab[merged] = len(vocab)
    merges = [("Ġ", "t"), ("h", "e"), ("Ġt", "he"), ("Ġ", "Ġ"), ("l", "l"), ("ll", "o")]
    return models.BPE(vocab=vocab, merges=merges, ignore_merges=False)


def _meta_model():
    vocab = {"<unk>": 0, "<s>": 1, "</s>": 2, **{f"<0x{b:02X}>": 3 + b for b in range(256)}}
    for piece in ("▁", "a", "b", "c", "e", "h", "l", "o", "t", "▁t", "he", "▁the", "ll", "▁a"):
        vocab[piece] = len(vocab)
    merges = [("▁", "t"), ("h", "e"), ("▁t", "he"), ("l", "l"), ("▁", "a")]
    return models.BPE(vocab=vocab, merges=merges, unk_token="<unk>", byte_fallback=True,
                      fuse_unk=True)


def _variants():
    out = []
    for behavior in ("removed", "isolated", "merged_with_previous", "merged_with_next",
                     "contiguous"):
        for invert in (False, True):
            for kind, pattern in (("regex", Regex(r"\s+|\p{N}")), ("string", "l")):
                out.append((f"split-{behavior}-{invert}-{kind}", "byte", pre_tokenizers.Sequence([
                    pre_tokenizers.Split(pattern, behavior=behavior, invert=invert),
                    pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)]),
                    decoders.ByteLevel(), {}))
    for prefix in (False, True):
        out.append((f"bytelevel-regex-{prefix}", "byte",
                    pre_tokenizers.ByteLevel(add_prefix_space=True, use_regex=True),
                    decoders.ByteLevel(), {"add_prefix_space": prefix}))
        out.append((f"bytelevel-seq-{prefix}", "byte", pre_tokenizers.Sequence([
            pre_tokenizers.Split(" ", "merged_with_next"),
            pre_tokenizers.ByteLevel(add_prefix_space=prefix, use_regex=False)]),
            decoders.ByteLevel(), {}))
    for scheme in ("first", "always", "never"):
        for split in (False, True):
            out.append((f"metaspace-{scheme}-{split}", "meta",
                        pre_tokenizers.Metaspace(replacement="▁", prepend_scheme=scheme,
                                                 split=split),
                        decoders.Sequence([decoders.ByteFallback(), decoders.Metaspace(
                            replacement="▁", prepend_scheme=scheme, split=split),
                            decoders.Fuse()]), {}))
    return out


VARIANTS = _variants()


@pytest.mark.parametrize("name,model,pre,dec,config", VARIANTS, ids=[v[0] for v in VARIANTS])
def test_pre_tokenizer_variants(name, model, pre, dec, config):
    tok = Tokenizer(_byte_model() if model == "byte" else _meta_model())
    tok.pre_tokenizer = pre
    tok.decoder = dec
    if model == "meta":
        from tokenizers import AddedToken

        tok.add_special_tokens([AddedToken(t, normalized=False, special=True)
                                for t in ("<unk>", "<s>", "</s>")])
    hf = PreTrainedTokenizerFast(tokenizer_object=tok, **config)
    port = LLMTokenizer(json.loads(tok.to_str()), config)
    texts = ["hello the hell 42", " the  lot\n\n1 2", "<s>the hello</s> all", "中a b", "",
             "  leading", "trailing  ", "x1y22z"]
    assert_same(port, hf, texts + seeded_texts(n=20, seed=len(name)), seed=len(name))


def test_regex_classes_match_oniguruma_on_non_ascii():
    """\\p{L}, \\p{N} and \\s rebuilt from unicodedata against the
    library's Oniguruma on text drawn from many scripts."""
    pattern = r"\p{L}+|\p{N}{1,3}|\s+(?!\S)|\s+|[^\s\p{L}\p{N}]+"
    split = pre_tokenizers.Split(Regex(pattern), behavior="isolated")
    port = hf_pipeline.compile_oniguruma(pattern)
    rng = np.random.default_rng(7)
    blocks = [(0x20, 0x250), (0x370, 0x530), (0x590, 0x700), (0x900, 0xE00), (0x1100, 0x1200),
              (0x1E00, 0x2200), (0x2460, 0x2500), (0x3000, 0x3100), (0x4E00, 0x4E80),
              (0xAC00, 0xAC80), (0xFF00, 0xFFF0), (0x1D400, 0x1D500), (0x1F300, 0x1F700)]
    for _ in range(200):
        chars = []
        for _ in range(int(rng.integers(1, 24))):
            lo, hi = blocks[int(rng.integers(len(blocks)))]
            chars.append(chr(int(rng.integers(lo, hi))))
        text = "".join(chars)
        want = [p for p, _ in split.pre_tokenize_str(text)]
        got = [t for t, _ in hf_pipeline.split_pieces([(text, True)], port, "Isolated")]
        assert got == want, repr(text)


def test_guided_prompt_and_ctc_map_equal_jax():
    """split_template and the CTC-to-LLM map over the byte-level fixture:
    the port's tokenizer against AutoTokenizer in the JAX functions."""
    d = PARITY / "tiny_llm_bytelevel"
    hf = AutoTokenizer.from_pretrained(d)
    port = LLMTokenizer.from_pretrained(d)
    for template in (TEMPLATE, 'fix ((HYP)) -> "', "((HYP))", None):
        want = j_split_template(hf, template, bos_token_id=hf.bos_token_id,
                                eos_token_id=hf.eos_token_id)
        got = split_template(port, template, bos_token_id=port.bos_token_id,
                             eos_token_id=port.eos_token_id)
        assert got.__dict__ == want.__dict__, template
    assert got.mid_ids is None and split_template(port, TEMPLATE, 1, 2).mid_ids
    # a quote merged into the marker's first token hides it from both
    for fn, tok in ((j_split_template, hf), (split_template, port)):
        with pytest.raises(ValueError, match="not found"):
            fn(tok, 'fix "((HYP))" -> "', bos_token_id=1, eos_token_id=2)
    ctc_tokens = ["<blank>", "<unk>", "a", "the", "▁the", "Ġworld", "café", "12", "中",
                  "<sos/eos>"]
    for a, b in zip(build_ctc_to_llm_map(ctc_tokens, port), j_ctc_map(ctc_tokens, hf)):
        np.testing.assert_array_equal(a, b)
    tok = HuggingFaceTokenizer(d)
    tokens = tok.text2tokens(" Café, it's 2024! ")
    assert tok.tokens2text(tokens) == hf.convert_tokens_to_string(tokens).strip()
