"""Port vs JAX, the text layer: the char, word and phoneme tokenizers,
``build_tokenizer``'s dispatch, the text cleaners, ``TokenIDConverter`` and
the ``CommonPreprocessor`` of the dataset's ``text`` type (with the mixed-
vocab ``ctc_text`` field and a cleaner) give the same tokens and ids as the
JAX package's copies (exact)."""

import numpy as np
import pytest
import torch

from llm_guided_asr_tpu.data import dataset as jdataset
from llm_guided_asr_tpu.text import cleaner as jcleaner
from llm_guided_asr_tpu.text import phoneme as jphoneme
from llm_guided_asr_tpu.text import tokenizers as jtok
from llm_guided_asr_tpu_torch.data import dataset as tdataset
from llm_guided_asr_tpu_torch.text import cleaner as tcleaner
from llm_guided_asr_tpu_torch.text import phoneme as tphoneme
from llm_guided_asr_tpu_torch.text import tokenizers as ttok

torch.set_num_threads(1)

LINES = ["hello world", "  two  spaces ", "<noise> the cat <noise>sat", "Mr. Smith's (aside) café",
         "tion ough igh qu x", "", "ÀÉÎ—naïve [laugh] 42"]
NLS = ["<noise>", "[laugh]"]


@pytest.mark.parametrize("kind", ["char", "char_nls", "char_remove", "word", "word_delim",
                                  "phn", "phn_lexicon"])
def test_tokenizers_match_jax(tmp_path, kind):
    lexicon = tmp_path / "lexicon.txt"
    lexicon.write_text("HELLO  HH AH L OW\nWORLD W ER L D\nTHE(2)  DH IY\nTHE  DH AH\n")
    make = {
        "char": lambda m: m.CharTokenizer(),
        "char_nls": lambda m: m.CharTokenizer(NLS),
        "char_remove": lambda m: m.CharTokenizer(NLS, remove_non_linguistic_symbols=True),
        "word": lambda m: m.WordTokenizer(),
        "word_delim": lambda m: m.WordTokenizer(" "),
        "phn": lambda m: (jphoneme if m is jtok else tphoneme).PhonemeTokenizer("rule_en", NLS),
        "phn_lexicon": lambda m: (jphoneme if m is jtok else tphoneme).PhonemeTokenizer(
            f"lexicon:{lexicon}"),
    }[kind]
    j, t = make(jtok), make(ttok)
    for line in LINES:
        tokens = t.text2tokens(line)
        assert tokens == j.text2tokens(line), line
        assert t.tokens2text(tokens) == j.tokens2text(tokens)


def test_build_tokenizer_dispatch_matches_jax():
    for token_type in ("char", "word", "phn"):
        j = jtok.build_tokenizer(token_type, non_linguistic_symbols=NLS)
        t = ttok.build_tokenizer(token_type, non_linguistic_symbols=NLS)
        assert type(t).__name__ == type(j).__name__
        assert [t.text2tokens(x) for x in LINES] == [j.text2tokens(x) for x in LINES]
    with pytest.raises(NotImplementedError, match="sentencepiece"):
        ttok.build_tokenizer("bpe", bpemodel="x.model")
    for token_type in ("hugging_face", "whisper"):
        assert isinstance(ttok.build_tokenizer(token_type, bpemodel="tests/parity/tiny_llm_bpe"),
                          ttok.HuggingFaceTokenizer)
        with pytest.raises(ValueError, match="requires bpemodel"):
            ttok.build_tokenizer(token_type)
    with pytest.raises(ValueError, match="unknown token_type"):
        ttok.build_tokenizer("bogus")
    with pytest.raises(RuntimeError, match="external engine"):
        tphoneme.PhonemeTokenizer("g2p_en")


@pytest.mark.parametrize("names", [["tacotron"], "basic", ["whisper_basic", "upper"], ["lower"]])
def test_cleaners_match_jax(names):
    j, t = jcleaner.TextCleaner(names), tcleaner.TextCleaner(names)
    for line in LINES:
        assert t(line) == j(line), line
    with pytest.raises(RuntimeError, match="external package"):
        tcleaner.TextCleaner("jaconv")
    with pytest.raises(ValueError, match="unknown cleaner"):
        tcleaner.TextCleaner("bogus")


def test_preprocessor_and_text_type_match_jax(tmp_path):
    """A dataset of raw text with a cleaner and a mixed-vocab ctc_text
    field: the same int64 ids from both packages."""
    vocab = ["<blank>", "<unk>"] + sorted(set("".join(LINES).lower()) - {" "}) + \
        ["<space>", "<sos/eos>"]
    words = ["<blank>", "<unk>", "hello", "world", "the", "cat", "<sos/eos>"]
    text = tmp_path / "text"
    text.write_text("".join(f"u{i} {line}\n" for i, line in enumerate(LINES) if line.strip()))

    def build(m, d):
        field = {"ctc_text": (m.WordTokenizer(), m.TokenIDConverter(words))}
        cleaner = (jcleaner if m is jtok else tcleaner).TextCleaner(["lower"])
        pre = d.CommonPreprocessor(m.CharTokenizer(NLS), m.TokenIDConverter(vocab),
                                   field_tokenizers=field, cleaner=cleaner)
        return d.ESPnetDataset([(str(text), "text", "text"), (str(text), "ctc_text", "text")],
                               preprocess=pre)

    j, t = build(jtok, jdataset), build(ttok, tdataset)
    assert t.keys == j.keys
    for uid in t.keys:
        ti, ji = t[uid], j[uid]
        assert ti.keys() == ji.keys()
        for k in ti:
            assert ti[k].dtype == ji[k].dtype == np.int64
            np.testing.assert_array_equal(ti[k], ji[k], err_msg=f"{uid} {k}")
        assert t.peek_length(uid) == j.peek_length(uid)
    with pytest.raises(RuntimeError, match="no tokenizer"):
        tdataset.CommonPreprocessor()("u", {"text": "abc"})
