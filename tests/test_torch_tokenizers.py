"""The port's reader of tokenizer.json against transformers.AutoTokenizer,
token for token, on both tiny LLM directories the repository's tests use:
the BPE one of tests/parity/tiny_llm_bpe/ and the char-level WordLevel one
that make_tiny_llm_dir writes.  An unsupported tokenizer.json raises
(tests/test_torch_llm_tokenizers.py holds the LLM kinds)."""

import json
import shutil
from pathlib import Path

import pytest
from transformers import AutoTokenizer

from llm_guided_asr_tpu.utils.testing import make_tiny_llm_dir
from llm_guided_asr_tpu_torch.text.tokenizers import (
    HuggingFaceTokenIDConverter,
    HuggingFaceTokenizer,
    LLMTokenizer,
    TokenIDConverter,
)

BPE_DIR = Path(__file__).resolve().parent / "parity" / "tiny_llm_bpe"
TEXTS = [
    'fix "((HYP))" then reply: ',  # the golden trained-guided template
    'words: ((BIAS)) fix "((HYP))" -> "',
    'fix "((HYP))" -> "',
    "abc, cab, bb",  # bias words joined as Speech2Text joins them
    "a<s>b</s> c<pad><unk>",  # special tokens inside text
    "(((x)))",  # leftmost merge among equal ranks
    "HYHYP ((((HY))",
    "Zq é\tü",  # characters outside the vocabulary
    "",
    "   ",
]
CHAR_LIST = ["<blank>", "<unk>", "a", "b", "c", "ab", "▁a", "<space>", "<sos/eos>"]


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    char_dir = make_tiny_llm_dir(tmp_path_factory.mktemp("tiny_llm_tok") / "model")
    return {"bpe": BPE_DIR, "wordlevel": char_dir}


@pytest.mark.parametrize("kind", ["bpe", "wordlevel"])
def test_tokenizer_matches_auto_tokenizer(dirs, kind):
    hf = AutoTokenizer.from_pretrained(dirs[kind])
    port = LLMTokenizer.from_pretrained(dirs[kind])
    for name in ("bos_token_id", "eos_token_id", "pad_token_id", "unk_token_id", "vocab_size"):
        assert getattr(port, name) == getattr(hf, name), name
    for text in TEXTS + [t.replace("▁", " ") for t in CHAR_LIST]:
        assert port.tokenize(text) == hf.tokenize(text), text
        for special in (True, False):
            ids = port(text, add_special_tokens=special)["input_ids"]
            assert ids == hf(text, add_special_tokens=special)["input_ids"], text
        for skip in (False, True):
            assert port.decode(ids, skip_special_tokens=skip) == hf.decode(
                ids, skip_special_tokens=skip), text
        tokens = port.tokenize(text)
        assert port.convert_tokens_to_string(tokens) == hf.convert_tokens_to_string(tokens)
    every_id = list(range(len(hf) + 2))  # two past the vocabulary: None
    assert port.convert_ids_to_tokens(every_id) == hf.convert_ids_to_tokens(every_id)
    assert port.convert_ids_to_tokens(3) == hf.convert_ids_to_tokens(3)
    names = ['"', "((", "HY", "<s>", "zz", "a", "ab"]
    assert port.convert_tokens_to_ids(names) == hf.convert_tokens_to_ids(names)
    assert port.convert_tokens_to_ids('"') == hf.convert_tokens_to_ids('"')


def test_token_converters(dirs, tmp_path):
    hf = AutoTokenizer.from_pretrained(dirs["bpe"])
    tok = HuggingFaceTokenizer(dirs["bpe"])
    conv = HuggingFaceTokenIDConverter(dirs["bpe"])
    ids = hf('fix "((HYP))"')["input_ids"]
    assert conv.ids2tokens(ids) == hf.convert_ids_to_tokens(ids)
    assert conv.tokens2ids(conv.ids2tokens(ids)) == ids
    assert conv.get_num_vocabulary_size() == hf.vocab_size
    tokens = tok.text2tokens(" ab c ")
    assert tok.tokens2text(tokens) == hf.convert_tokens_to_string(tokens).strip()
    token_file = tmp_path / "tokens.txt"
    token_file.write_text("\n".join(CHAR_LIST) + "\n\n")
    tc = TokenIDConverter(token_file)
    assert tc.token_list == CHAR_LIST and tc.get_num_vocabulary_size() == len(CHAR_LIST)
    assert tc.tokens2ids(["a", "zz", "c"]) == [2, 1, 4]
    assert tc.ids2tokens([4, 2]) == ["c", "a"]
    with pytest.raises(RuntimeError, match="unk symbol"):
        TokenIDConverter(["a", "b"])


@pytest.mark.parametrize("edit,what", [
    (lambda t: t["model"].update(type="Unigram"), "Unigram"),
    (lambda t: t.update(normalizer={"type": "NFKC"}), "NFKC"),
    (lambda t: t.update(normalizer={"type": "ByteLevel"}), "ByteLevel"),
    (lambda t: t.update(decoder={"type": "WordPiece", "prefix": "##"}), "WordPiece"),
    (lambda t: t.update(post_processor={"type": "RobertaProcessing"}), "RobertaProcessing"),
    (lambda t: t["model"].update(dropout=0.1), "dropout"),
    (lambda t: t["added_tokens"][0].update(lstrip=True), "added token"),
])
def test_unsupported_tokenizer_json_raises(tmp_path, edit, what):
    for name in ("tokenizer.json", "tokenizer_config.json", "special_tokens_map.json"):
        shutil.copy(BPE_DIR / name, tmp_path / name)
    tok = json.loads((tmp_path / "tokenizer.json").read_text())
    edit(tok)
    (tmp_path / "tokenizer.json").write_text(json.dumps(tok))
    with pytest.raises(NotImplementedError, match=what):
        LLMTokenizer.from_pretrained(tmp_path)


def test_cleaned_up_decoding_is_not_read(tmp_path):
    """With clean_up_tokenization_spaces transformers rewrites the decoded
    text (" ," -> ","); the port's decode does the same."""
    for name in ("tokenizer.json", "special_tokens_map.json"):
        shutil.copy(BPE_DIR / name, tmp_path / name)
    config = json.loads((BPE_DIR / "tokenizer_config.json").read_text())
    (tmp_path / "tokenizer_config.json").write_text(
        json.dumps({**config, "clean_up_tokenization_spaces": True}))
    hf = AutoTokenizer.from_pretrained(tmp_path)
    port = LLMTokenizer.from_pretrained(tmp_path)
    for text in ("abc , cab . bb ? a ! c", "a n't b 's c 've 're 'm"):
        ids = hf(text)["input_ids"]
        assert port.decode(ids) == hf.decode(ids)
    ids = hf("abc , cab . bb")["input_ids"]
    assert port.decode(ids) != port.convert_tokens_to_string(port.convert_ids_to_tokens(ids))


def test_no_local_tokenizer_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="nothing is downloaded"):
        LLMTokenizer.from_pretrained(tmp_path / "meta-llama" / "Llama-3.2-1B")
