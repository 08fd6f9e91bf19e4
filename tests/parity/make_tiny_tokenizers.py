#!/usr/bin/env python3
"""Write the tiny LLM tokenizer fixtures under tests/parity/tiny_llm_*/.

Each is a few hundred tokens, trained in memory with the ``tokenizers``
library on the corpus below (no download), in the layout that
``transformers/convert_slow_tokenizer.py`` gives a real model:

- ``tiny_llm_bytelevel``: Llama-3's (``TikTokenConverter``): its Split
  regex with ``\\p{N}{1,3}``, ByteLevel without a regex, ``ignore_merges``,
  the ByteLevel decoder, and a post-processor that is a Sequence of
  ByteLevel and the ``<|begin_of_text|>`` template;
  ``PreTrainedTokenizerFast`` with ``clean_up_tokenization_spaces``.  It
  also holds a tiny Llama sized to the vocabulary (config.json and
  model.safetensors, tied embeddings, llama3 RoPE scaling);
- ``tiny_llm_qwen``: Qwen-2.5's (``Qwen2Converter``): NFC, the same split
  with single digits, the ByteLevel post-processor, ``Qwen2Tokenizer``
  with no bos and ``<|im_end|>`` as eos;
- ``tiny_llm_metaspace``: Llama-2's (``LlamaConverter``, legacy): a
  ``Prepend``/``Replace`` normalizer, no pre-tokenizer, ``byte_fallback``
  with all 256 ``<0xNN>`` tokens and ``fuse_unk``, the
  Replace/ByteFallback/Fuse/Strip decoder, ``LlamaTokenizerFast`` with
  ``add_bos_token``;
- ``tiny_llm_metaspace_legacy``: the older Metaspace pre-tokenizer layout
  (``prepend_scheme`` always, ``split``), a ByteFallback/Metaspace/Fuse
  decoder, ``LlamaTokenizer`` with ``add_eos_token`` and no bos.

CJK and emoji are kept out of every training alphabet, so the tests reach
the byte paths.  Run from the repository root:

    python tests/parity/make_tiny_tokenizers.py
"""

from __future__ import annotations

import json
from pathlib import Path

OUT = Path(__file__).resolve().parent
LLAMA3_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}|"
                  r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
QWEN_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}|"
                r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
CORPUS = """\
The quick brown fox jumps over the lazy dog.  It's what they'd said we'll see.
Fix the hypothesis: "((HYP))" -> " and answer with the corrected transcript.
Words: ((BIAS)) then fix "((HYP))" then reply.
I'm sure you're right, we've been there and THEY'LL KNOW IT'S TRUE.
In 2024 the 12345 runners ran 42 km in 3 hours, 7 minutes and 59 seconds.
A café in São Paulo served crème brûlée; the naïve façade of Ærøskøbing.
Über die Straße gehen zwölf Männer, señor; déjà vu à la carte.
speech recognition with a large language model guiding the decoder
translate this sentence into german please and keep the numbers 1 2 3
hello world, hello there! how are you? fine, thanks. and you?
the cat sat on the mat with a hat and a bat and a rat.
"""


def _texts():
    lines = [ln for ln in CORPUS.splitlines() if ln.strip()]
    return lines * 4 + [ln.lower() for ln in lines] * 2


def _write(tok, out: Path, config: dict, special_map: dict):
    out.mkdir(parents=True, exist_ok=True)
    (out / "tokenizer.json").write_text(tok.to_str(pretty=True) + "\n", encoding="utf-8")
    (out / "tokenizer_config.json").write_text(json.dumps(config, indent=2, ensure_ascii=False)
                                               + "\n", encoding="utf-8")
    (out / "special_tokens_map.json").write_text(json.dumps(special_map, indent=2) + "\n",
                                                 encoding="utf-8")


def _added_decoder(tok) -> dict:
    return {str(i): {"content": t.content, "lstrip": False, "normalized": False, "rstrip": False,
                     "single_word": False, "special": True}
            for i, t in sorted(tok.get_added_tokens_decoder().items())}


def byte_level(kind: str):
    from tokenizers import AddedToken, Regex, Tokenizer, decoders, models, normalizers
    from tokenizers import pre_tokenizers, processors, trainers

    tok = Tokenizer(models.BPE(fuse_unk=False, ignore_merges=kind == "llama3"))
    pattern = LLAMA3_PATTERN if kind == "llama3" else QWEN_PATTERN
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(pattern), behavior="isolated", invert=False),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False),
    ])
    if kind == "qwen":
        tok.normalizer = normalizers.NFC()
    trainer = trainers.BpeTrainer(vocab_size=480, min_frequency=2, show_progress=False,
                                  initial_alphabet=pre_tokenizers.ByteLevel.alphabet())
    tok.train_from_iterator(_texts(), trainer)
    tok.decoder = decoders.ByteLevel()
    if kind == "llama3":
        specials = ["<|begin_of_text|>", "<|end_of_text|>", "<|reserved_special_token_0|>",
                    "<|start_header_id|>", "<|end_header_id|>", "<|eot_id|>"]
        tok.add_special_tokens([AddedToken(t, normalized=False, special=True) for t in specials])
        bos = tok.token_to_id("<|begin_of_text|>")
        tok.post_processor = processors.Sequence([
            processors.ByteLevel(trim_offsets=False),
            processors.TemplateProcessing(single="<|begin_of_text|> $A",
                                          pair="<|begin_of_text|> $A <|begin_of_text|> $B:1",
                                          special_tokens=[("<|begin_of_text|>", bos)]),
        ])
        config = {"added_tokens_decoder": _added_decoder(tok),
                  "bos_token": "<|begin_of_text|>", "clean_up_tokenization_spaces": True,
                  "eos_token": "<|end_of_text|>",
                  "model_input_names": ["input_ids", "attention_mask"],
                  "model_max_length": 131072, "tokenizer_class": "PreTrainedTokenizerFast"}
        special_map = {"bos_token": "<|begin_of_text|>", "eos_token": "<|end_of_text|>"}
        return tok, config, special_map
    specials = ["<|endoftext|>", "<|im_start|>", "<|im_end|>"]
    tok.add_special_tokens([AddedToken(t, normalized=False, special=True) for t in specials])
    tok.post_processor = processors.ByteLevel(trim_offsets=False)
    config = {"add_prefix_space": False, "added_tokens_decoder": _added_decoder(tok),
              "additional_special_tokens": ["<|im_start|>", "<|im_end|>"],
              "bos_token": None, "clean_up_tokenization_spaces": False,
              "eos_token": "<|im_end|>", "errors": "replace", "model_max_length": 131072,
              "pad_token": "<|endoftext|>", "split_special_tokens": False,
              "tokenizer_class": "Qwen2Tokenizer", "unk_token": None}
    special_map = {"additional_special_tokens": ["<|im_start|>", "<|im_end|>"],
                   "eos_token": "<|im_end|>", "pad_token": "<|endoftext|>"}
    return tok, config, special_map


def metaspace(legacy_pre_tokenizer: bool):
    from tokenizers import Tokenizer, decoders, models, normalizers, pre_tokenizers
    from tokenizers import processors, trainers

    byte_tokens = [f"<0x{b:02X}>" for b in range(256)]
    tok = Tokenizer(models.BPE(unk_token="<unk>", byte_fallback=True, fuse_unk=True))
    if legacy_pre_tokenizer:
        tok.pre_tokenizer = pre_tokenizers.Metaspace(replacement="▁", prepend_scheme="always",
                                                     split=True)
    else:
        tok.normalizer = normalizers.Sequence([normalizers.Prepend("▁"),
                                               normalizers.Replace(" ", "▁")])
        # trained word by word, as sentencepiece keeps merges inside words
        tok.pre_tokenizer = pre_tokenizers.Metaspace(replacement="▁", prepend_scheme="never",
                                                     split=True)
    alphabet = sorted(set("".join(_texts())) - set(" "))
    trainer = trainers.BpeTrainer(vocab_size=560, min_frequency=2, show_progress=False,
                                  special_tokens=["<unk>", "<s>", "</s>"] + byte_tokens,
                                  initial_alphabet=alphabet + ["▁"], limit_alphabet=len(alphabet) + 1)
    tok.train_from_iterator(_texts(), trainer)
    # the byte tokens belong to the model's vocabulary, not the added ones
    spec = json.loads(tok.to_str())
    spec["added_tokens"] = [a for a in spec["added_tokens"] if a["content"] not in byte_tokens]
    tok = Tokenizer.from_str(json.dumps(spec))
    if legacy_pre_tokenizer:
        tok.decoder = decoders.Sequence([
            decoders.ByteFallback(),
            decoders.Metaspace(replacement="▁", prepend_scheme="always", split=True),
            decoders.Fuse()])
        eos = tok.token_to_id("</s>")
        tok.post_processor = processors.TemplateProcessing(
            single="$A </s>", pair="$A </s> $B:1 </s>:1", special_tokens=[("</s>", eos)])
        config = {"add_bos_token": False, "add_eos_token": True,
                  "added_tokens_decoder": _added_decoder(tok), "bos_token": "<s>",
                  "clean_up_tokenization_spaces": False, "eos_token": "</s>",
                  "legacy": True, "model_max_length": 4096, "pad_token": None,
                  "tokenizer_class": "LlamaTokenizer", "unk_token": "<unk>"}
    else:
        tok.pre_tokenizer = None
        tok.decoder = decoders.Sequence([decoders.Replace("▁", " "), decoders.ByteFallback(),
                                         decoders.Fuse(), decoders.Strip(" ", 1, 0)])
        bos = tok.token_to_id("<s>")
        tok.post_processor = processors.TemplateProcessing(
            single="<s> $A", pair="<s> $A <s>:1 $B:1", special_tokens=[("<s>", bos)])
        config = {"add_bos_token": True, "add_eos_token": False,
                  "added_tokens_decoder": _added_decoder(tok), "bos_token": "<s>",
                  "clean_up_tokenization_spaces": False, "eos_token": "</s>",
                  "legacy": False, "model_max_length": 4096, "pad_token": None,
                  "padding_side": "right", "tokenizer_class": "LlamaTokenizerFast",
                  "unk_token": "<unk>"}
    special_map = {"bos_token": "<s>", "eos_token": "</s>", "unk_token": "<unk>"}
    return tok, config, special_map


def write_llm(out: Path, vocab_size: int, bos: int, eos: int, seed: int = 0):
    """A tiny Llama-3-shaped LLM (tied embeddings, llama3 RoPE scaling)."""
    import torch
    from transformers import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig(vocab_size=vocab_size, hidden_size=32, intermediate_size=48,
                      num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                      max_position_embeddings=512, rms_norm_eps=1e-5, rope_theta=500000.0,
                      rope_scaling={"rope_type": "llama3", "factor": 32.0,
                                    "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                                    "original_max_position_embeddings": 64},
                      tie_word_embeddings=True, bos_token_id=bos, eos_token_id=eos)
    torch.manual_seed(seed)
    LlamaForCausalLM(cfg).save_pretrained(out)


def main():
    for name, (tok, config, special_map) in {
        "tiny_llm_bytelevel": byte_level("llama3"),
        "tiny_llm_qwen": byte_level("qwen"),
        "tiny_llm_metaspace": metaspace(legacy_pre_tokenizer=False),
        "tiny_llm_metaspace_legacy": metaspace(legacy_pre_tokenizer=True),
    }.items():
        out = OUT / name
        _write(tok, out, config, special_map)
        if name == "tiny_llm_bytelevel":
            write_llm(out, tok.get_vocab_size(with_added_tokens=True),
                      tok.token_to_id("<|begin_of_text|>"), tok.token_to_id("<|end_of_text|>"))
        print(f"{out}: {tok.get_vocab_size(with_added_tokens=True)} tokens")


if __name__ == "__main__":
    main()
