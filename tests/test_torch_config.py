"""Port vs JAX, the config layer: the port's own YAML reader and writer
(llm_guided_asr_tpu_torch/utils/config.py) against PyYAML, whose
``safe_load``/``safe_dump`` the JAX package uses, and the CLI overrides
against the JAX package's ``parse_cli_overrides``/``build_config``.

Equality is exact: the same Python values (floats compared by repr, so
-0.0 and the NaN-free floats must match bit for bit)."""

import math

import pytest
import torch
import yaml
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from llm_guided_asr_tpu.utils import config as jconfig
from llm_guided_asr_tpu_torch.utils import config as tconfig

torch.set_num_threads(1)

TINY = {
    "token_type": "char",
    "token_list": "/data/tokens.txt",
    "frontend_conf": {"n_fft": 256, "hop_length": 128, "n_mels": 23},
    "normalize": "global_mvn",
    "encoder": "conformer",
    "encoder_conf": {"output_size": 32, "attention_heads": 2, "linear_units": 64,
                     "num_blocks": 2, "macaron_style": True, "use_cnn_module": True,
                     "cnn_module_kernel": 7, "dropout_rate": 0.0,
                     "positional_dropout_rate": 0.0, "attention_dropout_rate": 0.0},
    "decoder_conf": {"attention_heads": 2, "linear_units": 64, "num_blocks": 2,
                     "dropout_rate": 0.0, "positional_dropout_rate": 0.0},
    "model_conf": {"ctc_weight": 0.5, "lsm_weight": 0.1},
    "optim": "adam",
    "optim_conf": {"lr": 0.003},
    "scheduler": "warmuplr",
    "scheduler_conf": {"warmup_steps": 60},
    "batch_type": "sorted",
    "batch_size": 8,
    "max_epoch": 28,
    "keep_nbest_models": 3,
    "best_model_criterion": [["valid", "loss", "min"]],
    "speech_pad_multiple": 4000,
    "train_data_path_and_name_and_type": [["/d/train/wav.scp", "speech", "sound"],
                                          ["/d/train/text", "text", "text"]],
    "device": None,
}
GUIDED = {
    **TINY,
    "model": "llm_guided_asr",
    "llm_conf": {
        "model_name_or_path": "tests/parity/tiny_llm_bpe",
        "template_prompt": ("You are a careful transcription fixer.\n\nWords to prefer: "
                            "((BIAS))\nFix this hypothesis: \"((HYP))\"  \n\tanswer -> \""
                            " and keep   spacing, then stop. " * 2),
        "dtype": "float32",
        "pad_token": "<pad>",
    },
    "token_type": "hugging_face",
    "token_list": None,
    "freeze_param": ["encoder", "ctc"],
    "init_param": ["exp/asr/valid.loss.ave_2best.pth:encoder:encoder"],
}
# hand-written YAML of the kinds ESPnet configs hold
HANDWRITTEN = [
    "# a recipe\nencoder: conformer   # the encoder\nencoder_conf:\n    output_size: 256\n"
    "    macaron_style: true\noptim_conf:\n  lr: 1e-3\n  betas: [0.9, 0.98]\n",
    "specaug_conf:\n  freq_mask_width_range:\n  - 0\n  - 27\n  num_time_mask: 2\n",
    "best_model_criterion:\n-   - valid\n    - acc\n    - max\n- [valid, loss, min]\n",
    "a: {b: 1, c: [x, 'y z', \"w\\tv\"], d: {}}\nb: []\nc: ~\nd:\n",
    "flow: [1, 2,\n  3, {x: 1,\n   y: 2}]  # spans lines\nnext: yes\n",
    "---\nk: v\n...\n",
    "quoted: 'it''s\n\n  two lines'\nplain: one\n  two\n\n  three\n",
    "ints: [017, 0x1f, 0o7, 0b11, 1_000, +3, -0, 1:20]\n"
    "floats: [1.0e-3, 1e-3, 1.e-3, .5, -.inf, .NaN, 1:20.5, 6.8523015e+5]\n",
    "bools: [yes, No, ON, off, True, y, n]\nnull: [~, null, NULL, Null, '', ]\n",
    "? complex\n: value\n\"quoted key\": 1\n'single key': 2\n1: int key\n",
    "escapes: \"\\x41\\u00e9\\U0001F600\\N\\_\\L\\P\\0\\a\\e\\\\\\\"\\/ \\\n  joined\"\n",
    "unicode: día ü 漢字\nempty_map: {}\n",
]
UNSUPPORTED = [
    "a: &anchor 1\nb: *anchor\n", "a: !!int 3\n", "a: |\n  block\n", "a: >\n  folded\n",
    "a: 1\n---\nb: 2\n", "%YAML 1.1\n---\na: 1\n", "a: 2001-12-14\n", "<<: {a: 1}\n",
]


def _same(a, b):
    return repr(a) == repr(b)


def test_handwritten_yaml_reads_as_safe_load():
    for text in HANDWRITTEN:
        assert _same(tconfig.loads_yaml(text), yaml.safe_load(text)), text


def test_outside_the_subset_raises_with_the_line():
    for text in UNSUPPORTED:
        with pytest.raises(tconfig.YAMLUnsupported, match=r"<yaml>:\d+: .*outside the YAML"):
            tconfig.loads_yaml(text)
    for text in ("a: b: c\n", "a: [1, 2\n", "a: 'open\n", "- a\nb: 1\n", "e: -\n"):
        with pytest.raises(tconfig.YAMLError):
            tconfig.loads_yaml(text)
        with pytest.raises(yaml.YAMLError):
            yaml.safe_load(text)


@pytest.mark.parametrize("config", [TINY, GUIDED], ids=["tiny", "guided"])
def test_recipe_configs_round_trip_both_ways(tmp_path, config):
    """The JAX dump_yaml's file reads back in the port; the port's
    dump_yaml's file reads back in PyYAML and in the JAX load_yaml."""
    jconfig.dump_yaml(config, tmp_path / "jax.yaml")
    assert _same(tconfig.load_yaml(tmp_path / "jax.yaml"), config)
    tconfig.dump_yaml(config, tmp_path / "port.yaml")
    assert _same(jconfig.load_yaml(tmp_path / "port.yaml"), config)
    assert _same(tconfig.load_yaml(tmp_path / "port.yaml"), config)
    # PyYAML folds the long template over several lines, escapes and all
    assert "\\\n" in (tmp_path / "jax.yaml").read_text() or config is TINY


SPECIAL = ["1e-3", "1.0e-3", "yes", "no", "on", "off", "~", "-", "a: b", "#x", " lead",
           "trail ", "a #b", "null", "017", "0o7", "0x1F", "", "=", "<<", "- x", "[a]",
           "{a}", "'q'", '"dq"', "a\nb", "a\n\nb", "é ü 漢", "\t", "\\", "2001-12-14",
           ".inf", "1_0", "3:20", "@x", "?x", "? x", "a,b", ">", "|", "*x", "&x", "!x"]
# NEL, LS, PS and CR are line breaks to PyYAML when written raw; the port's
# reader refuses them raw (its writer escapes them)
TEXT = st.one_of(st.sampled_from(SPECIAL), st.text(
    st.characters(blacklist_characters="\x85\u2028\u2029\r"), max_size=24))
SCALAR = st.one_of(st.none(), st.booleans(), st.integers(-10**12, 10**12),
                   st.floats(allow_nan=False), TEXT)
TREE = st.recursive(SCALAR, lambda c: st.one_of(st.lists(c, max_size=4),
                                                 st.dictionaries(TEXT, c, max_size=4)),
                    max_leaves=16)


@settings(max_examples=250, deadline=None, suppress_health_check=list(HealthCheck))
@given(TREE, st.booleans(), st.sampled_from([20, 80]))
def test_generated_trees_match_pyyaml(tree, allow_unicode, width):
    """load_yaml == safe_load on safe_dump's block, flow and mixed output
    (folded at width 20 and 80); safe_load(dump_yaml(x)) == x."""
    for flow in (False, True, None):
        text = yaml.safe_dump(tree, allow_unicode=allow_unicode, default_flow_style=flow,
                              width=width)
        assert _same(tconfig.loads_yaml(text), yaml.safe_load(text)), text
    out = tconfig.dumps_yaml(tree)
    assert _same(yaml.safe_load(out), tree), out
    assert _same(tconfig.loads_yaml(out), tree), out


@pytest.mark.parametrize("tree", ["A\n", {"A\n": None}, {"k": "A\n"}, [{"A\n": None}],
                                  {"1e-3": {"A\n": None}}, "a b\n"])
def test_strings_ending_in_a_newline_are_written_quoted(tree):
    """A string that would be plain but for its last newline is quoted:
    PyYAML and the port read the written text back as the same tree."""
    out = tconfig.dumps_yaml(tree)
    assert _same(yaml.safe_load(out), tree), out
    assert _same(tconfig.loads_yaml(out), tree), out


def test_scalar_resolution_is_yaml_1_1():
    cases = {"1e-3": "1e-3", "1.0e-3": 1.0e-3, "1.e+2": 100.0, "yes": True, "Off": False,
             "017": 15, "0o17": "0o17", "0x1f": 31, "09": "09", "1_000": 1000, "~": None,
             ".5": 0.5, "-.inf": -math.inf, "3:20": 200, "y": "y", "2001-12-14": None}
    for text, want in cases.items():
        if text == "2001-12-14":
            with pytest.raises(tconfig.YAMLUnsupported):
                tconfig.loads_yaml(f"v: {text}\n")
            continue
        got = tconfig.loads_yaml(f"v: {text}\n")["v"]
        assert _same(got, want) and _same(got, yaml.safe_load(f"v: {text}\n")["v"]), text


ARGV = [
    ["--a", "1", "--b", "1e-3", "--c", "1.0e-3", "--d", "yes", "--e", "-", "--f", "~"],
    ["--x_conf", "lr=0.1", "--x_conf", "betas=[0.9, 0.98]", "--flag"],
    ["--x_conf", "{a: 1, b: [2, 3]}", "--y", "a", "b", "c"],
    ["--train_data_path_and_name_and_type", "w.scp,speech,sound",
     "--train_data_path_and_name_and_type", "t,text,text"],
    ["--k=v", "--dash-name", "3", "--s", "a: b", "--q", "'quoted'", "--bad", "[1, 2"],
    ["--normalize_conf", "stats_file=/a/b.npz", "--init_param", "a.pth:encoder:encoder"],
]


@pytest.mark.parametrize("argv", ARGV, ids=range(len(ARGV)))
def test_cli_overrides_and_build_config_match_jax(tmp_path, argv):
    assert _same(tconfig.parse_cli_overrides(argv), jconfig.parse_cli_overrides(argv))
    jconfig.dump_yaml(TINY, tmp_path / "base.yaml")
    cmd = ["--config", str(tmp_path / "base.yaml")] + argv
    defaults = {"optim_conf": {"lr": 1.0, "eps": 1e-8}, "x_conf": {"z": 0}, "max_epoch": 1}
    assert _same(tconfig.build_config(cmd, defaults), jconfig.build_config(cmd, defaults))
