"""Dataset and padded-bucket collate (the port's own copy of
llm_guided_asr_tpu/data/dataset.py).

Rebuild of espnet2/train/dataset.py:437 (ESPnetDataset + DATA_TYPES),
espnet2/train/preprocessor.py:137 (CommonPreprocessor) and
espnet2/train/collate_fn.py:11 (CommonCollateFn: float pad 0.0, int pad
-1).  The collate pads the batch maxima up to configurable bucket multiples
(speech samples, feature frames, token counts), so that sorted-length
batching yields a small closed set of shapes.  The data types are sound,
kaldi_ark (data/kaldi_ark.py), npy, text (tokenized by the
CommonPreprocessor), text_int, csv_int and text_float.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from llm_guided_asr_tpu_torch.data.fileio import (
    NpyScpReader,
    SoundScpReader,
    load_num_sequence_text,
    peek_audio_length,
    read_2columns_text,
)
from llm_guided_asr_tpu_torch.utils.config import normalize_triples


class _SoundAdapter:
    def __init__(self, path):
        self.reader = SoundScpReader(path)

    def __getitem__(self, key):
        rate, wav = self.reader[key]
        return wav

    def peek_length(self, key):
        """Header-only sample count (None -> caller must load)."""
        return peek_audio_length(self.reader.data[key])

    def keys(self):
        return self.reader.keys()

    def __len__(self):
        return len(self.reader)


class _TextAdapter:
    def __init__(self, path):
        self.data = read_2columns_text(path)

    def __getitem__(self, key):
        return self.data[key]

    def peek_length(self, key):
        return len(self.data[key])

    def keys(self):
        return self.data.keys()

    def __len__(self):
        return len(self.data)


class _IntSeqAdapter:
    def __init__(self, path, loader_type="text_int"):
        self.data = load_num_sequence_text(path, loader_type)

    def __getitem__(self, key):
        return self.data[key]

    def keys(self):
        return self.data.keys()

    def __len__(self):
        return len(self.data)


def _kaldi_ark_adapter(path):
    from llm_guided_asr_tpu_torch.data.kaldi_ark import KaldiScpReader

    return KaldiScpReader(path)


DATA_TYPES: Dict[str, Callable] = {
    "sound": _SoundAdapter,
    "kaldi_ark": _kaldi_ark_adapter,
    "npy": NpyScpReader,
    "text": _TextAdapter,
    "text_int": lambda p: _IntSeqAdapter(p, "text_int"),
    "csv_int": lambda p: _IntSeqAdapter(p, "csv_int"),
    "text_float": lambda p: _IntSeqAdapter(p, "text_float"),
}


class ESPnetDataset:
    """uid -> {name: array}; built from (path, name, type) triples
    (dataset.py:437)."""

    def __init__(
        self,
        path_name_type_list: Sequence[Tuple[str, str, str]],
        preprocess: Optional[Callable[[str, Dict], Dict]] = None,
    ):
        self.loaders = {}
        for path, name, typ in normalize_triples(path_name_type_list):
            if typ not in DATA_TYPES:
                raise ValueError(f"unknown data type {typ!r}; known: {sorted(DATA_TYPES)}")
            self.loaders[name] = DATA_TYPES[typ](path)
        self.preprocess = preprocess
        keys = None
        for name, loader in self.loaders.items():
            ks = set(loader.keys())
            keys = ks if keys is None else keys & ks
        self.keys: List[str] = sorted(keys or [])
        if not self.keys:
            raise RuntimeError("dataset has no common utterance ids")

    def __len__(self):
        return len(self.keys)

    def __getitem__(self, uid: str) -> Dict[str, np.ndarray]:
        data = {name: loader[uid] for name, loader in self.loaders.items()}
        if self.preprocess is not None:
            data = self.preprocess(uid, data)
        return data

    def peek_length(self, uid: str) -> int:
        """Length of the primary (first) stream, header-only when possible
        (the no-shape-file fallback of the batch samplers)."""
        first = next(iter(self.loaders.values()))
        if hasattr(first, "peek_length"):
            n = first.peek_length(uid)
            if n is not None:
                return int(n)
        item = self[uid]
        return int(np.asarray(next(iter(item.values()))).shape[0])


class CommonPreprocessor:
    """Tokenize text fields to int ids (preprocessor.py:137, minus wav aug).

    Every name in ``text_names`` is tokenized; ``field_tokenizers`` maps a
    name to its own (tokenizer, converter), as the mixed-vocab ``ctc_text``
    stream has; ``cleaner`` (a TextCleaner) runs first."""

    def __init__(self, tokenizer=None, token_id_converter=None, text_name: str = "text",
                 text_names: Optional[Sequence[str]] = None,
                 field_tokenizers: Optional[Dict[str, Tuple]] = None, cleaner=None):
        self.tokenizer = tokenizer
        self.converter = token_id_converter
        self.cleaner = cleaner
        self.text_names = (tuple(text_names) if text_names else
                           (text_name, "src_text", "bias_words", "text_prev", "text_ctc",
                            "ctc_text", "text_spk2", "text_spk3", "text_spk4"))
        self.field_tokenizers = dict(field_tokenizers or {})

    def __call__(self, uid: str, data: Dict) -> Dict:
        out = dict(data)
        for name in self.text_names:
            if name in out and isinstance(out[name], str):
                tok, conv = self.field_tokenizers.get(name, (self.tokenizer, self.converter))
                if tok is None or conv is None:
                    raise RuntimeError("text present but no tokenizer configured")
                if self.cleaner is not None:
                    out[name] = self.cleaner(out[name])
                out[name] = np.array(conv.tokens2ids(tok.text2tokens(out[name])),
                                     dtype=np.int64)
        return out


def round_up(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple


@dataclasses.dataclass
class CommonCollateFn:
    """Pad a list of {name: array} into a static-shape batch dict.

    float arrays pad with ``float_pad_value`` (0.0) into float32, int arrays
    with ``int_pad_value`` (-1) into int32 (collate_fn.py:11); per-name
    ``<name>_lengths`` vectors (int32) are added, and ``_uids`` and
    ``_nvalid`` (the rows before ``batch_size_multiple`` padding).
    ``pad_multiples`` maps name -> bucket multiple.
    """

    float_pad_value: float = 0.0
    int_pad_value: int = -1
    pad_multiples: Optional[Dict[str, int]] = None
    batch_size_multiple: int = 1

    def __call__(self, items: Sequence[Tuple[str, Dict[str, np.ndarray]]]) -> Dict:
        uids = [u for u, _ in items]
        names = list(items[0][1].keys())
        batch: Dict[str, np.ndarray] = {}
        b = len(items)
        b_pad = round_up(b, self.batch_size_multiple)
        for name in names:
            arrays = [np.asarray(d[name]) for _, d in items]
            lengths = np.array([a.shape[0] for a in arrays], dtype=np.int32)
            maxlen = int(lengths.max())
            mult = (self.pad_multiples or {}).get(name, 1)
            maxlen = round_up(max(maxlen, 1), mult)
            is_int = np.issubdtype(arrays[0].dtype, np.integer)
            pad_val = self.int_pad_value if is_int else self.float_pad_value
            dtype = np.int32 if is_int else np.float32
            out = np.full((b_pad, maxlen) + arrays[0].shape[1:], pad_val, dtype=dtype)
            for i, a in enumerate(arrays):
                out[i, : a.shape[0]] = a
            full_lengths = np.zeros((b_pad,), np.int32)
            full_lengths[:b] = lengths
            batch[name] = out
            batch[f"{name}_lengths"] = full_lengths
        batch["_uids"] = uids
        batch["_nvalid"] = b
        return batch
