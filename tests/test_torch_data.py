"""Port vs JAX, the data path of training: file IO, the batch samplers, the
collate, ESPnetDataset over a written wav / text_int corpus, and
SequenceIterFactory's batch order, each against the JAX function on the
same input (exact: the port's copies compute the same numbers)."""

import numpy as np
import pytest
import torch

from llm_guided_asr_tpu.data import dataset as jdataset
from llm_guided_asr_tpu.data import fileio as jfileio
from llm_guided_asr_tpu.data import iterator as jiterator
from llm_guided_asr_tpu.data import samplers as jsamplers
from llm_guided_asr_tpu_torch.data import dataset as tdataset
from llm_guided_asr_tpu_torch.data import fileio as tfileio
from llm_guided_asr_tpu_torch.data import iterator as titerator
from llm_guided_asr_tpu_torch.data import samplers as tsamplers

torch.set_num_threads(1)

N_UTT = 23


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """23 int16 wav files of 0.1-0.6 s of seeded noise, a text_int file,
    and npy / csv_int / text_float streams."""
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(0)
    wav, text, npy, csv, flt = [], [], [], [], []
    for i in range(N_UTT):
        uid = f"utt{i:03d}"
        n = int(rng.integers(1600, 9600))
        path = root / f"{uid}.wav"
        tfileio.write_wav(path, 16000, rng.uniform(-0.5, 0.5, n).astype(np.float32))
        wav.append(f"{uid} {path}")
        tokens = rng.integers(1, 30, int(rng.integers(1, 9)))
        text.append(f"{uid} " + " ".join(str(t) for t in tokens))
        arr = rng.standard_normal((int(rng.integers(3, 12)), 4)).astype(np.float32)
        np.save(root / f"{uid}.npy", arr)
        npy.append(f"{uid} {root / f'{uid}.npy'}")
        csv.append(f"{uid} " + ",".join(str(t) for t in rng.integers(0, 9, 3)))
        flt.append(f"{uid} " + " ".join(f"{x:.4f}" for x in rng.standard_normal(2)))
    for name, lines in (("wav.scp", wav), ("text", text), ("feats.scp", npy), ("csv", csv),
                        ("flt", flt)):
        (root / name).write_text("\n".join(lines) + "\n")
    return root


def _triples(root):
    return [(str(root / "wav.scp"), "speech", "sound"), (str(root / "text"), "text", "text_int"),
            (str(root / "feats.scp"), "feats", "npy"), (str(root / "csv"), "ids", "csv_int"),
            (str(root / "flt"), "aux", "text_float")]


def test_dataset_items_and_lengths_match_jax(corpus):
    j = jdataset.ESPnetDataset(_triples(corpus))
    t = tdataset.ESPnetDataset(_triples(corpus))
    assert t.keys == j.keys and len(t) == N_UTT
    for uid in t.keys:
        got, want = t[uid], j[uid]
        assert got.keys() == want.keys()
        for k in got:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert t.peek_length(uid) == j.peek_length(uid) == len(got["speech"])


def test_fileio_readers_match_jax(corpus, tmp_path):
    for path, kind in (("text", "text_int"), ("csv", "csv_int"), ("flt", "text_float")):
        got = tfileio.load_num_sequence_text(corpus / path, kind)
        want = jfileio.load_num_sequence_text(corpus / path, kind)
        assert got.keys() == want.keys()
        assert all(np.array_equal(got[k], want[k]) for k in got)
    wavs = tfileio.read_2columns_text(corpus / "wav.scp")
    assert wavs == jfileio.read_2columns_text(corpus / "wav.scp")
    uid, path = next(iter(wavs.items()))
    pipe = f"cat {path} |"
    for rx in (path, pipe):
        (r1, a1), (r2, a2) = tfileio.read_audio(rx), jfileio.read_audio(rx)
        assert r1 == r2 == 16000 and np.array_equal(a1, a2)
    assert tfileio.peek_audio_length(path) == jfileio.peek_audio_length(path)
    assert tfileio.peek_audio_length(pipe) is None
    shapes = {"a": (3, 4), "b": (7,)}
    tfileio.write_shape_file(tmp_path / "shape", shapes)
    assert jfileio.read_shape_file(tmp_path / "shape") == tfileio.read_shape_file(
        tmp_path / "shape") == shapes
    with tfileio.DatadirWriter(tmp_path / "out") as w:
        w["text"]["u1"] = "a b"
        w["sub/score"]["u1"] = "1.5"
    assert (tmp_path / "out" / "text").read_text() == "u1 a b\n"
    assert (tmp_path / "out" / "sub" / "score").read_text() == "u1 1.5\n"


def test_unported_formats_raise(corpus, tmp_path):
    """The formats this test once found refused: a flac file, Kaldi ark
    audio at 'file.ark:offset' and the kaldi_ark data type read as the JAX
    readers read them (tests/test_torch_recipe_io.py holds every payload);
    a broken flac stream still raises in both."""
    from llm_guided_asr_tpu.data.flac import write_flac
    from llm_guided_asr_tpu.data.kaldi_ark import KaldiArkWriter

    wave = np.random.default_rng(3).uniform(-0.5, 0.5, 4000).astype(np.float32)
    write_flac(tmp_path / "x.flac", 16000, wave)
    got, want = tfileio.read_audio(str(tmp_path / "x.flac")), jfileio.read_audio(
        str(tmp_path / "x.flac"))
    assert got[0] == want[0] == 16000 and np.array_equal(got[1], want[1])
    ark = tmp_path / "x.ark"
    ark.write_bytes(b"utt1 " + (tmp_path / "x.flac").read_bytes())
    assert np.array_equal(tfileio.read_audio(f"{ark}:5")[1], want[1])
    assert tfileio.peek_audio_length(f"{ark}:5") == 4000
    with KaldiArkWriter(tmp_path / "f.ark", tmp_path / "f.scp") as w:
        w["utt000"] = np.arange(12, dtype=np.float32).reshape(3, 4)
    ds = tdataset.ESPnetDataset([(str(tmp_path / "f.scp"), "feats", "kaldi_ark")])
    assert np.array_equal(ds["utt000"]["feats"], np.arange(12, dtype=np.float32).reshape(3, 4))
    (tmp_path / "bad.flac").write_bytes(b"fLaC" + bytes(40))
    for reader in (tfileio.read_audio, jfileio.read_audio):
        with pytest.raises((ValueError, IndexError)):
            reader(str(tmp_path / "bad.flac"))
    # the text data type reads the raw text
    ds = tdataset.ESPnetDataset([(str(corpus / "text"), "text", "text")])
    assert all(isinstance(ds[u]["text"], str) for u in ds.keys)


@pytest.mark.parametrize("batch_type, kw", [
    ("unsorted", {"batch_size": 4}),
    ("sorted", {"batch_size": 5}),
    ("sorted", {"batch_size": 5, "sort_in_batch": "ascending"}),
    ("folded", {"batch_size": 6, "fold_length": 3000, "min_batch_size": 2}),
    ("numel", {"batch_bins": 20000, "min_batch_size": 1}),
])
def test_batch_samplers_match_jax(corpus, batch_type, kw):
    data = tdataset.ESPnetDataset(_triples(corpus))
    lengths = {u: data.peek_length(u) for u in data.keys}
    got = tsamplers.build_batch_sampler(batch_type, data.keys, lengths, **kw)
    assert got == jsamplers.build_batch_sampler(batch_type, data.keys, lengths, **kw)
    for world in (1, 2, 4):
        assert tsamplers.round_batches_to_world_size(got, world) == \
            jsamplers.round_batches_to_world_size(got, world)


def test_collate_matches_jax(corpus):
    data = tdataset.ESPnetDataset(_triples(corpus))
    items = [(u, data[u]) for u in data.keys[:5]]
    kw = dict(pad_multiples={"speech": 1600, "text": 4}, batch_size_multiple=4)
    got = tdataset.CommonCollateFn(**kw)(items)
    want = jdataset.CommonCollateFn(**kw)(items)
    assert got.keys() == want.keys()
    assert got["_uids"] == want["_uids"] and got["_nvalid"] == want["_nvalid"] == 5
    for k, v in got.items():
        if isinstance(v, np.ndarray):
            assert v.dtype == want[k].dtype, k
            np.testing.assert_array_equal(v, want[k], err_msg=k)
    assert got["speech"].shape == (8, 9600) and got["text"].dtype == np.int32
    assert (got["text"][5:] == -1).all() and (got["speech"][5:] == 0).all()
    assert tdataset.round_up(13, 4) == jdataset.round_up(13, 4) == 16


@pytest.mark.parametrize("num_iters, rank, world", [(None, 0, 1), (3, 0, 1), (7, 1, 2)])
def test_iterator_batch_order_matches_jax(corpus, num_iters, rank, world):
    """Epochs 1-3: the same batches in the same order (num_iters_per_epoch
    rotation and rank striding included), and the port's tensors."""
    data = tdataset.ESPnetDataset(_triples(corpus))
    lengths = {u: data.peek_length(u) for u in data.keys}
    batches = tsamplers.build_batch_sampler("sorted", data.keys, lengths, batch_size=4)
    collate = tdataset.CommonCollateFn(pad_multiples={"speech": 1600})
    kw = dict(seed=5, num_iters_per_epoch=num_iters, rank=rank, world_size=world)
    t = titerator.SequenceIterFactory(data, batches, collate, device="cpu", **kw)
    j = jiterator.SequenceIterFactory(jdataset.ESPnetDataset(_triples(corpus)), batches,
                                      jdataset.CommonCollateFn(pad_multiples={"speech": 1600}),
                                      to_device=False, **kw)
    for epoch in (1, 2, 3):
        got, want = list(t(epoch)), list(j(epoch))
        assert [b["_uids"] for b in got] == [b["_uids"] for b in want]
        for gb, wb in zip(got, want):
            assert gb["speech"].dtype == torch.float32 and gb["text"].dtype == torch.int64
            assert gb["speech_lengths"].dtype == torch.int64
            np.testing.assert_array_equal(gb["speech"].numpy(), wb["speech"])
            np.testing.assert_array_equal(gb["text"].numpy(), wb["text"])
    assert [b["_uids"] for b in t(1)] != [b["_uids"] for b in t(2)] or num_iters == 7
    raw = next(iter(titerator.SequenceIterFactory(data, batches, collate, device=None)(1)))
    assert isinstance(raw["speech"], np.ndarray)
