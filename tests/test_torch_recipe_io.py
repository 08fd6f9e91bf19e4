"""The recipe inputs, port against the JAX package: every payload that
tests/test_data_formats.py covers read by both packages to equal arrays
(Kaldi ark FM, DM, FV, DV, CM, CM2, CM3, text mode and embedded RIFF;
flac files, pipes and ark offsets), flac streams that neither writer
emits built here from RFC 9639's layout (constant, LPC, fixed with rice2
and escaped partitions, wasted bits, the three stereo modes, 8/16/24-bit),
both ark writers byte for byte, JobRunner's submissions against the
expectations of tests/test_job_runner.py, and the pipeline's stages 12-15:
--decode_nj 2 writes the text that --decode_nj 1 writes, and the packed
model decodes as its experiment directory does."""

import io
import json
import struct
import sys

import numpy as np
import pytest
import torch

from llm_guided_asr_tpu.data import fileio as jfileio
from llm_guided_asr_tpu.data import kaldi_ark as jark
from llm_guided_asr_tpu.data.flac import _BitWriter, _crc8, _crc16
from llm_guided_asr_tpu.data.flac import read_flac as j_read_flac
from llm_guided_asr_tpu.data.flac import write_flac as j_write_flac
from llm_guided_asr_tpu.utils import job as jjob
from llm_guided_asr_tpu_torch.data import dataset as tdataset
from llm_guided_asr_tpu_torch.data import fileio as tfileio
from llm_guided_asr_tpu_torch.data import flac as tflac
from llm_guided_asr_tpu_torch.data import kaldi_ark as tark
from llm_guided_asr_tpu_torch.utils import job as tjob

RNG_SEED = 0


# ---------------------------------------------------------------------------
# Kaldi ark
# ---------------------------------------------------------------------------

def _ark_payload(kind, rng):
    """(bytes of one ark entry after 'utt1 ', the array it encodes)."""
    m = (rng.standard_normal((9, 5)) * 3.0).astype(np.float32)
    if kind in ("FM", "FV"):
        buf = io.BytesIO()
        jark._write_binary_matrix(buf, m if kind == "FM" else m[0])
        return buf.getvalue(), m if kind == "FM" else m[0]
    if kind in ("DM", "DV"):
        d = m.astype(np.float64) / 7.0
        if kind == "DM":
            body = b"\0BDM " + struct.pack("<bibi", 4, 9, 4, 5) + d.astype("<f8").tobytes()
            return body, d
        return b"\0BDV " + struct.pack("<bi", 4, 5) + d[0].astype("<f8").tobytes(), d[0]
    if kind in ("CM ", "CM2", "CM3"):
        buf = io.BytesIO()
        buf.write(b"utt1 ")
        jark.write_compressed_matrix(buf, m, "", kind)
        return buf.getvalue()[len(b"utt1 ") + 1:], m
    if kind == "text-matrix":
        return b"  [\n  1 2.5 3\n  4 5 -6e-1 ]\n", np.array([[1, 2.5, 3], [4, 5, -0.6]])
    if kind == "text-vector":
        return b" 1 2 3.25 ]\n", np.array([1, 2, 3.25])
    if kind == "riff":
        wav = (rng.uniform(-0.5, 0.5, 700) * 32767).astype(np.int16)
        buf = io.BytesIO()
        from scipy.io import wavfile

        wavfile.write(buf, 8000, wav)
        return buf.getvalue(), wav.astype(np.float32) / 32768.0
    raise ValueError(kind)


ARK_KINDS = ["FM", "DM", "FV", "DV", "CM ", "CM2", "CM3", "text-matrix", "text-vector", "riff"]


@pytest.mark.parametrize("kind", ARK_KINDS)
def test_kaldi_payloads_read_as_jax_reads_them(tmp_path, kind):
    payload, want = _ark_payload(kind, np.random.default_rng(ARK_KINDS.index(kind)))
    ark = tmp_path / "a.ark"
    ark.write_bytes(b"utt0 " + payload + b"utt1 " + payload)
    off = 5 + len(payload) + 5
    (tmp_path / "a.scp").write_text(f"utt0 {ark}:5\nutt1 {ark}:{off}\n")
    got = tark.load_mat(f"{ark}:{off}")
    lossy = kind.startswith("CM")
    np.testing.assert_allclose(got, want, atol=0.06 * np.ptp(want) if lossy else 1e-6)
    t_scp, j_scp = tark.KaldiScpReader(tmp_path / "a.scp"), jark.KaldiScpReader(tmp_path / "a.scp")
    if kind == "riff":
        # the JAX reader takes an embedded RIFF for text (it compares two
        # bytes with b"RIFF"); the wav.scp route reads it in both
        # (test_flac_sources_read_as_jax_reads_them)
        with pytest.raises(ValueError):
            jark.load_mat(f"{ark}:{off}")
        assert got.dtype == np.float32 and t_scp.peek_length("utt0") is None
        return
    ref = jark.load_mat(f"{ark}:{off}")
    assert got.dtype == ref.dtype and np.array_equal(got, ref)
    for uid in ("utt0", "utt1"):
        assert t_scp.peek_length(uid) == j_scp.peek_length(uid)
        assert np.array_equal(t_scp[uid], j_scp[uid])


def test_ark_writers_write_the_jax_bytes(tmp_path):
    rng = np.random.default_rng(1)
    mats = {f"u{i}": rng.standard_normal((4 + i, 3)).astype(np.float32) for i in range(3)}
    for pkg, name in ((jark, "j"), (tark, "t")):
        with pkg.KaldiArkWriter(tmp_path / f"{name}.ark", tmp_path / f"{name}.scp") as w:
            for k, m in mats.items():
                w[k] = m
            w["vec"] = m[0]
        with open(tmp_path / f"{name}.cm", "wb") as f:
            for fmt in ("CM ", "CM2", "CM3"):
                pkg.write_compressed_matrix(f, mats["u2"] * 5.0, f"k{fmt.strip()}", fmt)
    for suffix in ("ark", "cm"):
        assert (tmp_path / f"t.{suffix}").read_bytes() == (tmp_path / f"j.{suffix}").read_bytes()
    assert (tmp_path / "t.scp").read_text() == (tmp_path / "j.scp").read_text().replace(
        "j.ark", "t.ark")
    ds = tdataset.ESPnetDataset([(str(tmp_path / "t.scp"), "feats", "kaldi_ark")])
    assert all(np.array_equal(ds[k]["feats"], m) for k, m in mats.items())
    assert ds.peek_length("u2") == 6


# ---------------------------------------------------------------------------
# flac: a test-side encoder for the subframes neither writer emits
# ---------------------------------------------------------------------------

def _rice(bw, residual, method, porder, escape_parts=()):
    """Residual coding (RFC 9639 9.2.7): ``method`` 0 (rice, 4-bit
    parameters) or 1 (rice2, 5-bit), 2**porder partitions; the partitions
    in ``escape_parts`` hold raw signed values."""
    pbits = 4 if method == 0 else 5
    bw.write(method, 2)
    bw.write(porder, 4)
    parts = 1 << porder
    n_total = len(residual) + residual.pred_order
    per = n_total >> porder
    idx = 0
    for p in range(parts):
        n = per - (residual.pred_order if p == 0 else 0)
        chunk = residual[idx:idx + n]
        idx += n
        if p in escape_parts:
            raw = max(int(np.abs(chunk).max()).bit_length() + 1, 1) if n else 0
            bw.write((1 << pbits) - 1, pbits)
            bw.write(raw, 5)
            for v in chunk:
                bw.write(int(v), raw)
            continue
        zz = (np.abs(chunk) << 1) - (chunk < 0)
        k = min(int(np.log2(max(float(zz.mean()) if n else 1.0, 1.0))), (1 << pbits) - 2)
        bw.write(k, pbits)
        for z in zz:
            q = int(z) >> k
            if q:
                bw.write(0, q)
            bw.write(1, 1)
            if k:
                bw.write(int(z) & ((1 << k) - 1), k)


class _Residual(np.ndarray):
    pred_order = 0


def _residual(x, order):
    r = np.asarray(x, np.int64).view(_Residual)
    r.pred_order = order
    return r


def _subframe(bw, x, bps, kind, wasted=0, rice=(0, 0, ())):
    """One subframe of the int64 samples ``x`` (already shifted by
    ``wasted``) at ``bps`` bits (before the wasted bits come off)."""
    bps -= wasted
    types = {"constant": 0, "verbatim": 1}
    if kind.startswith("fixed"):
        order = int(kind[5:])
        code = 8 + order
    elif kind.startswith("lpc"):
        coefs, shift, prec = {"lpc2": ([3, -2], 1, 4), "lpc4": ([5, -3, 1, -1], 2, 5)}[kind]
        order = len(coefs)
        code = 32 + order - 1
    else:
        code, order = types[kind], 0
    bw.write(0, 1)
    bw.write(code, 6)
    if wasted:
        bw.write(1, 1)
        if wasted > 1:
            bw.write(0, wasted - 1)
        bw.write(1, 1)
    else:
        bw.write(0, 1)
    if kind == "constant":
        bw.write(int(x[0]), bps)
        return
    if kind == "verbatim":
        for v in x:
            bw.write(int(v), bps)
        return
    for v in x[:order]:
        bw.write(int(v), bps)
    if kind.startswith("fixed"):
        res = np.asarray(x, np.int64)
        for _ in range(order):
            res = np.diff(res)
    else:
        bw.write(prec - 1, 4)
        bw.write(shift, 5)
        for c in coefs:
            bw.write(c, prec)
        xi = [int(v) for v in x]
        res = np.array([xi[i] - (sum(c * xi[i - 1 - j] for j, c in enumerate(coefs)) >> shift)
                        for i in range(order, len(xi))], np.int64)
    _rice(bw, _residual(res, order), *rice)


def _flac_bytes(chans, bps, frames):
    """A flac stream of the int channels ``chans`` ([C, T]); ``frames`` lists
    (size, channel assignment, [(kind, wasted, rice) per subframe])."""
    total = chans.shape[1]
    si = _BitWriter()
    sizes = [f[0] for f in frames]
    for v, n in ((min(sizes), 16), (max(sizes), 16), (0, 24), (0, 24), (16000, 20),
                 (chans.shape[0] - 1, 3), (bps - 1, 5), (total, 36)):
        si.write(v, n)
    body = si.bytes() + bytes(16)
    out = bytearray(b"fLaC" + bytes([0x80]) + struct.pack(">I", len(body))[1:] + body)
    start = 0
    ss_code = {8: 1, 16: 4, 24: 6}[bps]
    for frame_no, (n, assign, subs) in enumerate(frames):
        hdr = _BitWriter()
        for v, k in ((0x3FFE, 14), (0, 1), (0, 1), (0b0111, 4), (0, 4), (assign, 4),
                     (ss_code, 3), (0, 1), (frame_no, 8), (n - 1, 16)):
            hdr.write(v, k)
        hdr.align()
        head = hdr.bytes()
        left, right = chans[0, start:start + n], chans[-1, start:start + n]
        side = left - right
        coded = {0: [left] if chans.shape[0] == 1 else [left, right], 1: [left, right],
                 8: [left, side], 9: [side, right], 10: [(left + right) >> 1, side]}[assign]
        widths = {8: [bps, bps + 1], 9: [bps + 1, bps], 10: [bps, bps + 1]}.get(
            assign, [bps] * len(coded))
        bw = _BitWriter()
        bw.write(_crc8(head), 8)
        for x, w, (kind, wasted, rice) in zip(coded, widths, subs):
            _subframe(bw, np.asarray(x, np.int64) >> wasted, w, kind, wasted, rice)
        bw.align()
        payload = head + bw.bytes()
        out += payload + struct.pack(">H", _crc16(payload))
        start += n
    return bytes(out)


def _signal(rng, t, bps, wasted=0, channels=1):
    top = (1 << (bps - 1)) - 1
    x = np.cumsum(rng.integers(-top // 40, top // 40, (channels, t)), axis=1)
    x = np.clip(x, -top // 2, top // 2)
    return (x >> wasted) << wasted


FLAC_CASES = {
    # name: (bps, channels, wasted, frames)
    "verbatim-8": (8, 1, 0, [(300, 0, [("verbatim", 0, None)])]),
    "constant-16": (16, 1, 0, [(256, 0, [("constant", 0, None)])]),
    "fixed-rice-16": (16, 1, 0, [(512, 0, [("fixed2", 0, (0, 2, ()))]),
                                 (512, 0, [("fixed3", 0, (0, 0, ()))])]),
    "fixed-rice2-escape-24": (24, 1, 0, [(600, 0, [("fixed1", 0, (1, 2, (1,)))]),
                                         (400, 0, [("fixed4", 0, (1, 1, ()))])]),
    "lpc-16": (16, 1, 0, [(512, 0, [("lpc2", 0, (0, 1, ()))]),
                          (300, 0, [("lpc4", 0, (1, 2, (2,)))])]),
    "wasted-bits-16": (16, 1, 3, [(400, 0, [("lpc2", 3, (0, 0, ()))]),
                                  (400, 0, [("verbatim", 2, None)])]),
    "stereo-modes-16": (16, 2, 0, [(256, 1, [("fixed2", 0, (0, 0, ())), ("lpc2", 0, (0, 0, ()))]),
                                   (256, 8, [("fixed1", 0, (0, 1, ())), ("fixed2", 0, (1, 0, ()))]),
                                   (256, 9, [("lpc4", 0, (0, 0, ())), ("verbatim", 0, None)]),
                                   (256, 10, [("fixed2", 0, (0, 0, ())), ("fixed1", 0, (0, 2, ()))])]),
    "stereo-24": (24, 2, 0, [(300, 10, [("lpc2", 0, (1, 0, ())), ("fixed3", 0, (1, 1, ()))])]),
}


@pytest.mark.parametrize("name", list(FLAC_CASES))
def test_flac_streams_decode_as_jax_decodes_them(tmp_path, name):
    bps, channels, wasted, frames = FLAC_CASES[name]
    rng = np.random.default_rng(list(FLAC_CASES).index(name))
    total = sum(f[0] for f in frames)
    x = _signal(rng, total, bps, wasted, channels)
    if name.startswith("constant"):
        x[:] = 1234
    data = _flac_bytes(x, bps, frames)
    rate, got = tflac.read_flac(data)
    j_rate, want = j_read_flac(data)
    assert rate == j_rate == 16000 and got.dtype == want.dtype and np.array_equal(got, want)
    expect = (x.T if channels > 1 else x[0]).astype(np.float32) / float(1 << (bps - 1))
    assert np.array_equal(got, expect)  # the encoder's samples, exactly
    path = tmp_path / "x.flac"
    path.write_bytes(data)
    assert tfileio.peek_audio_length(str(path)) == jfileio.peek_audio_length(str(path)) == total


def test_flac_sources_read_as_jax_reads_them(tmp_path):
    """The JAX writer's verbatim and fixed files, as a path, a pipe and a
    flac or RIFF payload at an ark offset, through read_audio and the
    sound data type."""
    wav = np.random.default_rng(3).uniform(-0.6, 0.6, (5000, 2)).astype(np.float32)
    j_write_flac(tmp_path / "v.flac", 16000, wav)
    j_write_flac(tmp_path / "f.flac", 16000, wav[:, 0], subframe="fixed")
    tfileio.write_wav(tmp_path / "w.wav", 16000, wav[:, 1])
    ark = tmp_path / "audio.ark"
    entries = []
    with open(ark, "wb") as f:
        for name in ("w.wav", "v.flac", "f.flac", "w.wav"):
            f.write(name.encode() + b" ")
            entries.append(f.tell())
            f.write((tmp_path / name).read_bytes())
    # a RIFF at an offset past its own length: the JAX reader hands the open
    # file to scipy, whose chunk loop compares file positions with the RIFF
    # size and finds no fmt chunk; the port reads the RIFF's bytes first
    late = f"{ark}:{entries.pop()}"
    with pytest.raises(UnboundLocalError):
        jfileio.read_audio(late)
    assert np.array_equal(tfileio.read_audio(late)[1],
                          tfileio.read_audio(str(tmp_path / "w.wav"))[1])
    rxs = [str(tmp_path / "v.flac"), str(tmp_path / "f.flac"), f"cat {tmp_path / 'f.flac'} |",
           f"cat {tmp_path / 'w.wav'} |"] + [f"{ark}:{off}" for off in entries]
    for rx in rxs:
        (rate, got), (j_rate, want) = tfileio.read_audio(rx), jfileio.read_audio(rx)
        assert rate == j_rate and np.array_equal(got, want), rx
        assert tfileio.peek_audio_length(rx) == jfileio.peek_audio_length(rx), rx
    np.testing.assert_allclose(tfileio.read_audio(str(tmp_path / "v.flac"))[1], wav, atol=1e-4)
    (tmp_path / "wav.scp").write_text("".join(f"u{i} {rx}\n" for i, rx in enumerate(rxs)))
    t_ds = tdataset.ESPnetDataset([(str(tmp_path / "wav.scp"), "speech", "sound")])
    from llm_guided_asr_tpu.data.dataset import ESPnetDataset as JDataset

    j_ds = JDataset([(str(tmp_path / "wav.scp"), "speech", "sound")])
    for uid in t_ds.keys:
        assert np.array_equal(t_ds[uid]["speech"], j_ds[uid]["speech"])
        assert t_ds.peek_length(uid) == j_ds.peek_length(uid)


def test_flac_writer_writes_the_jax_bytes(tmp_path):
    wav = np.random.default_rng(4).uniform(-0.9, 0.9, 9000).astype(np.float32)
    for sub in ("verbatim", "fixed"):
        j_write_flac(tmp_path / "j.flac", 16000, wav, subframe=sub)
        tflac.write_flac(tmp_path / "t.flac", 16000, wav, subframe=sub)
        assert (tmp_path / "t.flac").read_bytes() == (tmp_path / "j.flac").read_bytes()


# ---------------------------------------------------------------------------
# the job runner
# ---------------------------------------------------------------------------

def test_job_runner_submissions_match_jax(tmp_path):
    """test_job_runner.py's scenarios through both packages: the cluster
    submissions built from a conf, equal argv for argv; a local array job
    substitutes JOB, logs each job and returns the first failure's rc."""
    conf = tmp_path / "queue.conf"
    conf.write_text("command qsub -V -cwd\noption mem=* -l mem_free=$0\noption gpu=0\n"
                    "option gpu=* -l gpu=$0\ndefault gpu=0\n")
    opts = dict(mem="4G", time="2:00:00", num_threads=2, gpu=1, max_jobs_run=4)
    cmd = ["python", "decode.py", "--part", "JOB"]
    for backend, kw in (("slurm", {}), ("sge", {}), ("sge", {"conf": str(conf)}),
                        ("ssh", {"hosts": ["hostA", "hostB"]})):
        got = tjob.JobRunner(backend, **kw).run(cmd, "exp/log/d.JOB.log", array=(1, 3),
                                                options=tjob.JobOptions(**opts), build_only=True)
        want = jjob.JobRunner(backend, **kw).run(cmd, "exp/log/d.JOB.log", array=(1, 3),
                                                 options=jjob.JobOptions(**opts), build_only=True)
        assert got == want, backend
    slurm = " ".join(tjob.JobRunner("slurm").run(cmd, "exp/log/d.JOB.log", array=(1, 8),
                                                 options=tjob.JobOptions(**opts),
                                                 build_only=True))
    assert "--array 1-8%4" in slurm and "--gres gpu:1" in slurm and "--output exp/log/d.%a.log" \
        in slurm
    text = "# c\ncommand sbatch --wait\noption mem=* --mem $0\noption gpu=1 --gres gpu:1\n"
    t_conf, j_conf = tjob.SchedulerConf(text), jjob.SchedulerConf(text)
    assert (t_conf.command, t_conf.options, t_conf.defaults) == (j_conf.command, j_conf.options,
                                                                 j_conf.defaults)
    out = tmp_path / "out"
    out.mkdir()
    rc = tjob.JobRunner("local").run(
        [sys.executable, "-c", f"open(r'{out}/res.JOB','w').write('job JOB done')"],
        log=str(tmp_path / "log" / "t.JOB.log"), array=(1, 3),
        options=tjob.JobOptions(max_jobs_run=2))
    assert rc == 0
    for j in (1, 2, 3):
        assert (out / f"res.{j}").read_text() == f"job {j} done"
        assert (tmp_path / "log" / f"t.{j}.log").read_text().startswith("# ")
    assert tjob.JobRunner("local").run(
        [sys.executable, "-c", "import sys; sys.exit(3 if 'JOB' == '2' else 0)"],
        log=str(tmp_path / "f.JOB.log"), array=(1, 3)) == 3
    with pytest.raises(ValueError, match="JOB=1:N"):
        tjob.JobRunner("local").run(["true"], log=str(tmp_path / "x.log"), array=(0, 3))


# ---------------------------------------------------------------------------
# the pipeline's stages 12-15
# ---------------------------------------------------------------------------

TOKENS = ["<blank>", "<unk>", "a", "b", "c", "<space>", "<sos/eos>"]
ENC = {"output_size": 16, "attention_heads": 2, "linear_units": 32, "num_blocks": 1,
       "cnn_module_kernel": 5}
DEC = {"attention_heads": 2, "linear_units": 32, "num_blocks": 1}


def test_decode_jobs_pack_and_from_packed(tmp_path):
    """An experiment directory (a seeded tiny CTC/attention model) through
    asr_pipeline stages 12-15: the text of --decode_nj 2 (two asr_inference
    processes of the local runner, flac inputs) equals --decode_nj 1's; the
    bundle and the model card are written; Speech2Text.from_packed decodes
    as Speech2Text(config.yaml, checkpoint) does."""
    from llm_guided_asr_tpu_torch.bin import asr_pipeline
    from llm_guided_asr_tpu_torch.bin.asr_inference import Speech2Text
    from llm_guided_asr_tpu_torch.convert import init_weights
    from llm_guided_asr_tpu_torch.tasks.asr import ASRTask, build_model

    rng = np.random.default_rng(RNG_SEED)
    exp = tmp_path / "exp"
    valid = exp / "data" / "valid"
    valid.mkdir(parents=True)
    waves, scp, text = {}, [], []
    for i in range(5):
        uid = f"valid_{i:03d}"
        waves[uid] = rng.uniform(-0.4, 0.4, int(rng.integers(3000, 6000))).astype(np.float32)
        tflac.write_flac(valid / f"{uid}.flac", 16000, waves[uid])
        scp.append(f"{uid} {valid / f'{uid}.flac'}")
        text.append(f"{uid} abc ab")
    (valid / "wav.scp").write_text("\n".join(scp) + "\n")
    (valid / "text").write_text("\n".join(text) + "\n")
    (tmp_path / "tokens.txt").write_text("\n".join(TOKENS) + "\n")
    ASRTask.main(["--token_list", str(tmp_path / "tokens.txt"), "--device", "cpu",
                  "--frontend_conf", json.dumps({"n_fft": 256, "hop_length": 128, "n_mels": 23}),
                  "--normalize", "utterance_mvn", "--encoder_conf", json.dumps(ENC),
                  "--decoder_conf", json.dumps(DEC), "--output_dir", str(exp / "train"),
                  "--dry_run", "true"])
    config = ASRTask.get_default_config()
    from llm_guided_asr_tpu_torch.utils.config import load_yaml

    config.update(load_yaml(exp / "train" / "config.yaml"))
    model = init_weights(build_model(config, "cpu"), 0)
    torch.save(model.state_dict(), exp / "train" / "latest.pth")

    def pipeline(nj, expdir, stop=13):
        return asr_pipeline.main(["--train_dir", str(tmp_path), "--valid_dir", str(tmp_path),
                                  "--expdir", str(expdir), "--stage", "12", "--stop_stage",
                                  str(stop), "--device", "cpu", "--beam_size", "2",
                                  "--decode_nj", str(nj)])

    one = pipeline(1, exp)
    one_text = (exp / "decode" / "valid" / "1best_recog" / "text").read_text()
    (exp / "decode").rename(exp / "decode_nj1")
    two = pipeline(2, exp, stop=15)
    assert (exp / "decode" / "valid" / "1best_recog" / "text").read_text() == one_text
    assert one == two
    assert sorted(p.name for p in (exp / "decode" / "valid" / "split").iterdir()) == [
        "num_splits", "wav.scp.1", "wav.scp.2"]
    assert (exp / "decode" / "valid" / "log" / "decode.2.log").read_text().startswith("# ")
    assert (exp / "pack" / "README.md").read_text().startswith("---\ntags:")
    import zipfile

    with zipfile.ZipFile(exp / "pack" / "asr_model.zip") as z:
        assert sorted(z.namelist()) == ["config.yaml", "meta.json", "model.pth"]
    packed = Speech2Text.from_packed(exp / "pack" / "asr_model.zip",
                                     workdir=str(tmp_path / "unpacked"), device="cpu",
                                     beam_size=2)
    direct = Speech2Text(exp / "train" / "config.yaml", exp / "train" / "latest.pth",
                         device="cpu", beam_size=2)
    for uid, wave in list(waves.items())[:2]:
        (a_text, a_tok, a_ids, a_hyp), = packed(wave)
        (b_text, b_tok, b_ids, b_hyp), = direct(wave)
        assert (a_text, a_tok, a_ids, a_hyp.score) == (b_text, b_tok, b_ids, b_hyp.score)
