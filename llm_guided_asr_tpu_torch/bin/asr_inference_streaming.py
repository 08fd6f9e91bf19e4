"""Incremental streaming recognition (counterpart of
llm_guided_asr_tpu/bin/asr_inference_streaming.py; espnet2's
asr_inference_streaming.py with the online search of
batch_beam_search_online.py).

Audio arrives in chunks and every state is carried forward:

- log-mel frames are computed for the new samples only; a frame whose
  window would reach the signal's future end padding waits for the next
  chunk (or the last one);
- the contextual-block encoder (models/streaming.py) takes the new feature
  frames in whole blocks with its carried per-layer contexts
  (``encode_chunk``): no audio is encoded twice, and the rows equal the
  offline pass;
- the beam search resumes from its carried state (``stream_step``): the
  alive hypotheses' CTC rows are extended over the new frames and the
  search goes on with a larger frame budget.

Between chunks the token budget is the CTC-greedy length over the trusted
region (every frame but the last ``lookahead_blocks`` encoder blocks), so
hypotheses do not run ahead of the audio; the last chunk decodes to the
search's usual maxlen.

The port builds from a model object, as its Speech2Text does.  It streams
only what can be streamed: a contextual-block encoder, the default
frontend, a normalization that needs no whole utterance (global MVN or
none; utterance MVN is refused) and the stateless attention scorer.  The
JAX package's re-encoding fallback for other models is not ported.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from llm_guided_asr_tpu_torch.bin.asr_inference import Speech2Text, round_up
from llm_guided_asr_tpu_torch.ops.frontend import _dft_basis, global_mvn, logmel_from_power
from llm_guided_asr_tpu_torch.search.beam_search import NEG_INF, Hypothesis
from llm_guided_asr_tpu_torch.search.scorers import StatelessAttScorer


class Speech2TextStreaming:
    """Chunk-fed recognizer that carries the encoder and search state."""

    def __init__(self, model, chunk_samples: int = 16000, lookahead_blocks: int = 1, **kwargs):
        """``kwargs`` go to Speech2Text (beam_size, ctc_weight, lm, ...)."""
        self.s2t = Speech2Text.from_model(model, **kwargs)
        self.chunk_samples = chunk_samples
        self.lookahead_blocks = lookahead_blocks
        cfg = model.cfg
        beam = self.s2t.beam
        if not (getattr(cfg, "encoder_type", None) == "contextual_block_conformer"
                and cfg.frontend is not None and cfg.normalize in ("global_mvn", "none")
                and beam is not None and isinstance(beam.att_scorer, StatelessAttScorer)):
            raise ValueError("incremental streaming needs a contextual-block encoder, the "
                             "default frontend, a streamable normalize (global_mvn or none; "
                             "utterance_mvn needs the whole utterance) and the stateless "
                             "attention scorer")
        self.model = model
        self.beam = beam
        self.device = self.s2t.device
        f = cfg.frontend
        self._f = f
        self._basis = torch.from_numpy(_dft_basis(f.n_fft, f.win_length, f.window)).to(self.device)
        self._block = cfg.encoder.block_size
        self._n_layers = cfg.encoder.num_blocks
        self._d = cfg.encoder.output_size
        self.reset()

    def _feats_chunk(self, frames: np.ndarray) -> torch.Tensor:
        """[T, n_fft] sample windows -> [T, n_mels] normalized features, by
        the offline frontend's windowed-DFT product and log-mel."""
        f = self._f
        out = torch.from_numpy(frames).to(self.device) @ self._basis
        nf = f.n_fft // 2 + 1
        power = out[:, :nf] ** 2 + out[:, nf:] ** 2
        feats = logmel_from_power(power, f.fs, f.n_fft, f.n_mels, f.fmin, f.fmax, f.htk)
        if self.model.cfg.normalize == "global_mvn":
            feats = global_mvn(feats, self.model.mvn_mean, self.model.mvn_inv_std)
        return feats

    def reset(self):
        self._buffer = np.zeros((0,), np.float32)
        self._frames_done = 0
        self._feats = torch.zeros((0, self._f.n_mels), device=self.device)
        self._sub_done = 0
        self._ctxs = torch.zeros((self._n_layers, 1, self._d), device=self.device)
        self._cap = 16 * self._block
        self._enc = torch.zeros((self._cap, self._d), device=self.device)
        self._ctc_logp = torch.zeros((self._cap, self.model.cfg.vocab_size), device=self.device)
        self._carry = None
        self._enc_len_prev = 0
        self._lmax = self._cap + 2

    def _ensure_capacity(self, need_frames: int):
        """Double the encoder and CTC buffers (and the carried search state's
        token and frame axes) until they hold ``need_frames`` rows."""
        if need_frames <= self._cap:
            return
        new_cap = self._cap
        while new_cap < need_frames:
            new_cap *= 2
        grow = new_cap - self._cap
        pad = lambda x, value=0.0: torch.nn.functional.pad(x, (0, 0, 0, grow), value=value)  # noqa: E731
        self._enc, self._ctc_logp = pad(self._enc), pad(self._ctc_logp)
        if self._carry is not None:
            state, att = self._carry
            state = state._replace(
                alive_tokens=torch.nn.functional.pad(state.alive_tokens, (0, grow),
                                                     value=self.beam.sos),
                fin_tokens=torch.nn.functional.pad(state.fin_tokens, (0, grow)),
                ctc=state.ctc._replace(r=pad(state.ctc.r, NEG_INF)),
            )
            self._carry = (state, att)
        self._cap, self._lmax = new_cap, new_cap + 2

    @torch.inference_mode()
    def __call__(self, speech: np.ndarray, is_final: bool = False) -> list:
        """Feed one chunk; returns the current (partial or final) results in
        Speech2Text's format."""
        self._buffer = np.concatenate([self._buffer, np.asarray(speech, np.float32)])
        self._advance(is_final)
        results = self._current_results()
        if is_final:
            self.reset()
        return results

    def _new_frames(self, is_final: bool):
        """1. STFT frames of the new samples: frame t covers samples
        [t*hop - n_fft/2, t*hop + n_fft/2)."""
        n = len(self._buffer)
        n_fft, hop = self._f.n_fft, self._f.hop_length
        half = n_fft // 2
        if is_final:
            f_total = n // hop + 1 if n > 0 else 0
        else:
            f_total = (n - half) // hop + 1 if n >= half else 0
        if f_total <= self._frames_done:
            return
        # the offline pass zero-pads the speech to a bucket before the STFT's
        # reflect padding: the start reflects real samples (zero-extended if
        # tiny), the frames near the end read zeros
        src = self._buffer
        if len(src) < half + 1:
            src = np.concatenate([src, np.zeros(half + 1 - len(src), np.float32)])
        padded = np.concatenate([src[1: half + 1][::-1], self._buffer])
        if is_final:
            padded = np.concatenate([padded, np.zeros(half + hop, np.float32)])
        idx = np.arange(self._frames_done, f_total)[:, None] * hop + np.arange(n_fft)[None, :]
        self._feats = torch.cat([self._feats, self._feats_chunk(np.ascontiguousarray(padded[idx]))])
        self._frames_done = f_total

    def _new_sub_frames(self, is_final: bool):
        """2. Encoder sub-frames in whole blocks (at most 4 blocks a call
        mid-stream, to bound a chunk's latency)."""
        s = self._block
        f_avail = self._feats.shape[0]
        if is_final:
            s_next = (self._frames_done + 3) // 4
        else:
            s_next = (max((f_avail - 3) // 4, 0) // s) * s
        while s_next > self._sub_done:
            if is_final:
                m, n_valid = round_up(s_next - self._sub_done, s), s_next - self._sub_done
            else:
                m = n_valid = min(s_next - self._sub_done, 4 * s)
            start = 4 * self._sub_done
            chunk = self._feats[start: start + 4 * m + 6]
            chunk = torch.nn.functional.pad(chunk, (0, 0, 0, 4 * m + 6 - chunk.shape[0]))
            out, self._ctxs = self.model.encoder.encode_chunk(chunk[None], self._ctxs,
                                                              self._sub_done, n_valid)
            self._ensure_capacity(self._sub_done + n_valid)
            rows = self.model.ctc_log_softmax(out)[0]
            sl = slice(self._sub_done, self._sub_done + n_valid)
            self._enc[sl] = out[0, :n_valid]
            self._ctc_logp[sl] = rows[:n_valid]
            self._sub_done += n_valid

    def _advance(self, is_final: bool):
        self._new_frames(is_final)
        self._new_sub_frames(is_final)
        # 3. resume the search
        beam = self.beam
        if self._sub_done == 0:
            return
        enc_buf = self._enc[None]
        if self._carry is None:
            self._carry = beam.stream_start(self._ctc_logp, enc_buf, self._sub_done, self._lmax)
            # stream_start already ran the CTC rows over these frames: the
            # extension starts after them (from 0 it would add frame blanks
            # again from the r_b[0] base)
            self._enc_len_prev = self._sub_done
        if is_final:
            ratio = self.s2t.maxlenratio
            if ratio == 0.0:
                maxlen = self._sub_done
            elif ratio < 0.0:
                maxlen = int(-ratio)
            else:
                maxlen = max(1, int(ratio * self._sub_done))
            minlen = int(self.s2t.minlenratio * self._sub_done)
        else:
            # the token budget: the CTC-greedy count over the trusted region
            trusted = max(self._sub_done - self.lookahead_blocks * self._block, 0)
            am = self._ctc_logp[:trusted].argmax(-1).cpu().numpy()
            collapsed = am[np.concatenate([[True], am[1:] != am[:-1]])] if trusted else am
            maxlen = min(int((collapsed != beam.blank_id).sum()), self._sub_done)
            minlen = 0
        self._carry = beam.stream_step(enc_buf, self._enc_len_prev, self._sub_done, maxlen,
                                       minlen, self._carry, self._ctc_logp)
        self._enc_len_prev = self._sub_done

    def _current_results(self) -> list:
        if self._carry is None:
            return self.s2t._results([Hypothesis(yseq=[], score=0.0, scores={})])
        return self.s2t._results(self.beam.stream_hyps(self._carry, nbest=self.s2t.nbest))

    def decode_utterance(self, speech: np.ndarray) -> List[list]:
        """Stream a whole utterance chunk by chunk; returns each chunk's results."""
        self.reset()
        partials = []
        n = len(speech)
        for start in range(0, max(n, 1), self.chunk_samples):
            final = start + self.chunk_samples >= n
            partials.append(self(speech[start: start + self.chunk_samples], is_final=final))
        return partials
