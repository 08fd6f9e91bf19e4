"""N-gram LM: ARPA reader and scorers (counterpart of llm_guided_asr_tpu/search/ngram.py).

A kenlm replacement with no native dependencies (espnet/nets/scorers/ngram.py
wraps kenlm):

- :class:`ArpaLM`: a backoff model read from an ARPA file (natural log);
- :class:`NgramRescorer`: exact backoff scoring of whole hypotheses on the
  host, for n-best rescoring;
- :class:`DenseNgramScorer`: for vocabularies of at most 4096 tokens, the
  unigram and bigram slice of the model as dense [V] and [V, V] tables on
  the search's device, so that fusion runs inside the beam search;
- :func:`build_arpa`: a Witten-Bell smoothed model written as ARPA text.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np
import torch

from llm_guided_asr_tpu_torch.utils.device import resolve_device

LOG10 = math.log(10.0)


class ArpaLM:
    """Backoff n-gram LM parsed from an ARPA file (natural-log internally)."""

    def __init__(self, path: Union[str, Path]):
        self.logp: List[Dict[Tuple[str, ...], float]] = []
        self.backoff: List[Dict[Tuple[str, ...], float]] = []
        self._parse(Path(path))
        self.order = len(self.logp)

    def _parse(self, path: Path):
        section = None
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("\\data\\"):
                    continue
                if line.startswith("\\") and "-grams:" in line:
                    n = int(line[1 : line.index("-")])
                    while len(self.logp) < n:
                        self.logp.append({})
                        self.backoff.append({})
                    section = n
                    continue
                if line.startswith("\\end\\"):
                    break
                if section is None:
                    continue
                parts = line.split("\t")
                if len(parts) < 2:
                    parts = line.split()
                    if len(parts) < section + 1:
                        continue
                    lp = parts[0]
                    ngram = tuple(parts[1 : 1 + section])
                    bo = parts[1 + section] if len(parts) > 1 + section else None
                else:
                    lp = parts[0]
                    ngram = tuple(parts[1].split())
                    bo = parts[2] if len(parts) > 2 else None
                self.logp[section - 1][ngram] = float(lp) * LOG10
                if bo is not None:
                    self.backoff[section - 1][ngram] = float(bo) * LOG10

    def score_word(self, context: Sequence[str], word: str) -> float:
        """log P(word | context) with standard Katz backoff."""
        context = tuple(context)[-(self.order - 1):] if self.order > 1 else ()
        return self._score(context, word)

    def _score(self, context: Tuple[str, ...], word: str) -> float:
        ngram = context + (word,)
        n = len(ngram)
        if n <= self.order and ngram in self.logp[n - 1]:
            return self.logp[n - 1][ngram]
        if not context:
            return self.logp[0].get((word,), self.logp[0].get(("<unk>",), -20.0))
        bo = self.backoff[len(context) - 1].get(context, 0.0)
        return bo + self._score(context[1:], word)

    def score_sequence(self, tokens: Sequence[str], bos: str = "<s>", eos: str = "</s>") -> float:
        ctx: List[str] = [bos]
        total = 0.0
        for t in list(tokens) + [eos]:
            total += self.score_word(ctx, t)
            ctx.append(t)
        return total


class NgramRescorer:
    """Rescore n-best hypotheses: score' = score + weight * lm_logp(tokens)."""

    def __init__(self, arpa_path: Union[str, Path], weight: float = 0.5):
        self.lm = ArpaLM(arpa_path)
        self.weight = weight

    def __call__(self, nbest: List, token_lists: List[List[str]]) -> List:
        rescored = []
        for hyp, tokens in zip(nbest, token_lists):
            lm_lp = self.lm.score_sequence(tokens)
            rescored.append(hyp._replace(score=hyp.score + self.weight * lm_lp))
        return sorted(rescored, key=lambda h: h.score, reverse=True)


class DenseNgramScorer:
    """A (<=2)-order slice of the model as dense tables for fusion on the
    device: table[c, w] = log P(w | c), the unigram backoff baked in."""

    def __init__(self, arpa_path: Union[str, Path], token_list: Sequence[str],
                 device: Union[str, torch.device] = "cuda"):
        lm = ArpaLM(arpa_path)
        v = len(token_list)
        if v > 4096:
            raise ValueError("DenseNgramScorer is for small vocabularies (<=4096)")
        uni = np.full((v,), -20.0, np.float32)
        for i, t in enumerate(token_list):
            if (t,) in lm.logp[0]:
                uni[i] = lm.logp[0][(t,)]
        table = np.broadcast_to(uni[None, :], (v, v)).copy()
        if lm.order >= 2:
            bo = np.zeros((v,), np.float32)
            for i, t in enumerate(token_list):
                bo[i] = lm.backoff[0].get((t,), 0.0)
            table = table + bo[:, None]  # backoff path
            for (c, w), lp in lm.logp[1].items():
                try:
                    ci = token_list.index(c)
                    wi = token_list.index(w)
                except ValueError:
                    continue
                table[ci, wi] = lp
        dev = resolve_device(device)
        self.table = torch.from_numpy(table).to(dev)  # [V, V] log P(w | last=c)
        self.uni = torch.from_numpy(uni).to(dev)

    def make_score_fn(self):
        """Beam-search full scorer: (tokens [N, L], lengths [N]) -> log-probs
        [N, V]; the unigram at the first position (context sos only)."""
        table, uni = self.table, self.uni

        def score(tokens: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
            last = tokens[torch.arange(tokens.shape[0], device=tokens.device), lengths - 1]
            return torch.where((lengths == 1)[:, None], uni[None, :],
                               table[torch.clamp(last, 0, uni.shape[0] - 1)])

        return score


def build_arpa(
    sentences: Sequence[Sequence[str]],
    path: Union[str, Path],
    order: int = 3,
    bos: str = "<s>",
    eos: str = "</s>",
    unk: str = "<unk>",
):
    """Train a backoff n-gram LM and write it in ARPA format (the asr.sh
    stage-9 `lmplz` analog, asr.sh:1179; consumed by ArpaLM/DenseNgramScorer).

    Witten-Bell interpolated smoothing: for history h with count c(h) and
    T(h) distinct continuation types,
        p(w|h) = (c(hw) + T(h) * p(w|h')) / (c(h) + T(h))
        bow(h) = T(h) / (c(h) + T(h))
    which is normalized and needs no count thresholds (robust on the small
    corpora recipes train ngrams on).
    """
    from collections import Counter, defaultdict

    path = Path(path)
    counts = [Counter() for _ in range(order + 1)]  # counts[k]: k-gram tuples
    followers = [defaultdict(set) for _ in range(order)]  # followers[k]: h(len k) -> {w}
    for sent in sentences:
        toks = [bos] + list(sent) + [eos]
        for i in range(1, len(toks)):
            for k in range(1, order + 1):
                if i - k + 1 < 0:
                    continue
                gram = tuple(toks[i - k + 1 : i + 1])
                counts[k][gram] += 1
                followers[k - 1][gram[:-1]].add(gram[-1])
    # history counts: c(h) = sum over continuations (so <s> histories work)
    hist_count = [Counter() for _ in range(order)]
    for k in range(1, order + 1):
        for gram, c in counts[k].items():
            hist_count[k - 1][gram[:-1]] += c

    vocab = sorted({g[0] for g in counts[1]} | {unk})
    v = len(vocab)

    probs: List[Dict[Tuple[str, ...], float]] = [dict() for _ in range(order + 1)]
    # unigrams interpolate with the uniform distribution
    t0 = len(followers[0][()])
    c0 = hist_count[0][()]
    for w in vocab:
        c = counts[1].get((w,), 0)
        probs[1][(w,)] = (c + t0 * (1.0 / v)) / (c0 + t0)
    for k in range(2, order + 1):
        for gram, c in counts[k].items():
            h = gram[:-1]
            t = len(followers[k - 1][h])
            ch = hist_count[k - 1][h]
            lower = probs[k - 1].get(gram[1:], 1.0 / v)
            probs[k][gram] = (c + t * lower) / (ch + t)

    def bow(h: Tuple[str, ...]) -> float:
        k = len(h)
        t = len(followers[k][h]) if h in followers[k] else 0
        ch = hist_count[k].get(h, 0)
        return t / (ch + t) if (ch + t) > 0 else 1.0

    def lg(x: float) -> float:
        return math.log10(max(x, 1e-99))

    with open(path, "w", encoding="utf-8") as f:
        f.write("\\data\\\n")
        n_uni = v + 1  # + <s> (prob entry with -99 like standard tools)
        f.write(f"ngram 1={n_uni}\n")
        for k in range(2, order + 1):
            f.write(f"ngram {k}={len(counts[k])}\n")
        f.write("\n\\1-grams:\n")
        # a unigram model has no backoff weights (the JAX function takes
        # <s>'s anyway and fails with an IndexError at order 1)
        f.write(f"-99\t{bos}\t{lg(bow((bos,)))}\n" if order > 1 else f"-99\t{bos}\n")
        for w in vocab:
            b = lg(bow((w,))) if order > 1 else 0.0
            if order > 1:
                f.write(f"{lg(probs[1][(w,)])}\t{w}\t{b}\n")
            else:
                f.write(f"{lg(probs[1][(w,)])}\t{w}\n")
        for k in range(2, order + 1):
            f.write(f"\n\\{k}-grams:\n")
            for gram in sorted(counts[k]):
                p = lg(probs[k][gram])
                if k < order:
                    f.write(f"{p}\t{' '.join(gram)}\t{lg(bow(gram))}\n")
                else:
                    f.write(f"{p}\t{' '.join(gram)}\n")
        f.write("\n\\end\\\n")
    return path
