"""Edit-distance scoring (counterpart of llm_guided_asr_tpu/utils/metrics.py).

A plain Levenshtein aligner in Python (the JAX package builds a C++ one;
the port keeps no copy of it): corpus error rates are substitutions +
deletions + insertions over the reference length; :func:`align` gives the
alignment for the per-utterance report of bin/score.py, and
:func:`corpus_bleu` the BLEU of MT/ST scoring.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Dict, Iterable, List, Sequence, Tuple


def edit_distance(ref: Sequence, hyp: Sequence) -> Tuple[int, int, int, int]:
    """(#sub, #del, #ins, #correct) of an optimal alignment; the backtrace
    prefers a match or substitution, then a deletion, as the JAX one does."""
    ops = [op for op, _, _ in align(ref, hyp)]
    return ops.count("S"), ops.count("D"), ops.count("I"), ops.count("C")


def _table(ref: Sequence, hyp: Sequence) -> List[List[int]]:
    n, m = len(ref), len(hyp)
    d = [[0] * (m + 1) for _ in range(n + 1)]
    for i in range(n + 1):
        d[i][0] = i
    for j in range(m + 1):
        d[0][j] = j
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            d[i][j] = min(d[i - 1][j - 1] + (ref[i - 1] != hyp[j - 1]), d[i - 1][j] + 1,
                          d[i][j - 1] + 1)
    return d


def align(ref: Sequence, hyp: Sequence) -> List[Tuple[str, object, object]]:
    """An optimal alignment as [(op, ref_tok, hyp_tok)], op in C/S/D/I, with
    the JAX one's backtrace preferences (sclite's result.txt)."""
    d = _table(ref, hyp)
    ops: List[Tuple[str, object, object]] = []
    i, j = len(ref), len(hyp)
    while i > 0 or j > 0:
        if i > 0 and j > 0 and d[i][j] == d[i - 1][j - 1] + (ref[i - 1] != hyp[j - 1]):
            ops.append(("C" if ref[i - 1] == hyp[j - 1] else "S", ref[i - 1], hyp[j - 1]))
            i, j = i - 1, j - 1
        elif i > 0 and d[i][j] == d[i - 1][j] + 1:
            ops.append(("D", ref[i - 1], None))
            i -= 1
        else:
            ops.append(("I", None, hyp[j - 1]))
            j -= 1
    return ops[::-1]


def error_rate(refs: Iterable[Sequence], hyps: Iterable[Sequence]) -> Dict[str, float]:
    """Corpus-level error rate (percent) over pre-split sequences."""
    tot_s = tot_d = tot_i = tot_ref = n_utt = 0
    for ref, hyp in zip(refs, hyps):
        s, d, i, _ = edit_distance(list(ref), list(hyp))
        tot_s, tot_d, tot_i = tot_s + s, tot_d + d, tot_i + i
        tot_ref += len(ref)
        n_utt += 1
    denom = max(tot_ref, 1)
    return {"err": 100.0 * (tot_s + tot_d + tot_i) / denom, "sub": 100.0 * tot_s / denom,
            "del": 100.0 * tot_d / denom, "ins": 100.0 * tot_i / denom, "n_ref": tot_ref,
            "n_utt": n_utt}


def wer(refs: Iterable[str], hyps: Iterable[str]) -> float:
    return error_rate((r.split() for r in refs), (h.split() for h in hyps))["err"]


def cer(refs: Iterable[str], hyps: Iterable[str]) -> float:
    strip = lambda s: list(s.replace(" ", ""))  # noqa: E731
    return error_rate((strip(r) for r in refs), (strip(h) for h in hyps))["err"]


def corpus_bleu(refs: Iterable[Sequence], hyps: Iterable[Sequence], max_n: int = 4) -> float:
    """Corpus BLEU-N in [0, 100] with the brevity penalty and sacrebleu's
    default exponential smoothing (an order with no clipped match counts
    1 / (2^k * total), k counting the smoothed orders)."""
    clipped = [0] * max_n
    totals = [0] * max_n
    ref_len = hyp_len = 0
    for ref, hyp in zip(refs, hyps):
        ref, hyp = list(ref), list(hyp)
        ref_len += len(ref)
        hyp_len += len(hyp)
        for n in range(1, max_n + 1):
            h_ngrams = Counter(tuple(hyp[i:i + n]) for i in range(len(hyp) - n + 1))
            r_ngrams = Counter(tuple(ref[i:i + n]) for i in range(len(ref) - n + 1))
            totals[n - 1] += max(len(hyp) - n + 1, 0)
            clipped[n - 1] += sum(min(c, r_ngrams[g]) for g, c in h_ngrams.items())
    if hyp_len == 0 or any(t == 0 for t in totals):
        return 0.0
    log_p, smooth = 0.0, 1.0
    for c, t in zip(clipped, totals):
        if c == 0:
            smooth *= 2.0
            log_p += math.log(1.0 / (smooth * t))
        else:
            log_p += math.log(c / t)
    log_p /= max_n
    bp = 1.0 if hyp_len > ref_len else math.exp(1.0 - ref_len / hyp_len)
    return 100.0 * bp * math.exp(log_p)
