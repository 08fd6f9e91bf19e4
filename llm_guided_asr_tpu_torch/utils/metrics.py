"""Edit-distance scoring (counterpart of llm_guided_asr_tpu/utils/metrics.py).

A plain Levenshtein aligner in Python (the JAX package builds a C++ one;
the port keeps no copy of it): corpus error rates are substitutions +
deletions + insertions over the reference length.
"""

from __future__ import annotations

from typing import Dict, Iterable, Sequence, Tuple


def edit_distance(ref: Sequence, hyp: Sequence) -> Tuple[int, int, int, int]:
    """(#sub, #del, #ins, #correct) of an optimal alignment; the backtrace
    prefers a match or substitution, then a deletion, as the JAX one does."""
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
    i, j = n, m
    n_sub = n_del = n_ins = n_cor = 0
    while i > 0 or j > 0:
        if i > 0 and j > 0 and d[i][j] == d[i - 1][j - 1] + (ref[i - 1] != hyp[j - 1]):
            if ref[i - 1] == hyp[j - 1]:
                n_cor += 1
            else:
                n_sub += 1
            i, j = i - 1, j - 1
        elif i > 0 and d[i][j] == d[i - 1][j] + 1:
            n_del += 1
            i -= 1
        else:
            n_ins += 1
            j -= 1
    return n_sub, n_del, n_ins, n_cor


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
