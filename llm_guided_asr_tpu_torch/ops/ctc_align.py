"""CTC forced alignment: Viterbi over the CTC graph (counterpart of
llm_guided_asr_tpu/ops/ctc_align.py).

Given CTC log-posteriors and a known transcript, the best frame-level path
through the blank-interleaved state graph (2U+1 states: blank, token 0,
blank, token 1, ..., blank).  The forward pass is a loop over frames on
the device of ``logp`` with the state axis vectorised; each frame keeps
its decision (stay, diagonal or skip), and the backtrace follows the
stored decisions on the host.  Ties go to the first of (stay, diagonal,
skip), as ``jnp.argmax`` breaks them in JAX.
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch

NEG_INF = -1.0e30


def ctc_forced_align(logp: torch.Tensor, tokens: torch.Tensor,
                     t_len: Union[int, torch.Tensor], blank_id: int = 0
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """logp [T, V] CTC log-softmax, tokens [U] (no blanks), ``t_len`` valid
    frames -> (the state of each frame [T] in 0..2U, the token index of
    each frame [T], -1 for a blank); both -1 past ``t_len``.  CPU int64
    tensors."""
    t_max = logp.shape[0]
    t_len = int(t_len)
    dev = logp.device
    tokens = tokens.to(dev, torch.long)
    u = tokens.shape[0]
    s = 2 * u + 1
    state_tok = torch.full((s,), blank_id, dtype=torch.long, device=dev)
    state_tok[1::2] = tokens
    emit = logp[:, state_tok].float()  # [T, S]
    prev_tok = torch.cat([state_tok.new_full((2,), -1), state_tok[:-2]])
    can_skip = (torch.arange(s, device=dev) % 2 == 1) & (state_tok != prev_tok)
    neg = emit.new_full((2,), NEG_INF)

    alpha = emit.new_full((s,), NEG_INF)
    alpha[0] = emit[0, 0]
    if u > 0:
        alpha[1] = emit[0, 1]
    # frames at or past t_len keep alpha and stay (decision 0)
    came = torch.zeros((max(t_max - 1, 0), s), dtype=torch.long, device=dev)
    for t in range(1, min(t_len, t_max)):
        diag = torch.cat([neg[:1], alpha[:-1]])
        skip = torch.where(can_skip, torch.cat([neg, alpha[:-2]]), NEG_INF)
        choices = torch.stack([alpha, diag, skip])  # [3, S]
        came[t - 1] = torch.argmax(choices, dim=0)
        alpha = choices.gather(0, came[t - 1][None])[0] + emit[t]

    if u > 0:
        state = s - 1 if bool(alpha[s - 1] >= alpha[s - 2]) else s - 2
    else:
        state = 0
    came_h = came.cpu().numpy()
    seq = np.empty(t_max, np.int64)
    for t in range(t_max - 1, 0, -1):
        seq[t] = state
        if t < t_len:
            state -= int(came_h[t - 1, state])
    if t_max:
        seq[0] = state
    valid = np.arange(t_max) < t_len
    states = np.where(valid, seq, -1)
    toks = np.where(valid & (seq % 2 == 1), seq // 2, -1)
    return torch.from_numpy(states), torch.from_numpy(toks)


def token_boundaries(token_per_frame, n_tokens: int) -> np.ndarray:
    """[T] token index per frame (-1 = blank) -> [U, 2] (start, end)
    frames; a token no frame holds takes the previous one's end twice."""
    token_per_frame = np.asarray(token_per_frame)
    bounds = np.zeros((n_tokens, 2), np.int64)
    for u in range(n_tokens):
        frames = np.nonzero(token_per_frame == u)[0]
        if len(frames):
            bounds[u] = [frames[0], frames[-1] + 1]
        elif u > 0:
            bounds[u] = bounds[u - 1][[1, 1]]
    return bounds
