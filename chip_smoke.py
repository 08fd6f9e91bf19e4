#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card (H100).

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over; each
prints how long it took):

1. build   -- compile every CUDA kernel source in llm_guided_asr_tpu_torch/csrc
              with nvcc for sm_90a (one nvcc per source, started together)
              and print ptxas's register and spill lines;
2. kernels -- hold each kernel entry point against its plain PyTorch version
              and time it beside the plain version, the library call where
              one exists, and the bound from bytes and operations:
              the two forwards at the serving path's shapes (B=1, CUDA
              events around a CUDA graph of repeated launches), and at the
              training shapes (rel-attention B=64, H=4, T=312, dk=64;
              depthwise [64, 312, 256] x [31, 256] and an even K=8) the
              rel-attention forward with dropout and its backward against
              autograd through the plain version with the same hash mask
              (dropout 0 and 0.1, all keys valid and ragged), and the
              depthwise backward against its plain VJP, in float32 and
              bfloat16 (CUDA events around back-to-back launches);
3. serve   -- build the LLM-guided model at full width (Conformer 12x256,
              guided decoder 6x256, Llama-3.2-1B dims in bf16) with weights
              drawn from seed 0, serve one warm-up request at each of the
              3 lengths and then each request 5 times through Speech2Text
              with beam 10 (median latency and spread), and check the
              kernel launch counts of the timed requests (12 forward
              launches per request each, no backward), the hypotheses'
              score bookkeeping, and the card's encoder against the plain
              CPU path;
4. profile -- the 10 s request again: its encode time alone, then one run
              under torch.profiler (card activity only) for the device busy
              share of the unprofiled latency and the top kernels by device
              time;
5. train-1 -- phase 1 of the fork's training: the flagship CTC/attention
              ASRModel (bench.py build_flagship: vocab 5000, Conformer
              12x256, decoder 6x256) in float32 with SpecAug and attention
              dropout 0.1, AdamW, B=64 x 10 s of seeded noise: 2 warm-up and
              10 timed fused train steps (losses finite and falling, each of
              the four kernel entry points launched 12 times per step), peak
              memory, and one profiled step's device busy share;
6. train-2 -- phase 2: the serving model with encoder, ctc_head and llm
              frozen, B=2 x 10 s: 1 warm-up and 5 timed steps (forward
              kernels 12 launches per step, backward kernels none, frozen
              weights bit-identical afterwards) and one profiled step.

The last two lines of standard output are the kernel table as one JSON
object and {"ok": true, "device": {...}}; the line before them is the
card's name and power limit.  Without a card the script exits with
status 2 and prints no result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

# Published H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}

SR = 16000
REQUEST_SECONDS = (10.0, 7.3, 4.1)
ROUNDS = 5  # timed runs of each request
TRAIN_B, TRAIN_SECONDS, TRAIN_WARMUP, TRAIN_STEPS = 64, 10.0, 2, 10
GUIDED_B, GUIDED_WARMUP, GUIDED_STEPS = 2, 1, 5
REL_SHAPE = dict(b=64, h=4, t=312, dk=64)  # phase 1: 10 s of audio, 4 heads of 64
DW_SHAPE = (64, 312, 256)


def nvidia_smi_name_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def graph_time_ms(fn, launches: int = 20, replays: int = 10) -> float:
    """Device time per call: ``launches`` calls captured in one CUDA graph,
    replayed ``replays`` times between two CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (launches * replays)


def event_time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Device time per call of work long enough to hide the launches:
    ``iters`` calls back to back between two CUDA events, after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, flops: float, dtype) -> tuple:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


def reset_counts(kernels) -> None:
    for k in kernels:
        k.reset_launches()


def counts(kernels) -> dict:
    return {name: n for k in kernels for name, n in k.launches.items()}


# ---------------------------------------------------------------------------
def phase_build(kernels):
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(kernels)) as pool:  # one nvcc per source, together
        list(pool.map(lambda k: k.build(), kernels))
    print(f"[build] {len(kernels)} kernel sources built in {time.perf_counter() - t0:.1f} s")
    for k in kernels:
        entry = ""
        for line in k.ptxas_log.splitlines():
            if "Compiling entry" in line:
                entry = line.split("'")[1] if "'" in line else line
            elif "registers" in line or "spill" in line:
                print(f"[build] {k.source.name} {entry[:70]}: {line.strip()}")


def rel_attention_tol(ref: torch.Tensor) -> float:
    """float32 differs from the plain version only in the order of the sums;
    bfloat16 also rounds the output, by at most one unit in the last place
    (2**-7 of the largest output) when the two sit on either side of a tie."""
    if ref.dtype == torch.float32:
        return 1e-5
    return 2.0 ** -7 * ref.float().abs().max().item() + 1e-5


def grad_tol(ref: torch.Tensor, dtype) -> float:
    """Gradients: float32 1e-4 of the largest reference gradient (the order
    of the sums over up to 312 keys, 64 batch rows and their atomics);
    bfloat16 2**-6 of it, four units in the last place: the stored
    gradients are rounded once and the backward's delta is taken from the
    bfloat16 output."""
    scale = ref.float().abs().max().item()
    return (1e-4 if dtype == torch.float32 else 2.0 ** -6) * scale + 1e-6


def check_rel_attention(ra, dtype, gen):
    """Serving shapes: B=1, H=4, T=312 (10 s of audio), dk=64, no gradient.

    Unit-scale inputs give logits of standard deviation about 1.4, so the
    softmax is peaked enough that dropping or misplacing the positional
    term moves outputs far beyond the tolerance.  The error is checked with
    all keys valid (the serving path: every frame of a B=1 request is
    valid) and with 25 keys masked; the time and the bound are taken with
    all keys valid, as the serving path calls the kernel.
    """
    b, h, t, dk = 1, 4, 312, 64
    mk = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(dtype)  # noqa: E731
    qu, qv, k, v = (mk(b, h, t, dk) for _ in range(4))
    p = mk(h, 2 * t - 1, dk)
    sm = 1.0 / math.sqrt(dk)
    errs = {}
    for n_valid in (t, 287):
        kv_valid = (torch.arange(t, device="cuda")[None] < n_valid).to(torch.int32)
        out = ra.rel_attention(qu, qv, k, v, p, kv_valid, sm)
        ref = ra.rel_attention_plain(qu, qv, k, v, p, kv_valid, sm)
        torch.cuda.synchronize()
        err = max_err(out, ref)
        tol = rel_attention_tol(ref)
        if not err <= tol:
            raise AssertionError(f"rel_attention {dtype} {n_valid} valid keys: {err} > {tol}")
        errs[n_valid] = (err, tol)
    kv_valid = torch.ones(b, t, dtype=torch.int32, device="cuda")
    # what the function needs for these inputs: each query row against the
    # valid keys only (a masked key adds exactly 0), the k and v rows of
    # those keys, the T + n - 1 positional rows they index
    n = kv_valid.sum(dim=1)
    item = dtype.itemsize
    n_bytes = (item * (3 * b * h * t * dk + 2 * h * dk * n.sum().item()
                       + h * (t + n.max().item() - 1) * dk) + 4 * b * t)
    flops = 6.0 * h * t * dk * n.sum().item()  # qu.k, qv.p and probs.v products
    bms, by = bound_ms(n_bytes, flops, dtype)
    err, tol = max(errs.values())
    return dict(
        err=err, tol=tol,
        ms=graph_time_ms(lambda: ra.rel_attention(qu, qv, k, v, p, kv_valid, sm)),
        plain_ms=graph_time_ms(lambda: ra.rel_attention_plain(qu, qv, k, v, p, kv_valid, sm)),
        library_ms=None,  # no single PyTorch call computes rel-pos attention
        bound_ms=bms, bound_by=by,
    )


def check_dwconv(dc, dtype, k_size, gen):
    """Serving shape: [1, 312, 256] x [31, 256]; also an even K."""
    b, t, c = 1, 312, 256
    x = torch.randn(b, t, c, generator=gen, device="cuda").to(dtype)
    w = torch.randn(k_size, c, generator=gen, device="cuda").to(dtype)
    y = dc.depthwise_conv1d(x, w)
    ref = dc.depthwise_conv1d_plain(x, w)
    # library yardstick, timed only: F.conv1d over the channels-first view
    xt, wt = x.transpose(1, 2), w.t()[:, None, :]
    lib = lambda: torch.nn.functional.conv1d(xt, wt, groups=c, padding="same")  # noqa: E731
    torch.cuda.synchronize()
    err = max_err(y, ref)
    lib_err = max_err(lib().transpose(1, 2), ref)
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    if not err <= tol:
        raise AssertionError(f"depthwise fwd {dtype} K={k_size}: {err} > {tol}")
    if lib_err > 10 * tol:
        raise AssertionError(f"library yardstick computes another function (err {lib_err})")
    n_bytes = dtype.itemsize * (2 * b * t * c + k_size * c)
    flops = 2.0 * b * t * c * k_size
    bms, by = bound_ms(n_bytes, flops, dtype)
    return dict(
        err=err, tol=tol,
        ms=graph_time_ms(lambda: dc.depthwise_conv1d(x, w)),
        plain_ms=graph_time_ms(lambda: dc.depthwise_conv1d_plain(x, w)),
        library_ms=graph_time_ms(lib),
        bound_ms=bms, bound_by=by,
    )


def check_rel_attention_train(ra, dtype, gen):
    """Training shapes (phase 1: B=64, H=4, T=312, dk=64): the forward with
    the saved log-sum-exp and the backward, under autograd, against autograd
    through the plain version with the same hash mask; dropout 0 and 0.1,
    all keys valid and ragged (lengths from 312 down to 56).  Timed with all
    keys valid and dropout 0.1, as phase 1 calls them; the plain backward's
    time includes the forward it recomputes."""
    b, h, t, dk = REL_SHAPE["b"], REL_SHAPE["h"], REL_SHAPE["t"], REL_SHAPE["dk"]
    mk = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(dtype)  # noqa: E731
    qu, qv, k, v, dout = (mk(b, h, t, dk) for _ in range(5))
    p = mk(h, 2 * t - 1, dk)
    sm, seed = 1.0 / math.sqrt(dk), 1234567
    full = torch.ones(b, t, dtype=torch.int32, device="cuda")
    lengths = torch.linspace(t, 56, b, device="cuda").long()
    ragged = (torch.arange(t, device="cuda")[None] < lengths[:, None]).to(torch.int32)
    errs = {"out": 0.0, "dqu": 0.0, "dqv": 0.0, "dk": 0.0, "dv": 0.0, "dp": 0.0}
    for rate in (0.0, 0.1):
        for valid_name, kv_valid in (("all", full), ("ragged", ragged)):
            leaves = [x.clone().requires_grad_(True) for x in (qu, qv, k, v, p)]
            out = ra.rel_attention(*leaves, kv_valid, sm, seed=seed, dropout_rate=rate)
            grads = torch.autograd.grad(out, leaves, dout)
            ref = ra.rel_attention_plain(qu, qv, k, v, p, kv_valid, sm, seed, rate)
            refs = ra.rel_attention_bwd_plain(qu, qv, k, v, p, kv_valid, dout, sm, seed, rate)
            torch.cuda.synchronize()
            parts = [("out", out, ref, rel_attention_tol(ref))]
            parts += [(n, g, r, grad_tol(r.to(dtype), dtype)) for n, g, r in
                      zip(("dqu", "dqv", "dk", "dv", "dp"), grads, refs)]
            line = []
            for name, got, want, tol in parts:
                err = max_err(got, want.to(dtype))
                if not err <= tol:
                    raise AssertionError(f"rel_attention {dtype} rate {rate} {valid_name}: "
                                         f"{name} error {err} > {tol}")
                errs[name] = max(errs[name], err)
                line.append(f"{name} {err:.2e}/{tol:.1e}")
            print(f"[kernels] rel_attention train {str(dtype)[6:]} dropout {rate} keys "
                  f"{valid_name}: max_abs_err/tol " + ", ".join(line))
            del leaves, out, grads, ref, refs
    rate = 0.1
    out, lse = ra.rel_attention_fwd(qu, qv, k, v, p, full, sm, seed, rate)
    fwd = lambda: ra.rel_attention_fwd(qu, qv, k, v, p, full, sm, seed, rate)  # noqa: E731
    bwd = lambda: ra.rel_attention_bwd(qu, qv, k, v, p, full, out, lse, dout, sm,  # noqa: E731
                                       seed, rate)
    item, n = dtype.itemsize, float(full.sum().item())
    table = h * (2 * t - 1) * dk
    fwd_bytes = item * (5 * b * h * t * dk + table) + 4 * b * h * t + 4 * b * t
    # backward reads qu, qv, k, v, out, dout, p, lse, kv_valid; writes the
    # four [B, H, T, dk] gradients and dp in float32
    bwd_bytes = item * (10 * b * h * t * dk + table) + 4 * (table + b * h * t + b * t)
    fwd_bound, fwd_by = bound_ms(fwd_bytes, 6.0 * h * t * dk * n, dtype)
    bwd_bound, bwd_by = bound_ms(bwd_bytes, 16.0 * h * t * dk * n, dtype)
    plain_fwd = lambda: ra.rel_attention_plain(qu, qv, k, v, p, full, sm, seed, rate)  # noqa: E731
    plain_bwd = lambda: ra.rel_attention_bwd_plain(  # noqa: E731
        qu, qv, k, v, p, full, dout, sm, seed, rate)
    fwd_r = dict(err=errs["out"], ms=event_time_ms(fwd), plain_ms=event_time_ms(plain_fwd),
                 library_ms=None, bound_ms=fwd_bound, bound_by=fwd_by)
    bwd_r = dict(err=max(v for n_, v in errs.items() if n_ != "out"), errs=errs,
                 ms=event_time_ms(bwd), plain_ms=event_time_ms(plain_bwd, iters=5),
                 library_ms=None, bound_ms=bwd_bound, bound_by=bwd_by)
    return fwd_r, bwd_r


def check_dwconv_train(dc, dtype, k_size, gen):
    """Training shape [64, 312, 256] x [K, 256]: the backward against the
    plain VJP, and the forward; the library yardstick of the backward is
    autograd's backward of F.conv1d(groups=C) (timed only)."""
    b, t, c = DW_SHAPE
    x, dy = (torch.randn(b, t, c, generator=gen, device="cuda").to(dtype) for _ in range(2))
    w = torch.randn(k_size, c, generator=gen, device="cuda").to(dtype)
    dx, dw = dc.depthwise_conv1d_bwd(x, w, dy)
    ref_dx, ref_dw = dc.depthwise_conv1d_bwd_plain(x, w, dy)
    y, ref_y = dc.depthwise_conv1d(x, w), dc.depthwise_conv1d_plain(x, w)
    torch.cuda.synchronize()
    errs = {"dx": max_err(dx, ref_dx), "dw": max_err(dw, ref_dw)}
    for name, ref in (("dx", ref_dx), ("dw", ref_dw)):
        if not errs[name] <= grad_tol(ref, dtype):
            raise AssertionError(f"depthwise bwd {dtype} K={k_size}: {name} {errs[name]} > "
                                 f"{grad_tol(ref, dtype)}")
    fwd_err = max_err(y, ref_y)
    fwd_tol = 1e-4 if dtype == torch.float32 else 5e-2
    if not fwd_err <= fwd_tol:
        raise AssertionError(f"depthwise fwd {dtype} K={k_size}: {fwd_err} > {fwd_tol}")
    xt = x.transpose(1, 2).detach().requires_grad_(True)
    wt = w.t()[:, None, :].detach().requires_grad_(True)
    yt = torch.nn.functional.conv1d(xt, wt, groups=c, padding="same")
    dyt = dy.transpose(1, 2)
    lib = lambda: torch.autograd.grad(yt, (xt, wt), dyt, retain_graph=True)  # noqa: E731
    lib_dx, lib_dw = lib()
    if max_err(lib_dx.transpose(1, 2), ref_dx) > 10 * grad_tol(ref_dx, dtype):
        raise AssertionError("library yardstick computes another backward")
    item = dtype.itemsize
    bwd_bound, bwd_by = bound_ms(item * (3 * b * t * c + k_size * c) + 4 * k_size * c,
                                 4.0 * b * t * c * k_size, dtype)
    fwd_bound, fwd_by = bound_ms(item * (2 * b * t * c + k_size * c),
                                 2.0 * b * t * c * k_size, dtype)
    xf, wf = x.transpose(1, 2), w.t()[:, None, :]
    lib_fwd = lambda: torch.nn.functional.conv1d(xf, wf, groups=c, padding="same")  # noqa: E731
    fwd_r = dict(err=fwd_err, ms=event_time_ms(lambda: dc.depthwise_conv1d(x, w)),
                 plain_ms=event_time_ms(lambda: dc.depthwise_conv1d_plain(x, w)),
                 library_ms=event_time_ms(lib_fwd), bound_ms=fwd_bound, bound_by=fwd_by)
    bwd_r = dict(err=max(errs.values()), errs=errs,
                 ms=event_time_ms(lambda: dc.depthwise_conv1d_bwd(x, w, dy)),
                 plain_ms=event_time_ms(lambda: dc.depthwise_conv1d_bwd_plain(x, w, dy)),
                 library_ms=event_time_ms(lib), bound_ms=bwd_bound, bound_by=bwd_by)
    return fwd_r, bwd_r


def _print_timing(card, name, shape, dtype, r):
    lib = "none (no one PyTorch call)" if r["library_ms"] is None else \
        f"{r['library_ms'] * 1e3:.2f} us"
    print(f"[kernels] {name} {shape} {str(dtype)[6:]}: max_abs_err {r['err']:.3e}, kernel "
          f"{r['ms'] * 1e3:.2f} us, plain {r['plain_ms'] * 1e3:.2f} us, library {lib}, "
          f"bound {r['bound_ms'] * 1e3:.3f} us ({r['bound_by']}) [{card}]")


def phase_kernels(ra, dc, card):
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        cases = [("rel_attention_fwd", "serve B=1 T=312", check_rel_attention(ra, dtype, gen))]
        for k_size in (31, 8):
            cases.append(("dwconv1d_fwd", f"serve [1,312,256] K={k_size}",
                          check_dwconv(dc, dtype, k_size, gen)))
        fwd_r, bwd_r = check_rel_attention_train(ra, dtype, gen)
        cases += [("rel_attention_fwd", "train B=64 T=312 dropout 0.1", fwd_r),
                  ("rel_attention_bwd", "train B=64 T=312 dropout 0.1", bwd_r)]
        for k_size in (31, 8):
            fwd_r, bwd_r = check_dwconv_train(dc, dtype, k_size, gen)
            cases += [("dwconv1d_fwd", f"train [64,312,256] K={k_size}", fwd_r),
                      ("dwconv1d_bwd", f"train [64,312,256] K={k_size}", bwd_r)]
        for name, shape, r in cases:
            _print_timing(card, name, shape, dtype, r)
            results.setdefault((name, shape, dtype), r)
        torch.cuda.empty_cache()
    return results


def build_model():
    from llm_guided_asr_tpu_torch.convert import init_weights
    from llm_guided_asr_tpu_torch.models.conformer import ConformerConfig
    from llm_guided_asr_tpu_torch.models.llm.llama import LlamaConfig
    from llm_guided_asr_tpu_torch.models.llm.prompt import PromptTemplate
    from llm_guided_asr_tpu_torch.models.llm_guided import LLMGuidedASRConfig, LLMGuidedASRModel
    from llm_guided_asr_tpu_torch.models.transformer_decoder import TransformerDecoderConfig
    from llm_guided_asr_tpu_torch.ops.frontend import FrontendConfig

    # meta-llama/Llama-3.2-1B dims (HF config.json)
    llm = LlamaConfig(
        vocab_size=128256, hidden_size=2048, intermediate_size=8192, num_hidden_layers=16,
        num_attention_heads=32, num_key_value_heads=8, rms_norm_eps=1e-5,
        rope_theta=500000.0, max_position_embeddings=131072, tie_word_embeddings=True,
        rope_scaling_factor=32.0, rope_low_freq_factor=1.0, rope_high_freq_factor=4.0,
        rope_original_max_position=8192,
    )
    cfg = LLMGuidedASRConfig(
        vocab_size=llm.vocab_size, llm=llm,
        prompt=PromptTemplate(prefix_ids=tuple(range(2, 50)), suffix_ids=tuple(range(50, 66)),
                              start_of_response_id=70, end_of_response_id=70, pad_id=0),
        frontend=FrontendConfig(), normalize="utterance_mvn",
        encoder=ConformerConfig(output_size=256, attention_heads=4, linear_units=1024,
                                num_blocks=12, macaron_style=True, use_cnn_module=True,
                                cnn_module_kernel=31),
        decoder=TransformerDecoderConfig(attention_heads=4, linear_units=2048, num_blocks=6),
        ctc_weight=0.3,
    )
    model = LLMGuidedASRModel(cfg, llm_dtype=torch.bfloat16, device="cuda")
    return init_weights(model, seed=0).eval()


def phase_serve(model, kernels, card):
    """Serve every request ``ROUNDS`` times, after one warm-up at each
    length; returns the launch counts and each length's median latency."""
    from llm_guided_asr_tpu_torch.bin.asr_inference import Speech2Text

    s2t = Speech2Text(model, ctc_weight=0.3, beam_size=10, maxlenratio=-24.0)
    rng = np.random.default_rng(0)
    waves = [(rng.standard_normal(int(s * SR)) * 0.1).astype(np.float32) for s in REQUEST_SECONDS]
    # one warm-up request at each length, so that the timed ones pay for no
    # first use of a cuBLAS/cuDNN path or allocator growth at their shapes;
    # the launch counts start after them
    for sec, wave in zip(REQUEST_SECONDS, waves):
        t0 = time.perf_counter()
        s2t(wave)
        torch.cuda.synchronize()
        print(f"[serve] warm-up request, {sec:.1f} s audio: {(time.perf_counter() - t0) * 1e3:.1f} ms")
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    lat = {sec: [] for sec in REQUEST_SECONDS}
    hyps = []
    for _ in range(ROUNDS):
        for sec, wave in zip(REQUEST_SECONDS, waves):
            t0 = time.perf_counter()
            (ids, hyp), = s2t(wave)
            torch.cuda.synchronize()
            lat[sec].append(time.perf_counter() - t0)
            hyps.append((ids, hyp))
    launches = counts(kernels)
    peak = torch.cuda.max_memory_allocated()

    n_requests = len(hyps)
    for sec in REQUEST_SECONDS:
        ms = sorted(x * 1e3 for x in lat[sec])
        med = float(np.median(ms))
        print(f"[serve] {sec:.1f} s audio, {len(ms)} runs: latency median {med:.1f} ms "
              f"(min {ms[0]:.1f}, max {ms[-1]:.1f}), RTFx at the median {sec / med * 1e3:.2f} "
              f"[{card}]")
    for sec, (ids, hyp) in zip(REQUEST_SECONDS, hyps):
        print(f"[serve] {sec:.1f} s audio: hyp {len(ids)} tokens, score {hyp.score:.4f} {hyp.scores}")
    for ids, hyp in hyps:
        if not math.isfinite(hyp.score) or not all(0 <= i < model.cfg.vocab_size for i in ids):
            raise AssertionError(f"bad hypothesis: {hyp}")
        # total = att_weight * decoder + ctc_weight * ctc (penalty 0)
        want = 0.7 * hyp.scores["decoder"] + 0.3 * hyp.scores["ctc"]
        if abs(hyp.score - want) > 1e-3 * max(1.0, abs(want)):
            raise AssertionError(f"score {hyp.score} != weighted parts {want}")
    for i, (ids, _) in enumerate(hyps):
        if ids != hyps[i % len(REQUEST_SECONDS)][0]:
            raise AssertionError("the same request gave different hypotheses across rounds")
    n_blocks = model.cfg.encoder.num_blocks
    print(f"[serve] kernel launches over {n_requests} requests: {launches}")
    for name, n in launches.items():
        want = n_blocks * n_requests if name.endswith("_fwd") else 0
        if n != want:
            raise AssertionError(f"{name}: {n} launches, expected {want}")
    print(f"[serve] torch.cuda.max_memory_allocated: {peak} bytes ({peak / 2**30:.2f} GiB)")

    # the card's encoder (CUDA kernels) against the plain path on the CPU
    import copy

    wave = waves[-1]
    speech, n = torch.from_numpy(wave[None]), torch.tensor([wave.shape[0]])
    with torch.inference_mode():
        enc_gpu, lens_gpu = model.encode(speech.cuda(), n.cuda())
        cpu_model = copy.deepcopy(model.encoder).cpu()
        from llm_guided_asr_tpu_torch.ops.frontend import default_frontend, utterance_mvn

        feats, flens = default_frontend(speech, n)
        enc_cpu, lens_cpu = cpu_model(utterance_mvn(feats, flens), flens)
    err = (enc_gpu.cpu() - enc_cpu).abs().max().item()
    print(f"[serve] encoder card vs CPU plain path, {REQUEST_SECONDS[-1]} s: max_abs_err "
          f"{err:.3e} (tol 1e-3)")
    if not (err <= 1e-3 and torch.equal(lens_gpu.cpu(), lens_cpu)):
        raise AssertionError(f"encoder disagrees with the CPU plain path: {err}")
    return launches, waves, float(np.median(lat[REQUEST_SECONDS[0]]))


def device_busy(prof) -> tuple:
    """Device time (ms) of a traced run (card activity only) and its events."""
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(e.self_device_time_total for e in events) / 1e3, events


def print_top(tag, events, n=12):
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:n]:
        print(f"[{tag}]   {e.self_device_time_total / 1e3:8.2f} ms  {e.count:6d}x  {e.key[:90]}")


def phase_profile(model, wave, wall_s: float, card):
    """The 10 s request: its encode time alone (median of ``ROUNDS``), then
    one run with the profiler tracing the card only; the busy share divides
    that run's device time by the request's unprofiled median latency."""
    from torch.profiler import ProfilerActivity, profile

    from llm_guided_asr_tpu_torch.bin.asr_inference import Speech2Text

    s2t = Speech2Text(model, ctc_weight=0.3, beam_size=10, maxlenratio=-24.0)
    speech = torch.from_numpy(wave[None]).cuda()
    n = torch.tensor([wave.shape[0]], device="cuda")
    t_enc = []
    with torch.inference_mode():
        for _ in range(ROUNDS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.encode(speech, n)
            torch.cuda.synchronize()
            t_enc.append(time.perf_counter() - t0)
    enc_ms = sorted(x * 1e3 for x in t_enc)
    med_enc = float(np.median(enc_ms))
    print(f"[profile] {REQUEST_SECONDS[0]} s request, median latency {wall_s * 1e3:.1f} ms, of "
          f"which encode (frontend + Conformer) median {med_enc:.1f} ms (min {enc_ms[0]:.1f}, "
          f"max {enc_ms[-1]:.1f}, {len(enc_ms)} runs); first pass and search "
          f"{wall_s * 1e3 - med_enc:.1f} ms [{card}]")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        s2t(wave)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_ms, events = device_busy(prof)
    print(f"[profile] {REQUEST_SECONDS[0]} s request traced (card only): wall {wall * 1e3:.1f} ms, "
          f"device busy {dev_ms:.1f} ms = {100 * dev_ms / 1e3 / wall_s:.1f}% of the "
          f"unprofiled median latency")
    print_top("profile", events)


def run_steps(tag, step, batch, n_warmup, n_steps, kernels, card):
    """Warm-up steps, then timed steps with the launch counts reset before
    them; returns (per-step stats of all steps, timed seconds, counts)."""
    all_stats = []
    for i in range(n_warmup):
        t0 = time.perf_counter()
        stats, _ = step(batch)
        torch.cuda.synchronize()
        all_stats.append({k: float(v) for k, v in stats.items()})
        print(f"[{tag}] warm-up step {i + 1}: {(time.perf_counter() - t0) * 1e3:.1f} ms "
              f"[{card}], {all_stats[-1]}")
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    dts, timed = [], []
    for _ in range(n_steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats, _ = step(batch)
        torch.cuda.synchronize()
        dts.append(time.perf_counter() - t0)
        timed.append(stats)
    launches = counts(kernels)
    for i, (dt, stats) in enumerate(zip(dts, timed)):
        all_stats.append({k: float(v) for k, v in stats.items()})
        print(f"[{tag}] step {n_warmup + i + 1}: {dt * 1e3:.1f} ms [{card}], "
              + ", ".join(f"{k} {v:.4f}" for k, v in all_stats[-1].items()))
    for s in all_stats:
        if not all(math.isfinite(v) for v in s.values()):
            raise AssertionError(f"{tag}: non-finite stats {s}")
    ms = sorted(x * 1e3 for x in dts)
    med = float(np.median(ms))
    peak = torch.cuda.max_memory_allocated()
    print(f"[{tag}] {n_steps} timed steps: median {med:.1f} ms (min {ms[0]:.1f}, max "
          f"{ms[-1]:.1f}); peak memory {peak} bytes ({peak / 2**30:.2f} GiB) [{card}]")
    print(f"[{tag}] kernel launches over {n_steps} steps: {launches}")
    return all_stats, med, launches


def phase_train1(kernels, card):
    """The flagship CTC/attention model (bench.py build_flagship) trained
    at B=64 x 10 s, float32 with TF32 off, SpecAug and attention dropout."""
    from llm_guided_asr_tpu_torch.convert import init_weights
    from llm_guided_asr_tpu_torch.models.asr_model import ASRModel, ASRModelConfig
    from llm_guided_asr_tpu_torch.models.conformer import ConformerConfig
    from llm_guided_asr_tpu_torch.models.transformer_decoder import TransformerDecoderConfig
    from llm_guided_asr_tpu_torch.ops.frontend import FrontendConfig
    from llm_guided_asr_tpu_torch.ops.specaug import SpecAugConfig
    from llm_guided_asr_tpu_torch.train.optim import build_optimizer
    from llm_guided_asr_tpu_torch.train.trainer import init_train_state, make_fused_train_step

    cfg = ASRModelConfig(
        vocab_size=5000, frontend=FrontendConfig(), normalize="utterance_mvn",
        specaug=SpecAugConfig(),
        encoder=ConformerConfig(output_size=256, attention_heads=4, linear_units=1024,
                                num_blocks=12, macaron_style=True, use_cnn_module=True,
                                cnn_module_kernel=31, attention_dropout_rate=0.1),
        decoder=TransformerDecoderConfig(attention_heads=4, linear_units=2048, num_blocks=6),
        ctc_weight=0.3,
    )
    print("[train-1] flagship as bench.py build_flagship, with two deviations from the JAX "
          "defaults: specaug=SpecAugConfig() (JAX default None) and "
          "attention_dropout_rate=0.1 (JAX default 0.0), so that the kernels' dropout runs")
    model = init_weights(ASRModel(cfg, device="cuda"), seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    state = init_train_state(model, build_optimizer("adamw", {"lr": 1e-3}))
    step = make_fused_train_step(model, state, torch.Generator().manual_seed(0))
    samples = int(TRAIN_SECONDS * SR)
    rng = np.random.default_rng(4)
    batch = {
        "speech": torch.from_numpy((rng.standard_normal((TRAIN_B, samples)) * 0.1)
                                   .astype(np.float32)).cuda(),
        "speech_lengths": torch.full((TRAIN_B,), samples, device="cuda"),
        "text": torch.ones((TRAIN_B, 24), dtype=torch.long, device="cuda"),
        "text_lengths": torch.full((TRAIN_B,), 24, device="cuda"),
    }
    print(f"[train-1] {n_params} parameters, batch {TRAIN_B} x {TRAIN_SECONDS} s, text [64, 24]")
    all_stats, med, launches = run_steps("train-1", step, batch, TRAIN_WARMUP, TRAIN_STEPS,
                                         kernels, card)
    losses = [s["loss"] for s in all_stats]
    if not np.mean(losses[-3:]) < losses[0]:
        raise AssertionError(f"train-1: loss did not fall: {losses}")
    n_blocks = cfg.encoder.num_blocks
    for name, n in launches.items():
        if n != n_blocks * TRAIN_STEPS:
            raise AssertionError(f"train-1: {name} launched {n} times in {TRAIN_STEPS} steps, "
                                 f"expected {n_blocks} per step")
    print(f"[train-1] audio seconds per second at the median: "
          f"{TRAIN_B * TRAIN_SECONDS / (med / 1e3):.1f} [{card}]")
    profile_step("train-1", step, batch, med)
    return launches, med


def profile_step(tag, step, batch, median_ms):
    """One more step with the profiler tracing the card only: its device
    time over the unprofiled median step, and the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step(batch)
        torch.cuda.synchronize()
    dev_ms, events = device_busy(prof)
    print(f"[{tag}] one step traced (card only): device busy {dev_ms:.1f} ms = "
          f"{100 * dev_ms / median_ms:.1f}% of the unprofiled median step")
    print_top(tag, events, n=15)


def phase_train2(model, kernels, card):
    """Phase 2 on the serving model: encoder, ctc_head and llm frozen."""
    from llm_guided_asr_tpu_torch.train.optim import build_optimizer, path_prefix_mask
    from llm_guided_asr_tpu_torch.train.trainer import init_train_state, make_fused_train_step

    frozen = path_prefix_mask(model, ["encoder", "ctc_head", "llm"])
    snapshot = {n: p.detach().clone() for n, p in model.named_parameters() if n in frozen}
    stats_before = {n: b.clone() for n, b in model.named_buffers() if "running_" in n}
    tx = build_optimizer("adamw", {"lr": 1e-3}, freeze_mask=frozen)
    state = init_train_state(model, tx)
    n_train = sum(p.numel() for p in state.params)
    print(f"[train-2] {len(frozen)} frozen tensors ({sum(t.numel() for t in snapshot.values())} "
          f"values), {n_train} trainable parameters")
    step = make_fused_train_step(model, state, torch.Generator().manual_seed(1))
    samples = int(TRAIN_SECONDS * SR)
    rng = np.random.default_rng(1)
    batch = {
        "speech": torch.from_numpy((rng.standard_normal((GUIDED_B, samples)) * 0.1)
                                   .astype(np.float32)).cuda(),
        "speech_lengths": torch.full((GUIDED_B,), samples, device="cuda"),
        "text": torch.ones((GUIDED_B, 16), dtype=torch.long, device="cuda"),
        "text_lengths": torch.full((GUIDED_B,), 16, device="cuda"),
    }
    _, med, launches = run_steps("train-2", step, batch, GUIDED_WARMUP, GUIDED_STEPS, kernels,
                                 card)
    n_blocks = model.cfg.encoder.num_blocks
    for name, n in launches.items():
        want = n_blocks * GUIDED_STEPS if name.endswith("_fwd") else 0
        if n != want:
            raise AssertionError(f"train-2: {name} launched {n} times, expected {want}")
    print(f"[train-2] audio seconds per second at the median: "
          f"{GUIDED_B * TRAIN_SECONDS / (med / 1e3):.1f} [{card}]")
    profile_step("train-2", step, batch, med)
    changed = [n for n, p in model.named_parameters() if n in frozen
               and not torch.equal(p, snapshot[n])]
    changed += [n for n, b in model.named_buffers() if n in stats_before
                and not torch.equal(b, stats_before[n])]
    if changed:
        raise AssertionError(f"train-2: frozen weights moved: {changed[:5]}")
    print(f"[train-2] frozen parameters and running statistics bit-identical after "
          f"{GUIDED_WARMUP + GUIDED_STEPS + 1} steps")
    return launches, med


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available; nothing was run", file=sys.stderr)
        return 2
    from llm_guided_asr_tpu_torch.ops import depthwise_conv as dc
    from llm_guided_asr_tpu_torch.ops import rel_attention as ra

    from llm_guided_asr_tpu_torch.utils.device import resolve_device

    resolve_device("cuda")  # the card's float32 policy, before the first kernel check
    card = nvidia_smi_name_power()
    print(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}; {card}")
    t_start = time.perf_counter()
    kernels = [ra.KERNEL, dc.KERNEL]
    phases = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phases[name] = time.perf_counter() - t0
        print(f"[{name}] phase took {phases[name]:.1f} s [{card}]")
        return out

    timed("build", phase_build, kernels)
    timings = timed("kernels", phase_kernels, ra, dc, card)
    model = build_model()
    serve_launches, waves, wall_10s = timed("serve", phase_serve, model, kernels, card)
    timed("profile", phase_profile, model, waves[0], wall_10s, card)
    train_launches, _ = timed("train-1", phase_train1, kernels, card)
    guided_launches, _ = timed("train-2", phase_train2, model, kernels, card)
    print(f"[done] {time.perf_counter() - t_start:.1f} s; phases "
          + ", ".join(f"{k} {v:.1f} s" for k, v in phases.items()) + f" [{card}]")

    f32 = torch.float32
    table = []
    for name, shape, serve_shape, kernel, replaces in (
        ("rel_attention_fwd", "train B=64 T=312 dropout 0.1", "serve B=1 T=312", ra.KERNEL,
         "llm_guided_asr_tpu/ops/rel_attention.py:143"),
        ("rel_attention_bwd", "train B=64 T=312 dropout 0.1", None, ra.KERNEL,
         "llm_guided_asr_tpu/ops/rel_attention.py:200"),
        ("dwconv1d_fwd", "train [64,312,256] K=31", "serve [1,312,256] K=31", dc.KERNEL,
         "llm_guided_asr_tpu/ops/depthwise_conv.py:37"),
        ("dwconv1d_bwd", "train [64,312,256] K=31", None, dc.KERNEL,
         "llm_guided_asr_tpu/ops/depthwise_conv.py:48"),
    ):
        r = timings[(name, shape, f32)]
        row = {
            "name": name, "route": "cuda",
            "source": str(kernel.source.relative_to(kernel.source.parents[2])),
            "replaces": replaces, "launches": train_launches[name],
            "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": shape,
            "launches_by_path": {"serve": serve_launches[name], "train-1": train_launches[name],
                                 "train-2": guided_launches[name]},
        }
        if serve_shape is not None:
            s = timings[(name, serve_shape, f32)]
            row.update(serve_ms=s["ms"], serve_plain_ms=s["plain_ms"],
                       serve_bound_ms=s["bound_ms"], serve_library_ms=s["library_ms"])
        table.append(row)
    print(card)
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
