#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card (H100).

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. build   -- compile every CUDA kernel of the serving path from
              llm_guided_asr_tpu_torch/csrc with nvcc for sm_90a (one nvcc
              per source, started together) and print ptxas's register and
              spill lines;
2. kernels -- hold each kernel against its plain PyTorch version at the
              serving path's shapes, in float32 and bfloat16, and time it
              (CUDA events around a CUDA graph of repeated launches) beside
              the plain version, the library call where one exists, and the
              bound from bytes and operations;
3. serve   -- build the LLM-guided model at full width (Conformer 12x256,
              guided decoder 6x256, Llama-3.2-1B dims in bf16) with weights
              drawn from seed 0, serve one warm-up request at each of the
              3 lengths and then each request 5 times through Speech2Text
              with beam 10 (median latency and spread), and check the
              kernel launch counts of the timed requests (12 per request
              each), the hypotheses' score bookkeeping, and the card's
              encoder against the plain CPU path;
4. profile -- the 10 s request again: its encode time alone, then one run
              under torch.profiler (card activity only) for the device busy
              share of the unprofiled latency and the top kernels by device
              time.

The last two lines of standard output are the kernel table as one JSON
object and {"ok": true, "device": {...}}.  Without a card the script exits
with status 2 and prints no result.
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


def bound_ms(n_bytes: float, flops: float, dtype) -> tuple:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
def phase_build(kernels):
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(kernels)) as pool:  # one nvcc per source, together
        list(pool.map(lambda k: k.build(), kernels))
    print(f"[build] {len(kernels)} kernels built in {time.perf_counter() - t0:.1f} s")
    for k in kernels:
        for line in k.ptxas_log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"[build] {k.source.name}: {line.strip()}")


def rel_attention_tol(ref: torch.Tensor) -> float:
    """float32 differs from the plain version only in the order of the sums;
    bfloat16 also rounds the output, by at most one unit in the last place
    (2**-7 of the largest output) when the two sit on either side of a tie."""
    if ref.dtype == torch.float32:
        return 1e-5
    return 2.0 ** -7 * ref.float().abs().max().item() + 1e-5


def check_rel_attention(ra, dtype, gen):
    """Main-path shapes: B=1, H=4, T=312 (10 s of audio), dk=64.

    Unit-scale inputs give logits of standard deviation about 1.4, so the
    softmax is peaked enough that dropping or misplacing the positional
    term moves outputs far beyond the tolerance.  The error is checked with
    all keys valid (the serving path: every frame of a B=1 request is
    valid) and with 25 keys masked; the time and the bound are taken with
    all keys valid, as the serving path calls the kernel.
    """
    b, h, t, dk = 1, 4, 312, 64
    mk = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(dtype)
    qu, qv, k, v = (mk(b, h, t, dk) for _ in range(4))
    p = mk(h, 2 * t - 1, dk)
    sm = 1.0 / math.sqrt(dk)
    errs = {}
    for n_valid in (t, 287):
        kv_valid = (torch.arange(t, device="cuda")[None] < n_valid).to(torch.int32)
        out = ra.rel_attention(qu, qv, k, v, p, kv_valid, sm)
        ref = ra.rel_attention_plain(qu, qv, k, v, p, kv_valid, sm)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
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
    """Main-path shape: [1, 312, 256] x [31, 256]; also an even K."""
    b, t, c = 1, 312, 256
    x = torch.randn(b, t, c, generator=gen, device="cuda").to(dtype)
    w = torch.randn(k_size, c, generator=gen, device="cuda").to(dtype)
    y = dc.depthwise_conv1d(x, w)
    ref = dc.depthwise_conv1d_plain(x, w)
    # library yardstick, timed only: F.conv1d over the channels-first view
    xt, wt = x.transpose(1, 2), w.t()[:, None, :]
    lib = lambda: torch.nn.functional.conv1d(xt, wt, groups=c, padding="same")
    torch.cuda.synchronize()
    err = (y.float() - ref.float()).abs().max().item()
    lib_err = (lib().transpose(1, 2).float() - ref.float()).abs().max().item()
    tol = 1e-4 if dtype == torch.float32 else 5e-2
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


def phase_kernels(ra, dc):
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        cases = [("rel_attention", "T=312", check_rel_attention(ra, dtype, gen))]
        for k_size in (31, 8):
            cases.append(("depthwise_conv1d", f"K={k_size}", check_dwconv(dc, dtype, k_size, gen)))
        for name, shape, r in cases:
            lib = "-" if r["library_ms"] is None else f"{r['library_ms'] * 1e3:.2f} us"
            print(f"[kernels] {name} {shape} {str(dtype)[6:]}: max_abs_err {r['err']:.3e} "
                  f"(tol {r['tol']:.1e}) kernel {r['ms'] * 1e3:.2f} us, plain "
                  f"{r['plain_ms'] * 1e3:.2f} us, library {lib}, "
                  f"bound {r['bound_ms'] * 1e3:.3f} us ({r['bound_by']})")
            if not r["err"] <= r["tol"]:
                raise AssertionError(f"{name} {shape} {dtype}: error {r['err']} > {r['tol']}")
            results.setdefault((name, shape, dtype), r)
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


def phase_serve(model, kernels):
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
    for k in kernels:
        k.launches = 0
    lat = {sec: [] for sec in REQUEST_SECONDS}
    hyps = []
    for _ in range(ROUNDS):
        for sec, wave in zip(REQUEST_SECONDS, waves):
            t0 = time.perf_counter()
            (ids, hyp), = s2t(wave)
            torch.cuda.synchronize()
            lat[sec].append(time.perf_counter() - t0)
            hyps.append((ids, hyp))
    launches = {k.source.stem: k.launches for k in kernels}
    peak = torch.cuda.max_memory_allocated()

    n_requests = len(hyps)
    for sec in REQUEST_SECONDS:
        ms = sorted(x * 1e3 for x in lat[sec])
        med = float(np.median(ms))
        print(f"[serve] {sec:.1f} s audio, {len(ms)} runs: latency median {med:.1f} ms "
              f"(min {ms[0]:.1f}, max {ms[-1]:.1f}), RTFx at the median {sec / med * 1e3:.2f}")
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
        if n != n_blocks * n_requests:
            raise AssertionError(f"{name}: {n} launches, expected {n_blocks} per request")
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


def phase_profile(model, wave, wall_s: float):
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
          f"{wall_s * 1e3 - med_enc:.1f} ms")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        s2t(wave)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in events)
    print(f"[profile] {REQUEST_SECONDS[0]} s request traced (card only): wall {wall * 1e3:.1f} ms, "
          f"device busy {dev_us / 1e3:.1f} ms = {100 * dev_us / 1e6 / wall_s:.1f}% of the "
          f"unprofiled median latency")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"[profile]   {e.self_device_time_total / 1e3:8.2f} ms  {e.count:6d}x  {e.key[:90]}")


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
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    t_start = time.perf_counter()
    kernels = [ra.KERNEL, dc.KERNEL]
    phase_build(kernels)
    timings = phase_kernels(ra, dc)
    model = build_model()
    launches, waves, wall_10s = phase_serve(model, kernels)
    phase_profile(model, waves[0], wall_10s)
    print(f"[done] {time.perf_counter() - t_start:.1f} s")

    f32 = torch.float32
    table = []
    for name, shape, kernel, replaces in (
        ("rel_attention", "T=312", ra.KERNEL, "llm_guided_asr_tpu/ops/rel_attention.py:143"),
        ("depthwise_conv1d", "K=31", dc.KERNEL, "llm_guided_asr_tpu/ops/depthwise_conv.py:37"),
    ):
        r = timings[(name, shape, f32)]
        table.append({
            "name": name, "route": "cuda",
            "source": str(kernel.source.relative_to(kernel.source.parents[2])),
            "replaces": replaces, "launches": launches[kernel.source.stem],
            "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        })
    print(card)
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
