"""Time the WKV forward and backward, the depthwise backward and the LSTM
recurrence of this checkout against an older revision of their sources,
and sweep their grid choices, on one card.

    python -m llm_guided_asr_tpu_torch.bin.compare_kernels [--old DIR] [--sweep] [--trace]

``--old DIR`` holds ``wkv.cu``, ``depthwise_conv.cu`` and/or ``lstm.cu`` of an
older revision, and only the sources it holds are compared: an ``lstm.cu``
with the cooperative-grid recurrence (``lstm_fwd(xi, w_hh, bias, y, gates,
cells, hbuf, bar, B, L, H, stream)``, ``lstm_bwd(dy, gates, cells, w_hh,
da, bar, B, L, H, stream)`` and ``lstm_max_rows``), run as its wrapper ran
it (rows cut into launches of at most ``lstm_max_rows`` within 200 KB of
shared memory, a zeroed barrier and an h buffer a launch), timed by CUDA
events (5 calls) at the LSTM shapes of the kernel table; a ``depthwise_conv.cu``
with the per-slab dw (whose ``dwconv1d_fwd`` and ``dwconv1d_bwd`` take the
arguments they take now), a ``wkv.cu`` with the chunked WKV forward and the
WKV backward from before its chunked scan, which takes no workspace:
``wkv_bwd(w, u, k, v, y, gy, gw, gu, gk, gv, B, T, C, stream)`` with gw and
gu zeroed by the caller; e.g. ``git show <rev>:<path> > DIR/<file>``.  Both
builds run on the same inputs in turns (old, new, new, old), each timed by
CUDA graph (20 calls captured, replayed 10 times), and the new results are
held against the old ones; the depthwise shapes time the forward that
way too.  ``--sweep`` times the new kernels at every chunk count and
slab count from 1 to 32 (the WKV backward's chunks of at most 64 steps)
beside the one the grid rule picks.  ``--trace`` runs 10 calls of each new
entry point under torch.profiler and prints the device time of each
kernel inside it.  Prints one line per shape, with the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
from pathlib import Path

import torch

from llm_guided_asr_tpu_torch.ops import depthwise_conv as dc
from llm_guided_asr_tpu_torch.ops import lstm as lk
from llm_guided_asr_tpu_torch.ops import wkv as wk
from llm_guided_asr_tpu_torch.ops.cuda_build import ARCH_FLAGS, NVCC_FLAGS, find_nvcc

WKV_SHAPES = [(5, 201, 512), (1, 313, 512), (16, 25, 512)]
# train-transducer's labels (U + 1 = 25), and those of ~40 s of audio at
# its 24 tokens per 10 s
WKV_BWD_SHAPES = [(16, 25, 512), (16, 101, 512)]
DW_SHAPES = [(64, 312, 256, 31, torch.float32), (64, 312, 256, 8, torch.float32),
             (64, 312, 256, 31, torch.bfloat16), (64, 312, 256, 8, torch.bfloat16),
             (16, 312, 256, 31, torch.float32), (8, 1874, 256, 31, torch.float32),
             # the MultiConvformer's cgMLP taps (K = 7 and 23 at 512 channels)
             (64, 312, 512, 7, torch.float32), (64, 312, 512, 23, torch.float32),
             (16, 312, 512, 7, torch.float32), (16, 312, 512, 23, torch.float32)]
# (B, L, H, backward too): the LSTM shapes of the kernel table (the
# transducer's beam-5 prefix and training labels, the RNN encoders' 320
# units) and the LSTM LM's 650 units
LSTM_SHAPES = [(5, 201, 256, False), (16, 25, 256, True), (1, 312, 320, False),
               (1, 1251, 320, False), (16, 312, 320, True), (16, 1251, 320, True),
               (64, 312, 320, True), (16, 100, 650, True)]
OLD_LSTM_SMEM = 200 * 1024  # the shared memory the older wrapper let a launch take
_P, _I = ctypes.c_void_p, ctypes.c_int


def graph_us(fn, launches: int = 20, replays: int = 10) -> float:
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
    return start.elapsed_time(end) * 1e3 / (launches * replays)


def kernel_times(fn, calls: int = 10) -> str:
    """Device time per call of each kernel that ``fn`` launches, by name."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    return ", ".join(f"{e.key.split('(')[0].split('::')[-1][:40]} "
                     f"{e.self_device_time_total / calls:.2f}"
                     for e in sorted(events, key=lambda e: -e.self_device_time_total))


def event_us(fn, calls: int = 5) -> float:
    """Device time per call of work long enough to hide its launches."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / calls


def build_old(src_dir: Path) -> dict:
    """The older sources ``src_dir`` holds, built and loaded: {stem: CDLL}."""
    libs = {}
    for stem in ("wkv", "depthwise_conv", "lstm"):
        if not (src_dir / f"{stem}.cu").exists():
            continue
        out = src_dir / f"lib{stem}_old.so"
        subprocess.run([find_nvcc(), *ARCH_FLAGS, *NVCC_FLAGS, "-o", str(out),
                        str(src_dir / f"{stem}.cu")], check=True)
        libs[stem] = ctypes.CDLL(str(out))
    if "wkv" in libs:
        libs["wkv"].wkv_fwd.argtypes = wk.KERNEL.functions["wkv_fwd"]
        libs["wkv"].wkv_bwd.argtypes = [_P] * 10 + [_I] * 3 + [_P]
    if "depthwise_conv" in libs:
        for name in ("dwconv1d_fwd", "dwconv1d_bwd"):
            getattr(libs["depthwise_conv"], name).argtypes = dc.KERNEL.functions[name]
    if "lstm" in libs:
        libs["lstm"].lstm_fwd.argtypes = [_P] * 8 + [_I] * 3 + [_P]
        libs["lstm"].lstm_bwd.argtypes = [_P] * 6 + [_I] * 3 + [_P]
        libs["lstm"].lstm_max_rows.argtypes = [_I] * 3
    return libs


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def wkv_fwd_at(fn, w, u, k, v, y, n):
    """The C forward ``fn`` from the initial state with ``n`` chunks."""
    b, t, c = k.shape
    work = torch.empty(3 * b * n * c, device="cuda") if n > 1 else None
    fn(w.data_ptr(), u.data_ptr(), k.data_ptr(), v.data_ptr(), None, None, None,
       None if work is None else work.data_ptr(), y.data_ptr(), None, None, None, n, b, t, c,
       stream())


def wkv_bwd_at(w, u, k, v, y, gy, grads, n):
    """The new backward with ``n`` chunks into ``grads`` = (gw, gu, gk, gv)."""
    b, t, c = k.shape
    work = torch.empty(10 * b * n * c, device="cuda")
    wk.KERNEL.launch("wkv_bwd", w.data_ptr(), u.data_ptr(), k.data_ptr(), v.data_ptr(),
                     y.data_ptr(), gy.data_ptr(), work.data_ptr(),
                     *(g.data_ptr() for g in grads), n, b, t, c, stream())


def dw_at(fn, x, w, dy, dx, dw, slabs):
    b, t, c = x.shape
    work = torch.empty(b * slabs * w.shape[0] * c, device="cuda")
    fn(dy.data_ptr(), x.data_ptr(), w.data_ptr(), dx.data_ptr(), dw.data_ptr(),
       work.data_ptr(), slabs, b, t, c, w.shape[0], dc._DTYPE_CODE[x.dtype], stream())


def old_lstm(lib, backward: bool, b: int, h: int, launch) -> int:
    """The older wrapper's launches: rows cut into launches of at most
    ``lstm_max_rows``, each ``launch(r0, r1, bar, hbuf)`` with a zeroed
    barrier (and an h buffer for the forward); returns the launch count."""
    rows = lib.lstm_max_rows(h, OLD_LSTM_SMEM, int(backward))
    for r0 in range(0, b, rows):
        r1 = min(b, r0 + rows)
        bar = torch.zeros(2, dtype=torch.int32, device="cuda")
        hbuf = None if backward else torch.empty(2 * (r1 - r0) * h, device="cuda")
        code = launch(r0, r1, bar, hbuf)
        if code != 0:
            raise RuntimeError(f"the older lstm launch failed: CUDA error {code}")
    return -(-b // rows)


def compare_lstm(lib, gen, card: str) -> None:
    """The LSTM recurrence, new against old in turns on the same inputs."""
    for b, t, h, backward in LSTM_SHAPES:
        xi = 0.5 * torch.randn(b, t, 4 * h, generator=gen, device="cuda")
        w = torch.randn(4 * h, h, generator=gen, device="cuda") / h ** 0.5
        bias = 0.1 * torch.randn(4 * h, generator=gen, device="cuda")
        dy = torch.randn(b, t, h, generator=gen, device="cuda")
        y_new, gates, cells = lk.lstm_fwd(xi, w, bias, save=True)
        y_old, da_old = torch.empty_like(y_new), torch.empty_like(gates)

        def old_fwd():
            return old_lstm(lib, False, b, h, lambda r0, r1, bar, hbuf: lib.lstm_fwd(
                xi[r0:r1].data_ptr(), w.data_ptr(), bias.data_ptr(), y_old[r0:r1].data_ptr(),
                None, None, hbuf.data_ptr(), bar.data_ptr(), r1 - r0, t, h, stream()))

        def old_bwd():
            return old_lstm(lib, True, b, h, lambda r0, r1, bar, hbuf: lib.lstm_bwd(
                dy[r0:r1].data_ptr(), gates[r0:r1].data_ptr(), cells[r0:r1].data_ptr(),
                w.data_ptr(), da_old[r0:r1].data_ptr(), bar.data_ptr(), r1 - r0, t, h, stream()))

        def new_fwd():
            return lk.lstm_fwd(xi, w, bias)[0]

        def new_bwd():
            return lk.lstm_bwd(dy, gates, cells, w)

        p = lk.plan_for(b, h, False, xi.device)
        cases = [("lstm_fwd", old_fwd, new_fwd, y_old, p)]
        if backward:
            cases.append(("lstm_bwd", old_bwd, new_bwd, da_old, lk.plan_for(b, h, True, xi.device)))
        for name, old, new, out_old, plan in cases:
            times = [event_us(f) for f in (old, new, new, old)]
            n_old = old()
            diff = (new() - out_old).abs().max().item()
            print(f"{name} [{b},{t},{h}]: old {times[0]:.2f} / {times[3]:.2f} us ({n_old} "
                  f"launch(es)), new {times[1]:.2f} / {times[2]:.2f} us (one launch: "
                  f"{plan.groups} x {plan.cluster} CTAs, {plan.rows} rows a cluster, W_hh "
                  f"{'from L2' if plan.streamed else 'in shared memory'}); us a step old "
                  f"{(times[0] + times[3]) / 2 / t:.3f}, new {(times[1] + times[2]) / 2 / t:.3f}; "
                  f"max |new - old| {diff:.2e} [{card}]", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", type=Path,
                    help="directory with the older wkv.cu, depthwise_conv.cu or lstm.cu")
    ap.add_argument("--sweep", action="store_true", help="time every chunk and slab count")
    ap.add_argument("--trace", action="store_true", help="device time of each kernel, traced")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("compare_kernels needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    libs = build_old(args.old) if args.old else {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    new_fwd = lambda *a: wk.KERNEL.launch("wkv_fwd", *a)  # noqa: E731
    new_dw = lambda *a: dc.KERNEL.launch("dwconv1d_bwd", *a)  # noqa: E731
    if "lstm" in libs:
        compare_lstm(libs["lstm"], gen, card)
    for b, t, c in WKV_SHAPES:
        w = -torch.exp(0.5 * torch.randn(c, generator=gen, device="cuda"))
        u = 0.5 * torch.randn(c, generator=gen, device="cuda")
        k, v = (torch.randn(b, t, c, generator=gen, device="cuda") for _ in range(2))
        y = torch.empty_like(k)
        new = lambda: wk.wkv_fwd(w, u, k, v)  # noqa: E731
        line = f"wkv_fwd [{b},{t},{c}] ({wk.chunks(k)} chunks)"
        if "wkv" in libs:
            def old():
                wkv_fwd_at(libs["wkv"].wkv_fwd, w, u, k, v, y, wk.chunks(k))
            times = [graph_us(f) for f in (old, new, new, old)]
            old()
            diff = (new()[0] - y).abs().max().item()
            line += (f": old {times[0]:.2f} / {times[3]:.2f} us, new {times[1]:.2f} / "
                     f"{times[2]:.2f} us; max |new - old| {diff:.2e}")
        if args.sweep:
            line += "; by chunks " + ", ".join(
                f"{n}: {graph_us(lambda: wkv_fwd_at(new_fwd, w, u, k, v, y, n)):.2f}"
                for n in (1, 2, 4, 8, 16, 32))
        if args.trace:
            line += "; traced us per call: new " + kernel_times(new)
            if "wkv" in libs:
                line += "; old " + kernel_times(old)
        print(line + f" [{card}]", flush=True)

    for b, t, c, k_size, dtype in DW_SHAPES:
        x, dy = (torch.randn(b, t, c, generator=gen, device="cuda").to(dtype) for _ in range(2))
        w = torch.randn(k_size, c, generator=gen, device="cuda").to(dtype)
        dx, dw = torch.empty_like(x), torch.zeros(k_size, c, device="cuda")
        new = lambda: dc.depthwise_conv1d_bwd(x, w, dy)  # noqa: E731
        line = (f"dwconv1d_bwd [{b},{t},{c}] K={k_size} {str(dtype)[6:]} "
                f"({dc.dw_slabs(x, k_size)} slabs)")
        if "depthwise_conv" in libs:
            y = torch.empty_like(x)

            def old_fwd():
                libs["depthwise_conv"].dwconv1d_fwd(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                                                    b, t, c, k_size, dc._DTYPE_CODE[dtype],
                                                    stream())

            def new_fwd():
                return dc.depthwise_conv1d(x, w)
            fwd_times = [graph_us(f) for f in (old_fwd, new_fwd, new_fwd, old_fwd)]
            old_fwd()
            y_err = (new_fwd().float() - y.float()).abs().max().item()

            def old():
                dw_at(libs["depthwise_conv"].dwconv1d_bwd, x, w, dy, dx, dw,
                      dc.dw_slabs(x, k_size))
            times = [graph_us(f) for f in (old, new, new, old)]
            old()
            ndx, ndw = new()
            dx_err = (ndx.float() - dx.float()).abs().max().item()
            dw_err = (ndw.float() - dw).abs().max().item() / dw.abs().max().item()
            line += (f": old {times[0]:.2f} / {times[3]:.2f} us, new {times[1]:.2f} / "
                     f"{times[2]:.2f} us; max |new - old| dx {dx_err:.2e}, "
                     f"dw {dw_err:.2e} of max |dw|; dwconv1d_fwd old {fwd_times[0]:.2f} / "
                     f"{fwd_times[3]:.2f} us, new {fwd_times[1]:.2f} / {fwd_times[2]:.2f} us, "
                     f"max |new - old| {y_err:.2e}")
        if args.sweep:
            line += "; by slabs " + ", ".join(
                f"{n}: {graph_us(lambda: dw_at(new_dw, x, w, dy, dx, dw, n)):.2f}"
                for n in (1, 2, 4, 8, 16, 32))
        if args.trace:
            line += "; traced us per call: new " + kernel_times(new)
            if "depthwise_conv" in libs:
                line += "; old " + kernel_times(old)
        print(line + f" [{card}]", flush=True)

    for b, t, c in WKV_BWD_SHAPES:
        w = -torch.exp(0.5 * torch.randn(c, generator=gen, device="cuda"))
        u = 0.5 * torch.randn(c, generator=gen, device="cuda")
        k, v, gy = (torch.randn(b, t, c, generator=gen, device="cuda") for _ in range(3))
        y = wk.wkv_fwd(w, u, k, v)[0]
        new = lambda: wk.wkv_bwd(w, u, k, v, y, gy)  # noqa: E731
        line = f"wkv_bwd [{b},{t},{c}] ({wk.bwd_chunks(k)} chunks)"
        if "wkv" in libs:
            grads = [torch.zeros_like(w), torch.zeros_like(u), torch.empty_like(k),
                     torch.empty_like(v)]

            def old():
                grads[0].zero_()
                grads[1].zero_()
                libs["wkv"].wkv_bwd(w.data_ptr(), u.data_ptr(), k.data_ptr(), v.data_ptr(),
                                    y.data_ptr(), gy.data_ptr(),
                                    *(g.data_ptr() for g in grads), b, t, c, stream())
            times = [graph_us(f) for f in (old, new, new, old)]
            old()
            diffs = [(n_ - o).abs().max().item() / o.abs().max().item()
                     for n_, o in zip(new(), grads)]
            line += (f": old {times[0]:.2f} / {times[3]:.2f} us, new {times[1]:.2f} / "
                     f"{times[2]:.2f} us; max |new - old| of max |old|: " + ", ".join(
                         f"{n_} {d:.2e}" for n_, d in zip(("gw", "gu", "gk", "gv"), diffs)))
        if args.sweep:
            grads = [torch.empty_like(w), torch.empty_like(u), torch.empty_like(k),
                     torch.empty_like(v)]
            line += "; by chunks " + ", ".join(
                f"{n}: {graph_us(lambda: wkv_bwd_at(w, u, k, v, y, gy, grads, n)):.2f}"
                for n in (1, 2, 4, 8, 16, 32) if -(-t // n) <= 64)
        if args.trace:
            line += "; traced us per call: new " + kernel_times(new)
            if "wkv" in libs:
                line += "; old " + kernel_times(old)
        print(line + f" [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
