"""Time the WKV forward and the depthwise backward of this checkout against an
older revision of their sources, and sweep their grid choices, on one card.

    python -m llm_guided_asr_tpu_torch.bin.compare_kernels [--old DIR] [--sweep]

``--old DIR`` holds ``wkv.cu`` and ``depthwise_conv.cu`` of a revision from
before the chunked WKV forward and the per-slab dw (their entry points take
no workspace: ``wkv_fwd(w, u, k, v, aa0, bb0, pp0, y, aa1, bb1, pp1, B, T, C,
stream)`` and ``dwconv1d_bwd(dy, x, w, dx, dw, B, T, C, K, dtype, stream)``
with dw zeroed by the caller); e.g. ``git show <rev>:<path> > DIR/<file>``.
Both builds run on the same inputs in turns (old, new, new, old), each
timed by CUDA graph (20 calls captured, replayed 10 times), and the new
results are held against the old ones.  ``--sweep`` times the new kernels
at every chunk count and slab count from 1 to 32 beside the one the
grid rule picks.  ``--trace`` runs 10 calls of each new entry point under
torch.profiler and prints the device time of each kernel inside it.
Prints one line per shape, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
from pathlib import Path

import torch

from llm_guided_asr_tpu_torch.ops import depthwise_conv as dc
from llm_guided_asr_tpu_torch.ops import wkv as wk
from llm_guided_asr_tpu_torch.ops.cuda_build import ARCH_FLAGS, NVCC_FLAGS, find_nvcc

WKV_SHAPES = [(5, 201, 512), (1, 313, 512), (16, 25, 512)]
DW_SHAPES = [(64, 312, 256, 31, torch.float32), (64, 312, 256, 8, torch.float32),
             (64, 312, 256, 31, torch.bfloat16), (64, 312, 256, 8, torch.bfloat16),
             (16, 312, 256, 31, torch.float32), (8, 1874, 256, 31, torch.float32)]
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


def build_old(src_dir: Path) -> dict:
    libs = {}
    for stem in ("wkv", "depthwise_conv"):
        out = src_dir / f"lib{stem}_old.so"
        subprocess.run([find_nvcc(), *ARCH_FLAGS, *NVCC_FLAGS, "-o", str(out),
                        str(src_dir / f"{stem}.cu")], check=True)
        libs[stem] = ctypes.CDLL(str(out))
    libs["wkv"].wkv_fwd.argtypes = [_P] * 11 + [_I] * 3 + [_P]
    libs["depthwise_conv"].dwconv1d_bwd.argtypes = [_P] * 5 + [_I] * 5 + [_P]
    return libs


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def wkv_new_at(w, u, k, v, y, n):
    """The new forward from the initial state with ``n`` chunks."""
    b, t, c = k.shape
    work = torch.empty(3 * b * n * c, device="cuda") if n > 1 else None
    wk.KERNEL.launch("wkv_fwd", w.data_ptr(), u.data_ptr(), k.data_ptr(), v.data_ptr(),
                     None, None, None, None if work is None else work.data_ptr(),
                     y.data_ptr(), None, None, None, n, b, t, c, stream())


def dw_new_at(x, w, dy, dx, dw, slabs):
    b, t, c = x.shape
    work = torch.empty(b * slabs * w.shape[0] * c, device="cuda")
    dc.KERNEL.launch("dwconv1d_bwd", dy.data_ptr(), x.data_ptr(), w.data_ptr(), dx.data_ptr(),
                     dw.data_ptr(), work.data_ptr(), slabs, b, t, c, w.shape[0],
                     dc._DTYPE_CODE[x.dtype], stream())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", type=Path,
                    help="directory with the older wkv.cu and depthwise_conv.cu")
    ap.add_argument("--sweep", action="store_true", help="time every chunk and slab count")
    ap.add_argument("--trace", action="store_true", help="device time of each kernel, traced")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("compare_kernels needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    libs = build_old(args.old) if args.old else None
    gen = torch.Generator(device="cuda").manual_seed(0)

    for b, t, c in WKV_SHAPES:
        w = -torch.exp(0.5 * torch.randn(c, generator=gen, device="cuda"))
        u = 0.5 * torch.randn(c, generator=gen, device="cuda")
        k, v = (torch.randn(b, t, c, generator=gen, device="cuda") for _ in range(2))
        y = torch.empty_like(k)
        new = lambda: wk.wkv_fwd(w, u, k, v)  # noqa: E731
        line = f"wkv_fwd [{b},{t},{c}] ({wk.chunks(k)} chunks)"
        if libs:
            def old():
                libs["wkv"].wkv_fwd(w.data_ptr(), u.data_ptr(), k.data_ptr(), v.data_ptr(),
                                    None, None, None, y.data_ptr(), None, None, None, b, t, c,
                                    stream())
            times = [graph_us(f) for f in (old, new, new, old)]
            old()
            diff = (new()[0] - y).abs().max().item()
            line += (f": old {times[0]:.2f} / {times[3]:.2f} us, new {times[1]:.2f} / "
                     f"{times[2]:.2f} us; max |new - old| {diff:.2e}")
        if args.sweep:
            line += "; by chunks " + ", ".join(
                f"{n}: {graph_us(lambda: wkv_new_at(w, u, k, v, y, n)):.2f}"
                for n in (1, 2, 4, 8, 16, 32))
        if args.trace:
            line += "; traced us per call: new " + kernel_times(new)
            if libs:
                line += "; old " + kernel_times(old)
        print(line + f" [{card}]", flush=True)

    for b, t, c, k_size, dtype in DW_SHAPES:
        x, dy = (torch.randn(b, t, c, generator=gen, device="cuda").to(dtype) for _ in range(2))
        w = torch.randn(k_size, c, generator=gen, device="cuda").to(dtype)
        dx, dw = torch.empty_like(x), torch.zeros(k_size, c, device="cuda")
        new = lambda: dc.depthwise_conv1d_bwd(x, w, dy)  # noqa: E731
        line = (f"dwconv1d_bwd [{b},{t},{c}] K={k_size} {str(dtype)[6:]} "
                f"({dc.dw_slabs(x, k_size)} slabs)")
        if libs:
            def old():
                dw.zero_()
                libs["depthwise_conv"].dwconv1d_bwd(
                    dy.data_ptr(), x.data_ptr(), w.data_ptr(), dx.data_ptr(), dw.data_ptr(),
                    b, t, c, k_size, dc._DTYPE_CODE[dtype], stream())
            times = [graph_us(f) for f in (old, new, new, old)]
            old()
            ndx, ndw = new()
            dx_err = (ndx.float() - dx.float()).abs().max().item()
            dw_err = (ndw.float() - dw).abs().max().item() / dw.abs().max().item()
            line += (f": old {times[0]:.2f} / {times[3]:.2f} us, new {times[1]:.2f} / "
                     f"{times[2]:.2f} us; max |new - old| dx {dx_err:.2e}, "
                     f"dw {dw_err:.2e} of max |dw|")
        if args.sweep:
            line += "; by slabs " + ", ".join(
                f"{n}: {graph_us(lambda: dw_new_at(x, w, dy, dx, dw, n)):.2f}"
                for n in (1, 2, 4, 8, 16, 32))
        if args.trace:
            line += "; traced us per call: new " + kernel_times(new)
            if libs:
                line += "; old " + kernel_times(old)
        print(line + f" [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
