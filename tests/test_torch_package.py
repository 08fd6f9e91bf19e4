"""Port package rules: no JAX at runtime, no silent CPU fallback, and the
kernel launcher's bookkeeping."""

import ast
import os
import shutil
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

import llm_guided_asr_tpu_torch
from llm_guided_asr_tpu_torch.ops.cuda_build import BUILD_DIR, CudaKernel
from llm_guided_asr_tpu_torch.ops.rel_attention import KERNEL as REL_KERNEL

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
# the card-only tests run where JAX is not installed, so they count as port files
PORT_FILES = sorted(Path(llm_guided_asr_tpu_torch.__file__).parent.rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "tests" / "test_torch_gpu.py"
]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "transformers", "tokenizers", "safetensors",
             "llm_guided_asr_tpu", "yaml", "msgpack", "ml_dtypes"}
# modules that hold their own copies of JAX-package code the port may not import
OWN_COPIES = ("text/tokenizers.py", "utils/config.py", "utils/metrics.py",
              "search/cached_decoder.py", "models/llm/prompt.py", "train/reporter.py",
              "data/fileio.py", "data/samplers.py", "data/dataset.py", "data/iterator.py",
              "text/cleaner.py", "text/phoneme.py", "train/checkpoint.py", "tasks/asr.py",
              "tasks/lm.py", "bin/score.py", "bin/tokenize_text.py", "bin/asr_pipeline.py",
              "ez/__init__.py", "data/flac.py", "data/kaldi_ark.py", "utils/job.py",
              "bin/pack.py", "bin/split_scps.py", "tasks/st.py", "bin/st_inference.py",
              "bin/st_train.py", "models/llm_guided_st.py", "text/hf_pipeline.py")


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_files_import_no_jax_nor_the_jax_package(path):
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_the_guard_covers_the_ported_copies():
    package = Path(llm_guided_asr_tpu_torch.__file__).parent
    for rel in OWN_COPIES:
        assert package / rel in PORT_FILES, rel


def _run_smoke(cwd: Path):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_without_a_card_fails_and_prints_no_result(tmp_path):
    for cwd in (REPO, tmp_path):
        if cwd is tmp_path:  # a directory holding chip_smoke.py and nothing else
            shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
        proc = _run_smoke(cwd)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout


def test_launch_counts_only_successful_launches():
    k = CudaKernel("rel_attention.cu", {"fn": [], "gn": []}, error_fn="err")
    k._lib = types.SimpleNamespace(fn=lambda *a: 0, gn=lambda *a: 0,
                                   err=lambda code: b"invalid argument")
    k.launch("fn")
    k.launch("fn")
    k.launch("gn")
    assert k.launches == {"fn": 2, "gn": 1}  # counted per C entry point
    k._lib.fn = lambda *a: 1
    with pytest.raises(RuntimeError, match="CUDA error 1 \\(invalid argument\\)"):
        k.launch("fn")
    assert k.launches == {"fn": 2, "gn": 1}
    k.reset_launches()
    assert k.launches == {"fn": 0, "gn": 0}


def test_kernel_build_targets_sm90a_into_the_build_directory(monkeypatch):
    monkeypatch.setattr("llm_guided_asr_tpu_torch.ops.cuda_build.find_nvcc", lambda: "nvcc")
    lib = REL_KERNEL.library_path()
    assert lib.parent == BUILD_DIR and lib.name.startswith("librel_attention-")
    cmd = REL_KERNEL.build_command(lib)
    assert "arch=compute_90a,code=sm_90a" in cmd and str(REL_KERNEL.source) in cmd
    assert REL_KERNEL.source.is_file()


def test_library_path_follows_the_headers_a_source_includes(tmp_path):
    """Two sources share csrc/tensor_core.cuh: a header edit must name a new
    library, or a stale build would be served."""
    for name in ("rel_attention.cu", "flash_attention.cu", "tensor_core.cuh"):
        shutil.copy(REL_KERNEL.source.parent / name, tmp_path / name)
    kernels = [CudaKernel(str(tmp_path / name), {}, error_fn="x")
               for name in ("rel_attention.cu", "flash_attention.cu")]
    assert all(tmp_path / "tensor_core.cuh" in k.sources() for k in kernels)
    before = [k.library_path() for k in kernels]
    header = tmp_path / "tensor_core.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = [k.library_path() for k in kernels]
    assert all(a != b for a, b in zip(after, before))
    assert all(a.parent == BUILD_DIR for a in after)
    header.write_text(header.read_text()[: -len("\n// edited\n")])
    assert [k.library_path() for k in kernels] == before


@pytest.mark.skipif(torch.cuda.is_available(), reason="the refusal needs a machine without a card")
def test_st_entry_points_default_to_the_card(tmp_path):
    """The ST task, its CLIs and Speech2Translation take the card unless
    told device cpu, and raise on a machine without one (no CPU fallback),
    before any file is written."""
    from llm_guided_asr_tpu_torch.bin import st_inference, st_train
    from llm_guided_asr_tpu_torch.bin.st_inference import Speech2Translation
    from llm_guided_asr_tpu_torch.tasks.st import build_st_model
    from llm_guided_asr_tpu_torch.utils.config import dump_yaml

    llm = str(REPO / "tests" / "parity" / "tiny_llm_bytelevel")
    config = {"llm_conf": {"model_name_or_path": llm, "template_prompt": "fix ((HYP)) ->"},
              "device": None}
    dump_yaml(config, tmp_path / "config.yaml")
    calls = [lambda: build_st_model(config),
             lambda: Speech2Translation(tmp_path / "config.yaml"),
             lambda: st_inference.main(["--train_config", str(tmp_path / "config.yaml"),
                                        "--wav_scp", str(tmp_path / "wav.scp"),
                                        "--output_dir", str(tmp_path / "dec")]),
             lambda: st_train.main(["--config", str(tmp_path / "config.yaml"),
                                    "--output_dir", str(tmp_path / "exp")])]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert not (tmp_path / "dec").exists() and not (tmp_path / "exp").exists()
