"""PyTorch/CUDA port of the LLM-guided ASR serving path.

Counterpart of the JAX package ``llm_guided_asr_tpu``: the file layout
mirrors it (``ops/``, ``models/``, ``models/llm/``, ``search/``, ``bin/``,
``utils/``), each module names its JAX counterpart, and ``convert.py``
carries weights across so both packages compute the same function.  The
kernels written for the TPU in Pallas are hand-written CUDA for Hopper
(``csrc/``), built with ``nvcc`` at first use.
"""
