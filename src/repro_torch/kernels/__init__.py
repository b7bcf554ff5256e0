"""Kernels written by hand for Hopper, one family per directory.

Each family ships ``kernel.py`` (the CUDA wrappers, their plain PyTorch
versions and launch counters), ``csrc/`` (the CUDA C++ sources, built on
first use), ``ops.py`` (staging and placement) and ``ref.py`` (oracles).

  * ``sptrsv`` — the accelerator's VLIW instruction-stream executor, in a
    resident and a row-blocked placement;
  * ``ssd_scan`` — the chunked gated linear recurrence of the Mamba2 blocks;
  * ``flash_attention`` — online-softmax attention, with GQA head mapping.

`common.resolve_device` gives every family the same device rule: CUDA
unless the caller names another device; `common.build_library` is the one
``nvcc`` builder of their CUDA sources.
"""
