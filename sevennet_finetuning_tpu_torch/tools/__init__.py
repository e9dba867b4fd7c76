"""Measurement probes of the card, counterparts of the JAX repo's ``tools/``.

- ``bench_dma``   : copy bandwidth of hand-written kernels against
                    PyTorch's own (``tools/bench_dma.py``)
- ``hopper_feats``: the Hopper features a faster kernel would use
                    (``tools/test_mosaic_feats.py``)

Both run on the card only: ``python -m
sevennet_finetuning_tpu_torch.tools.<name>``.  Their kernels live in
``csrc/probe_copy.cu`` and ``csrc/probe_feats.cu``; each wrapper has its
plain PyTorch version beside it, which runs for CPU tensors.
"""
