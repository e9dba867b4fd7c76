"""Parallel execution over ``torch.distributed``.

Port of ``sevennet_finetuning_tpu/parallel/``:

- ``data_parallel``: data-parallel training, the reference's DDP path
  (one process per card, launched by ``torchrun``; the gradients averaged
  with one ``all_reduce`` a step, the metric accumulators summed once an
  epoch);
- ``halo``: halo-parallel inference and MD (the reference's
  ``pair_e3gnn_parallel``): a brick decomposition of the cell, the ghost
  features refreshed from their owners before every convolution, the
  reverse pass through the exchange's backward.
"""
