"""SevenNet-FT in PyTorch, with hand-written CUDA kernels for Hopper.

The PyTorch/CUDA counterpart of ``sevennet_finetuning_tpu`` (the JAX
package, which stays the reference).  Module names mirror the JAX
package so each module's counterpart is easy to find; this package keeps
its own copies of the host-side code and never imports JAX.

- ``irreps``, ``keys``: O(3) irrep algebra and config/batch key names
- ``config``, ``presets``: YAML -> validated config, preset inputs
- ``data``      : structures, extxyz reader, neighbor lists, dataset
                  statistics and the padded-batch loader
- ``model``     : padded graph batches, the model (the nequip, mace,
                  gaunt, gaunt_gate and custom interaction families),
                  spec builder, ``init_params``
- ``ops``       : equivariant primitives (the symmetric contraction and
                  the Gaunt products among them); ``scatter`` and the
                  ``fused_conv_*`` modules wrap the CUDA kernels in
                  ``csrc/`` (plain PyTorch versions run for CPU tensors)
- ``train``     : trainer (train / eval steps, rehearsal, Fisher), loss,
                  optimizers and LR controllers, metrics, checkpoints
- ``pipeline``  : dataset, statistics, continue / fine-tune, epoch loop
- ``parallel``  : data-parallel training and halo-parallel inference and
                  MD over ``torch.distributed``
- ``main``      : the command line (``train`` with ``-d``, ``preset``,
                  ``get_model``, ``inference``, ``graph_build``)
- ``logger``    : log.sevenn and log.csv
- ``calculator``: single-point energy / forces / stress
- ``tools``     : the measurement probes

Entry points run on ``cuda`` unless the caller passes ``device='cpu'``.
"""

import torch

# lower-precision matmuls break force accuracy (the JAX package forces
# precision=HIGHEST for the same reason); TF32 is that hazard on Hopper
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = '0.1.0'


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller names a device; no silent CPU path."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                'no CUDA device: pass device="cpu" to run on the CPU')
        return torch.device('cuda')
    return torch.device(device)
