"""SevenNet-FT in PyTorch, with hand-written CUDA kernels for Hopper.

The PyTorch/CUDA counterpart of ``sevennet_finetuning_tpu`` (the JAX
package, which stays the reference).  Module names mirror the JAX
package so each module's counterpart is easy to find; this package keeps
its own copies of the host-side code and never imports JAX.

- ``irreps``, ``keys``: O(3) irrep algebra and config/batch key names
- ``data``      : structures, extxyz reader, neighbor lists
- ``model``     : padded graph batches, the NequIP model, spec builder
- ``ops``       : equivariant primitives; ``scatter`` and the
                  ``fused_conv_*`` modules wrap the CUDA kernels in
                  ``csrc/`` (plain PyTorch versions run for CPU tensors)
- ``train``     : checkpoint loading
- ``calculator``: single-point energy / forces / stress

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
