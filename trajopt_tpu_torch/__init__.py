"""trajopt_tpu_torch — the PyTorch/CUDA port of ``trajopt_tpu``.

The package mirrors the JAX package's module tree (each module's
counterpart sits at the same path) and imports neither ``jax`` nor
``trajopt_tpu``.  Batching is an explicit leading lane axis where the JAX
package used ``vmap``.  On the card the banded interior-point QP runs as
one hand-written CUDA kernel per solve (K6, with the KKT assembly and the
block-tridiagonal factorization and solves as its device functions), and
the cast-collision distances as others (``csrc/``); every kernel has a
plain PyTorch version in the same module, which a CPU tensor takes.

Entry points default to ``device="cuda"`` and raise when CUDA is absent,
unless the caller passes ``device="cpu"``.

TF32 is OFF: float32 matmuls and convolutions run in full float32 — the QP
and Cholesky math needs full float32 accumulation (the JAX package pins
``jax_default_matmul_precision="highest"`` in bench.py for the same reason).
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device="cuda") -> torch.device:
    """The torch device an entry point runs on.

    Raises when a CUDA device is asked for (the default) and none is
    available: a run on the CPU has to be asked for with ``device="cpu"``.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "trajopt_tpu_torch: CUDA is not available; pass device='cpu' "
            "to run on the CPU")
    return dev
