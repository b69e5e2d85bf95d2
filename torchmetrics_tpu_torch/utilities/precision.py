"""Full float32 arithmetic on the card: TF32 off for a block."""

from contextlib import contextmanager
from typing import Iterator

import torch


@contextmanager
def full_float32() -> Iterator[None]:
    """Convolutions and matrix products in full float32 inside, as the JAX package runs them: cuDNN's and
    cuBLAS's TF32 off for the block, each flag restored after it."""
    matmul = torch.backends.cuda.matmul
    allowed = matmul.allow_tf32
    matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled, benchmark=torch.backends.cudnn.benchmark,
                                        deterministic=torch.backends.cudnn.deterministic, allow_tf32=False):
            yield
    finally:
        matmul.allow_tf32 = allowed
