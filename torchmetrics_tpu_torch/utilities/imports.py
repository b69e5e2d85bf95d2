"""Loading checkpoints without a network (counterpart of ``torchmetrics_tpu/utilities/imports.py``'s
``hf_local_kwargs``)."""

from __future__ import annotations


def hf_local_kwargs() -> dict:
    """``from_pretrained`` kwargs that resolve a checkpoint locally and never download.

    An id that is not a local directory or in the local cache fails at once
    (``OSError``) instead of reaching for the hub. Shared by every loader of
    the port (BERTScore's encoder, InfoLM's masked language model).
    """
    return {"local_files_only": True}
