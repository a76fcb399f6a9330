"""Device selection for the port's entry points."""

from __future__ import annotations

import os

import torch


def resolve_device(device="cuda") -> torch.device:
    """The requested device; raises when CUDA is asked for and missing (the
    port never carries on quietly on the CPU).

    Also keeps fp32 matmuls and convolutions out of TF32 on the card
    (``torch.backends.cuda.matmul.allow_tf32`` and
    ``torch.backends.cudnn.allow_tf32`` set to False): an fp32 run computes in
    full fp32, as the JAX reference's fp32 paths do.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return device


def rank_device() -> torch.device:
    """The card of this data-parallel rank, ``cuda:<LOCAL_RANK>`` (0 when
    ``LOCAL_RANK`` is unset), through ``resolve_device``; raises without a
    card or when ``LOCAL_RANK`` names a card this host lacks."""
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    device = resolve_device(torch.device("cuda", local_rank))
    if local_rank >= torch.cuda.device_count():
        raise RuntimeError("LOCAL_RANK=%d but this host has %d CUDA devices"
                           % (local_rank, torch.cuda.device_count()))
    return device
