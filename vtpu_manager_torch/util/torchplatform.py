"""Which device the port runs on, and how the comparisons are kept exact.

The counterpart of `vtpu_manager/util/jaxplatform.py:18-56`. There, a CPU
request had to be forced past an ambient TPU registration; here the rule is
simpler and strict: entry points run on the card unless the caller asks for
the CPU, and a missing card is an error, never a silent fall back to the
CPU (a number measured there would be mistaken for the card's).
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """`None` means the card. "cpu" is honoured; a CUDA device must exist."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card unless device='cpu' "
            "is passed explicitly")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def device_name(dev: torch.device) -> str:
    """The card's own name, for labelling a measurement; "cpu" off it."""
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def exact_fp32() -> None:
    """Comparison mode: float32 products in full float32. Matrix products
    already default to it; cuDNN convolutions default to TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def cap_cpu_threads(n: int = 2) -> None:
    """Keep CPU tests from oversubscribing the host: the suite runs under
    several pytest workers at once, each with torch's default of one
    thread per core."""
    if torch.get_num_threads() > n:
        torch.set_num_threads(n)
