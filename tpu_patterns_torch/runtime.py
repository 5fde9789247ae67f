"""Device resolution and the card spec table.

The JAX package picks its backend from the platform it finds and runs
Pallas kernels in interpret mode off-TPU (``tpu_patterns/runtime.py``).
This package never falls back: an entry point runs on ``cuda``, and on
the CPU only when the caller asks for it by name (the tests do).  A box
with no CUDA device and no explicit CPU request raises, so a missing
card can never turn into a quiet CPU run.
"""

from __future__ import annotations

import torch

# Datasheet peaks (NVIDIA's data sheet and the Hopper white paper, SXM
# part, dense rates without sparsity, at the full 700 W power limit).
# These are published values, not measurements; a roofline share in this
# package is stated against them with the card's power limit beside it.
# Keyed by a substring of ``torch.cuda.get_device_name()``.  Only the
# rates a kernel's bound reads are kept.  K1 does scalar f32 math.  The
# flash kernels K2-K4 replace Pallas kernels that run their products on
# the TPU's matrix unit, so the card's least time for the same work is
# the tensor-core time: their bound reads the dense bf16 rate.
DEVICE_SPECS: dict[str, dict[str, float]] = {
    "h100": {
        "hbm_gbps": 3350.0,  # device memory, decimal GB/s
        "f32_tflops": 67.0,  # outside the tensor cores
        "bf16_tflops": 989.0,  # tensor cores, dense (no sparsity)
    },
}


def match_device_spec(name: str) -> dict[str, float] | None:
    """Longest-substring lookup of :data:`DEVICE_SPECS` by device name."""
    kind = name.lower()
    best = None
    for key, spec in DEVICE_SPECS.items():
        if key in kind and (best is None or len(key) > best[0]):
            best = (len(key), spec)
    return best[1] if best else None


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``cuda`` unless the caller names ``cpu``; raises when CUDA is
    asked for (explicitly or by default) and no CUDA device exists."""
    dev = torch.device("cuda" if device in (None, "") else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU"
            )
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {device!r}: want cuda or cpu")


def torch_dtype(name: str) -> torch.dtype:
    """The model dtype for a config string: the two the serve path and
    its kernel take."""
    try:
        return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}") from None
