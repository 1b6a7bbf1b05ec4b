"""Resolve `--device cuda|cpu|host`.

  cuda  the hand-written CUDA kernels on the first visible GPU (the
        default). Raises at once when PyTorch sees no GPU: it never falls
        back to the CPU.
  cpu   the kernels' plain PyTorch versions on CPU tensors (what the CPU
        tests run).
  host  no tensors at all: the host twins (`align_ends_free_text`,
        `native.endsfree_banded`, `edit_distance`, `align_end_to_end`,
        `Hmm.label`).
"""

from typing import Optional

DEVICE_MODES = ("cuda", "cpu", "host")


def resolve_device(mode: str) -> Optional["torch.device"]:
    """torch.device for `cuda`/`cpu`, None for `host`. torch is imported
    here, not with the module: `merge`, `plot` and `validate` import the
    CLI and never load it."""
    import torch
    if mode == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda: PyTorch sees no CUDA device")
        return torch.device("cuda", torch.cuda.current_device())
    if mode == "cpu":
        return torch.device("cpu")
    if mode == "host":
        return None
    raise ValueError(f"unknown device mode {mode!r}; expected one of "
                     f"{DEVICE_MODES}")
