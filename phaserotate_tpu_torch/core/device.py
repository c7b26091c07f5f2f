"""Where the port's entry points run: on the card unless asked otherwise."""

from __future__ import annotations

import torch

__all__ = ["as_f32", "indexed_device", "resolve_device"]


def resolve_device(device=None, like=None) -> torch.device:
    """The device an entry point runs on.

    * An explicit ``device`` is used as given (a tensor input is moved).
    * Otherwise a tensor input ``like`` keeps its own device.
    * Otherwise the result is the CUDA device.

    Nothing falls back to the CPU unasked: with no CUDA device, no
    ``device`` and no tensor input this raises.
    """
    if device is not None:
        return torch.device(device)
    if isinstance(like, torch.Tensor):
        return like.device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: phaserotate_tpu_torch runs on the card by "
            "default; pass device=\"cpu\" (or CPU tensors) to run on the CPU")
    return torch.device("cuda")


def indexed_device(option=None) -> torch.device:
    """The device a plugin-style ``device`` option names.

    An int indexes the CUDA devices (where the JAX package indexes
    ``jax.devices()``) and raises ``ValueError`` out of range; a string or
    ``torch.device`` (``"cpu"``) is used as given; ``None`` is the card
    (:func:`resolve_device`)."""
    if option is None or isinstance(option, (str, torch.device)):
        return resolve_device(option)
    index = int(option)
    count = torch.cuda.device_count()
    if not 0 <= index < count:
        raise ValueError(f"device {index} out of range ({count} available)")
    return torch.device("cuda", index)


def as_f32(audio, device=None) -> torch.Tensor:
    """``audio`` as a float32 tensor on :func:`resolve_device`'s device."""
    return torch.as_tensor(audio, dtype=torch.float32,
                           device=resolve_device(device, audio))
