"""Hand-written Hopper kernels of the port, each beside its plain version.

``LAUNCHES`` counts, per kernel, the launches its wrapper made; a wrapper
adds one only where it launched its CUDA kernel (never for the plain
version, which it runs for CPU tensors).
"""

LAUNCHES = {"cascade": 0, "band_soft": 0, "band_hard": 0, "fold": 0,
            "align_score": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def require_cuda(t, what: str) -> None:
    """Raise unless ``t`` is a CUDA tensor (the wrappers take the plain
    version only for CPU tensors)."""
    if t.device.type != "cuda":
        raise RuntimeError(f"{what}: no kernel for device {t.device}")


def entry_device(device):
    """The device an entry point runs on: ``device`` where the caller named
    one, else the card.  Nothing carries on on the CPU because no card was
    found: without one, only ``device="cpu"`` asks for the CPU."""
    import torch

    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: this entry point runs on the GPU unless the "
            'caller passes device="cpu"')
    return torch.device("cuda")
