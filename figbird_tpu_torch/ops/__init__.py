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
    found: without one, only ``device="cpu"`` asks for the CPU.  On the card
    the port's f32 matmuls must be full f32, so TF32 must be off; the flag
    is the caller's to set, and is only checked here."""
    import torch

    if device is not None:
        dev = torch.device(device)
    elif torch.cuda.is_available():
        dev = torch.device("cuda")
    else:
        raise RuntimeError(
            "no CUDA device: this entry point runs on the GPU unless the "
            'caller passes device="cpu"')
    if dev.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 is on: the port's f32 "
            "matmuls would round their inputs to 10-bit TF32; set it to "
            "False (torch.set_float32_matmul_precision('highest'))")
    return dev
