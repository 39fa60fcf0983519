"""Hand-written Hopper kernels of the port, each beside its plain version.

``LAUNCHES`` counts, per kernel, the launches its wrapper made; a wrapper
adds one only where it launched its CUDA kernel (never for the plain
version, which it runs for CPU tensors).  ``LAUNCHES_BY_SHAPE`` splits the
counts of K1-K4 by (kernel, reads, positions) of the launch, and the overlap
bonus's by ("overlap", reads, candidate list length).
"""

from collections import Counter

LAUNCHES = {"cascade": 0, "band_soft": 0, "band_hard": 0, "fold": 0,
            "align_score": 0, "overlap": 0}
LAUNCHES_BY_SHAPE: Counter = Counter()


def reset_launches() -> None:
    from .align_score import LAUNCHES_BY_C

    for k in LAUNCHES:
        LAUNCHES[k] = 0
    LAUNCHES_BY_C.clear()
    LAUNCHES_BY_SHAPE.clear()


def launch_device(what: str, *tensors):
    """The one device all of a wrapper's tensor arguments lie on (a
    ``ValueError`` where they lie on more than one).  A wrapper launches its
    kernel under ``torch.cuda.device`` of it, so the launcher's
    ``cudaFuncSetAttribute`` and the stream belong to that device."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"{what}: arguments on more than one device: "
                         f"{sorted(map(str, devs))}")
    return devs.pop()


def canonical_device(device):
    """``device`` with its index: ``cuda`` is the current card, as the
    tensors made there report it (so devices compare and hash as their
    tensors' do)."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


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
