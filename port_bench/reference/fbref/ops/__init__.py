"""Device helpers of the frozen copy (no kernels: see band.py and align_score.py)."""


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
    one, else the card.  (The port also refuses TF32 here; the copy runs at
    whatever precision its caller sets: the benchmark sets TF32 off, and its
    control turns it on.)"""
    import torch

    if device is not None:
        return torch.device(device)
    if torch.cuda.is_available():
        return torch.device("cuda")
    raise RuntimeError(
        "no CUDA device: this entry point runs on the GPU unless the "
        'caller passes device="cpu"')
