"""figbird_tpu_torch — the PyTorch/CUDA port of figbird_tpu.

The JAX package ``figbird_tpu`` is the reference; this package runs the same
partial-mode iteration (align -> pair -> model -> triage -> banded EM fill ->
splice) with PyTorch, at the production default (the exact soft-count
cascade), and its five Pallas kernels rewritten as CUDA C++ kernels for
Hopper (``csrc/``, built with ``nvcc`` at first use).  It imports ``torch``
and never ``jax`` nor anything of ``figbird_tpu``: the numpy host modules it
needs (``dtypes``, ``genome``, ``config``, ``simulate``, ``io``,
``model.error_model``, ``align.index``, ``align.pairing``, ``triage.assign``,
``utils.trace``) are its own copies under the same relative names, and
:mod:`.convert` carries the reference's objects across for the tests.

Each kernel wrapper runs its plain PyTorch version for CPU tensors and its
CUDA kernel for CUDA tensors.  The entry points (``Pipeline``, ``Aligner``,
``fill_gaps``) run on the card unless the caller passes ``device="cpu"``;
without a card and without that argument they raise.
"""

__version__ = "0.2.0"
