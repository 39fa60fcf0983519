"""figbird_tpu_torch — the PyTorch/CUDA port of figbird_tpu.

The JAX package ``figbird_tpu`` is the reference; this package runs the same
iterations with PyTorch — partial mode (align -> pair -> model -> triage ->
banded EM fill -> splice) and unmapped mode (plus an end-to-end alignment
pass, a model relearn and the full-window unmapped EM) — at the production
default (the exact soft-count cascade), and its five Pallas kernels
rewritten as CUDA C++ kernels for Hopper (``csrc/``, built with ``nvcc`` at
first use).  Above the iterations it has the reference's whole run:
``Pipeline.run`` (the iteration schedule and its N-count gating), the
output tree of a ``workdir``, ``pipeline.run_from_config`` and the CLI,
``python -m figbird_tpu_torch Config.json``.  It imports ``torch`` and never
``jax`` nor anything of ``figbird_tpu``: the numpy host modules it needs
(``dtypes``, ``genome``, ``config``, ``simulate``, ``combine``, ``evalx``,
``golden``, ``io`` with the SAM reader and writer, ``model.error_model``,
``align.index``, ``align.pairing``, ``triage.assign``, ``fill.draw``,
``utils``) are its own copies under the same relative names, and
:mod:`.convert` carries the reference's objects across for the tests.  The
package and its subpackages export the reference's public names, but for
its JAX-only ones.

Each kernel wrapper runs its plain PyTorch version for CPU tensors and its
CUDA kernel for CUDA tensors.  The entry points (``Pipeline``, ``Aligner``,
``fill_gaps``, the CLI) run on the card unless the caller passes
``device="cpu"`` (``--device cpu``); without a card and without that
argument they raise.  The multi-device layer (:mod:`.parallel`) runs them
over a ``(reads, genome)`` mesh of devices, with code-range or
contig-range genome shards, and over several processes joined by gloo,
with the single-device results.
"""

from .config import FigbirdConfig, Parameters, ReadLibrary
from .genome import GapInfo, Genome

__all__ = [
    "FigbirdConfig",
    "Parameters",
    "ReadLibrary",
    "Genome",
    "GapInfo",
]

__version__ = "0.3.0"
