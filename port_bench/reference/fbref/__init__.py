"""A frozen copy of the plain path of ``figbird_tpu_torch``, the benchmark's
reference.

The modules are the port's as they stood when the benchmark was defined,
with four changes: the kernel entry points of ``ops`` run their plain
PyTorch versions on every device (no CUDA kernel is built or launched), the
k-mer table is always the numpy one and the FASTQ parser the numpy one (the
native C++ library is not copied), and ``ops.entry_device`` does not refuse
TF32 (the benchmark turns it off; its control turns it on).  Later changes to the port do not reach
it, so what the port computes is held to what it computed then.  It imports
``torch`` and ``numpy`` only.
"""
