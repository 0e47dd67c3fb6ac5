"""PyTorch/CUDA port of the scheduling simulator's batch path.

The JAX package ``kube_scheduler_simulator_tpu`` is the reference; this
package runs the same batch scheduling round with PyTorch on an NVIDIA
GPU, through hand-written CUDA kernels for the device work:

- ``ops/encode.py``  host encoder (numpy), copied from the reference;
- ``ops/batch.py``   lowering to device tensors, the plain PyTorch versions
                     of the scan and the trace compaction, and the host
                     trace reconstruction;
- ``ops/kernels.py`` + ``csrc/``  the CUDA kernels, their build and binding;
- ``scheduler/batch_engine.py``  ``BatchEngine`` and ``BatchResult``: one
                     traced round and its byte-exact annotation trail.

Entry points run on the card (``device="cuda"``) unless the caller asks for
the CPU (``device="cpu"``), where the plain versions stand in for the
kernels.  Nothing here imports JAX or the reference package.
"""

__version__ = "0.1.0"
