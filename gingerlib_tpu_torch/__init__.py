"""gingerlib_tpu_torch: the PyTorch/CUDA port of gingerlib_tpu.

Same module layout as the JAX package (``ops/limbs.py``, ``fields/fp.py``,
``curves/sw.py``, ``proofs/groth16.py`` ...), plain functions on tensors, and
hand-written CUDA kernels under ``csrc/`` for the arithmetic that the JAX
package does in Pallas kernels.  Imports torch and numpy only.

Device rule: every entry point takes ``device``; ``None`` means the GPU and
raises when there is none, and only an explicit ``device="cpu"`` runs on the
CPU (as the tests do).
"""
