"""reference_seal_backend_tpu_torch — the PyTorch/CUDA port of the
homomorphic-encryption benchmark framework, for one NVIDIA H100.

Same sub-package layout as the JAX package beside it
(``nums/ ops/ schemes/ evaluator/ models/ engine/ utils/``), plain functions
on tensors, frozen dataclasses for ciphertexts and keys, an explicit device
carried by the context.  Residues are uint32 bit patterns stored as
``torch.int32`` (ops/modops.py).  The negacyclic NTT runs on the card as a
hand-written CUDA kernel (``csrc/ntt.cu`` via ``ops/cuda/ntt.py``); every
other operation is plain PyTorch.  The package imports ``torch`` and
``numpy`` only.
"""

__version__ = "0.1.0"
