"""cwfa_tpu_torch — the PyTorch / CUDA port of ``cwfa_tpu`` for NVIDIA Hopper.

The JAX package ``cwfa_tpu`` stays the reference; this package mirrors its
module layout and names so that each counterpart is easy to find, and it
imports neither JAX nor ``cwfa_tpu`` (only the tests import both).

Ported so far: deterministic batched reconstruction, raw camera frames in,
volumes out (``engine.inference.XLFMReconstructor``), with the two Pallas
flow kernels of ``cwfa_tpu/ops/pallas_flow.py`` replaced by hand-written
CUDA kernels (``ops.flow_affine``, sources in ``csrc/``).

Subpackages
-----------
data      lenslet view extraction, dataset statistics
flow      soft clamp and CAT affine, permutations, subnet towers
ops       the CUDA flow-affine kernels, their plain versions and the loader
models    CWF step, condition nets, UNet, LRNN, the full CWFA model
engine    the reconstructor and the JAX weight bridge
"""

__version__ = "0.1.0"
