"""cwfa_tpu_torch — the PyTorch / CUDA port of ``cwfa_tpu`` for NVIDIA Hopper.

The JAX package ``cwfa_tpu`` stays the reference; this package mirrors its
module layout and names so that each counterpart is easy to find, and it
imports neither JAX nor ``cwfa_tpu`` (only the tests import both).

Ported so far: batched reconstruction, raw camera frames in, volumes out
(``engine.inference.XLFMReconstructor``), the exact-likelihood path
(``engine.ood``) and the serving entry point (``cli.serve``), with every
Pallas kernel of the repo replaced by a hand-written CUDA kernel (``ops``,
sources in ``csrc/``).

Subpackages
-----------
cli       the serving CLI (and the training CLI's flags)
data      lenslet view extraction, dataset statistics, TIFF I/O (over
          ``native/tiffio.cpp``), lenslet files
flow      soft clamp and CAT affine, permutations, subnet towers
ops       the CUDA kernels, their plain versions and the loader
models    CWF step, condition nets, UNet, LRNN, the full CWFA model
engine    the reconstructor, the likelihood scorer, the streaming service,
          the JAX package's checkpoints and the JAX weight bridge
parallel  more than one device: one process per GPU on torch.distributed,
          the data mesh axis, the batch shard of a data-parallel call
utils     host helpers and ``profiling`` (trace, debug_nans, FrameTimer)
"""

__version__ = "0.1.0"
