"""dsm_tpu_torch — the PyTorch + CUDA port of dsm_tpu's index build and
mining episode.

The JAX package `dsm_tpu` stays the reference; this package imports
`torch` and never `jax`.  It reuses dsm_tpu's JAX-free host modules (FASTA
input, the FMIndex type and occ tables, fused occ tables, the NumPy
engine, gnu-order reconstruction) and replaces the device path:

ops      : the hand-written CUDA kernels (csrc/) and their plain PyTorch
           versions: fused rank, masked row compaction, segment stats,
           the suffix array's sort and rank update, the repro cases
index    : FM-index build with the suffix arrays on a device
mining   : device tables, the device-resident level loop, host drain
convert  : JAX episode state and tables <-> the port's
cli      : `python -m dsm_tpu_torch mine|build [--device cuda|cpu] ...`
tools    : `python -m dsm_tpu_torch.tools.pallas_repro`
utils    : device selection
"""

__version__ = "0.1.0"
