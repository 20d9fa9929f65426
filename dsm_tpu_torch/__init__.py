"""dsm_tpu_torch — the PyTorch + CUDA port of dsm_tpu: the index build,
the mining episode, the wire-protocol pair and its launcher, and the
distance matrices.

The JAX package `dsm_tpu` stays the reference; this package imports
`torch`, never `jax` and nothing of `dsm_tpu`.  It keeps its own copy of
the host modules it needs, under dsm_tpu's module and function names
(FASTA input, the FMIndex type and its file formats, the occ tables, the
NumPy engine, gnu-order reconstruction, the snapshot codec, the distance
accumulator), and replaces the device path:

ops      : the hand-written CUDA kernels (csrc/) and their plain PyTorch
           versions: fused rank, masked row compaction, segment stats,
           children, path decode, the per-level engines' dense expand and
           analyse-and-compact, the rank on raw BWT blocks, the suffix
           array's sort and rank update, the pairwise distance matrices,
           the repro cases; and the host occ tables and NumPy suffix sort
index    : FM-index (build with the suffix arrays on a device, query,
           .dsmi/.fmi/.rlcsa files), FASTA input, incremental merge
mining   : device tables, the device-resident level loop, host drain,
           the per-level loop (level-gnu), the NumPy engine, gnu order,
           checkpoints, capacity planning (bigindex)
parallel : the sample-sharded episode on torch.distributed, the
           (prefix, samples) mesh engine, prefix ownership (multihost)
net      : the reference wire protocol on the host: the codec (and its
           C++ twin, built with g++ at first use), the client behind
           `enumerate` and the merging server behind `serve`
post     : mined rows -> pairwise sample-distance matrices
convert  : dsm_tpu's indexes, configs, tables and episode state -> the
           port's
cli      : `python -m dsm_tpu_torch build|mine|enumerate|serve|launch|
           distance [--device cuda|cpu]`; launch: the serve/enumerate
           fleet on this machine, sbatch scripts or discovery files
tools    : `python -m dsm_tpu_torch.tools.pallas_repro`
utils    : device selection
"""

__version__ = "0.1.0"
