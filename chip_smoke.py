"""Smoke run of the PyTorch + CUDA port (dsm_tpu_torch) on one GPU.

    python3 chip_smoke.py

and, for timings alone (see `level_times`, `variant_times`, `drain_times`,
`expand_times`, `dense_level_times` and `level_variant_times`),

    python3 -c 'import torch, chip_smoke as c; c.level_times(torch, torch.device("cuda", 0))'
    python3 -c 'import torch, chip_smoke as c; c.variant_times(torch, torch.device("cuda", 0))'
    python3 -c 'import torch, chip_smoke as c; c.drain_times(torch, torch.device("cuda", 0))'
    python3 -c 'import torch, chip_smoke as c; c.expand_times(torch, torch.device("cuda", 0))'
    python3 -c 'import torch, chip_smoke as c; c.dense_level_times(torch, torch.device("cuda", 0))'
    python3 -c 'import torch, chip_smoke as c; c.level_variant_times(torch, torch.device("cuda", 0))'

and phase 17 alone (see `levels_alone`),

    python3 -c 'import torch, chip_smoke as c; c.levels_alone(torch, torch.device("cuda", 0))'

Phases, each of which fails the run (non-zero exit, no result line):
  1. environment: the card, torch/CUDA versions, nvcc, triton;
  2. build: nvcc builds dsm_tpu_torch/csrc into build/kernels;
  3. data (the build path): scale-100 toydata (tests/make_toydata.py,
     GOLDEN_SEED) and its FM-indexes by `indexes_from_fasta` on the card,
     so all 10 suffix arrays (5 samples, 2 directions) go through the SA
     kernels; every build-path kernel must have been launched;
  4. kernels: each CUDA kernel against its plain PyTorch version on the
     card at main-path shapes (equal integers; the f64 entropy within
     ENT_TOL), with both times. The rank kernel runs by all four of its
     entries: one end at RANK_Q queries, the level's expand step at the
     widest level of the scale-100 mine (made by the port's own level loop;
     there also its expand_tables entry over 1 and 2 shard tables, equal to
     the one-table outputs) and on a synthetic level of ~4.2M pairs with as
     many pairs whose two ends share a table row, and the leftChar (below).
     The suffix
     array of toy0, forward and reverse, must also equal the host
     `suffix_array_np`; it is timed there and at n = 2^24. The sort's
     k = 16 round of toy0 is checked from the previous round's order and
     from scratch, its first round from scratch; the round's bytes a key
     and TB/s are printed (toy0 and 2^24). P2-P4 are timed by events and by
     the profiler's device time, also at N = 2^24 beside the PyTorch call
     with the same result (P4's entry in the kernels line is at 2^24). The
     drain's leftChar (the rank kernel's leftChar entry, K5) runs on the
     staged rows of every drain of the scale-100 mine (ascending and gnu;
     the kernels line has the largest ascending drain), on every pair of its
     widest level staged as output rows, and over 2 and 5 shard tables of
     the same samples (codes equal to one table's). The
     compaction (P1) also runs with width below the count, an unaligned
     mask and a tail to zero, and its emit entry (`stage_rows`) on the
     children case's pairs with 0.1% and 30% of them marked. The stats
     step (K2) runs on ~4.2M pairs in nodes of 1..5, 1..64 and 1..273
     pairs: one launch each, flags, pair_out and the level's counts equal,
     the entropy and its range within ENT_TOL. The path decode (K6) walks
     a synthetic history of DEC_LEVELS levels of SEG_NODES nodes, random and
     shaped as a trie (rows in order, children numbered in (parent,
     symbol) order; its bound also by the distinct ancestors the walks
     read), and the children step (K3) runs on SEG_NODES nodes of
     1..5 pairs with ~30% of the lanes kept (all symbols, and one symbol
     alone), on the same ~4.2M pairs in nodes of 1..64 and 1..273 pairs
     (K9c too), with nodes that hold no pair, and with nothing kept. The
     pairwise distance matrices (K11) take DIST_R rows of DIST_D samples in
     DIST_BINS bins (`distance_rows`: ~30% of the entries nonzero,
     long-tailed), against the plain version run in chunks on the card
     (count equal, the f64 sums within DIST_TOL) and against NumPy
     `pairwise_matrices` on the first 4,096 rows; also d = 5 and d = 273 at
     fewer rows, and with the normalising factors (this one after phase 12,
     so that the plain version's library workspace is not in the mine's
     peak memory). The kernels of the sharded level and drain: the
     partial rows (K9a) of a list on the stats step's three levels (nodes
     of 1..5, 1..64 and 1..273 pairs: integers and the kept lanes equal,
     the fixed-point entropy sums within one unit a pair); on SEG_NODES
     nodes over S = 5 samples split into 5 shards and into shards of 2 and
     3, the shards' pairs as one process's list: its rows (K9a, one launch,
     equal to the shards' rows added) and the gates, global child ids, the
     pair gates and the level's values from them (K9b: one launch;
     integers equal, the entropy and its range within ENT_TOL); the
     outside-ids children step (K9c) on that list and on each of the 2
     shards' pairs (one process's list of a group) and the gather of 2 and
     5 blocks of GATHER_ROWS rows (K10, by events around the wrapper and by
     the profiler's device time, its inputs cold in the L2);
  5. main path: `mine_torch` ascending and gnu order at fmin=2, emax=1.2
     on the card-built indexes; the counts and the gnu-order sha256 must
     equal the frozen reference (BENCH_BASELINE.json), so they also
     prove the build, and every mining kernel must have been launched;
     one more warm ascending run under torch.profiler gives the device
     time and the number of device activities of a run and a level, and
     must launch the rank kernel once a level and once a drain;
  6. resume: the gnu-order mine with `checkpoint=` (out_reserve
     RESUME_RESERVE: saves where the frontier is wide) is killed by a
     raise from `save_checkpoint` after its second save and resumed from
     the file; the same frozen reference, and the file must be gone; the
     frontier decode of its saves with the most rows x levels is then held
     against the plain version and timed (K6 on the real trie);
  7. halt: the ascending mine with `halt` returning [b"A"] (out_reserve
     HALT_RESERVE: the first poll before the tail); its lines are a
     subset of the warm ascending run's, none under A is deeper than the
     first poll, and the lines outside A are equal;
  8. sharded path: on the card-built indexes `mine_device_sharded` with
     1, 2 and 5 shards on the one card, gnu order, each against the frozen
     reference; the 2-shard ascending run's lines equal the warm
     single-device run's; the 2-shard gnu run with `checkpoint=` at
     RESUME_RESERVE killed at its second save and resumed by the
     SINGLE-DEVICE `mine_torch` to the frozen reference; and the 2-shard
     gnu run once more inside a one-rank NCCL process group, so that the
     level's all-reduce and the drain's all-gathers run on the card between
     the kernels (K10 is also held against its plain version and timed
     on the 1-, 2- and 5-shard drains' one block: the kernels line has the
     5-shard drain's).  Every kernel of the sharded path must have been
     launched by the plain 2-shard gnu run, every run must launch the
     expand (the rank kernel), K9a and K9b once a level and K9c once a
     level that is not a HISTFULL exit, and every drain the gather (K10)
     once and the rank kernel once (its leftChar entry; in the process
     group the all-gather's gather adds one), whatever the shard count;
  9. owned: `mine_owned` (prefix ownership) on the card at 2 hosts x hash
     depth 1 (4 prefixes) and 3 hosts x hash depth 2 (16 prefixes, split
     5/5/6): each set's `merge_outputs` equals the warm ascending run's
     bytes, with the reference's total_paths (47,025,699 at depth 1; at
     depth 2 each depth-1 node is counted by the four runs under it, as
     dsm_tpu counts it); every prefix's run launches the rank kernel once a
     level and once a drain; each prefix's wall and levels, and their sum
     against one full run;
 10. cli: the card-built indexes saved as .dsmi; two `python -m
     dsm_tpu_torch mine --num-hosts 2 --host-id {0,1}` processes on the
     card, their stdouts in post-order equal to the warm ascending bytes;
     `mine --engine auto -v` names device mode and prints the same bytes;
 11. capacity: `plan` with the card's budget gives device mode;
     `table_bytes + episode_bytes` is at or above the peak device memory
     (`max_memory_allocated` after a reset) of an ascending, a gnu and a
     2-shard run, each with its own tables alone on the card; a budget 1
     byte short does not give device mode; `DeviceIndexes.build` under
     DSM_HBM_BYTES=1024 raises the sizing error;
 12. fleet: `launch --mode local -E 1.2 -f 2` (4 servers and 5 clients of
     the port, host code) on the port's indexes of tests/data/toydata, its
     four outputs equal to tests/golden/server-output.default.{A,C,G,T};
     its wall and the codec that ran;
 13. distance path: the gnu mine's 485 lines through
     `DistanceAccumulator(smpls=5, maxents=entropy_steps(0.05))`, exact on
     the host and exact=False on the card: count and noutput equal, the
     f64 matrices within DIST_TOL, and the kernel launched;
 14. repro path: `dsm_tpu_torch.tools.pallas_repro`'s cases must PASS,
     each launching its kernel;
 15. scale 1000, the JAX package's largest size (bench.py:240-281): the
     toydata at scale 1000 (81,131,072 symbols) built on the card (10
     suffix arrays of ~16.2M symbols through K8; the build's kernels
     launched; toy0's both arrays against `suffix_array_plain` and its
     round k = 16 against the plain sort and rank), uploaded once; then
     `mine_torch(prefix=p)` for p in A, C, G, T over that one upload,
     ascending and gnu, each against the frozen S1000 entry of its prefix
     and concatenated against the whole; the whole trie in one episode,
     ascending and gnu, against the frozen concatenation (paths, lines,
     sha256, occurrences, entropy range), with at least one HISTFULL exit
     under the default history cap; the
     2-shard episode on the one card, gnu, against the same bytes.  Each
     run's launches are counted from 0 (every kernel of its path
     launched; the rank kernel once a level and once a drain; in the
     2-shard run K9a, K9b and K9c once a level as in phase 8), with its
     levels, `level_s`, `drain_s`, `tail_s`, tail depth, drains, HISTFULL
     exits, pulled levels and peak memory, and the capacity plan's bytes
     against the peaks.  K1 (`occ_cum8` at RANK_Q queries, `expand`), K2,
     K3, P1 and its `stage_rows` entry, and the sharded level's kernels
     (K1's `expand_tables` and K9a, K9b and K9c on the level as the one
     pair list of the 2-shard mesh's shards) run at the widest real level
     (made by the port's own level loop), K5 and K6 on the
     whole-trie run's largest drain and path decode, K10 on the 2-shard
     run's largest drain, each against its plain version, with the table
     rows that the widest level's pairs touch against the 50 MB L2;
 16. the sample axis, at the JAX package's sample widths: D64 (64
     samples), D273 (273, the reference's MAX_READERS) and D512 (512,
     maxdepth 6), tests/freeze_samples_reference.py's metagenome-shaped
     data built on the card a sample at a time (the build's kernels
     launched), uploaded once; the whole trie on one device, ascending
     and gnu, then (its tables freed) the sharded episode at 2 and 128
     shards (MAX_SHARDS; D512 at 128 alone) on the one card in both
     orders, each against the frozen D64 / D273 / D512 (paths, lines,
     occurrences, the frequency histogram's and both orders' sha256, the
     entropy range within SAMPLES_ENT_TOL), every kernel of its path
     launched, the expand, K9a, K9b and K9c once a level as in phase 8;
     each 128-shard ascending run once more under torch.profiler (its
     `level_s`, peak, device time and activities a level on a line of its
     own); D273's gnu
     mine killed at its second save (out_reserve SAMPLES_RESERVE) and
     resumed to the same bytes; the levels' widths by depth (nodes, pairs,
     widest node, nodes past 64 pairs; D512 must hold a node of 512
     pairs); `distance --fast` on each set's gnu lines against the exact
     host path (DIST_TOL); the capacity plan (`mine --engine auto`'s
     `plan`: device mode, its bytes at or above every run's peak).  At
     D273's widest level and its level with the most nodes past 64 pairs
     (each with its histogram of pairs a node) K1's expand, K2, K3, P1 and
     its stage_rows entry, and the sharded level's kernels on the level as
     the one pair list of the 128 shards of one process (K1's
     expand_tables over the 128 shard tables, K9a, K9b on its one row a
     node, K9c), against their plain versions, and K10 and K5 on the
     largest drain of its 128-shard gnu run, timed by events and device
     time.
 17. the per-level engines (`mine_torch(reader_order="level-gnu")` and
     `mine_sharded`, dsm_tpu's dense per-level loop and its (prefix,
     samples) mesh engine; a level one launch of K12, the dense expand in
     csrc/rank.cu, and one of K13, csrc/level.cu, whatever the rows and
     shard tables, redone levels included): on D512 (phase 16's indexes,
     one upload) level-gnu, `mine_sharded` at mesh (1, 1) ascending and at
     (4, 2) and (4, 128) in both orders and at (4, 2) in gnu order inside
     a one-rank NCCL group, each against the frozen D512; the
     four one-symbol prefix runs through the episode (both orders) and
     through level-gnu, concatenated, against the whole run's sha256; on
     scale 100 under LEVEL_PREFIX (two symbols, ~2.9M paths; a gnu run's
     host loop ~45-48 s) the episode in both orders, and level-gnu and
     `mine_sharded` at (4, 2) in both orders equal to its bytes; K12 and
     K13 against their plain versions (every output equal) at the widest
     level of the level-gnu run (one row, one table) and of the sharded
     run with four prefix rows (scale 100's (4, 2): 2 tables; D512's
     (4, 128): 128 tables) of each set (D512's level-gnu: depth 6, 4,096
     nodes x 512 samples), each entry with its own run's launches and
     also timed by events around calls queued behind a spin kernel
     (`queued_ms`: device time without the wrapper's host time), the runs
     passing the tables prepared once (`LevelTables`); K14
     (`compact_kidx`, csrc/compact.cu) at N = LEVEL_KIDX_N with 30% set,
     also below the count, beside `torch.nonzero`, and K15 (`occ_batch`,
     csrc/occbatch.cu) at LEVEL_OCC_Q queries: (a) random positions on
     toy0's blocks, (b) the same sorted, (c) random on a table of
     OCC_BIG_CODES codes past the L2 (`occ_cases`), each an entry of its
     own with its L2 floor in sectors a query (`occ_bounds`); each first
     called once through its API (the "ops" path), K14 and K15 also timed
     by `queued_ms`.  Each run's wall,
     levels, regrows and launches on a line of its own; "levels summary:"
     and "levels kernels:" lines.  Alone: `python3 -c 'import torch, chip_smoke as c;
     c.levels_alone(torch, torch.device("cuda", 0))'`.  K15's three cases
     timed in turns with another tree's kernel and beside OCC_PATCHES'
     builds: `c.occ_batch_times(torch, torch.device("cuda", 0),
     parent="build/parent")` (one JSON line; not part of the run).
Launches are counted per path: set to 0 just before it, read just after
(the mining kernels also for the resume, halt, owned and capacity
phases).
Phase 15 logs its own kernels' entries (the same keys, at scale 1000) on a
line that starts "scale 1000 kernels:", and its runs on "scale 1000
summary:"; phase 16 its sets' runs on "D64 summary:" and the like, and its
kernels' entries on "samples kernels:", which also go into the kernels line,
each with a "case" (its set and level) and the launches of its D273 path.
Then one JSON line of kernels (each with its launches on its path, its
error and time against the plain version, the least time the card could
take for the same bytes and operations, and the time of the one PyTorch
call that computes the same function, where there is one), the card's
name and power limit, and the final line {"ok": true, "device": {...}}.

The script imports torch and the port, never JAX or the JAX package.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

ENT_TOL = 1e-9   # f64 entropy: the same sums, atomics order in the plain
#                  version's index_add_ may differ by a few ulps
FMIN, EMAX = 2, 1.2
SCALE = 100             # the scale of the frozen reference
# main-path shapes of the kernel checks at scale 100
RANK_Q = 1 << 22        # rank queries (two per pair per level)
COMPACT_N = 1 << 23     # candidate rows of a plateau level's children
SEG_NODES = 1_400_000   # nodes of 1..5 pairs (S = 5 samples): ~4.2M pairs
SEG_WIDTHS = ("1..5", "1..64", "1..273")   # K2's node widths, in pairs
# build variants that `variant_times` times against the sources as they are:
# (source in dsm_tpu_torch/csrc, constant, its value in the variant)
VARIANTS = (("decode.cu", "kRows", 1), ("decode.cu", "kRows", 4),
            ("segstats.cu", "kMaxTile", 256), ("segstats.cu", "kWide", 32),
            ("segstats.cu", "kLut", 1),
            # K9a's block-tile shape at every width, its warp shape at every
            # width, and K9b with one node a thread a tile
            ("shardstats.cu", "kWarpLevel", 0),
            ("shardstats.cu", "kWarpLevel", 1 << 20),
            ("shardstats.cu", "kNodes", 1))
DEC_LEVELS = 48         # levels each decoded row walks (K6)
RESUME_RESERVE = 100    # gnu order: saves at depths 10-12, 33, 59
HALT_RESERVE = 500      # ascending: the first halt poll at depth 10
# Phase 15's reference: tests/make_toydata.py at scale 1000 with GOLDEN_SEED,
# fmin 2, emax 1.2, mined by dsm_tpu on the host (FMIndex.from_texts, then
# dsm_tpu.mining.engine_np.mine_np once a prefix and reader order), as
# `python tests/freeze_scale_reference.py DIR` prints it.  The whole trie's
# bytes in either order are the four prefixes' concatenated, and its counts
# their sums.  S1000_PREFIXES: (prefix, paths, lines, gnu sha256, ascending
# sha256) of each prefix run.
S1000_PREFIXES = (
    ("A", 115_877_243, 826,
     "f39d2630153d5a8f7693ae5616d858ef053ea17be389377c4bea2c58fb4b8fb1",
     "471ddc13829e912da651a2e6c33b95c3fe6a4fc795caf2f63b0f950be75ba611"),
    ("C", 115_825_559, 751,
     "aad7e3e78e763d3f90eaea6a757052f6c0590bfe139397f0cb7ce70b42af4e4c",
     "38d1db1e2aae71a16650abc3cc000df1b86b3093d60b0c05c30ea18dde947ccf"),
    ("G", 115_818_292, 831,
     "2cfa6874882b3a6010f0645f299db0bb5b04e8ee0bb9add133d2b28b1ae8570f",
     "988c24dd59be87a8ea20745e5410c1e806875be47fbd11306c79f094915d78b6"),
    ("T", 115_990_105, 750,
     "c85722adedc068723aedb987c5dc3be412dad0e36e291310b62cd743151a596a",
     "a6eff0f7f772263d2ad425dc304edaca5ca85de7faf62b8246329ca6aa13407e"))
S1000 = dict(
    scale=1000, symbols=81_131_072, paths=463_511_199, lines=3_158,
    occs=6_411, entropy=(0.8787124922704876, 2.3219280948873626),
    gnu="c2825a4d6ab757cf15a0da8ce17fdbda26ea94cfabb3c2f3254cf787720ec9bf",
    ascending=(
        "ee006466a30a27a9e5ab51b200f611f18cccdd3d0c5a5ad19729ad2dfa528095"),
    prefixes={p: dict(paths=n, lines=m, gnu=g, ascending=a)
              for p, n, m, g, a in S1000_PREFIXES})
# Phase 16's references: tests/freeze_samples_reference.py's `make_samples`
# data (`make`: its samples, the symbols asked for and the seed), fmin 2,
# pmin 2, the emax given (the smallest that leaves ~1,000 lines: at these
# widths the pseudo-count term d + sum f keeps every line above 1.2) and
# maxdepth (None: unlimited), mined by dsm_tpu on the host CPU
# (FMIndex.from_texts, then mine_device on the JAX CPU backend, the whole
# trie in each reader order), as `python tests/freeze_samples_reference.py
# DIR --samples D --symbols N --emax E [--maxdepth M]` prints it.  `hist`:
# the sha256 of the frequency histogram as d int64 words; `entropy`:
# dsm_tpu's float32 diagnostics, held within SAMPLES_ENT_TOL.
D64 = dict(
    make=(64, 35_200_000, 14), symbols=33_134_166, emax=1.2, maxdepth=None,
    paths=78_235_886, lines=8_282, occs=17_576,
    entropy=(1.0915398597717285, 5.94761323928833),
    hist="248834a6ac626b3d34a377239617303458c5db5626a44c04e1ae6db1662ddaa1",
    gnu="bd887b2f88b64f89a96ffd34ce7a1e651cafb97f0b82c3916c61302ede52ec16",
    ascending=(
        "f87cdf47c164375647a494b361eea6dea815492dd231c3ad7e47b83382c78790"))
D273 = dict(
    make=(273, 33_600_000, 14), symbols=33_465_996, emax=3.78,
    maxdepth=None, paths=56_673_117, lines=1_014, occs=4_218,
    entropy=(2.9631969928741455, 8.079411506652832),
    hist="e9b48db3097df6f1e206f6ea2a34b387094aaa433692b3b80079913464cd666c",
    gnu="903689416e563ed38813a6af6d3ae7e4999269458279a8b7b70428b84fb13ddb",
    ascending=(
        "525c0f5235561577ee91e9a4487a1aac60055e951983c1e2005f165c3c84b5c2"))
D512 = dict(
    make=(512, 2_000_000, 14), symbols=1_804_510, emax=8.6, maxdepth=6,
    paths=5_460, lines=1_103, occs=205_340,
    entropy=(8.194402694702148, 8.866853713989258),
    hist="8cc5631e0c98346d4e95e37d4b1ffcaa0fc8d73227f66976b97b95d8ca72ee68",
    gnu="954cb11af1e61fe42c0ce845e0bddb46855ee70d6a68dec426585595e5b90307",
    ascending=(
        "dc1465e15fa0220d12425597b169284045100a6be3cb433eaa301ecee185a517"))
SAMPLES_ENT_TOL = 5e-6  # the port's f64 entropy range against dsm_tpu's f32
# phase 17: the enforced prefix of the scale-100 per-level runs (~0.7M
# paths; their gnu runs' host loop sets the phase's wall), and the shapes
# of K14 and K15's checks
LEVEL_PREFIX = b"AC"
LEVEL_KIDX_N = 1 << 23
LEVEL_OCC_Q = 1 << 22
OCC_BIG_CODES = 1 << 27  # K15's case (c): 1,048,576 blocks, past the L2
SAMPLES_SHARDS = (2, 128)   # the sharded episode's shards on the one card
SAMPLES_RESERVE = 400   # D273's killed gnu mine: a few drains, each a save
SA_ROUND_K = 16         # the round of toy0's suffix array timed alone
SA_BIG = 1 << 24        # a synthetic suffix array, beyond scale 100
REPRO_BIG = 1 << 24     # P2-P4 where bytes count (128 MB moved a call)
GATHER_ROWS = 100_000   # rows a block of the gather kernel's check (K10)
GATHER_SETS = 6         # its sets of inputs: 6 x 10.7 MB > the 50 MB L2
DIST_R, DIST_D, DIST_BINS = 1 << 20, 64, 21   # K11: rows, samples, bins
# K11's f64 sums against the plain version's: up to 2^20 same-signed terms
# a matrix entry, added in another order (the kernel's row slices meet in
# atomics), and against NumPy also another libm's log1p and lgamma
DIST_TOL = 1e-9         # |got - want| <= DIST_TOL * (1 + |want|)
HBM_TBS = 3.35          # H100 SXM HBM3 peak, TB/s
F32_TOPS = 67.0         # H100 SXM peak outside the tensor cores, T op/s:
#                         taken for f32 and, generously, for integer work
F64_TOPS = 33.5         # f64 outside the tensor cores: half the f32 rate
# the kernels of each path, by the name in the kernels line
LAUNCH_KEY = {"occ_cum8": "rank", "expand": "rank", "leftchar": "rank",
              "expand_tables": "rank",
              "compact_rows": "compact",
              "segstats": "segstats", "decode": "decode",
              "children": "children", "stage_rows": "compact",
              "sa_sort": "sa_sort",
              "sa_rank": "sa_rank", "smem_carry": "repro_carry",
              "async_copy": "repro_async", "dynamic_store": "repro_dynstore",
              "pairwise_matrices": "distance",
              "shard_partials": "shard_partials", "node_gates": "node_gates",
              "children_ids": "children_ids", "gather_pack": "gather_pack",
              "level_expand": "level_expand", "level_compact": "level_compact",
              "compact_kidx": "compact_kidx", "occ_batch": "occ_batch"}


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def load_tests_module(name: str):
    """tests/<name>.py by path: `tests` is no package, and another
    installed `tests` package may shadow a namespace import."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(HERE, "tests", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_make_toydata():
    return load_tests_module("make_toydata")


def phase_env(torch) -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False: "
                         "no GPU, nothing to smoke-test")
    smi = smi_line()
    log(f"nvidia-smi: {smi}")
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  devices {torch.cuda.device_count()}")
    from dsm_tpu_torch.ops import _build

    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True).stdout.strip().splitlines()
    log(f"nvcc: {nvcc[-1] if nvcc else 'no output'}")
    try:
        import triton
        log(f"triton: {triton.__version__}")
    except ImportError:
        log("triton: not importable")
    return smi


def phase_build() -> None:
    from dsm_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.lib()
    log(f"build: {path} in {time.perf_counter() - t0:.2f} s "
        f"(nvcc ran: {_build.build_seconds is not None})")


def path_launches(path: str, label: str | None = None) -> dict:
    """The launch counts of `path`'s kernels since the last reset; fails
    if one of them was never launched."""
    from dsm_tpu_torch.ops import _build

    label = label or f"the {path} path"
    launches = {k: _build.LAUNCHES[k] for k in _build.PATHS[path]}
    log(f"launches in {label}: {json.dumps(launches)}")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise SystemExit(f"kernels never launched by {label}: {missing}")
    return launches


def bound(nbytes: float, ops: float, tops: float = F32_TOPS) -> dict:
    """The least time the card could take: `nbytes` (each input read once,
    each output written once) at the memory's peak rate, or `ops`
    operations at `tops` T op/s, whichever is longer."""
    by_bytes = nbytes / (HBM_TBS * 1e12) * 1e3
    by_ops = ops / (tops * 1e12) * 1e3
    return dict(bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations")


def phase_data(torch, toy, td: str, device):
    """Scale-100 toydata and its indexes, built on the card per sample;
    -> (indexes, toy0's forward and reverse codes, build launches)."""
    from dsm_tpu_torch.index import indexes_from_fasta
    from dsm_tpu_torch.index.alphabet import transform
    from dsm_tpu_torch.index.fasta import read_fasta
    from dsm_tpu_torch.index.fmindex import collection_codes
    from dsm_tpu_torch.ops import _build

    fastas = toy.make_toydata(td, scale=SCALE, seed=toy.GOLDEN_SEED)
    idxs, secs = [], []
    torch.cuda.synchronize()
    _build.reset_launches()
    for path in fastas:
        t0 = time.perf_counter()
        idxs += indexes_from_fasta([path], device)
        secs.append(time.perf_counter() - t0)
    launches = path_launches("build")
    log(f"data: scale {SCALE}, {sum(i.n for i in idxs):,} indexed "
        f"symbols in {len(idxs)} samples, built on the card in "
        f"{sum(secs):.4f} s (per sample: "
        f"{', '.join(f'{t:.4f}' for t in secs)} s)")
    codes, rcodes, _lengths, _max = collection_codes(
        [transform(rec.seq) for rec in read_fasta(fastas[0])])
    return idxs, (codes, rcodes), launches


def device_ms(torch, fn, reps: int = 20):
    """Device time per call of fn: the durations of the device activities
    (kernels, memsets) that torch.profiler records over reps calls, in ms;
    None when the profiler records none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA)
    return us / reps / 1000 if us else None


def device_profile(torch, fn):
    """One call of fn under torch.profiler -> (the device activities'
    summed duration in ms, or None when none was recorded; their number;
    the eight names with the most time, ms each)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name, n = {}, 0     # by the name's first 60 characters
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n += 1
            by_name[e.name[:60]] = by_name.get(e.name[:60], 0.0) \
                + e.time_range.elapsed_us() / 1000
    top = {k: round(v, 3) for k, v in sorted(
        by_name.items(), key=lambda kv: -kv[1])[:8]}
    return (sum(by_name.values()) if n else None), n, top


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def sort_bytes_per_key(n: int, k: int, max_rank: int, derive: bool):
    """-> (bytes a key, passes) of csrc/sa.cu's sort in one round (see its
    header): the digit counts' read, each pass's reads and writes, the
    last pass's gather of rank[i+k] and its packed-key write."""
    from dsm_tpu_torch.ops.sa import RADIX_BITS

    lo = 0 if derive or k >= n else (max_rank + 1).bit_length()
    bits = max_rank.bit_length() + lo
    passes = max(1, -(-bits // RADIX_BITS))
    kv = (4 if bits <= 32 else 8) + 4          # a carried key and value
    counts = 8 if lo else 4                    # rank (and rank[i+k])
    first_in = 8 if derive or lo else 4        # prev + rank, or rank(s)
    middle = 2 * kv * (passes - 1)             # reads and writes between
    last_out = 12 + (4 if lo == 0 and k < n else 0)
    return counts + first_in + middle + last_out, passes


def cuda_ms(torch, fn, reps: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def queued_ms(torch, fn, reps: int = 40) -> float:
    """Device time a call of fn without its host time: CUDA events around
    `reps` calls queued behind a spin kernel (torch.cuda._sleep) that keeps
    the card busy while the host enqueues them, so that they run back to
    back; in ms."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) / reps
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    # spin ~2x the host's enqueue time (cycles at ~1.98 GHz)
    torch.cuda._sleep(int(2 * host * reps * 1.98e9))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def host_ms(torch, fn, reps: int = 200) -> float:
    """Host time of a call of fn (its Python and its launches) in ms, by
    the host's clock over reps calls that the device keeps up with."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / reps * 1e3


def phase_kernels(torch, dev, device) -> list[dict]:
    from dsm_tpu_torch.ops.compact import compact_rows, compact_rows_plain

    rng = np.random.default_rng(2024)
    # rank: ~4M queries on the forward table, positions over [0, n_s]
    results = [occ_cum8_case(torch, dev, device, rng),
               phase_expand(torch, dev, device)]

    # compact: N = 2^23 rows, C in (2, 5, 6, 8), masks 0%, ~30%, 100%
    n = COMPACT_N
    times = {}
    for c in (2, 5, 6, 8):
        vals = torch.as_tensor(
            rng.integers(-2**31, 2**31, size=(n, c), dtype=np.int64)
            .astype(np.int32), device=device)
        for frac in (0.0, 0.3, 1.0):
            mask = torch.as_tensor(rng.random(n) < frac, device=device)
            k = int(mask.sum())
            got, gcnt = compact_rows(mask, vals, k)
            want, wcnt = compact_rows_plain(mask, vals, k)
            torch.cuda.synchronize()
            if int(gcnt) != int(wcnt) or not torch.equal(got, want):
                raise SystemExit(f"compact kernel disagrees with its plain "
                                 f"version at C={c} frac={frac}")
            if frac == 0.3 and c == 6:
                compact_edges(torch, mask, vals, k)
            if frac == 0.3:
                times[c] = (
                    cuda_ms(torch, lambda: compact_rows(mask, vals, k)),
                    cuda_ms(torch, lambda: compact_rows_plain(mask, vals, k)),
                    cuda_ms(torch, lambda: vals[mask]), k)
    for c, (km, pm, lm, _k) in times.items():
        log(f"kernel compact: N={n} C={c} 30% set: {km:.3f} ms vs plain "
            f"{pm:.3f} ms (values[mask] {lm:.3f} ms)")
    km, pm, lm, k = times[6]
    results.append(dict(
        name="compact_rows", route="cuda",
        source="dsm_tpu_torch/csrc/compact.cu",
        replaces="dsm_tpu/ops/pallas_compact.py:162", max_abs_err=0,
        ms=km, plain_ms=pm,
        # the mask and the kept rows in, the kept rows and the count out
        # (the rows that are dropped need not be read); a scan step and a
        # test a row
        **bound(n + 2 * k * 6 * 4 + 8, 2 * n), library_ms=lm))

    # segstats: ~4.2M pairs in nodes of 1..5 pairs (S = 5 samples; the
    # kernels line's entry), then about as many in nodes of 1..64 and
    # 1..273 pairs (the d = 64 and d = 273 collections)
    seg = [segstats_case(torch, label, device) for label in SEG_WIDTHS]
    return results + seg[:1] + phase_level_kernels(torch, device)


def occ_cum8_case(torch, dev, device, rng, device_time=False) -> dict:
    """The rank kernel's one-end entry (occ_cum8) against its plain version
    at RANK_Q queries on `dev`'s forward tables, their samples and
    positions drawn from `rng` (the end of every text among them), timed
    (also by the profiler's device time with `device_time`); -> its entry
    of the kernels line."""
    from dsm_tpu_torch.ops.rank import occ_cum8, occ_cum8_plain

    q = RANK_Q
    s = rng.integers(0, dev.S, size=q)
    pos = (rng.random(q) * (dev.ns[s] + 1)).astype(np.int64)
    s[:dev.S] = np.arange(dev.S)            # the end of every text
    pos[:dev.S] = dev.ns
    pos_t = torch.as_tensor(pos.astype(np.int32), device=device)
    soff_t = dev.soff[torch.as_tensor(s, device=device)]
    got = occ_cum8(dev.frows, pos_t, soff_t)
    want = occ_cum8_plain(dev.frows, pos_t, soff_t)
    torch.cuda.synchronize()
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    if err:
        raise SystemExit(f"rank kernel disagrees with its plain version "
                         f"(max abs err {err})")
    entry = dict(
        name="occ_cum8", route="cuda", source="dsm_tpu_torch/csrc/rank.cu",
        replaces="dsm_tpu/ops/rank.py:241", max_abs_err=err,
        ms=cuda_ms(torch, lambda: occ_cum8(dev.frows, pos_t, soff_t)),
        plain_ms=cuda_ms(torch,
                         lambda: occ_cum8_plain(dev.frows, pos_t, soff_t)),
        # the table rows these queries touch (128 B each) once, 8 B in and
        # 32 B out a query; ~60 integer operations a query
        **bound(128 * int(torch.unique((pos_t >> 7) + soff_t).numel())
                + q * (8 + 32), 60 * q), library_ms=None)
    if device_time:
        entry["device_ms"] = device_ms(
            torch, lambda: occ_cum8(dev.frows, pos_t, soff_t))
    log(f"kernel rank: Q={q} equal; {entry['ms']:.4f} ms vs plain "
        f"{entry['plain_ms']:.4f} ms (bound {entry['bound_ms']:.4f} ms)")
    return entry


def segstats_level(torch, label: str, device):
    """A synthetic level for the stats step (K2), made from a seed: ~4.2M
    pairs in nodes of `label` ("lo..hi") pairs, freq in 0..2999 (10% 0);
    -> (nb, freq, cact, gates), the entropy window around the middle of
    these nodes' entropies."""
    from dsm_tpu_torch.ops.segstats import Gates

    lo, hi = map(int, label.split(".."))
    rng = np.random.default_rng(900 + hi)
    sizes = rng.integers(lo, hi + 1, size=SEG_NODES if hi <= 5
                         else 2 * 3 * SEG_NODES // (lo + hi))
    nb = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    p, s = int(nb[-1]), max(5, hi)
    freq = rng.integers(0, 3000, size=p)
    freq[rng.random(p) < 0.1] = 0
    cact = (rng.integers(0, 16, size=p) * (freq > 0)).astype(np.uint8)
    g = Gates(depth=7, s_total=s, mindepth=0, pmin=2, pmax=0,
              use_egate=True, sym_mask=0b1111, emin_lo=-0.01,
              emax_hi=EMAX + 0.01 if s == 5 else float(np.log2(s)) - 1.0)
    return (torch.as_tensor(nb, device=device),
            torch.as_tensor(freq.astype(np.int32), device=device),
            torch.as_tensor(cact, device=device), g)


def segstats_case(torch, label: str, device) -> dict:
    """The stats step (K2) against its plain version on `segstats_level`'s
    level: one launch; flags, pair_out and the level's counts equal, the
    entropy and its range within ENT_TOL; timed; -> its entry of the
    kernels line."""
    from dsm_tpu_torch.ops import _build
    from dsm_tpu_torch.ops.segstats import (S_ENT_MIN, segstats,
                                            segstats_plain)

    args = segstats_level(torch, label, device)
    u, p = args[0].shape[0] - 1, args[1].shape[0]
    before = _build.LAUNCHES["segstats"]
    fk, ek, pk, sk = segstats(*args)
    launched = _build.LAUNCHES["segstats"] - before
    fp, ep, pp, sp = segstats_plain(*args)
    torch.cuda.synchronize()
    eerr = float((ek - ep).abs().max())
    got, want = sk.tolist(), sp.tolist()
    rerr = max(abs(a - b) if a != b else 0.0
               for a, b in zip(got[S_ENT_MIN:], want[S_ENT_MIN:]))
    if launched != 1 or not (torch.equal(fk, fp) and torch.equal(pk, pp)) \
            or got[:S_ENT_MIN] != want[:S_ENT_MIN] \
            or max(eerr, rerr) > ENT_TOL:
        raise SystemExit(f"segstats kernel disagrees with its plain version "
                         f"({label} pairs a node: {launched} launches, "
                         f"entropy max abs err {eerr}, sums {got} vs {want})")
    entry = dict(
        name="segstats", route="cuda", source="dsm_tpu_torch/csrc/segstats.cu",
        replaces="dsm_tpu/mining/engine_device.py:726",
        max_abs_err=max(eerr, rerr),
        ms=cuda_ms(torch, lambda: segstats(*args)),
        plain_ms=cuda_ms(torch, lambda: segstats_plain(*args)),
        # nb, freq, cact in; flags, entropy, pair_out and the six sums out;
        # ~6 f64 operations a pair (one of them a log) and ~6 a node
        **bound(4 * (u + 1) + 5 * p + 12 * u + p + 48, 6 * p + 6 * u,
                F64_TOPS), library_ms=None)
    log(f"kernel segstats: {label} pairs a node, U={u:,} P={p:,}: one "
        f"launch, equal (entropy err {eerr:.3g}, its range {rerr:.3g}; "
        f"sums {json.dumps(got)}); {entry['ms']:.4f} ms vs plain "
        f"{entry['plain_ms']:.4f} ms (bound {entry['bound_ms']:.4f} ms); "
        f"device {fmt_ms(device_ms(torch, lambda: segstats(*args)))}")
    return entry


def widest_state(dev):
    """The widest level of a mine over `dev`'s tables, made on the card by
    the port's own level loop (`_seed_episode`, `_level`; the staged rows
    are dropped, not drained) -> (its pair rows, its node starts nb, its
    depth)."""
    from dsm_tpu_torch.mining.config import MiningConfig
    from dsm_tpu_torch.mining.engine_device import (FLAG_DONE, FLAG_HISTFULL,
                                                    FLAG_TAIL, _hist_cap,
                                                    _level, _Scalars,
                                                    _seed_episode)

    sc = _Scalars.build(MiningConfig(fmin=FMIN, emax=EMAX))
    st = _seed_episode(dev, _hist_cap(dev))
    best = (st.pairs, st.nb, 0)
    while True:
        flag = _level(dev, sc, st)
        if flag == FLAG_HISTFULL:
            st.hist_len, st.lvl_off = 0, []
            continue
        st.out, st.ocount = [], 0
        if st.npairs > best[0].shape[0]:
            best = (st.pairs, st.nb, st.depth)
        if flag in (FLAG_DONE, FLAG_TAIL):
            return best


def synthetic_pairs(torch, dev, gen, p: int, share: float):
    """(p, 6) int32 pair rows over the card's tables, their samples drawn
    at random: lo uniform in the text, hi in lo's table row for a `share`
    of the pairs (a uniform end up to the row's end or n) and up to 4,000
    symbols past the next row's start for the rest, clipped to n."""
    device = dev.frows.device
    sid = torch.randint(0, dev.S, (p,), device=device, generator=gen)
    n = torch.as_tensor(dev.ns, device=device)[sid]
    u = torch.rand((2, p), device=device, generator=gen, dtype=torch.float64)
    lo = (u[0] * (n + 1)).to(torch.int64)
    row_end = torch.minimum(n, lo | 127)
    near = lo + (u[1] * (row_end - lo + 1)).to(torch.int64)
    far = torch.minimum(n, (lo & ~127) + 128 + torch.randint(
        0, 4000, (p,), device=device, generator=gen))
    same = torch.rand(p, device=device, generator=gen) < share
    pairs = torch.randint(0, 1 << 20, (p, 6), dtype=torch.int32,
                          device=device, generator=gen)
    pairs[:, 0], pairs[:, 1] = lo, torch.where(same, near, far)
    pairs[:, 3], pairs[:, 4] = sid, dev.soff[sid]
    return pairs


def expand_case(torch, dev, pairs, label: str):
    """The expand entry of the rank kernel against expand_plain on `pairs`
    (fmin FMIN, all symbols), timed; -> (its entry of the kernels line, the
    share of pairs with both ends in one table row)."""
    from dsm_tpu_torch.ops.rank import expand, expand_plain

    args = (dev.frows, pairs, FMIN, 0b1111)
    got, want = expand(*args), expand_plain(*args)
    torch.cuda.synchronize()
    if not all(g.dtype == w.dtype and torch.equal(g, w)
               for g, w in zip(got, want)):
        raise SystemExit(f"expand disagrees with its plain version ({label})")
    p = pairs.shape[0]
    blo = (pairs[:, 0] >> 7) + pairs[:, 4]
    bhi = (pairs[:, 1] >> 7) + pairs[:, 4]
    share = float((blo == bhi).double().mean())
    rows = int(torch.unique(torch.cat([blo, bhi])).numel())
    # the pair rows in (every 32-byte sector holds a needed word), each
    # table row touched once, 64 B of ranks, freq, keepc and cbits out a
    # pair; ~120 integer operations a pair
    entry = dict(
        name="expand", route="cuda", source="dsm_tpu_torch/csrc/rank.cu",
        replaces="dsm_tpu/mining/engine_device.py:714", max_abs_err=0,
        ms=cuda_ms(torch, lambda: expand(*args)),
        plain_ms=cuda_ms(torch, lambda: expand_plain(*args)),
        **bound(24 * p + 128 * rows + (64 + 4 + 4 + 1) * p, 120 * p),
        library_ms=None)
    log(f"kernel expand: {label}: P={p:,}, {share:.1%} of the pairs with "
        f"both ends in one table row, {rows:,} table rows touched; equal; "
        f"{entry['ms']:.4f} ms vs plain {entry['plain_ms']:.4f} ms (bound "
        f"{entry['bound_ms']:.4f} ms by {entry['bound_by']})")
    return entry, share


def expand_tables_case(torch, dev, pairs, bounds, label: str) -> dict:
    """The expand step over shard tables (ops/rank.expand_tables, the
    sharded level's form) on `pairs` of the stacked tables `dev`: the
    shards [bounds[k], bounds[k+1]) as row slices of its tables, each
    pair's offset made one into its own shard's; against the plain version
    and the one-table expand of the same pairs, all outputs equal; timed
    (the one-table expand beside it) -> its entry of the kernels line."""
    from dsm_tpu_torch.ops.rank import (expand, expand_tables,
                                        expand_tables_plain)

    rows_total = dev.frows.shape[0]
    starts = [int(dev.soff[b]) if b < dev.S else rows_total for b in bounds]
    tables = [(dev.frows[a:b], int(lo))
              for a, b, lo in zip(starts[:-1], starts[1:], bounds[:-1])]
    shard = torch.searchsorted(
        torch.tensor(bounds[:-1], dtype=torch.int32, device=pairs.device),
        pairs[:, 3].contiguous(), right=True) - 1
    local = pairs.clone()
    local[:, 4] -= torch.tensor(starts[:-1], dtype=torch.int32,
                                device=pairs.device)[shard]
    args = (tables, local, FMIN, 0b1111)
    got, want = expand_tables(*args), expand_tables_plain(*args)
    one = expand(dev.frows, pairs, FMIN, 0b1111)
    torch.cuda.synchronize()
    if not all(g.dtype == w.dtype and torch.equal(g, w) and torch.equal(g, o)
               for g, w, o in zip(got, want, one)):
        raise SystemExit(f"expand_tables disagrees with its plain version or "
                         f"with the one-table expand ({label})")
    p, n = pairs.shape[0], len(tables)
    blo = (pairs[:, 0] >> 7) + pairs[:, 4]
    bhi = (pairs[:, 1] >> 7) + pairs[:, 4]
    rows = int(torch.unique(torch.cat([blo, bhi])).numel())
    entry = dict(
        name="expand_tables", route="cuda",
        source="dsm_tpu_torch/csrc/rank.cu",
        replaces="dsm_tpu/mining/engine_device.py:409", max_abs_err=0,
        ms=cuda_ms(torch, lambda: expand_tables(*args)),
        plain_ms=cuda_ms(torch, lambda: expand_tables_plain(*args), 3),
        # expand's bytes and operations, and a bisection of the n bases a
        # pair (a compare and a select a step)
        **bound(24 * p + 128 * rows + (64 + 4 + 4 + 1) * p,
                (120 + 2 * max(1, (n - 1).bit_length())) * p),
        library_ms=None,
        device_ms=device_ms(torch, lambda: expand_tables(*args)))
    one_ms = cuda_ms(torch, lambda: expand(dev.frows, pairs, FMIN, 0b1111))
    log(f"kernel expand_tables: {label}: P={p:,} over {n} shard tables, "
        f"{rows:,} table rows touched; equal to the plain version and to "
        f"the one-table expand; {entry['ms']:.4f} ms (device "
        f"{fmt_ms(entry['device_ms'])}) vs the one-table expand "
        f"{one_ms:.4f} ms, plain {entry['plain_ms']:.4f} ms (bound "
        f"{entry['bound_ms']:.4f} ms by {entry['bound_by']})")
    return entry


def phase_expand(torch, dev, device) -> dict:
    """The level's expand step (K1's expand entry) at the widest level of
    the real scale-100 mine (and its expand_tables entry there over 1 and 2
    shard tables) and on a synthetic level of SEG_NODES nodes of 1..5 pairs
    (~4.2M) whose share of pairs with both ends in one table row is the
    real level's; -> the synthetic level's entry."""
    pairs, _nb, depth = widest_state(dev)
    _entry, share = expand_case(
        torch, dev, pairs, f"the widest level of the mine (depth {depth})")
    # the sharded level's expand over the tables of 1 and 2 shards (the
    # 2-shard mesh's [0, 2) and [2, 5))
    for bounds in ((0, dev.S), (0, 2 * dev.S // 5, dev.S)):
        expand_tables_case(torch, dev, pairs, bounds,
                           f"the widest level of the mine (depth {depth})")
    gen = torch.Generator(device=device)
    gen.manual_seed(2030)
    sizes = torch.randint(1, 6, (SEG_NODES,), device=device, generator=gen)
    synth = synthetic_pairs(torch, dev, gen, int(sizes.sum()), share)
    return expand_case(torch, dev, synth, "synthetic level")[0]


def real_drain_rows(torch, idxs, dev, device) -> dict:
    """The staged output rows that each drain of the scale-100 mine hands
    its leftChar (`engine_device.leftchar_rows` wrapped to keep a copy),
    ascending and gnu -> {order: [rows, ...]}."""
    from dsm_tpu_torch.mining import engine_device as ed
    from dsm_tpu_torch.mining.engine import MiningConfig, mine_torch

    kept = {}
    orig = ed.leftchar_rows

    def keeping(tables, orows, out=None):
        kept[order].append(orows.clone())
        return orig(tables, orows, out)

    ed.leftchar_rows = keeping
    try:
        for order in ("ascending", "gnu"):
            kept[order] = []
            mine_torch(idxs, MiningConfig(fmin=FMIN, emax=EMAX), dev=dev,
                       device=device, reader_order=order)
    finally:
        ed.leftchar_rows = orig
    return kept


def leftchar_case(torch, tables, orows, label: str, plain=True):
    """The leftChar entry against its plain version on `orows` over
    `tables`, timed by events and by the profiler's device time; -> (its
    entry of the kernels line, the codes)."""
    from dsm_tpu_torch.mining.engine import leftchar_rows, leftchar_rows_plain

    got = leftchar_rows(tables, orows)
    want = leftchar_rows_plain(tables, orows)
    torch.cuda.synchronize()
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) \
        if orows.shape[0] else 0
    if err or not torch.equal(got, want):
        raise SystemExit(f"leftchar disagrees with its plain version "
                         f"({label}: max abs err {err})")
    n = orows.shape[0]
    # the reverse-table rows both ends touch, shard by shard
    touched = 0
    bases = torch.tensor([int(b) for _r, _s, b in tables], device=orows.device,
                         dtype=torch.int32)
    shard = torch.searchsorted(bases, orows[:, 2].contiguous(),
                               right=True) - 1
    for k, (_rrows, soff, base) in enumerate(tables):
        mine = orows[shard == k]
        so = soff[(mine[:, 2] - int(base)).to(torch.int64)].to(torch.int64)
        lo = mine[:, 1].to(torch.int64)
        hi = lo + mine[:, 0].to(torch.int64)
        touched += int(torch.unique(torch.cat([(lo >> 7) + so,
                                               (hi >> 7) + so])).numel())
    soffs = sum(int(t[1].numel()) for t in tables)
    entry = dict(
        name="leftchar", route="cuda", source="dsm_tpu_torch/csrc/rank.cu",
        replaces="dsm_tpu/mining/engine_device.py:1077", max_abs_err=err,
        ms=cuda_ms(torch, lambda: leftchar_rows(tables, orows), 20),
        device_ms=device_ms(torch, lambda: leftchar_rows(tables, orows)),
        plain_ms=(cuda_ms(torch, lambda: leftchar_rows_plain(tables, orows))
                  if plain else None),
        # the 12 needed bytes of a 20-byte row (freq, rlo, sid), each
        # reverse-table row both ends touch once, the soff entries, one
        # byte out; ~140 integer operations a row (two ends and the select)
        **bound(12 * n + 128 * touched + 4 * soffs + n, 140 * n),
        library_ms=None)
    log(f"kernel leftchar: {label}: n={n:,} rows over {len(tables)} "
        f"table(s), {touched:,} reverse-table rows touched; equal; "
        f"{entry['ms']:.4f} ms (device {fmt_ms(entry['device_ms'])}) vs "
        f"plain {fmt_ms(entry['plain_ms'])} (bound {entry['bound_ms']:.4f} "
        f"ms by {entry['bound_by']})")
    return entry, got


def phase_leftchar(torch, idxs, dev, device) -> dict:
    """The drain's leftChar (the rank kernel's leftChar entry, K5) on the
    real drains' rows of the scale-100 mine (ascending and gnu), on every
    pair of its widest level staged as output rows, and over 2 and 5 shard
    tables of the same samples (codes equal to one table's); -> the entry
    of the largest ascending drain."""
    from dsm_tpu_torch.ops.compact import stage_rows
    from dsm_tpu_torch.parallel.engine_sharded import ShardedIndexes
    from dsm_tpu_torch.parallel.multihost import global_samples_mesh

    one = [(dev.rrows, dev.soff, 0)]
    drains = real_drain_rows(torch, idxs, dev, device)
    log("leftchar: the real drains' rows, ascending "
        f"{[r.shape[0] for r in drains['ascending']]}, gnu "
        f"{[r.shape[0] for r in drains['gnu']]}")
    entry = None
    for order, rows_list in drains.items():
        orows = max(rows_list, key=lambda r: r.shape[0])
        e, _codes = leftchar_case(torch, one, orows, f"the {order} drain")
        entry = entry or e
    pairs, _nb, depth = widest_state(dev)
    p = pairs.shape[0]
    wide = stage_rows(torch.ones(p, dtype=torch.bool, device=device), pairs,
                      depth, p)[0]
    _e, want = leftchar_case(torch, one, wide,
                             f"every pair of the widest level (depth "
                             f"{depth}) staged")
    for n in (2, 5):
        sh = ShardedIndexes.build(idxs, global_samples_mesh(n, device))
        tables = [(sd.rrows, sd.soff, sh.base(j))
                  for j, sd in enumerate(sh.shards)]
        _e, got = leftchar_case(torch, tables, wide,
                                f"the widest level over {n} shard tables",
                                plain=False)
        if not torch.equal(got, want):
            raise SystemExit(f"leftchar over {n} shard tables disagrees "
                             "with one table's codes")
        del sh, tables
    return entry


def compact_edges(torch, mask, vals, k: int) -> None:
    """The one-pass compaction where the main path does not go: width
    below the count (the count is still the total), a mask that starts
    at an odd byte, and width above the count into an output that held
    garbage (the kernel zeroes the tail; the whole output is compared)."""
    from dsm_tpu_torch.ops.compact import compact_rows, compact_rows_plain

    c = vals.shape[1]
    odd = torch.cat([mask[:5], mask])[5:]
    if odd.data_ptr() % 16 == 0 or not odd.is_contiguous():
        raise SystemExit("compact: the mask view is not unaligned")
    for label, m, width in (("width < count", mask, k // 2),
                            ("unaligned mask", odd, k),
                            ("zeroed tail", mask, k + 100_003)):
        junk = torch.full((width, c), -0x5A5A5A5B, dtype=torch.int32,
                          device=vals.device)
        torch.cuda.synchronize()
        del junk         # the wrapper's torch.empty takes this block again
        got, gcnt = compact_rows(m, vals, width)
        want, wcnt = compact_rows_plain(m, vals, width)
        torch.cuda.synchronize()
        if int(gcnt) != int(wcnt) or int(gcnt) != k \
                or not torch.equal(got, want):
            raise SystemExit(f"compact kernel disagrees with its plain "
                             f"version ({label})")
    log(f"kernel compact: N={vals.shape[0]} C={c}: width < count, an "
        f"unaligned mask and the zeroed tail equal")


def synthetic_level(torch, gen, sizes, device):
    """A level whose node u holds sizes[u] pairs: nb, the pair rows (their
    node in the last column), rank outputs with ohi >= olo; -> (nb, pairs,
    olo, ohi, P)."""
    i32 = dict(dtype=torch.int32, device=device, generator=gen)
    w = sizes.shape[0]
    nb = torch.zeros(w + 1, dtype=torch.int32, device=device)
    nb[1:] = torch.cumsum(sizes, 0)
    p = int(nb[-1])
    pairs = torch.randint(-2**31, 2**31 - 1, (p, 6), **i32)
    pairs[:, 5] = torch.repeat_interleave(
        torch.arange(w, dtype=torch.int32, device=device),
        sizes.to(torch.int64))
    olo = torch.randint(-2**31, 2**31 - 5000, (8, p), **i32)
    ohi = olo + torch.randint(0, 5000, (8, p), **i32)
    return nb, pairs, olo, ohi, p


def lane_bytes(keep) -> int:
    """The bytes that the children step must move for the lanes of a (4, P)
    keep mask: the mask, the 24-byte row of every pair that keeps a lane,
    the four rank outputs (16 B) of a kept lane in and its 24-byte row out.
    The rank outputs of the lanes that are dropped need not be read."""
    p, kept = keep.shape[1], int(keep.sum())
    return 4 * p + 24 * int(keep.any(0).sum()) + (16 + 24) * kept


def level_sizes(torch, gen, label: str, device):
    """Node sizes of the children cases: `lo..hi` pairs a node, as many
    nodes as give ~SEG_NODES * 3 pairs."""
    lo, hi = map(int, label.split(".."))
    nodes = SEG_NODES if hi <= 5 else 2 * 3 * SEG_NODES // (lo + hi)
    return torch.randint(lo, hi + 1, (nodes,), dtype=torch.int32,
                         device=device, generator=gen)


def trie_history(torch, gen, levels: int, width: int, device):
    """A trie-shaped parent-pointer history on the card: the base holds
    `width` nodes and each node has 0-4 children (1 on average) with
    distinct ascending symbols, numbered in (parent, symbol) order as the
    children step numbers them; -> (hist, lvl_off, the top level's
    width)."""
    probs = torch.tensor([0.5, 0.2, 0.15, 0.1, 0.05], device=device)
    parts, offs, off, wid = [], [], 0, width
    for _ in range(levels):
        kids = torch.multinomial(probs, wid, replacement=True, generator=gen)
        kids[0] = kids[0].clamp(min=1)
        parent = torch.repeat_interleave(
            torch.arange(wid, device=device), kids)
        within = torch.arange(parent.shape[0], device=device) \
            - (torch.cumsum(kids, 0) - kids)[parent]
        shift = (torch.rand(wid, generator=gen, device=device)
                 * (5 - kids)).to(torch.int64)
        parts.append((parent * 4 + within + shift[parent]).to(torch.int32))
        offs.append(off)
        off += parent.shape[0]
        wid = parent.shape[0]
    return (torch.cat(parts),
            torch.tensor(offs, dtype=torch.int32, device=device), wid)


def distinct_ancestors(torch, hist, lvl_off, rows, jrel, maxj: int) -> int:
    """The distinct (level, node) entries the rows' walks read: the least
    history words a decode must fetch."""
    r, n = rows.to(torch.int64), 0
    for lev in range(maxj, 0, -1):
        take = jrel >= lev
        n += int(torch.unique(r[take]).numel())
        e = hist[torch.where(take, r + int(lvl_off[lev - 1]), 0)]
        r = torch.where(take, (e >> 2).to(torch.int64), r)
    return n


def decode_inputs(torch, gen, device):
    """K6's synthetic inputs, made on the card from `gen`: DEC_LEVELS
    levels of SEG_NODES nodes whose parents are drawn at random in the
    level before (SEG_NODES rows at the top, drawn at random, walk all of
    them), then a history of the same size shaped as a trie (rows 0..w'-1
    at the top, children numbered in (parent, symbol) order); yields
    (label, (hist, lvl_off, rows, jrel, maxj))."""
    w = SEG_NODES
    i32 = dict(dtype=torch.int32, device=device, generator=gen)
    hist = (torch.randint(0, w, (DEC_LEVELS * w,), **i32) * 4
            + torch.randint(0, 4, (DEC_LEVELS * w,), **i32))
    lvl_off = torch.arange(0, DEC_LEVELS * w, w, dtype=torch.int32,
                           device=device)
    yield "random history", (
        hist, lvl_off, torch.randint(0, w, (w,), **i32),
        torch.full((w,), DEC_LEVELS, dtype=torch.int32, device=device),
        DEC_LEVELS)
    hist, lvl_off, top = trie_history(torch, gen, DEC_LEVELS, w, device)
    yield "trie-shaped history", (
        hist, lvl_off, torch.arange(top, dtype=torch.int32, device=device),
        torch.full((top,), DEC_LEVELS, dtype=torch.int32, device=device),
        DEC_LEVELS)


def decode_case(torch, label: str, args) -> dict:
    """The decode kernel (K6) against its plain version on `args` (hist,
    lvl_off, rows, jrel, maxj), timed; -> its entry of the kernels line,
    bound by the bytes the walks need: 4 a distinct ancestor a level (the
    bound by 4 a row a level, which charges a word each walk reads again,
    is logged beside it)."""
    from dsm_tpu_torch.ops.decode import decode, decode_plain

    hist, lvl_off, rows, jrel, maxj = args
    (kb, ks), (pb, ps) = decode(*args), decode_plain(*args)
    torch.cuda.synchronize()
    if not (torch.equal(kb, pb) and torch.equal(ks, ps)):
        raise SystemExit(f"decode kernel disagrees with its plain version "
                         f"({label})")
    m, steps = rows.shape[0], int(jrel.to(torch.int64).sum())
    words = distinct_ancestors(torch, hist, lvl_off, rows, jrel, maxj)
    # rows and jrel in, one 4-byte history entry a distinct ancestor a
    # level (or a row a level), the base and maxj symbol bytes a row out
    entry = dict(
        name="decode", route="cuda", source="dsm_tpu_torch/csrc/decode.cu",
        replaces="dsm_tpu/mining/engine_device.py:990", max_abs_err=0,
        ms=cuda_ms(torch, lambda: decode(*args)),
        plain_ms=cuda_ms(torch, lambda: decode_plain(*args)),
        **bound(m * (8 + 4 + maxj) + 4 * words, 3 * steps), library_ms=None)
    by_rows = bound(m * (8 + 4 + maxj) + 4 * steps, 3 * steps)["bound_ms"]
    log(f"kernel decode: {label}, m={m:,} rows, maxj {maxj}, {steps:,} "
        f"steps, {words:,} distinct ancestors ({words / max(steps, 1):.4f} a "
        f"step): equal; events {entry['ms']:.4f} ms vs plain "
        f"{entry['plain_ms']:.4f} ms; device "
        f"{fmt_ms(device_ms(torch, lambda: decode(*args)))}; bound "
        f"{entry['bound_ms']:.4f} ms by distinct ancestors, {by_rows:.4f} ms "
        f"by rows")
    return entry


def phase_level_kernels(torch, device) -> list[dict]:
    """K6 (decode) and K3 (children) against their plain versions on
    SEG_NODES-wide synthetic levels, made on the card from a seed."""
    from dsm_tpu_torch.ops.children import children, children_plain

    gen = torch.Generator(device=device)
    gen.manual_seed(2027)
    # decode: the random history's entry goes into the kernels line
    results = [decode_case(torch, label, args)
               for label, args in decode_inputs(torch, gen, device)][:1]

    # children: nodes of 1..5 pairs (the table's row; ~30% of the lanes
    # kept under the full symbol mask and under G alone), then the same
    # ~4.2M pairs in nodes of 1..64 and 1..273 pairs (wider collections),
    # nodes of 0..5 pairs (a sixth hold none) and a level that keeps nothing
    sym = torch.arange(4, device=device)[:, None]
    for sizes_label, label, frac, only in (
            ("1..5", "all symbols", 0.3, None), ("1..5", "G alone", 0.3, 2),
            ("1..64", "d = 64", 0.3, None), ("1..273", "d = 273", 0.3, None),
            ("0..5", "nodes without a pair", 0.3, None),
            ("1..5", "nothing kept", 0.0, None)):
        sizes = level_sizes(torch, gen, sizes_label, device)
        nb, pairs, olo, ohi, p = synthetic_level(torch, gen, sizes, device)
        u = sizes.shape[0]
        mask = torch.rand((4, p), generator=gen, device=device) < frac
        if only is not None:
            mask &= sym == only
        lane = pairs[:, 5].to(torch.int64) * 4 + sym
        pair_count = int(mask.sum())
        child_total = int(torch.unique(lane[mask]).numel())
        hk = torch.full((child_total,), -1, dtype=torch.int32, device=device)
        hp = hk.clone()
        cargs = (nb, pairs, olo, ohi, mask, pair_count, child_total)
        (kr, kn), (pr_, pn) = children(*cargs, hk), children_plain(*cargs, hp)
        torch.cuda.synchronize()
        if not (torch.equal(kr, pr_) and torch.equal(kn, pn)
                and torch.equal(hk, hp)):
            raise SystemExit(f"children kernel disagrees with its plain "
                             f"version ({sizes_label} pairs a node, {label})")
        ms = cuda_ms(torch, lambda: children(*cargs, hk))
        plain_ms = cuda_ms(torch, lambda: children_plain(*cargs, hp))
        # nb in, the lanes' bytes, nb_next and the history entries out
        bnd = bound(4 * (u + 1) + lane_bytes(mask) + 4 * (child_total + 1)
                    + 4 * child_total, 16 * p)
        log(f"kernel children: U={u:,} P={p:,} {sizes_label} pairs a node, "
            f"{label}: {pair_count:,} lanes kept, {child_total:,} children, "
            f"equal; {ms:.4f} ms vs plain {plain_ms:.4f} ms (bound "
            f"{bnd['bound_ms']:.4f} ms)")
        if label == "all symbols":
            results.append(dict(
                name="children", route="cuda",
                source="dsm_tpu_torch/csrc/children.cu",
                replaces="dsm_tpu/mining/engine_device.py:789",
                max_abs_err=0, ms=ms, plain_ms=plain_ms, **bnd,
                library_ms=None))
            results.append(stage_rows_check(torch, gen, pairs))
        if label.startswith("d = "):
            outside_ids_check(torch, gen, label, nb, pairs, olo, ohi, mask)
    return results


def stage_rows_check(torch, gen, pairs) -> dict:
    """The emit entry of the compaction kernel against its plain version on
    the children case's pair rows, 0.1% (a level's emit) and 30% of them
    marked; -> its entry of the kernels line, at 0.1%."""
    from dsm_tpu_torch.ops.compact import stage_rows, stage_rows_plain

    p, depth, entry = pairs.shape[0], 23, None
    for frac in (0.001, 0.3):
        mark = torch.rand(p, generator=gen, device=pairs.device) < frac
        k = int(mark.sum())
        for width in (k, k // 2):
            got, gcnt = stage_rows(mark, pairs, depth, width)
            want, wcnt = stage_rows_plain(mark, pairs, depth, width)
            torch.cuda.synchronize()
            if int(gcnt) != int(wcnt) or not torch.equal(got, want):
                raise SystemExit(f"stage_rows disagrees with its plain "
                                 f"version ({frac:.1%} marked, width {width})")
        ms = cuda_ms(torch, lambda: stage_rows(mark, pairs, depth, k))
        plain_ms = cuda_ms(torch,
                           lambda: stage_rows_plain(mark, pairs, depth, k))
        # the mask and the marked pairs' rows in, 20 B a row and the count
        # out; a scan step and a test a pair
        bnd = bound(p + k * (24 + 20) + 8, 2 * p)
        dms = device_ms(torch, lambda: stage_rows(mark, pairs, depth, k))
        log(f"kernel stage_rows: P={p:,} {frac:.1%} marked ({k:,} rows) "
            f"equal; events {ms:.4f} ms (device {fmt_ms(dms)}: the memset "
            f"and the kernel) vs plain {plain_ms:.4f} ms (bound "
            f"{bnd['bound_ms']:.4f} ms)")
        entry = entry or dict(
            name="stage_rows", route="cuda",
            source="dsm_tpu_torch/csrc/compact.cu",
            replaces="dsm_tpu/mining/engine_device.py:858", max_abs_err=0,
            ms=ms, plain_ms=plain_ms, **bnd, library_ms=None)
    return entry


def outside_ids_check(torch, gen, label, nb, pairs, olo, ohi, keep) -> None:
    """K9c on a synthetic level as one shard of a sharded one: a tenth of
    the (node, symbol) children exist only on other shards."""
    from dsm_tpu_torch.ops.children import children_ids, children_ids_plain

    device, u = pairs.device, nb.shape[0] - 1
    exists = torch.rand((u, 4), generator=gen, device=device) < 0.1
    c, at = torch.nonzero(keep, as_tuple=True)
    exists[pairs[at, 5].to(torch.int64), c] = True
    nchild = exists.sum(1)
    kid0 = (torch.cumsum(nchild, 0) - nchild).to(torch.int32)
    flags = ((exists.to(torch.int32) << torch.arange(
        4, device=device, dtype=torch.int32)).sum(1, dtype=torch.int32) << 4) | 5
    cargs = (nb, pairs, olo, ohi, keep, flags, kid0, int(keep.sum()),
             int(nchild.sum()))
    (kr, kn), (pr_, pn) = children_ids(*cargs), children_ids_plain(*cargs)
    torch.cuda.synchronize()
    if not (torch.equal(kr, pr_) and torch.equal(kn, pn)):
        raise SystemExit(f"children_ids disagrees with its plain version "
                         f"({label})")
    log(f"kernel children_ids: {label}, U={u:,} P={pairs.shape[0]:,}: "
        f"{cargs[7]:,} lanes kept into {cargs[8]:,} children, equal; "
        f"{cuda_ms(torch, lambda: children_ids(*cargs)):.4f} ms vs plain "
        f"{cuda_ms(torch, lambda: children_ids_plain(*cargs)):.4f} ms")


def sharded_level(torch, gen, device):
    """A level of SEG_NODES nodes over S = 5 samples (each node holds 1..5
    of them, one sample at least), made on the card from `gen`: (nid,
    sid, freq, cbits) of its pairs in (node, sample) order, freq in
    0..2999 (10% 0)."""
    i32 = dict(dtype=torch.int32, device=device, generator=gen)
    U, S = SEG_NODES, 5
    member = torch.rand((U, S), generator=gen, device=device) < 0.5
    member[torch.arange(U, device=device),
           torch.randint(0, S, (U,), device=device, generator=gen)] = True
    nid, sid = torch.nonzero(member, as_tuple=True)
    p = nid.shape[0]
    freq = torch.randint(0, 3000, (p,), **i32)
    freq[torch.rand(p, generator=gen, device=device) < 0.1] = 0
    cbits = (torch.randint(0, 16, (p,), **i32) * (freq > 0)).to(torch.uint8)
    return nid, sid, freq, cbits


def split_level(torch, level, bounds, nodes: int = SEG_NODES):
    """A level of `nodes` nodes (`sharded_level`'s) cut into the sample
    shards [bounds[k], bounds[k+1]): per shard (nb, nid, sid, freq, cbits),
    its pairs in (node, sample) order."""
    nid, sid, freq, cbits = level
    shards = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        own = (sid >= lo) & (sid < hi)
        nb = torch.zeros(nodes + 1, dtype=torch.int32, device=nid.device)
        nb[1:] = torch.cumsum(torch.bincount(nid[own], minlength=nodes), 0)
        shards.append((nb, nid[own], sid[own], freq[own], cbits[own]))
    return shards


def one_list(torch, shards):
    """A split level's shards (`split_level`'s) as one process's pair list:
    (nb, freq, cbits) in (node, sample) order, the nb of all its shards'
    pairs."""
    nb = sum(sh[0] for sh in shards)
    nid = torch.cat([sh[1] for sh in shards])
    sid = torch.cat([sh[2] for sh in shards])
    order = torch.argsort(nid.to(torch.int64) * (1 << 20) + sid)
    return (nb, torch.cat([sh[3] for sh in shards])[order].contiguous(),
            torch.cat([sh[4] for sh in shards])[order].contiguous())


def shardstats_calls(torch, shards, g, ocounts):
    """The package's K9a and K9b on a split level, whichever of their
    signatures it has: (its K9a launches, one over the process's one pair
    list where K9b takes one list's (nb, P, ocount), else one a shard,
    writing or adding into one row a node the rows that the K9b call
    reads; one K9b call, with the torch glue of the sharded level that a
    level runs between it and its readback where the package's K9b leaves
    that to torch: the per-shard gather of the pair gates, the kept and
    gated sums, the staged maximum and the entropy range).  Timing only:
    `level_times` runs it in another tree of the repo too."""
    import inspect

    from dsm_tpu_torch.ops import shardstats as ss

    device, n = shards[0][0].device, len(shards)
    U = shards[0][0].shape[0] - 1
    parts = torch.empty((n, U, ss.PART_COLS), dtype=torch.int64,
                        device=device)
    hist = torch.empty(4 * U, dtype=torch.int32, device=device)
    params = inspect.signature(ss.node_gates).parameters
    if "nb" in params:
        nb, freq, cbits = one_list(torch, shards)
        vals = ss.level_values(device)
        part = parts[0]
        return (lambda: ss.shard_partials(nb, freq, cbits, g.sym_mask, part,
                                          ss.kept_slot(vals)),
                lambda: ss.node_gates(part, g, hist, nb, freq.shape[0],
                                      max(ocounts), vals))
    if "shards" in params:
        vals = ss.level_values(n, device)
        table = [(nb, nid.shape[0], oc)
                 for (nb, nid, _s, _f, _c), oc in zip(shards, ocounts)]
        # where K9a can add the shards' rows into one row a node, as the
        # episode then does, K9b reads that one row
        one = "accumulate" in inspect.signature(
            ss.shard_partials).parameters
        rows = parts[:1] if one else parts

        def k9a():
            for k, (nb, _nid, _sid, freq, cbits) in enumerate(shards):
                kw = dict(accumulate=k > 0) if one else {}
                ss.shard_partials(nb, freq, cbits, g.sym_mask,
                                  rows[0] if one else parts[k],
                                  ss.kept_slot(vals, k), **kw)

        return k9a, lambda: ss.node_gates(rows, g, hist, table, vals)

    # the other signature: the level's glue as its engine ran it
    sym = torch.arange(4, device=device, dtype=torch.int32)[:, None]
    glue = []
    for nb, nid, _sid, _freq, cbits in shards:
        pairs = torch.zeros((nid.shape[0], 6), dtype=torch.int32,
                            device=device)
        pairs[:, 5] = nid.to(torch.int32)
        keepc = ((cbits.to(torch.int32)[None, :] >> sym) & 1
                 & ((g.sym_mask >> sym) & 1)) > 0
        glue.append((pairs, keepc))
    emin0 = torch.tensor(np.inf, dtype=torch.float64, device=device)
    emax0 = torch.tensor(-np.inf, dtype=torch.float64, device=device)

    def k9a():
        for k, (nb, _nid, _sid, freq, cbits) in enumerate(shards):
            ss.shard_partials(nb, freq, cbits, parts[k])

    def k9b():
        flags, ent, _kid0, counts = ss.node_gates(parts, g, hist)
        gated = (flags & 4) != 0
        sums = []
        for pairs, keepc in glue:
            po = gated[pairs[:, 5].to(torch.int64)]
            sums += [keepc.sum(), po.sum()]
        sums = torch.stack(sums)
        staged = (sums[1::2] + torch.tensor(ocounts, device=device)).max()
        vals = torch.cat([counts, staged.reshape(1), sums])
        stat = (flags & 2) != 0
        return (vals, torch.minimum(emin0, torch.where(stat, ent, np.inf)
                                    .min()),
                torch.maximum(emax0, torch.where(stat, ent, -np.inf).max()))

    return k9a, k9b


def k9a_case(torch, label: str, device) -> dict:
    """K9a against its plain version on one shard of `segstats_level`'s
    level (nodes of `label` pairs a shard): one launch; the rows equal but
    the fixed-point column, within one unit a pair; the kept lanes equal;
    timed; -> its entry of the kernels line."""
    from dsm_tpu_torch.ops import _build
    from dsm_tpu_torch.ops.shardstats import (PART_COLS, shard_partials,
                                              shard_partials_plain)

    nb, freq, cbits, g = segstats_level(torch, label, device)
    u, p = nb.shape[0] - 1, freq.shape[0]
    out = torch.empty((u, PART_COLS), dtype=torch.int64, device=device)
    kept = torch.empty(1, dtype=torch.float64, device=device)
    before = _build.LAUNCHES["shard_partials"]
    shard_partials(nb, freq, cbits, g.sym_mask, out, kept)
    launched = _build.LAUNCHES["shard_partials"] - before
    want, want_kept = shard_partials_plain(nb, freq, cbits, g.sym_mask)
    torch.cuda.synchronize()
    # the fixed-point term truncates a log: the card's two libraries may
    # round it apart by one unit a pair
    off = (out[:, 1] - want[:, 1]).abs()
    if launched != 1 or not torch.equal(out[:, [0, 2]], want[:, [0, 2]]) \
            or bool((off > (nb[1:] - nb[:-1])).any()) \
            or not torch.equal(kept, want_kept):
        raise SystemExit(f"shard_partials disagrees with its plain version "
                         f"({label} pairs a node: {launched} launches, kept "
                         f"{kept.tolist()} vs {want_kept.tolist()})")
    nid = torch.repeat_interleave(torch.arange(u, device=device),
                                  (nb[1:] - nb[:-1]).to(torch.int64),
                                  output_size=p)
    freq64 = freq.to(torch.int64)
    entry = dict(
        name="shard_partials", route="cuda",
        source="dsm_tpu_torch/csrc/shardstats.cu",
        replaces="dsm_tpu/mining/engine_device.py:421",
        max_abs_err=float(off.max()),
        ms=cuda_ms(torch, lambda: shard_partials(nb, freq, cbits, g.sym_mask,
                                                 out, kept)),
        plain_ms=cuda_ms(torch, lambda: shard_partials_plain(
            nb, freq, cbits, g.sym_mask)),
        # nb, freq, cbits in, a 24-byte row a node and the kept lanes out;
        # ~6 f64 operations a pair (one a log)
        **bound(4 * (u + 1) + 5 * p + 24 * u + 8, 6 * p, F64_TOPS),
        # one of the row's three columns by index_add_
        library_ms=cuda_ms(torch, lambda: torch.zeros(
            u, dtype=torch.int64, device=device).index_add_(0, nid, freq64)))
    log(f"kernel shard_partials: {label} pairs a node, U={u:,} P={p:,}: one "
        f"launch, equal (fixed-point sums off by at most {int(off.max())} "
        f"units; kept lanes {int(kept)}); {entry['ms']:.4f} ms vs plain "
        f"{entry['plain_ms']:.4f} ms (bound {entry['bound_ms']:.4f} ms, "
        f"without the kept lanes' 8 bytes "
        f"{bound(4 * (u + 1) + 5 * p + 24 * u, 0)['bound_ms']:.4f} ms; "
        f"index_add_ of one column {entry['library_ms']:.4f} ms); device "
        + fmt_ms(device_ms(torch, lambda: shard_partials(
            nb, freq, cbits, g.sym_mask, out, kept))))
    return entry


def k9b_case(torch, shards, g, device) -> dict:
    """K9a on the one pair list of a split level's shards (the episode's
    form: a process's shards in one list) and K9b on its rows, against the
    plain versions: one launch each; K9a's rows equal to the shards' plain
    rows added (the merge over processes adds them so); rows, kept lanes,
    flags, kid0, history, pair_out and the level's values equal, the
    entropy and its range within ENT_TOL; K9b timed -> its entry of the
    kernels line, the one list, K9b's flags and kid0 (for K9c) and the
    children."""
    from dsm_tpu_torch.ops import _build
    from dsm_tpu_torch.ops.shardstats import (PART_COLS, V_CHILDREN,
                                              V_ENT_MAX, V_ENT_MIN,
                                              V_PRESENT, V_STAGED, kept_slot,
                                              level_values, node_gates,
                                              node_gates_plain,
                                              shard_partials,
                                              shard_partials_plain)

    n = len(shards)
    nb, freq, cbits = one_list(torch, shards)
    U, P = nb.shape[0] - 1, freq.shape[0]
    part = torch.empty((U, PART_COLS), dtype=torch.int64, device=device)
    vals = level_values(device)
    before = _build.LAUNCHES["shard_partials"]
    shard_partials(nb, freq, cbits, g.sym_mask, part, kept_slot(vals))
    launched = {"shard_partials": _build.LAUNCHES["shard_partials"] - before}
    want, kept = shard_partials_plain(nb, freq, cbits, g.sym_mask)
    added = sum(shard_partials_plain(sh[0], sh[3], sh[4], g.sym_mask)[0]
                for sh in shards)
    torch.cuda.synchronize()
    off = (part[:, 1] - want[:, 1]).abs()
    if not torch.equal(part[:, [0, 2]], want[:, [0, 2]]) \
            or bool((off > (nb[1:] - nb[:-1])).any()) \
            or not torch.equal(kept_slot(vals), kept) \
            or not torch.equal(want, added):
        raise SystemExit(f"shard_partials disagrees with its plain version "
                         f"(the one list of {n} shards)")
    ocount = 1000 * n
    wvals = vals.clone()
    hp = torch.full((4 * U,), -1, dtype=torch.int32, device=device)
    fp, ep, kp, pp = node_gates_plain(part, g, hp, nb, P, ocount, wvals)
    want = wvals.tolist()
    hk = torch.full((4 * U,), -1, dtype=torch.int32, device=device)
    before = _build.LAUNCHES["node_gates"]
    fk, ek, kk, pk = node_gates(part, g, hk, nb, P, ocount, vals)
    launched["node_gates"] = _build.LAUNCHES["node_gates"] - before
    torch.cuda.synchronize()
    eerr = float((ek - ep).abs().max())
    got = vals.tolist()
    rerr = max(abs(got[i] - want[i]) if got[i] != want[i] else 0.0
               for i in (V_ENT_MIN, V_ENT_MAX))
    same = [a == b for i, (a, b) in enumerate(zip(got, want))
            if i not in (V_ENT_MIN, V_ENT_MAX)]
    if not (torch.equal(fk, fp) and torch.equal(kk, kp)
            and torch.equal(hk, hp) and all(same) and torch.equal(pk, pp)) \
            or max(eerr, rerr) > ENT_TOL:
        raise SystemExit(f"node_gates disagrees with its plain version ({n} "
                         f"shards in one list: entropy max abs err {eerr}, "
                         f"values {got} vs {want})")
    if launched != {"shard_partials": 1, "node_gates": 1}:
        raise SystemExit(f"K9a/K9b launches {launched}, not one a call")
    children = int(got[V_CHILDREN])
    entry = dict(
        name="node_gates", route="cuda",
        source="dsm_tpu_torch/csrc/shardstats.cu",
        replaces="dsm_tpu/mining/engine_device.py:438",
        max_abs_err=max(eerr, rerr),
        ms=cuda_ms(torch, lambda: node_gates(part, g, hk, nb, P, ocount,
                                             vals)),
        plain_ms=cuda_ms(torch, lambda: node_gates_plain(
            part, g, hp, nb, P, ocount, wvals)),
        # the summed row and nb in; flags, entropy and first child id a
        # node, an entry a child, a gate a pair and the values out; ~12 f64
        # operations a node (one a log)
        **bound(24 * U + 4 * (U + 1) + 16 * U + 4 * children + P
                + 8 * len(got), 12 * U, F64_TOPS),
        library_ms=None,
        device_ms=device_ms(torch, lambda: node_gates(part, g, hk, nb, P,
                                                      ocount, vals)))
    log(f"kernel node_gates: the one list of {n} shards, U={U:,} nodes, "
        f"{P:,} pairs -> {children:,} children, {int(got[V_PRESENT]):,} "
        f"present nodes, staged {int(got[V_STAGED]):,}: K9a once over the "
        f"list (its rows the {n} shards' rows added) and K9b once, each "
        f"equal (entropy err {eerr:.3g}, its range {rerr:.3g}); "
        f"{entry['ms']:.4f} ms vs plain {entry['plain_ms']:.4f} ms (bound "
        f"{entry['bound_ms']:.4f} ms); device {fmt_ms(entry['device_ms'])}")
    return entry, (nb, freq, cbits), fk, kk, children


def phase_sharded_kernels(torch, device) -> list[dict]:
    """K9a, K9b, K9c and K10 against their plain versions: K9a on a list
    of `segstats_level`'s levels (nodes of 1..5, 1..64 and 1..273 pairs);
    K9a and K9b on the one list of `sharded_level`'s SEG_NODES nodes over 5
    samples split into 5 shards and into 2 ([0, 2) and [2, 5)); K9c on that
    list and on each of the 2 shards' pairs, with K9b's ids; K10 on 2 and 5
    blocks of ~GATHER_ROWS rows with codes, timed with GATHER_SETS sets of
    inputs taken in turn, so that none is in the L2 when it is read again.
    The kernels line has K9a at 1..5, K9b and K9c on the 2 shards' one
    list (and K10 at the real drain's blocks: `phase_sharded`)."""
    from dsm_tpu_torch.ops.children import children_ids, children_ids_plain
    from dsm_tpu_torch.ops.gatherpack import gather_pack, gather_pack_plain
    from dsm_tpu_torch.ops.segstats import Gates

    gen = torch.Generator(device=device)
    gen.manual_seed(2029)
    i32 = dict(dtype=torch.int32, device=device, generator=gen)
    U = SEG_NODES
    results = [k9a_case(torch, label, device) for label in SEG_WIDTHS][:1]
    g = Gates(depth=7, s_total=5, mindepth=0, pmin=2, pmax=0,
              use_egate=True, sym_mask=0b1111, emin_lo=-0.01, emax_hi=1.21)
    level = sharded_level(torch, gen, device)
    for bounds in ((0, 1, 2, 3, 4, 5), (0, 2, 5)):
        shards = split_level(torch, level, bounds)
        entry, whole, fk, kk, child_total = k9b_case(torch, shards, g,
                                                     device)
    results.append(entry)

    # K9c on the one list (the episode's form) and on one shard's pairs
    # (one process's list of a group): every active child lane kept (the
    # full symbol mask), the ids from K9b; rank outputs with ohi >= olo
    nid, sid, _freq, _cbits = level
    lists = [("the one list", whole[0], nid, sid, whole[2])] + [
        (f"shard {k}", nb, nid_k, sid_k, cbits_k)
        for k, (nb, nid_k, sid_k, _f, cbits_k) in enumerate(shards)]
    for k, (what, nb, nid, sid, cbits) in enumerate(lists):
        p = nid.shape[0]
        pairs = torch.randint(-2**31, 2**31 - 1, (p, 6), **i32)
        pairs[:, 3], pairs[:, 5] = sid.to(torch.int32), nid.to(torch.int32)
        olo = torch.randint(-2**31, 2**31 - 5000, (8, p), **i32)
        ohi = olo + torch.randint(0, 5000, (8, p), **i32)
        keep = ((cbits.to(torch.int32)[None, :] >> torch.arange(
            4, device=device, dtype=torch.int32)[:, None]) & 1) > 0
        pair_count = int(keep.sum())
        cargs = (nb, pairs, olo, ohi, keep, fk, kk, pair_count, child_total)
        (kr, kn), (pr_, pn) = children_ids(*cargs), children_ids_plain(*cargs)
        torch.cuda.synchronize()
        if not (torch.equal(kr, pr_) and torch.equal(kn, pn)):
            raise SystemExit(f"children_ids disagrees with its plain version "
                             f"({what})")
        ms = cuda_ms(torch, lambda: children_ids(*cargs))
        plain_ms = cuda_ms(torch, lambda: children_ids_plain(*cargs))
        log(f"kernel children_ids: {what}, U={U:,} P={p:,}: {pair_count:,} "
            f"lanes kept into {child_total:,} children, equal; {ms:.4f} ms "
            f"vs plain {plain_ms:.4f} ms")
        if k == 0:
            results.append(dict(
                name="children_ids", route="cuda",
                source="dsm_tpu_torch/csrc/children.cu",
                replaces="dsm_tpu/mining/engine_device.py:490",
                max_abs_err=0, ms=ms, plain_ms=plain_ms,
                # nb, flags and kid0 in, the lanes' bytes, and nb_next out
                **bound(12 * U + 4 + lane_bytes(keep)
                        + 4 * (child_total + 1), 16 * p), library_ms=None))

    for nblk in (2, 5):
        sizes = [GATHER_ROWS + 1000 * b for b in range(nblk)]
        bases = [7 * b for b in range(nblk)]
        sets = [([torch.randint(-2**31, 2**31 - 1000, (m, 5), **i32)
                  for m in sizes],
                 [torch.randint(0, 6, (m,), **i32).to(torch.int8)
                  for m in sizes]) for _ in range(GATHER_SETS)]
        for blocks, lcs in sets:
            gargs = (blocks, bases, 2, lcs)
            (kr, kl), (pr_, pl) = gather_pack(*gargs), \
                gather_pack_plain(*gargs)
            torch.cuda.synchronize()
            if not (torch.equal(kr, pr_) and torch.equal(kl, pl)):
                raise SystemExit(f"gather_pack disagrees with its plain "
                                 f"version ({nblk} blocks)")
        turn = iter(range(1 << 30))

        def cold():
            blocks, lcs = sets[next(turn) % GATHER_SETS]
            gather_pack(blocks, bases, 2, lcs)

        ms, dev_ms = cuda_ms(torch, cold, 24), device_ms(torch, cold, 24)
        b = bound(2 * 21 * sum(sizes), 2 * 5 * sum(sizes))
        log(f"kernel gather_pack: {nblk} blocks, {sum(sizes):,} rows of 5 "
            f"with codes, equal; inputs cold in the L2: {ms:.4f} ms by "
            f"events around the wrapper, device {fmt_ms(dev_ms)}, vs plain "
            f"{cuda_ms(torch, lambda: gather_pack_plain(*gargs)):.4f} ms "
            f"(bound {b['bound_ms']:.4f} ms by {b['bound_by']})")
        del sets, gargs, kr, kl, pr_, pl
    return results


def phase_sa_kernels(torch, toy0, device) -> list[dict]:
    """The suffix-array kernels on toy0's collections (both directions)
    and at SA_BIG; toy0's first round checked, and its round k = 16 of
    each kernel timed alone (the sort's also at SA_BIG)."""
    from dsm_tpu_torch.ops.sa import (rank_round, rank_round_plain,
                                      sort_round, sort_round_plain,
                                      suffix_array, suffix_array_np,
                                      suffix_array_plain)

    for label, codes in zip(("forward", "reverse"), toy0):
        c = torch.as_tensor(codes, device=device)
        got = suffix_array(c)
        want = suffix_array_plain(c)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise SystemExit(f"SA kernel disagrees with its plain version "
                             f"on toy0 {label}")
        t0 = time.perf_counter()
        host = suffix_array_np(codes)
        host_s = time.perf_counter() - t0
        if not np.array_equal(got.cpu().numpy(), host):
            raise SystemExit(f"SA kernel disagrees with suffix_array_np on "
                             f"toy0 {label}")
        log(f"kernel suffix_array: toy0 {label} n={len(codes):,} equals "
            f"plain and suffix_array_np; "
            f"{cuda_ms(torch, lambda: suffix_array(c), 5):.3f} ms vs plain "
            f"{cuda_ms(torch, lambda: suffix_array_plain(c), 5):.3f} ms "
            f"(suffix_array_np on the host {host_s:.3f} s)")

    # toy0's first round, and its round k = 16 with the rank update
    c = torch.as_tensor(toy0[0], device=device)
    first, top0 = c.to(torch.int32), int(c.max())
    if not all(torch.equal(g, w) for g, w in zip(
            sort_round(first, 1, top0), sort_round_plain(first, 1, top0))):
        raise SystemExit("sa_sort disagrees with its plain version in "
                         "toy0's first round")
    log(f"kernel sa_sort: toy0 forward first round (k=1, from scratch, "
        f"codes < {top0 + 1}) equal")
    rank, k, top, (keys, order), ms, plain_ms, lib_ms = sa_round(
        torch, c, "toy0 forward")
    n0 = rank.shape[0]
    r1, r2 = rank.clone(), rank.clone()
    new1, new2 = rank_round(keys, order, r1), rank_round_plain(keys, order,
                                                               r2)
    torch.cuda.synchronize()
    if new1 != new2 or not torch.equal(r1, r2):
        raise SystemExit("sa_rank disagrees with its plain version")
    results = [
        dict(name="sa_sort", route="cuda", source="dsm_tpu_torch/csrc/sa.cu",
             replaces="dsm_tpu/ops/sa.py:109", max_abs_err=0, ms=ms,
             plain_ms=plain_ms,
             # rank and the previous order in, keys and order out; one
             # digit and one move a key a pass
             **bound(n0 * (4 + 4 + 8 + 4),
                     2 * n0 * sort_bytes_per_key(n0, k, top, True)[1]),
             library_ms=lib_ms),
        dict(name="sa_rank", route="cuda", source="dsm_tpu_torch/csrc/sa.cu",
             replaces="dsm_tpu/ops/sa.py:110", max_abs_err=0,
             ms=cuda_ms(torch, lambda: rank_round(keys, order, r1)),
             plain_ms=cuda_ms(torch,
                              lambda: rank_round_plain(keys, order, r2)),
             # keys and order in, rank out; a compare, a scan step and a
             # scatter a key
             **bound(n0 * (8 + 4 + 4), 3 * n0), library_ms=None)]
    log(f"kernel sa_rank: toy0 forward n={len(toy0[0]):,} round k={k} "
        f"equal; {results[1]['ms']:.3f} ms vs plain "
        f"{results[1]['plain_ms']:.3f} ms")

    rng = np.random.default_rng(2025)
    big = torch.as_tensor(rng.integers(1, 5, size=SA_BIG).astype(np.int8),
                          device=device)
    if not torch.equal(suffix_array(big), suffix_array_plain(big)):
        raise SystemExit(f"SA kernel disagrees with its plain version at "
                         f"n={SA_BIG}")
    log(f"kernel suffix_array: random n={SA_BIG:,} equal; "
        f"{cuda_ms(torch, lambda: suffix_array(big), 3):.3f} ms vs plain "
        f"{cuda_ms(torch, lambda: suffix_array_plain(big), 3):.3f} ms")
    sa_round(torch, big, "random")
    return results


def sa_round(torch, codes, label: str):
    """Round k = SA_ROUND_K of the prefix doubling of `codes` (the rounds
    before it by the plain versions): the kernel's sort from the previous
    round's order and from scratch, each against the plain sort, timed;
    -> (rank, k, max rank, the plain (keys, order), ms, plain ms, the ms
    of torch.sort alone on the packed keys)."""
    from dsm_tpu_torch.ops.sa import (rank_round_plain, sort_round,
                                      sort_round_plain)

    rank = codes.to(torch.int32)
    top, k, prev = int(codes.max()), 1, None
    while k < SA_ROUND_K:
        keys, prev = sort_round_plain(rank, k, top)
        top = rank_round_plain(keys, prev, rank)
        k *= 2
    want = sort_round_plain(rank, k, top)
    for how, given in (("from the previous order", prev),
                       ("from scratch", None)):
        got = sort_round(rank, k, top, given)
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise SystemExit(f"sa_sort disagrees with its plain version: "
                             f"{label} round k={k} {how}")
    ms = cuda_ms(torch, lambda: sort_round(rank, k, top, prev))
    scratch_ms = cuda_ms(torch, lambda: sort_round(rank, k, top))
    plain_ms = cuda_ms(torch, lambda: sort_round_plain(rank, k, top))
    packed = want[0][torch.randperm(want[0].shape[0], device=rank.device)]
    lib_ms = cuda_ms(torch, lambda: torch.sort(packed, stable=True))
    n, bits = rank.shape[0], top.bit_length()
    per_key, passes = sort_bytes_per_key(n, k, top, True)
    tbs = per_key * n / (ms * 1e-3) / 1e12
    log(f"kernel sa_sort: {label} n={n:,} round k={k} (ranks < {top + 1:,}"
        f": {bits} bits, {passes} passes) equal from the "
        f"previous order and from scratch; {ms:.4f} ms (from scratch "
        f"{scratch_ms:.4f} ms) vs plain {plain_ms:.4f} ms (torch.sort alone "
        f"{lib_ms:.4f} ms); {per_key} B a "
        f"key, {tbs:.3f} TB/s = {100 * tbs / HBM_TBS:.1f}% of {HBM_TBS} TB/s")
    return rank, k, top, want, ms, plain_ms, lib_ms


def phase_repro_kernels(torch, device) -> list[dict]:
    """P2-P4 against their plain versions and the repro tool's expected
    arrays, timed by events and by the profiler's device time, at the
    tool's N and at N = REPRO_BIG; -> their entries of the kernels line,
    P2's and P3's at the tool's N, P4's at N = REPRO_BIG."""
    from dsm_tpu_torch.ops import repro
    from dsm_tpu_torch.tools.pallas_repro import N, expected

    want = expected(device)
    x = torch.arange(N, dtype=torch.int32, device=device)
    results = []
    # the one PyTorch call with the same result, where there is one
    for name, line, fn, plain, library in (
            ("smem_carry", 81, repro.smem_carry, repro.smem_carry_plain,
             None),
            ("async_copy", 101, repro.async_copy, repro.async_copy_plain,
             lambda t: torch.mul(t, 2)),
            ("dynamic_store", 123, repro.dynamic_store,
             repro.dynamic_store_plain, torch.clone)):
        got = fn(x)
        torch.cuda.synchronize()
        if not (torch.equal(got, plain(x)) and torch.equal(got, want[name])):
            raise SystemExit(f"{name} kernel disagrees with its plain version "
                             f"or the expected array")
        results.append(dict(
            name=name, route="cuda", source="dsm_tpu_torch/csrc/repro.cu",
            replaces=f"tools/pallas_repro.py:{line}", max_abs_err=0,
            ms=cuda_ms(torch, lambda: fn(x)),
            plain_ms=cuda_ms(torch, lambda: plain(x)),
            # N int32 in, N out; one operation an element
            **bound(8 * N, N),
            library_ms=(None if library is None
                        else cuda_ms(torch, lambda: library(x)))))
        log(f"kernel {name}: N={N} equal; events {results[-1]['ms']:.4f} ms "
            f"vs plain {results[-1]['plain_ms']:.4f} ms; device "
            f"{fmt_ms(device_ms(torch, lambda: fn(x)))} vs plain "
            f"{fmt_ms(device_ms(torch, lambda: plain(x)))}")

    # where bytes count: N = REPRO_BIG (128 MB moved a call), each beside
    # the PyTorch call with the same result
    rng = np.random.default_rng(2026)
    xb = torch.as_tensor(rng.integers(-2**30, 2**30, size=REPRO_BIG,
                                      dtype=np.int64).astype(np.int32),
                         device=device)
    xb[0] = 3     # dynamic_store's offset is x[0] * 0
    moved = 2 * 4 * REPRO_BIG
    for entry, fn, plain, library in zip(results, (
            repro.smem_carry, repro.async_copy, repro.dynamic_store), (
            repro.smem_carry_plain, repro.async_copy_plain,
            repro.dynamic_store_plain), (
            None, lambda t: torch.mul(t, 2), torch.clone)):
        name = entry["name"]
        if not torch.equal(fn(xb), plain(xb)):
            raise SystemExit(f"{name} disagrees with its plain version at "
                             f"N={REPRO_BIG}")
        # 50 calls a timing: the first call's enqueue is not a tenth of it
        big = dict(ms=cuda_ms(torch, lambda: fn(xb), 50),
                   plain_ms=cuda_ms(torch, lambda: plain(xb)),
                   **bound(moved, REPRO_BIG),
                   library_ms=(None if library is None
                               else cuda_ms(torch, lambda: library(xb), 50)))
        lib = "" if library is None else \
            f", library call {big['library_ms']:.4f} ms"
        log(f"kernel {name}: N={REPRO_BIG:,} equal; events {big['ms']:.4f} ms "
            f"({moved / (big['ms'] * 1e-3) / 1e12:.3f} TB/s, bound "
            f"{big['bound_ms']:.4f} ms) vs plain {big['plain_ms']:.4f} "
            f"ms{lib}; device {fmt_ms(device_ms(torch, lambda: fn(xb)))} vs "
            f"plain {fmt_ms(device_ms(torch, lambda: plain(xb)))}")
        if name == "dynamic_store":
            # P4's entry: the copy where its bytes count, beside torch.clone
            entry.update(big)
    return results


def distance_rows(rng, rows: int, d: int, nbins: int):
    """Mined-row-like inputs of K11: (rows, d) int32 frequencies, ~30% of
    them nonzero with a long (Pareto) tail, and a bin a row in [0, nbins)
    with bin 1 left empty when there are more than two."""
    F = np.minimum(rng.pareto(1.1, size=(rows, d)) * 4 + 1, 2e6)
    F = (F * (rng.random((rows, d)) < 0.3)).astype(np.int32)
    bins = rng.integers(0, nbins, size=rows).astype(np.int32)
    if nbins > 2:
        bins[bins == 1] = 0
    return F, bins


def plain_in_chunks(torch, F, nbins, bins, nfactor, chunk: int) -> dict:
    """pairwise_matrices_plain over row chunks (its (rows, d, d) f64
    temporaries bound the chunk), summed."""
    from dsm_tpu_torch.ops.distance import pairwise_matrices_plain

    total = None
    for r0 in range(0, F.shape[0], chunk):
        part = pairwise_matrices_plain(F[r0:r0 + chunk], nbins,
                                       bins[r0:r0 + chunk], nfactor)
        if total is None:
            total = part
        else:
            for kind in total:
                total[kind] += part[kind]
    return total


def distance_err(got: dict, want: dict, label: str) -> float:
    """Fails unless count is equal and the f64 matrices are within
    DIST_TOL; -> the largest absolute difference.  Takes tensors or
    NumPy arrays."""
    def host(a):
        return a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)

    if not np.array_equal(host(got["count"]), host(want["count"])):
        raise SystemExit(f"{label}: count differs")
    worst = 0.0
    for kind in ("log", "sqrt", "lgamma"):
        g, w = host(got[kind]), host(want[kind])
        diff = np.abs(g - w)
        if not np.isfinite(g).all() or (diff > DIST_TOL * (1 + np.abs(w))).any():
            i = np.unravel_index(np.argmax(diff), diff.shape)
            raise SystemExit(f"{label}: {kind} differs at {i}: got {g[i]!r}, "
                             f"want {w[i]!r}")
        worst = max(worst, float(diff.max(initial=0.0)))
    return worst


def phase_distance_kernel(torch, device) -> list[dict]:
    """K11 against its plain version (in chunks on the card) and against
    NumPy `pairwise_matrices`, at DIST_R x DIST_D in DIST_BINS bins, at
    d = 5 and d = 273 with fewer rows, and with normalising factors."""
    from dsm_tpu_torch.ops.distance import pairwise_matrices
    from dsm_tpu_torch.post.distance import pairwise_matrices as oracle

    rng = np.random.default_rng(2028)
    result = None
    for rows, d, nbins, chunk, scaled in (
            (DIST_R, DIST_D, DIST_BINS, 8192, False),
            ((1 << 18) + 77, 5, DIST_BINS, 1 << 16, False),
            ((1 << 16) + 5, 273, 30, 512, False),
            ((1 << 16) + 5, DIST_D, 3, 8192, True)):
        F_np, bins_np = distance_rows(rng, rows, d, nbins)
        F = torch.as_tensor(F_np, device=device)
        bins = torch.as_tensor(bins_np, device=device)
        nf_np = 1.0 / rng.uniform(500, 4000, size=d) if scaled else None
        nf = None if nf_np is None else torch.as_tensor(nf_np, device=device)
        got = pairwise_matrices(F, nbins, bins, nf)
        torch.cuda.synchronize()
        label = f"kernel pairwise_matrices R={rows:,} d={d} nbins={nbins}" \
                + (" normalised" if scaled else "")
        t0 = time.perf_counter()
        want = plain_in_chunks(torch, F, nbins, bins, nf, chunk)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = distance_err(got, want, label + " vs plain")
        head = 4096 if d <= DIST_D else 256   # NumPy's (head, d, d) temporaries
        ref = oracle(F_np[:head].astype(np.int64), nbins, bins_np[:head],
                     nf_np)
        if scaled:
            ref["lgamma"] = np.zeros_like(ref["lgamma"])
        np_err = distance_err(
            pairwise_matrices(F[:head].contiguous(), nbins, bins[:head], nf),
            ref, label + f" vs NumPy on {head} rows")
        ms = cuda_ms(torch, lambda: pairwise_matrices(F, nbins, bins, nf), 5)
        dms = device_ms(torch, lambda: pairwise_matrices(F, nbins, bins, nf), 3)
        # this data's work: per row with z nonzero entries, the j < k pairs
        # with either entry nonzero (6 f64 operations for the two squared
        # differences and 6 for the lgamma term each), those with both
        # (one more lgamma), and 3 transcendentals a nonzero entry
        z = (F > 0).sum(dim=1).to(torch.float64)
        either = float((d * (d - 1) / 2 - (d - z) * (d - z - 1) / 2).sum())
        both = float((z * (z - 1) / 2).sum())
        ops = (6 if scaled else 12) * either + 3 * float(z.sum()) \
            + (0 if scaled else both)
        bnd = bound(rows * d * 4 + rows * 4 + 4 * nbins * d * d * 8, ops,
                    F64_TOPS)
        log(f"{label}: count equal, f64 sums within {DIST_TOL} of plain (max "
            f"abs err {err:.3g}) and of NumPy on {head} rows ({np_err:.3g}); "
            f"events {ms:.4f} ms, device {fmt_ms(dms)}, plain in chunks of "
            f"{chunk} rows {plain_ms:.1f} ms (one run, host clock); "
            f"{either:.4g} pairs with an entry, {both:.4g} with both; bound "
            f"{bnd['bound_ms']:.4f} ms by {bnd['bound_by']}")
        if result is None:
            result = dict(
                name="pairwise_matrices", route="cuda",
                source="dsm_tpu_torch/csrc/distance.cu",
                replaces="dsm_tpu/post/distance.py:323",
                max_abs_err=max(err, np_err), ms=ms, plain_ms=plain_ms,
                **bnd, library_ms=None)
    return [result]


def phase_distance(torch, device, gnu) -> dict:
    """The distance path: the mined lines through the accumulator, exact on
    the host and in chunks through the kernel on the card."""
    from dsm_tpu_torch.ops import _build
    from dsm_tpu_torch.post.distance import (DistanceAccumulator,
                                             entropy_steps)

    lines = gnu.format_lines().decode().splitlines()
    kw = dict(smpls=5, maxents=entropy_steps(0.05))
    exact = DistanceAccumulator(**kw)
    exact.add_lines(lines)
    want = exact.matrices()
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    fast = DistanceAccumulator(exact=False, device=device, **kw)
    fast.add_lines(lines)
    got = fast.matrices()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = path_launches("distance")
    if not np.array_equal(got["noutput"], want["noutput"]):
        raise SystemExit("distance: noutput differs")
    err = distance_err(got, want, "distance path")
    if not all(np.isfinite(got[k]).all() and got[k].shape == (21, 5, 5)
               for k in ("log", "sqrt", "lgamma")):
        raise SystemExit("distance: matrices of the wrong shape")
    log(f"distance: {fast.rows_read} lines -> {int(got['noutput'][-1])} rows "
        f"in {len(got['thresholds'])} nested bins in {wall:.4f} s; count and "
        f"noutput equal the exact host path, f64 matrices within {DIST_TOL} "
        f"(max abs err {err:.3g})")
    return launches


def phase_repro(torch, device) -> dict:
    """The repro tool's cases, through its entry point's function."""
    from dsm_tpu_torch.ops import _build
    from dsm_tpu_torch.tools.pallas_repro import run_cases

    torch.cuda.synchronize()
    _build.reset_launches()
    report = run_cases(device)
    launches = path_launches("repro")
    log(f"repro tool: {json.dumps(report)}")
    if set(report.values()) != {"PASS"}:
        raise SystemExit("repro tool: a case did not pass")
    return launches


def phase_main(torch, idxs, dev, device) -> dict:
    from dsm_tpu_torch.mining.engine import MiningConfig, mine_torch
    from dsm_tpu_torch.ops import _build

    cfg = MiningConfig(fmin=FMIN, emax=EMAX)

    def run(label: str, order: str):
        prof = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = mine_torch(idxs, cfg, dev=dev, device=device,
                         reader_order=order, profile=prof)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        log(f"mine {label}: {out.total_paths} paths, {out.total_output} "
            f"lines in {wall:.4f} s = {out.total_paths / wall:,.0f} paths/s;"
            " host phases " + json.dumps(
                {k: (round(v, 4) if isinstance(v, float) else v)
                 for k, v in prof.items()}))
        return out

    torch.cuda.reset_peak_memory_stats(device)
    before = torch.cuda.memory_allocated(device)
    _build.reset_launches()
    # the first run pays one-time costs (the host indexes' lazy dense
    # tables, first use of each torch op on the card); the second is warm
    cold = run("ascending (first in process)", "ascending")
    out = run("ascending (warm)", "ascending")
    gnu = run("gnu", "gnu")
    torch.cuda.synchronize()
    launches = path_launches("mine")
    prof = {}
    rank0 = _build.LAUNCHES["rank"]
    ms, acts, top = device_profile(torch, lambda: mine_torch(
        idxs, cfg, dev=dev, device=device, reader_order="ascending",
        profile=prof))
    ranks = _build.LAUNCHES["rank"] - rank0
    log(f"mine ascending (warm, under torch.profiler): device time "
        f"{fmt_ms(ms)} in {acts:,} device activities, {prof['levels']} "
        f"levels on the device: {acts / prof['levels']:.1f} activities and "
        f"{ranks / prof['levels']:.3f} rank launches a level "
        f"({ranks} = {prof['levels']} expand steps + {prof['drains']} "
        f"drains' leftChar); the largest: " + json.dumps(top))
    if ranks != prof["levels"] + prof["drains"]:
        raise SystemExit("the rank kernel was not launched once a level and "
                         "once a drain")
    peak = torch.cuda.max_memory_allocated(device)
    log(f"peak device memory (max_memory_allocated): {peak:,} bytes "
        f"({before:,} allocated before the mine)")

    if cold.format_lines() != out.format_lines():
        raise SystemExit("two ascending runs on the card disagree")
    if gnu.total_output != out.total_output \
            or gnu.total_paths != out.total_paths:
        raise SystemExit("gnu and ascending runs report different counts")
    check_reference(gnu, "scale-100 parity")
    return launches, out, gnu


def check_reference(gnu, label: str) -> None:
    """A gnu-order scale-100 output against the frozen reference."""
    with open(os.path.join(HERE, "BENCH_BASELINE.json")) as f:
        ref = json.load(f)["reference"]
    sha = hashlib.sha256(gnu.format_lines()).hexdigest()
    log(f"{label}: gnu-order sha256 {sha}")
    want = (ref["total_paths"], 485, ref["lines_sha256"])
    if (gnu.total_paths, gnu.total_output, sha) != want:
        raise SystemExit(
            f"{label} FAILED: got paths={gnu.total_paths} "
            f"lines={gnu.total_output} sha={sha}, want {want}")
    log(f"{label}: paths, lines and gnu sha256 equal the frozen reference")


class Killed(Exception):
    """Raised from save_checkpoint to abort a mining run."""


def frontier_recorder(*records):
    """A stand-in for engine_device._frontier_codes that keeps, in each
    (store, key) of `records`, the inputs of the frontier decode with the
    largest key(nodes, levels of the segment), then decodes as the original
    does."""
    from dsm_tpu_torch.mining import engine_device as ed

    frontier_codes = ed._frontier_codes

    def recording(st, ph, seg_depth0):
        j = st.depth - seg_depth0
        for store, key in records:
            if key(st.nnodes, j) > store.get("key", 0):
                store.update(key=key(st.nnodes, j), n=st.nnodes, jrel=j,
                             hist=st.hist[:st.hist_len].clone(),
                             lvl_off=list(st.lvl_off))
        return frontier_codes(st, ph, seg_depth0)

    return recording


def frontier_args(torch, f: dict, device):
    """A recorded frontier decode -> decode's (hist, lvl_off, rows, jrel,
    maxj): rows 0..n-1, each walking the segment's jrel levels."""
    n, j = f["n"], f["jrel"]
    return (f["hist"], torch.tensor(f["lvl_off"][:j], dtype=torch.int32,
                                    device=device),
            torch.arange(n, dtype=torch.int32, device=device),
            torch.full((n,), j, dtype=torch.int32, device=device), j)


def phase_resume(torch, idxs, dev, device, td: str) -> None:
    """The gnu-order mine with a snapshot file, killed after its second
    save and resumed from it in this process."""
    from dsm_tpu_torch.mining import checkpoint as ckpt
    from dsm_tpu_torch.mining import engine_device as ed
    from dsm_tpu_torch.mining.engine import MiningConfig, mine_torch
    from dsm_tpu_torch.ops import _build

    cfg = MiningConfig(fmin=FMIN, emax=EMAX)
    path = os.path.join(td, "mine.ckpt")
    save = ckpt.save_checkpoint
    saves = []     # (depth, frontier nodes, write seconds, file bytes)
    frontier_codes = ed._frontier_codes
    biggest = {}   # the inputs of the frontier decode of the most steps

    def killing(p, state, *a, **k):
        t0 = time.perf_counter()
        save(p, state, *a, **k)
        saves.append((int(state["depth"]), int(state["nvalid"]),
                      round(time.perf_counter() - t0, 4),
                      os.path.getsize(p)))
        if killed is None and len(saves) == 2:
            raise Killed()

    ckpt.save_checkpoint = killing
    ed._frontier_codes = frontier_recorder((biggest, lambda n, j: n * j))
    killed = None
    torch.cuda.synchronize()
    _build.reset_launches()
    try:
        t0 = time.perf_counter()
        try:
            mine_torch(idxs, cfg, dev=dev, device=device, reader_order="gnu",
                       out_reserve=RESUME_RESERVE, checkpoint=path)
        except Killed:
            killed = time.perf_counter() - t0
        if killed is None or not os.path.exists(path):
            raise SystemExit("resume: the run was not killed at its second "
                             "save, or left no snapshot")
        prof = {}
        t0 = time.perf_counter()
        gnu = mine_torch(idxs, cfg, dev=dev, device=device,
                         reader_order="gnu", out_reserve=RESUME_RESERVE,
                         checkpoint=path, profile=prof)
        torch.cuda.synchronize()
        resumed = time.perf_counter() - t0
    finally:
        ckpt.save_checkpoint = save
        ed._frontier_codes = frontier_codes
    path_launches("mine", "the resume phase")
    log(f"resume: killed after save 2 at {killed:.4f} s, resumed run "
        f"{resumed:.4f} s; {len(saves)} saves (depth, frontier nodes, "
        f"write s, bytes): {json.dumps([list(s) for s in saves])}; the "
        f"resumed run's {prof['saves']} saves took {prof['save_s']:.4f} s "
        f"in all (frontier decode and write)")
    # the real frontier decode (K6) of the most rows x levels, rows 0..n-1
    # (the widest frontier, at depth 12, is decoded by the resumed run from
    # a segment of one level)
    decode_case(torch, f"the resume phase's largest frontier decode "
                f"({biggest['n']:,} nodes, {biggest['jrel']} levels of the "
                f"segment)", frontier_args(torch, biggest, device))
    if len(saves) < 3 or min(s[1] for s in saves) < 100_000:
        raise SystemExit("resume: fewer than three saves at wide frontiers")
    if os.path.exists(path):
        raise SystemExit("resume: the snapshot file outlived the run")
    check_reference(gnu, "resume parity")


def level_launches_once(label: str, prof: dict) -> None:
    """Fail unless a sharded run of `prof`'s levels and drains launched the
    expand (the rank kernel, which a drain's leftChar launches once more),
    K9a and K9b once a level and K9c once a level that did not end as
    HISTFULL, whatever its shards a process."""
    from dsm_tpu_torch.ops import _build

    levels = prof["levels"]
    want = {"rank": levels + prof["drains"], "shard_partials": levels,
            "node_gates": levels, "children_ids": levels - prof["histfull"]}
    got = {k: _build.LAUNCHES[k] for k in want}
    if got != want:
        raise SystemExit(f"{label}: launches {got}, not {want} for "
                         f"{levels} levels and {prof['drains']} drains")


def phase_sharded(torch, idxs, dev, device, warm, td: str):
    """The sharded episode on the one card; -> (the launches of the plain
    2-shard gnu run, K10's entry of the kernels line: the 5-shard drain's
    block)."""
    import torch.distributed as dist

    from dsm_tpu_torch.mining import checkpoint as ckpt
    from dsm_tpu_torch.mining.engine import MiningConfig, mine_torch
    from dsm_tpu_torch.ops import _build
    from dsm_tpu_torch.parallel import engine_episode as tee
    from dsm_tpu_torch.parallel.engine_episode import mine_device_sharded
    from dsm_tpu_torch.parallel.engine_sharded import ShardedIndexes
    from dsm_tpu_torch.parallel.multihost import (global_samples_mesh,
                                                  initialize)

    cfg = MiningConfig(fmin=FMIN, emax=EMAX)

    drain = tee._drain_sharded

    def run(label: str, mesh, tables, order: str = "gnu", **kw):
        prof = {}
        drains = []     # (rows, emits since the last drain, launches)
        emits = [0]     # the emit's launches at the last drain

        def counted(*a, **k):
            st = a[3]
            rows = st.ocount
            if rows > staged_blocks.get(label, (0,))[0]:
                # a copy: the buffer takes the next levels' rows
                staged_blocks[label] = (rows, [
                    (st.out[:st.ocount].clone(), a[6].base(0))])
            before = dict(_build.LAUNCHES)
            staged = drain(*a, **k)
            if staged:
                drains.append((rows, before["compact"] - emits[0], {
                    key: _build.LAUNCHES[key] - before[key]
                    for key in ("gather_pack", "rank")}))
            emits[0] = _build.LAUNCHES["compact"]
            return staged

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        _build.reset_launches()
        tee._drain_sharded = counted
        t0 = time.perf_counter()
        try:
            out = mine_device_sharded(idxs, cfg, mesh=mesh, dev=tables,
                                      reader_order=order, profile=prof, **kw)
            torch.cuda.synchronize()
        finally:
            tee._drain_sharded = drain
        wall = time.perf_counter() - t0
        log(f"sharded mine {label}: {out.total_paths} paths, "
            f"{out.total_output} lines in {wall:.4f} s; host phases "
            + json.dumps({k: (round(v, 4) if isinstance(v, float) else v)
                          for k, v in prof.items()})
            + "; launches " + json.dumps(
                {k: _build.LAUNCHES[k] for k in _build.PATHS["mine_sharded"]})
            + f"; peak device memory "
              f"{torch.cuda.max_memory_allocated(device):,} bytes")
        level_launches_once(f"sharded mine {label}", prof)
        # a drain: one gather and one leftChar launch at any shard count
        # (in a process group the all-gather's gather adds one)
        want = {"gather_pack": 1 + (mesh.group is not None), "rank": 1}
        log(f"sharded mine {label}: {len(drains)} drain(s) of (rows, emits "
            f"staged) {[d[:2] for d in drains]}, launches a drain "
            f"{[d[2] for d in drains]}")
        if not drains or any(d[2] != want for d in drains):
            raise SystemExit(f"sharded mine {label}: a drain did not launch "
                             f"{want}")
        return out

    launches = None
    staged_blocks = {}   # a run's largest drain's block
    for n in (1, 2, 5):
        mesh = global_samples_mesh(n, device)
        tables = ShardedIndexes.build(idxs, mesh)
        gnu = run(f"{n} shard(s), gnu", mesh, tables)
        if n == 2:
            launches = path_launches("mine_sharded")
            mesh2, tables2 = mesh, tables
        check_reference(gnu, f"sharded parity, {n} shard(s)")
        k10 = gather_case(torch, staged_blocks[f"{n} shard(s), gnu"][1],
                          f"the {n}-shard drain's block")
    asc = run("2 shards, ascending", mesh2, tables2, order="ascending")
    if asc.format_lines() != warm.format_lines():
        raise SystemExit("the 2-shard ascending run's lines differ from the "
                         "single-device run's")
    log("sharded mine: the 2-shard ascending lines equal the single-device "
        "run's")

    # killed at its second save, resumed by the single-device engine
    path = os.path.join(td, "sharded.ckpt")
    save = ckpt.save_checkpoint
    saves = []

    def killing(p, state, *a, **k):
        save(p, state, *a, **k)
        saves.append((int(state["depth"]), int(state["nvalid"])))
        if len(saves) == 2:
            raise Killed()

    ckpt.save_checkpoint = killing
    try:
        try:
            run("2 shards, gnu, to be killed", mesh2, tables2,
                out_reserve=RESUME_RESERVE, checkpoint=path)
            raise SystemExit("sharded resume: the run was not killed")
        except Killed:
            pass
    finally:
        ckpt.save_checkpoint = save
    if not os.path.exists(path):
        raise SystemExit("sharded resume: the killed run left no snapshot")
    t0 = time.perf_counter()
    gnu = mine_torch(idxs, cfg, dev=dev, device=device, reader_order="gnu",
                     checkpoint=path)
    torch.cuda.synchronize()
    log(f"sharded resume: killed after saves (depth, nodes) "
        f"{json.dumps(saves)}; resumed by the single-device engine in "
        f"{time.perf_counter() - t0:.4f} s")
    if os.path.exists(path):
        raise SystemExit("sharded resume: the snapshot file outlived the run")
    check_reference(gnu, "sharded snapshot resumed single-device")

    # the collectives on the card: a process group of this one process
    t0 = time.perf_counter()
    initialize(f"file://{os.path.join(td, 'nccl_rendezvous')}", 1, 0,
               backend="nccl")
    try:
        mesh = global_samples_mesh(2, device)
        if mesh.group is None or mesh.world != 1:
            raise SystemExit("no one-rank process group after initialize()")
        up = time.perf_counter() - t0
        # the first collective makes the communicator: timed apart, so that
        # the run's level_s reads what a level's collectives cost
        t0 = time.perf_counter()
        dist.all_reduce(torch.zeros(1, dtype=torch.int64, device=device))
        torch.cuda.synchronize()
        log(f"nccl: one-rank group up in {up:.4f} s (backend "
            f"{dist.get_backend()}), its first all_reduce "
            f"{time.perf_counter() - t0:.4f} s")
        gnu = run("2 shards, gnu, in a one-rank NCCL group", mesh, tables2)
        check_reference(gnu, "sharded parity inside the NCCL group")
    finally:
        dist.destroy_process_group()
    return launches, k10


# ------------------------------------------------ phases 9-12: the rest of
# `dsm`: prefix ownership, the CLI's multi-host and planned mines, capacity
# planning against measured peaks, the wire-protocol fleet

def expected_owned_paths(depth: int, present1: int) -> int:
    """The reference's total_paths summed over the 4**depth prefix runs of
    hash depth `depth` (1 or 2): each run also counts its prefix's depth-1
    node, so each of the `present1` depth-1 nodes is counted by the
    4**(depth - 1) runs under it, as dsm_tpu's mine_owned counts them."""
    with open(os.path.join(HERE, "BENCH_BASELINE.json")) as f:
        full = json.load(f)["reference"]["total_paths"]
    return full + present1 * (4 ** (depth - 1) - 1)


def phase_owned(torch, idxs, device, warm) -> dict:
    """`mine_owned` on the card at 2 hosts x hash depth 1 and 3 hosts x
    hash depth 2: every set's merge equals the warm ascending run's bytes,
    with the reference's total_paths; each prefix's run launches the rank
    kernel once a level and once a drain.  Prints each prefix's wall and
    levels, and their sum against one full run that, like each of them,
    uploads its own tables.  -> the launches of the 3-host set."""
    from dsm_tpu_torch.mining import engine as eng
    from dsm_tpu_torch.mining.engine import MiningConfig
    from dsm_tpu_torch.ops import _build
    from dsm_tpu_torch.parallel.multihost import merge_outputs, mine_owned

    cfg = MiningConfig(fmin=FMIN, emax=EMAX)
    orig = eng.mine_torch
    runs = []

    def timed(indexes, cfg, prefix=b"", **kw):
        prof = {}
        rank0 = _build.LAUNCHES["rank"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(indexes, cfg, prefix=prefix, profile=prof, **kw)
        torch.cuda.synchronize()
        runs.append(dict(prefix=prefix.decode(),
                         wall=round(time.perf_counter() - t0, 4),
                         levels=prof["levels"], drains=prof["drains"],
                         ranks=_build.LAUNCHES["rank"] - rank0,
                         paths=out.total_paths, lines=out.total_output))
        return out

    full = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    orig(idxs, cfg, device=device, profile=full)
    torch.cuda.synchronize()
    full_wall = time.perf_counter() - t0
    present1 = None
    launches = None
    eng.mine_torch = timed
    try:
        for hosts, depth in ((2, 1), (3, 2)):
            runs.clear()
            torch.cuda.synchronize()
            _build.reset_launches()
            t0 = time.perf_counter()
            parts = [mine_owned(idxs, cfg, hosts, h, depth, device=device)
                     for h in range(hosts)]
            merged = merge_outputs(parts, len(idxs))
            wall = time.perf_counter() - t0
            label = f"{hosts} hosts x hash depth {depth}"
            launches = path_launches("mine", f"the owned phase, {label}")
            log(f"owned {label}: {len(runs)} prefix runs (prefix, wall s, "
                "levels, drains, rank launches, paths, lines): "
                + json.dumps([list(r.values()) for r in runs]))
            log(f"owned {label}: {wall:.4f} s in all, the prefixes' walls "
                f"sum to {sum(r['wall'] for r in runs):.4f} s against "
                f"{full_wall:.4f} s for one full run with its own tables "
                f"({sum(r['levels'] for r in runs)} levels against the "
                f"full run's {full['levels']})")
            bad = [r["prefix"] for r in runs
                   if r["ranks"] != r["levels"] + r["drains"]]
            if bad:
                raise SystemExit(f"owned {label}: the rank kernel was not "
                                 f"launched once a level and once a drain "
                                 f"in the runs of {bad}")
            if depth == 1:
                present1 = sum(r["paths"] > 0 for r in runs)
            want = expected_owned_paths(depth, present1)
            if merged.format_lines() != warm.format_lines() \
                    or merged.total_paths != want:
                raise SystemExit(
                    f"owned {label}: the merge differs from the warm "
                    f"ascending run (paths {merged.total_paths}, want {want})")
            log(f"owned {label}: the merge equals the warm ascending run's "
                f"bytes, {merged.total_paths:,} paths")
    finally:
        eng.mine_torch = orig
    return launches


def port_cli(args) -> subprocess.Popen:
    """`python -m dsm_tpu_torch <args>` from this checkout, started."""
    return subprocess.Popen(
        [sys.executable, "-m", "dsm_tpu_torch", *args], cwd=HERE,
        env={**os.environ, "PYTHONPATH": HERE}, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE)


def finish(procs, label: str, timeout: int = 600) -> list:
    """The (stdout, stderr) of started processes; fails unless each exits
    0 within `timeout` s, and stops them all."""
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for p, (_o, err) in zip(procs, outs):
        if p.returncode != 0:
            raise SystemExit(f"{label}: exit {p.returncode}:\n"
                             f"{err.decode()[-3000:]}")
    return outs


def postorder(blob: bytes) -> bytes:
    """Lines in the reference server's post-order (by path + 0xFF)."""
    return b"".join(sorted(blob.splitlines(keepends=True),
                           key=lambda ln: ln.split(b" ", 1)[0] + b"\xff"))


def phase_cli(idxs, td: str, warm) -> None:
    """The CLI on the card (its default --device): two `mine --num-hosts 2`
    processes, and `mine --engine auto -v`, on the card-built indexes saved
    as .dsmi."""
    d = os.path.join(td, "cli")
    os.makedirs(d)
    t0 = time.perf_counter()
    paths = []
    for i, idx in enumerate(idxs):
        paths.append(os.path.join(d, f"toy{i}.dsmi"))
        idx.save(paths[-1])
    log(f"cli: {len(paths)} indexes saved as .dsmi in "
        f"{time.perf_counter() - t0:.4f} s")
    mine = ["mine", "-f", str(FMIN), "-E", str(EMAX)]
    t0 = time.perf_counter()
    outs = finish([port_cli([*mine, "--num-hosts", "2", "--host-id", str(h),
                             *paths]) for h in range(2)],
                  "cli: mine --num-hosts 2")
    log(f"cli: two `mine --num-hosts 2` processes on the card in "
        f"{time.perf_counter() - t0:.4f} s")
    if postorder(outs[0][0] + outs[1][0]) != warm.format_lines():
        raise SystemExit("cli: the two hosts' stdouts in post-order differ "
                         "from the warm ascending run's bytes")
    t0 = time.perf_counter()
    (out, err), = finish([port_cli([*mine, "--engine", "auto", "-v",
                                    *paths])], "cli: mine --engine auto")
    line = next((ln for ln in err.decode().splitlines()
                 if ln.startswith("mine_big: ")), "")
    log(f"cli: `mine --engine auto -v` in {time.perf_counter() - t0:.4f} s: "
        f"{line}")
    if not line.startswith("mine_big: device — ") \
            or out != warm.format_lines():
        raise SystemExit("cli: `mine --engine auto` did not plan device mode "
                         "or its stdout differs from the warm ascending run")
    log("cli: both hosts' stdouts and `--engine auto`'s equal the warm "
        "ascending run's bytes")


def phase_capacity(torch, idxs, device) -> dict:
    """`plan` with the card's budget, `table_bytes + episode_bytes` against
    the peak device memory of the ascending, gnu and 2-shard runs, a
    budget 1 byte short, and the sizing error of DeviceIndexes.build under
    DSM_HBM_BYTES=1024.  -> the launches of the 2-shard run."""
    from dsm_tpu_torch.mining import bigindex as big
    from dsm_tpu_torch.mining.engine import (DeviceIndexes, MiningConfig,
                                             hbm_budget, mine_torch)
    from dsm_tpu_torch.ops import _build
    from dsm_tpu_torch.parallel.engine_episode import mine_device_sharded
    from dsm_tpu_torch.parallel.multihost import global_samples_mesh

    cfg = MiningConfig(fmin=FMIN, emax=EMAX)
    tb = big.table_bytes(idxs)
    eb = big.episode_bytes(idxs, FMIN)
    p = big.plan(idxs, fmin=FMIN, device=device)
    log(f"capacity: table_bytes {tb:,}, episode_bytes {eb:,} (fmin "
        f"{FMIN}), the card's budget {hbm_budget(device):,}: plan "
        f"{p.mode} ({p.reason})")
    if p.mode != "device":
        raise SystemExit("capacity: the card's own budget does not plan "
                         "device mode")
    short = big.plan(idxs, budget=tb + eb - 1, devices_available=1,
                     fmin=FMIN)
    log(f"capacity: budget {tb + eb - 1:,} (1 byte short), 1 device: plan "
        f"{short.mode}")
    if short.mode == "device":
        raise SystemExit("capacity: a budget 1 byte short plans device mode")

    def peak(label: str, planned: int, run) -> None:
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        run()
        torch.cuda.synchronize()
        got = torch.cuda.max_memory_allocated(device)
        log(f"capacity: {label}: planned {planned:,} bytes, peak "
            f"max_memory_allocated {got:,} ({before:,} allocated before the "
            f"run), planned / peak {planned / got:.3f}")
        if planned < got:
            raise SystemExit(f"capacity: {label}: the planned bytes are "
                             "below the measured peak")

    dev = DeviceIndexes.build(idxs, device)
    for order in ("ascending", "gnu"):
        peak(f"{order} run", tb + eb, lambda: mine_torch(
            idxs, cfg, dev=dev, device=device, reader_order=order))
    del dev
    _build.reset_launches()
    peak("2-shard gnu run (its tables built in the run)", tb + eb,
         lambda: mine_device_sharded(idxs, cfg,
                                     mesh=global_samples_mesh(2, device),
                                     reader_order="gnu"))
    launches = path_launches("mine_sharded", "the capacity phase's 2-shard run")
    old = os.environ.get("DSM_HBM_BYTES")
    os.environ["DSM_HBM_BYTES"] = "1024"
    try:
        DeviceIndexes.build(idxs, device)
        raise SystemExit("capacity: DeviceIndexes.build under "
                         "DSM_HBM_BYTES=1024 did not raise")
    except ValueError as e:
        if "mine_big" not in str(e):
            raise SystemExit(f"capacity: the sizing error names no way out: "
                             f"{e}")
        log(f"capacity: under DSM_HBM_BYTES=1024: {e}")
    finally:
        if old is None:
            del os.environ["DSM_HBM_BYTES"]
        else:
            os.environ["DSM_HBM_BYTES"] = old
    return launches


def free_base_port(n: int) -> int:
    """A port p with p .. p + n - 1 all free now."""
    import random
    import socket

    for _ in range(200):
        base = random.randrange(20000, 60000 - n)
        socks = []
        try:
            for port in range(base, base + n):
                socks.append(socket.socket())
                socks[-1].bind(("", port))
            return base
        except OSError:
            continue
        finally:
            for sock in socks:
                sock.close()
    raise SystemExit(f"fleet: no {n} consecutive free ports")


def phase_fleet(td: str, device) -> None:
    """`launch --mode local -E 1.2 -f 2` (4 servers, 5 clients of the port)
    on the port's indexes of tests/data/toydata, built on the card: the
    four outputs against the frozen goldens."""
    import glob
    import gzip

    from dsm_tpu_torch.index import indexes_from_fasta
    from dsm_tpu_torch.net.native import codec_name

    d = os.path.join(td, "fleet")
    os.makedirs(d)
    fastas = sorted(glob.glob(os.path.join(HERE, "tests", "data", "toydata",
                                           "toy*.fasta.gz")))
    paths = []
    for path, idx in zip(fastas, indexes_from_fasta(fastas, device)):
        paths.append(os.path.join(d, os.path.basename(path).split(".")[0]
                                  + ".dsmi"))
        idx.save(paths[-1])
    codec = codec_name()    # builds the codec the fleet's processes load
    t0 = time.perf_counter()
    (out, _err), = finish([port_cli(
        ["launch", "--mode", "local", "--tmpdir", os.path.join(d, "tmp"),
         "--outdir", os.path.join(d, "out"), "--base-port",
         str(free_base_port(4)), "-E", "1.2", "-f", "2", *paths])],
        "fleet: launch --mode local")
    wall = time.perf_counter() - t0
    for prefix in "ACGT":
        with gzip.open(os.path.join(HERE, "tests", "golden",
                                    f"server-output.default.{prefix}"
                                    ".txt.gz")) as f:
            want = f.read()
        with open(os.path.join(d, "out", f"server-output.{prefix}.txt"),
                  "rb") as f:
            if f.read() != want:
                raise SystemExit(f"fleet: server-output.{prefix} differs "
                                 "from the golden")
    log(f"fleet: `launch --mode local` (4 servers, {len(paths)} clients) in "
        f"{wall:.4f} s, codec {codec}; the four outputs equal "
        "tests/golden/server-output.default.{A,C,G,T}")


def gather_case(torch, blocks, label: str) -> dict:
    """K10 against its plain version on a real drain's blocks (one a shard
    that staged rows, each with its shard's base), as `_drain_sharded`
    hands them over, timed by events around the wrapper, by the
    profiler's device time and by the host's clock (the wrapper's Python
    and the launch); -> its entry of the kernels line."""
    from dsm_tpu_torch.ops.gatherpack import gather_pack, gather_pack_plain

    rows_ = [c for c, _b in blocks]
    bases = [b for _c, b in blocks]
    got = gather_pack(rows_, bases, 2)[0]
    want = gather_pack_plain(rows_, bases, 2)[0]
    torch.cuda.synchronize()
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    if err or not torch.equal(got, want):
        raise SystemExit(f"gather_pack disagrees with its plain version "
                         f"({label}: max abs err {err})")
    rows = got.shape[0]
    entry = dict(
        name="gather_pack", route="cuda",
        source="dsm_tpu_torch/csrc/gatherpack.cu",
        replaces="dsm_tpu/parallel/engine_episode.py:226", max_abs_err=err,
        ms=cuda_ms(torch, lambda: gather_pack(rows_, bases, 2), 20),
        device_ms=device_ms(torch, lambda: gather_pack(rows_, bases, 2)),
        host_ms=host_ms(torch, lambda: gather_pack(rows_, bases, 2)),
        plain_ms=cuda_ms(torch, lambda: gather_pack_plain(rows_, bases, 2)),
        # 20 bytes a row in and out (the table rides in the launch's
        # parameters); a test and an add a word
        **bound(2 * 20 * rows, 2 * 5 * rows), library_ms=None)
    log(f"kernel gather_pack: {label}: {len(rows_)} block(s), {rows:,} rows, "
        f"equal; {entry['ms']:.4f} ms by events around the wrapper, device "
        f"{fmt_ms(entry['device_ms'])}, host {entry['host_ms']:.4f} ms a "
        f"call, vs plain {entry['plain_ms']:.4f} ms (bound "
        f"{entry['bound_ms']:.6f} ms by {entry['bound_by']})")
    return entry


def phase_halt(torch, idxs, dev, device, warm) -> None:
    """The ascending mine halted under A at its first poll, against the
    warm ascending run `warm`."""
    from dsm_tpu_torch.mining.engine import MiningConfig, mine_torch
    from dsm_tpu_torch.ops import _build

    polls = []

    def halt(depth, out):
        polls.append(depth)
        return [b"A"]

    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    got = mine_torch(idxs, MiningConfig(fmin=FMIN, emax=EMAX), dev=dev,
                     device=device, out_reserve=HALT_RESERVE, halt=halt)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    path_launches("mine", "the halt phase")
    lines = got.format_lines().splitlines()
    want = warm.format_lines().splitlines()
    first = polls[0] if polls else None
    log(f"halt: polls at depths {polls}; {len(lines)} of {len(want)} lines "
        f"in {wall:.4f} s")
    outside = [ln for ln in want if not ln.startswith(b"A")]
    if (first is None or not set(lines) <= set(want)
            or any(ln.startswith(b"A") and len(ln.split(b" ", 1)[0]) > first
                   for ln in lines)
            or [ln for ln in lines if not ln.startswith(b"A")] != outside):
        raise SystemExit("halt: the halted output is not the warm run's "
                         "pruned below A at the first poll")
    if len(lines) == len(want):
        raise SystemExit("halt: nothing was pruned")
    log("halt: a subset of the warm run, nothing under A deeper than the "
        "first poll, the lines outside A equal")


def level_times(torch, device) -> None:
    """Times, without checks, the kernels and runs of the package beside
    this file that a redesign of the level's kernels moves, and prints one
    JSON line: the stats step (K2) on `segstats_level`'s three levels (CUDA
    events: three timings of 20 calls; the profiler's device time), the
    decode (K6) on `decode_inputs`' two histories and on two real frontier
    decodes of the scale-100 gnu mine at RESUME_RESERVE (the widest, and
    the one of the most rows x levels; its snapshot writes skipped), the
    warm ascending mine (five walls and level_s, then one run under
    torch.profiler: device time and activities), the gnu mine's walls and
    level_s with 2 and 5 sample shards on the one card (three runs each,
    then one under torch.profiler: device time, activities and launches),
    K9a on one shard of `segstats_level`'s three levels and K9b, with the
    sharded level's torch glue where the tree's K9b leaves that to torch
    (`shardstats_calls`), on `sharded_level`'s level split into 2 and 5
    shards; and each real level's (nodes, pairs, widest node) of the warm
    ascending mine and the 2-shard gnu mine (a shard's pairs and widest
    node each).  A copy of this file in the root of another tree of the
    repo times that tree, so that two commits are compared in turns with
    the same code."""
    from dsm_tpu_torch.mining import checkpoint as ckpt
    from dsm_tpu_torch.mining import engine_device as ed
    from dsm_tpu_torch.mining.engine import (DeviceIndexes, MiningConfig,
                                             mine_torch)
    from dsm_tpu_torch.ops import _build
    from dsm_tpu_torch.ops.decode import decode
    from dsm_tpu_torch.ops.segstats import Gates, segstats
    from dsm_tpu_torch.parallel import engine_episode as tee
    from dsm_tpu_torch.parallel.engine_episode import mine_device_sharded
    from dsm_tpu_torch.parallel.engine_sharded import ShardedIndexes
    from dsm_tpu_torch.parallel.multihost import global_samples_mesh

    res = {"tree": HERE, "smi": smi_line()}
    phase_build()
    for label in SEG_WIDTHS:
        args = segstats_level(torch, label, device)
        res[f"k2_{label}_ms"] = [cuda_ms(torch, lambda: segstats(*args), 20)
                                 for _ in range(3)]
        res[f"k2_{label}_device_ms"] = device_ms(
            torch, lambda: segstats(*args), 10)
        res[f"k2_{label}_shape"] = [args[0].shape[0] - 1, args[1].shape[0]]
        nb, freq, cbits, g = args
        nid = torch.repeat_interleave(
            torch.arange(nb.shape[0] - 1, device=device),
            (nb[1:] - nb[:-1]).to(torch.int64), output_size=freq.shape[0])
        k9a, _k9b = shardstats_calls(torch, [(nb, nid, nid, freq, cbits)], g,
                                     [0])
        res[f"k9a_{label}_ms"] = [cuda_ms(torch, k9a, 20) for _ in range(3)]
        res[f"k9a_{label}_device_ms"] = device_ms(torch, k9a, 10)
    del args, nb, freq, cbits, nid
    gen = torch.Generator(device=device)
    gen.manual_seed(2029)
    level = sharded_level(torch, gen, device)
    g = Gates(depth=7, s_total=5, mindepth=0, pmin=2, pmax=0,
              use_egate=True, sym_mask=0b1111, emin_lo=-0.01, emax_hi=1.21)
    for nsh, bounds in ((2, (0, 2, 5)), (5, (0, 1, 2, 3, 4, 5))):
        shards = split_level(torch, level, bounds)
        k9a, k9b = shardstats_calls(torch, shards, g,
                                    [1000 * k for k in range(nsh)])
        k9a()
        res[f"k9b_{nsh}_ms"] = [cuda_ms(torch, k9b, 20) for _ in range(3)]
        res[f"k9b_{nsh}_device_ms"] = device_ms(torch, k9b, 10)
        res[f"k9b_{nsh}_activities"] = device_profile(torch, k9b)[1]
    del level, shards, k9a, k9b

    cfg = MiningConfig(fmin=FMIN, emax=EMAX)
    with tempfile.TemporaryDirectory(prefix="dsm_times_") as td:
        idxs, _toy0, _ = phase_data(torch, load_make_toydata(), td, device)
        dev = DeviceIndexes.build(idxs, device)
        widest, most = {}, {}
        fc, save = ed._frontier_codes, ckpt.save_checkpoint
        ed._frontier_codes = frontier_recorder(
            (widest, lambda n, j: n), (most, lambda n, j: n * j))
        ckpt.save_checkpoint = lambda *a, **k: None
        try:
            mine_torch(idxs, cfg, dev=dev, device=device, reader_order="gnu",
                       out_reserve=RESUME_RESERVE,
                       checkpoint=os.path.join(td, "times.ckpt"))
        finally:
            ed._frontier_codes, ckpt.save_checkpoint = fc, save
    gen = torch.Generator(device=device)
    gen.manual_seed(2027)
    cases = list(decode_inputs(torch, gen, device)) + [
        ("frontier_widest", frontier_args(torch, widest, device)),
        ("frontier_most", frontier_args(torch, most, device))]
    for label, args in cases:
        key = "k6_" + label.split()[0].replace("-", "_")
        res[f"{key}_ms"] = [cuda_ms(torch, lambda: decode(*args), 10)
                            for _ in range(3)]
        res[f"{key}_device_ms"] = device_ms(torch, lambda: decode(*args), 5)
        res[f"{key}_shape"] = [args[2].shape[0], args[4]]
    del cases, args

    mine_torch(idxs, cfg, dev=dev, device=device)
    res["warm_wall_s"], res["warm_level_s"] = [], []
    for _ in range(5):
        prof = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mine_torch(idxs, cfg, dev=dev, device=device, profile=prof)
        torch.cuda.synchronize()
        res["warm_wall_s"].append(time.perf_counter() - t0)
        res["warm_level_s"].append(prof["level_s"])
    prof = {}
    _build.reset_launches()
    ms, acts, top = device_profile(torch, lambda: mine_torch(
        idxs, cfg, dev=dev, device=device, profile=prof))
    res.update(warm_device_ms=ms, warm_activities=acts,
               warm_levels=prof["levels"], warm_top=top,
               warm_activities_a_level=acts / prof["levels"],
               warm_launches=dict(_build.LAUNCHES), widths_single=[])
    level = ed._level

    def recording(dev_, sc, st, eskip=0):
        res["widths_single"].append([st.nnodes, st.npairs,
                                     int((st.nb[1:] - st.nb[:-1]).max())])
        return level(dev_, sc, st, eskip)

    ed._level = recording
    try:
        mine_torch(idxs, cfg, dev=dev, device=device)
    finally:
        ed._level = level
    del dev
    for nsh in (2, 5):
        mesh = global_samples_mesh(nsh, device)
        tables = ShardedIndexes.build(idxs, mesh)
        walls, lvl = [], []
        for _ in range(3):
            prof = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mine_device_sharded(idxs, cfg, mesh=mesh, dev=tables,
                                reader_order="gnu", profile=prof)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            lvl.append(prof["level_s"])
        res[f"sharded{nsh}_wall_s"], res[f"sharded{nsh}_level_s"] = walls, lvl
        prof = {}
        _build.reset_launches()
        ms, acts, top = device_profile(torch, lambda: mine_device_sharded(
            idxs, cfg, mesh=mesh, dev=tables, reader_order="gnu",
            profile=prof))
        res.update({f"sharded{nsh}_device_ms": ms,
                    f"sharded{nsh}_activities": acts,
                    f"sharded{nsh}_levels": prof["levels"],
                    f"sharded{nsh}_activities_a_level": acts / prof["levels"],
                    f"sharded{nsh}_top": top,
                    f"sharded{nsh}_launches": {
                        k: _build.LAUNCHES[k]
                        for k in _build.PATHS["mine_sharded"]}})
        if nsh == 2:
            res["widths_sharded2"] = []
            level_sharded = tee._level_sharded

            def recording(dev_, sc, st, mesh_, eskip=0):
                # a process's one pair list, or (older trees) its shards'
                lists = st.shards if hasattr(st, "shards") else [st]
                res["widths_sharded2"].append([
                    st.nnodes, [x.pairs.shape[0] for x in lists],
                    [int((x.nb[1:] - x.nb[:-1]).max()) for x in lists]])
                return level_sharded(dev_, sc, st, mesh_, eskip)

            tee._level_sharded = recording
            try:
                mine_device_sharded(idxs, cfg, mesh=mesh, dev=tables,
                                    reader_order="gnu")
            finally:
                tee._level_sharded = level_sharded
        del tables
    print(json.dumps(res), flush=True)


def drain_times(torch, device) -> None:
    """Times, without checks, the drains of the package beside this file and
    its gather kernel (K10), and prints one JSON line: every drain's (rows,
    emits staged since the drain before) of the scale-100 mine on one device
    (ascending and gnu) and with 1, 2 and 5 shards on the one card (gnu);
    the largest drain of each replayed from a copy of what it found staged,
    its host half skipped, so that what is timed is its device part and the
    readbacks (CUDA events around 20 replays, three times, then one replay
    under torch.profiler: device time, activities and the kernels with the
    most time); K10 on the blocks that the largest 2- and 5-shard drains
    hand it, and on 5 blocks of ~GATHER_ROWS rows with codes in
    GATHER_SETS sets taken in turn (inputs cold in the L2).  It calls only
    what every tree of the repo has had since the sharded episode (the
    drains, their host half, the gather's contract), so a copy of this file
    in the root of another tree times that tree, and two commits are
    compared in turns with the same code (parent, change, change,
    parent)."""
    import copy

    from dsm_tpu_torch.mining import engine_device as ed
    from dsm_tpu_torch.mining.engine import (DeviceIndexes, MiningConfig,
                                             mine_torch)
    from dsm_tpu_torch.ops import _build
    from dsm_tpu_torch.parallel import engine_episode as tee
    from dsm_tpu_torch.parallel.engine_sharded import ShardedIndexes
    from dsm_tpu_torch.parallel.multihost import global_samples_mesh

    res = {"tree": HERE, "smi": smi_line()}
    phase_build()
    cfg = MiningConfig(fmin=FMIN, emax=EMAX)
    with tempfile.TemporaryDirectory(prefix="dsm_drain_") as td:
        idxs, _toy0, _ = phase_data(torch, load_make_toydata(), td, device)
    dev = DeviceIndexes.build(idxs, device)

    def timed(label: str, fn) -> None:
        res[f"{label}_ms"] = [cuda_ms(torch, fn, 20) for _ in range(3)]
        ms, acts, top = device_profile(torch, fn)
        res[f"{label}_device_ms"], res[f"{label}_activities"] = ms, acts
        res[f"{label}_top"] = top

    def parts(st):
        return st.shards if hasattr(st, "shards") else [st]

    res["drains"], largest, gathers = {}, {}, {}
    gather = tee.gather_pack

    def recorder(label: str, drain):
        emits = [_build.LAUNCHES["compact"]]

        def recording(*a, **k):
            shards = parts(a[3])
            rows = sum(x.ocount for x in shards)
            staged = [(copy.deepcopy(x.out), x.ocount) for x in shards]

            def keeping(*ga, **gk):
                got = gather(*ga, **gk)
                gathers[label] = copy.deepcopy((ga, gk))
                return got

            tee.gather_pack = keeping
            try:
                done = drain(*a, **k)
            finally:
                tee.gather_pack = gather
            if done:
                res["drains"].setdefault(label, []).append(
                    [rows, _build.LAUNCHES["compact"] - emits[0]])
                if rows > largest.get(label, (0,))[0]:
                    largest[label] = (rows, a, k, staged)
            emits[0] = _build.LAUNCHES["compact"]
            return done
        return recording

    d0, s0, e0 = ed._drain, tee._drain_sharded, tee._emit_drained
    try:
        for order in ("ascending", "gnu"):
            ed._drain = recorder(f"single_{order}", d0)
            mine_torch(idxs, cfg, dev=dev, device=device, reader_order=order)
        for n in (1, 2, 5):
            mesh = global_samples_mesh(n, device)
            tee._drain_sharded = recorder(f"sharded{n}_gnu", s0)
            tee.mine_device_sharded(idxs, cfg, mesh=mesh,
                                    dev=ShardedIndexes.build(idxs, mesh),
                                    reader_order="gnu")
        # the replays: what the drain found staged put back each time (the
        # drains leave the staged tensors as they were), the host half
        # (_emit_drained) skipped
        ed._drain, tee._drain_sharded = d0, s0
        ed._emit_drained = tee._emit_drained = lambda *a, **k: None
        for label, (rows, a, k, staged) in largest.items():
            drain = d0 if label.startswith("single") else s0

            def replay():
                for x, (out, oc) in zip(parts(a[3]), staged):
                    x.out, x.ocount = out, oc
                drain(*a, **k)

            res[f"drain_{label}_rows"] = rows
            timed(f"drain_{label}", replay)
    finally:
        ed._drain, tee._drain_sharded = d0, s0
        ed._emit_drained = tee._emit_drained = e0

    for n in (2, 5):
        ga, gk = gathers[f"sharded{n}_gnu"]
        res[f"k10_sharded{n}_rows"] = sum(b.shape[0] for b in ga[0])
        res[f"k10_sharded{n}_blocks"] = len(ga[0])
        timed(f"k10_sharded{n}", lambda: gather(*ga, **gk))
        res[f"k10_sharded{n}_host_ms"] = host_ms(
            torch, lambda: gather(*ga, **gk))
    gen = torch.Generator(device=device)
    gen.manual_seed(2031)
    i32 = dict(dtype=torch.int32, device=device, generator=gen)
    sizes = [GATHER_ROWS + 1000 * b for b in range(5)]
    sets = [([torch.randint(-2**31, 2**31 - 1000, (m, 5), **i32)
              for m in sizes],
             [torch.randint(0, 6, (m,), **i32).to(torch.int8)
              for m in sizes]) for _ in range(GATHER_SETS)]
    bases = [7 * b for b in range(5)]
    turn = iter(range(1 << 30))

    def cold():
        blocks, lcs = sets[next(turn) % GATHER_SETS]
        gather(blocks, bases, 2, lcs)

    res["k10_5blocks_rows"] = sum(sizes)
    timed("k10_5blocks_cold", cold)
    print(json.dumps(res), flush=True)


def random_tables(torch, rng, samples: int, n: int, device):
    """`samples` texts of n random A/C/G/T codes as stacked forward tables
    on `device` (a DeviceIndexes whose reverse tables are the same rows):
    the rank kernel reads nothing but the rows, so any text times it."""
    from dsm_tpu_torch.mining.engine import EXT4, DeviceIndexes
    from dsm_tpu_torch.ops.rank import OccTable, fused_rows

    parts, offs, off = [], [], 0
    for _ in range(samples):
        t = OccTable.build(rng.choice(np.array(EXT4, dtype=np.int8), size=n))
        parts.append(fused_rows(t, c4=[int(t.C[x]) for x in EXT4]))
        offs.append(off)
        off += parts[-1].shape[0]
    rows = np.concatenate(parts)
    return DeviceIndexes.from_host([n] * samples, rows, rows, offs, device)


def expand_times(torch, device) -> None:
    """Times, without checks but equality, the expand step of the package
    beside this file and prints one JSON line: the one-table `expand`
    (events, five times 20 calls, and device time) on 5 random texts of
    1.6M symbols and seeded synthetic levels (`synthetic_pairs`) of
    4,198,755 pairs (96.4% with both ends in one table row) and 1,428,600
    (90%); where the package has it, `expand_tables` against `expand` on
    the same pairs of 273 random texts of 122,000 symbols cut into 128
    shard tables (row slices of the stacked table), with 1,905,212 pairs of
    random sample ids (the sample order of a level of 1.24 pairs a node)
    and 4,619,296 with runs of consecutive ids (a level whose nodes hold
    every sample).  It calls only `expand`'s contract for the first part,
    so a copy of this file in the root of another tree times that tree,
    and two commits are compared in turns (parent, change, change,
    parent)."""
    from dsm_tpu_torch.ops import rank

    phase_build()
    res = {"tree": HERE, "smi": smi_line()}
    rng = np.random.default_rng(15)
    dev = random_tables(torch, rng, 5, 1_600_000, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(2030)
    for p, share in ((4_198_755, 0.964), (1_428_600, 0.9)):
        pairs = synthetic_pairs(torch, dev, gen, p, share)
        fn = lambda: rank.expand(dev.frows, pairs, FMIN, 0b1111)  # noqa: E731
        res[f"expand_{p}_ms"] = [cuda_ms(torch, fn, 20) for _ in range(5)]
        res[f"expand_{p}_device_ms"] = device_ms(torch, fn)
    del dev
    if hasattr(rank, "expand_tables"):
        S, n, shards = 273, 122_000, 128
        dev = random_tables(torch, rng, S, n, device)
        bounds = [k * S // shards for k in range(shards + 1)]
        for label, p in (("random", 1_905_212), ("runs", 4_619_296)):
            sid = (torch.randint(0, S, (p,), device=device, generator=gen)
                   if label == "random" else torch.arange(p, device=device) % S)
            u = torch.rand((2, p), device=device, generator=gen,
                           dtype=torch.float64)
            pairs = torch.zeros((p, 6), dtype=torch.int32, device=device)
            pairs[:, 0] = (u[0] * (n + 1)).to(torch.int64)
            pairs[:, 1] = torch.clamp(pairs[:, 0] + (u[1] * 300).to(
                torch.int32), max=n)
            pairs[:, 3], pairs[:, 4] = sid, dev.soff[sid]
            one = lambda: rank.expand(dev.frows, pairs, FMIN,  # noqa: E731
                                      0b1111)
            e = expand_tables_case(torch, dev, pairs, bounds,
                                   f"{S} random texts, {label} ids")
            res[f"tables_{label}"] = {k: e[k] for k in (
                "ms", "device_ms", "plain_ms", "bound_ms")}
            res[f"tables_{label}_expand_ms"] = [cuda_ms(torch, one, 20)
                                                for _ in range(3)]
            res[f"tables_{label}_expand_device_ms"] = device_ms(torch, one)
        res["tables"] = shards
    print(json.dumps(res), flush=True)


def variant_times(torch, device) -> None:
    """The decode (K6) on `decode_inputs`' histories, the stats step (K2)
    and the partial rows (K9a) on `segstats_level`'s levels (K9a also on
    the 3-sample and a 1-sample shard of `sharded_level`'s level), each
    held against its plain version and timed (CUDA events: three timings
    of 10 calls) through the package's wrappers, and K9b on that level in
    2 shards (`k9b_case`'s checks, then three timings), first as built and
    then with each of VARIANTS: its source with one constant changed, built
    with the other sources into its own library under build/variants/;
    prints one JSON line."""
    import re
    import shutil

    from dsm_tpu_torch.ops import _build
    from dsm_tpu_torch.ops.decode import decode, decode_plain
    from dsm_tpu_torch.ops.segstats import (S_ENT_MIN, Gates, segstats,
                                            segstats_plain)
    from dsm_tpu_torch.ops.shardstats import (PART_COLS, shard_partials,
                                              shard_partials_plain)

    def k9a(nb, freq, cbits, g):
        out = torch.empty((nb.shape[0] - 1, PART_COLS), dtype=torch.int64,
                          device=device)
        kept = torch.empty(1, dtype=torch.float64, device=device)
        shard_partials(nb, freq, cbits, g.sym_mask, out, kept)
        return out, kept

    def k9a_plain(nb, freq, cbits, g):
        return shard_partials_plain(nb, freq, cbits, g.sym_mask)

    gen = torch.Generator(device=device)
    gen.manual_seed(2027)
    g9 = Gates(depth=7, s_total=5, mindepth=0, pmin=2, pmax=0,
               use_egate=True, sym_mask=0b1111, emin_lo=-0.01, emax_hi=1.21)
    level = sharded_level(torch, gen, device)
    shards2 = split_level(torch, level, (0, 2, 5))
    k9a_in = {label: segstats_level(torch, label, device)
              for label in SEG_WIDTHS}
    for label, bounds in (("shard of 3 samples", (0, 2, 5)),
                          ("shard of 1 sample", (0, 4, 5))):
        nb, _nid, _sid, freq, cbits = split_level(torch, level, bounds)[1]
        k9a_in[label] = (nb, freq, cbits, g9)
    cases = {"decode.cu": (decode, decode_plain,
                           dict(decode_inputs(torch, gen, device))),
             "segstats.cu": (segstats, segstats_plain, {
                 label: segstats_level(torch, label, device)
                 for label in SEG_WIDTHS}),
             "shardstats.cu": (k9a, k9a_plain, k9a_in)}
    want = {src: {label: plain(*args) for label, args in inputs.items()}
            for src, (_fn, plain, inputs) in cases.items()}
    res = {"smi": smi_line()}

    def time_source(src: str, tag: str) -> None:
        fn, _plain, inputs = cases[src]
        for label, args in inputs.items():
            got, exp = fn(*args), want[src][label]
            if src == "segstats.cu":   # flags, pair_out, counts; entropy
                equal = (torch.equal(got[0], exp[0])
                         and torch.equal(got[2], exp[2])
                         and got[3][:S_ENT_MIN].tolist()
                         == exp[3][:S_ENT_MIN].tolist()
                         and float((got[1] - exp[1]).abs().max()) <= ENT_TOL)
            elif src == "shardstats.cu":   # the log's unit a pair, as k9a_case
                nb = args[0]
                equal = (torch.equal(got[0][:, [0, 2]], exp[0][:, [0, 2]])
                         and bool(((got[0][:, 1] - exp[0][:, 1]).abs()
                                   <= (nb[1:] - nb[:-1])).all())
                         and torch.equal(got[1], exp[1]))
            else:
                equal = all(torch.equal(a, b) for a, b in zip(got, exp))
            if not equal:
                raise SystemExit(f"variant_times: {tag} disagrees with the "
                                 f"plain version on {label}")
            res[f"{tag} {label}"] = [cuda_ms(torch, lambda: fn(*args), 10)
                                     for _ in range(3)]
        if src == "shardstats.cu":
            k9b_case(torch, shards2, g9, device)   # its checks
            k9a2, k9b2 = shardstats_calls(torch, shards2, g9, [0, 1000])
            k9a2()
            res[f"{tag} K9b 2 shards"] = [cuda_ms(torch, k9b2, 10)
                                          for _ in range(3)]

    phase_build()
    for src in cases:
        time_source(src, f"{src} as built")
    csrc, build_dir = _build.CSRC, _build.BUILD_DIR
    try:
        for src, name, value in VARIANTS:
            work = os.path.join(HERE, "build", "variants", f"{name}{value}")
            shutil.rmtree(work, ignore_errors=True)
            shutil.copytree(csrc, os.path.join(work, "csrc"))
            path = os.path.join(work, "csrc", src)
            with open(path) as fh:
                text, n = re.subn(rf"constexpr int {name} = \d+;",
                                  f"constexpr int {name} = {value};",
                                  fh.read())
            if n != 1:
                raise SystemExit(f"variant_times: no constant {name} in {src}")
            with open(path, "w") as fh:
                fh.write(text)
            _build.CSRC = Path(work) / "csrc"
            _build.BUILD_DIR, _build._lib = Path(work), None
            _build.lib()
            time_source(src, f"{src} {name} = {value}")
    finally:
        _build.CSRC, _build.BUILD_DIR, _build._lib = csrc, build_dir, None
    print(json.dumps(res), flush=True)


# ------------------------------------------------ phase 15: scale 1000, the
# JAX package's largest size (bench.py:240-281), against a reference frozen
# from the JAX package's own host engine

def s1000_build(torch, toy, td: str, device):
    """The scale-1000 toydata and its indexes built on the card per sample
    (10 suffix arrays of ~16.2M symbols through K8); -> (indexes, toy0's
    forward and reverse codes, the build's launches, seconds a sample)."""
    from dsm_tpu_torch.index import indexes_from_fasta
    from dsm_tpu_torch.index.alphabet import transform
    from dsm_tpu_torch.index.fasta import read_fasta
    from dsm_tpu_torch.index.fmindex import collection_codes
    from dsm_tpu_torch.ops import _build

    t0 = time.perf_counter()
    fastas = toy.make_toydata(os.path.join(td, "s1000"), scale=S1000["scale"],
                              seed=toy.GOLDEN_SEED)
    log(f"scale 1000: toydata made on the host in "
        f"{time.perf_counter() - t0:.2f} s")
    idxs, secs = [], []
    torch.cuda.synchronize()
    _build.reset_launches()
    for path in fastas:
        t0 = time.perf_counter()
        idxs += indexes_from_fasta([path], device)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    launches = path_launches("build", "the scale-1000 build")
    n = sum(i.n for i in idxs)
    log(f"scale 1000: {n:,} indexed symbols in {len(idxs)} samples, built on "
        f"the card in {sum(secs):.4f} s (per sample: "
        f"{', '.join(f'{t:.4f}' for t in secs)} s)")
    if n != S1000["symbols"]:
        raise SystemExit(f"scale 1000: {n} indexed symbols, the reference "
                         f"has {S1000['symbols']}")
    codes, rcodes, _lengths, _max = collection_codes(
        [transform(rec.seq) for rec in read_fasta(fastas[0])])
    return idxs, (codes, rcodes), launches, secs


def s1000_sa(torch, toy0, device) -> list[dict]:
    """K8 on toy0 at scale 1000: both directions' whole suffix arrays
    against suffix_array_plain on the card, timed, and the sort's round k =
    16 (`sa_round`) with the rank update; -> the sort's and the rank's
    entries."""
    from dsm_tpu_torch.ops.sa import (rank_round, rank_round_plain,
                                      sort_round, suffix_array,
                                      suffix_array_plain)

    for label, codes in zip(("forward", "reverse"), toy0):
        c = torch.as_tensor(codes, device=device)
        got, want = suffix_array(c), suffix_array_plain(c)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise SystemExit(f"scale 1000: the SA kernels disagree with the "
                             f"plain version on toy0 {label}")
        log(f"kernel suffix_array: scale 1000 toy0 {label} n={c.numel():,} "
            f"equal; {cuda_ms(torch, lambda: suffix_array(c), 3):.3f} ms vs "
            f"plain {cuda_ms(torch, lambda: suffix_array_plain(c), 2):.3f} "
            f"ms")
        del got, want
    c = torch.as_tensor(toy0[0], device=device)
    rank, k, top, (keys, order), ms, plain_ms, lib_ms = sa_round(
        torch, c, "scale 1000 toy0 forward")
    r1, r2 = rank.clone(), rank.clone()
    if rank_round(keys, order, r1) != rank_round_plain(keys, order, r2) \
            or not torch.equal(r1, r2):
        raise SystemExit("scale 1000: sa_rank disagrees with its plain "
                         "version")
    n = rank.shape[0]
    return [
        dict(name="sa_sort", route="cuda", source="dsm_tpu_torch/csrc/sa.cu",
             replaces="dsm_tpu/ops/sa.py:109", max_abs_err=0, ms=ms,
             # from scratch: sa_round keeps the previous order to itself
             device_ms=device_ms(torch, lambda: sort_round(rank, k, top)),
             plain_ms=plain_ms,
             **bound(n * (4 + 4 + 8 + 4),
                     2 * n * sort_bytes_per_key(n, k, top, True)[1]),
             library_ms=lib_ms),
        dict(name="sa_rank", route="cuda", source="dsm_tpu_torch/csrc/sa.cu",
             replaces="dsm_tpu/ops/sa.py:110", max_abs_err=0,
             ms=cuda_ms(torch, lambda: rank_round(keys, order, r1)),
             device_ms=device_ms(torch, lambda: rank_round(keys, order, r1)),
             plain_ms=cuda_ms(torch,
                              lambda: rank_round_plain(keys, order, r2)),
             **bound(n * (8 + 4 + 4), 3 * n), library_ms=None)]


def s1000_check(out, want: dict, label: str, order: str) -> str:
    """A scale-1000 output against the frozen entry `want` (paths, lines
    and the sha256 of its bytes in `order`); -> that sha256."""
    sha = hashlib.sha256(out.format_lines()).hexdigest()
    got = (out.total_paths, out.total_output, sha)
    exp = (want["paths"], want["lines"], want[order])
    if got != exp:
        raise SystemExit(f"scale 1000 {label} ({order}) FAILED: got paths, "
                         f"lines, sha256 {got}, want {exp}")
    log(f"scale 1000 {label} ({order}): {out.total_paths:,} paths, "
        f"{out.total_output:,} lines, sha256 {sha}: the frozen reference's")
    return sha


def s1000_run(torch, label: str, run, mine_path: str = "mine",
              tag: str = "scale 1000") -> tuple:
    """One run of phase 15 (or 16: `tag`): the launch counts set to 0 just
    before it and
    read just after (every kernel of `mine_path` launched), its wall, its
    profile, the host seconds of its walks down pulled history segments
    (`walk_s`: engine_device._history_codes timed) and its peak device
    memory; -> (output, the record)."""
    from dsm_tpu_torch.mining import engine_device as ed
    from dsm_tpu_torch.ops import _build

    prof, walk = {}, [0.0]
    history_codes = ed._history_codes

    def timed(*a):
        t = time.perf_counter()
        codes = history_codes(*a)
        walk[0] += time.perf_counter() - t
        return codes

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    _build.reset_launches()
    ed._history_codes = timed
    t0 = time.perf_counter()
    try:
        out = run(prof)
        torch.cuda.synchronize()
    finally:
        ed._history_codes = history_codes
    wall = time.perf_counter() - t0
    prof["walk_s"] = walk[0]
    launches = {k: _build.LAUNCHES[k] for k in _build.PATHS[mine_path]}
    rec = dict(
        wall_s=wall, paths=out.total_paths, lines=out.total_output,
        paths_per_s=out.total_paths / wall,
        peak_bytes=torch.cuda.max_memory_allocated(),
        allocated_before=before, launches=launches,
        **{k: (round(v, 4) if isinstance(v, float) else v)
           for k, v in prof.items()})
    log(f"{tag} {label}: {json.dumps(rec)}")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise SystemExit(f"{tag} {label}: kernels never launched: "
                         f"{missing}")
    if mine_path == "mine" and launches["rank"] != prof["levels"] \
            + prof["drains"]:
        raise SystemExit(f"{tag} {label}: the rank kernel was not "
                         "launched once a level and once a drain")
    if mine_path == "mine_sharded":
        level_launches_once(f"{tag} {label}", prof)
    return out, rec


def s1000_prefixes(torch, idxs, dev, device) -> dict:
    """The JAX package's topology at scale 1000 (bench.py:240-281): one
    run an enforced prefix A, C, G, T over the one upload `dev`, ascending
    and gnu, each against the frozen prefix; their concatenation against
    the frozen whole; -> the records."""
    from dsm_tpu_torch.mining.engine import MiningConfig, mine_torch

    cfg = MiningConfig(fmin=FMIN, emax=EMAX)
    # one run first pays the process's one-time costs at this size (the
    # host indexes' lazy dense tables, which the tail reads)
    t0 = time.perf_counter()
    mine_torch(idxs, cfg, prefix=b"A", dev=dev, device=device)
    torch.cuda.synchronize()
    log(f"scale 1000: a first prefix run (A, ascending, not checked) in "
        f"{time.perf_counter() - t0:.4f} s")
    recs, blobs, paths = {}, {"ascending": [], "gnu": []}, 0
    for p in "ACGT":
        for order in ("ascending", "gnu"):
            out, recs[f"{p} {order}"] = s1000_run(
                torch, f"prefix {p} {order}",
                lambda prof: mine_torch(idxs, cfg, prefix=p.encode(),
                                        dev=dev, device=device,
                                        reader_order=order, profile=prof))
            s1000_check(out, S1000["prefixes"][p], f"prefix {p}", order)
            blobs[order].append(out.format_lines())
        paths += out.total_paths
    for order, parts in blobs.items():
        sha = hashlib.sha256(b"".join(parts)).hexdigest()
        if sha != S1000[order]:
            raise SystemExit(f"scale 1000: the four prefixes' {order} bytes "
                             f"concatenated: sha256 {sha}, want "
                             f"{S1000[order]}")
    if paths != S1000["paths"]:
        raise SystemExit(f"scale 1000: the prefixes' paths sum to {paths}, "
                         f"want {S1000['paths']}")
    log(f"scale 1000: the four prefix runs over one upload equal the frozen "
        f"reference, each and concatenated ({paths:,} paths; walls "
        f"{sum(r['wall_s'] for r in recs.values()):.2f} s in all)")
    return recs


def s1000_keeper(torch, store: dict, entry: str, key):
    """A stand-in for engine_device's `entry` (leftchar_rows or decode)
    that keeps a copy of the inputs of its largest call by key(args) in
    `store`, then calls the original; -> (the original, the stand-in)."""
    from dsm_tpu_torch.mining import engine_device as ed

    orig = getattr(ed, entry)

    def keeping(*args):
        k = key(*args)
        if k > store.get("key", -1):
            store.update(key=k, args=tuple(
                a.clone() if isinstance(a, torch.Tensor) else a
                for a in args))
        return orig(*args)

    return orig, keeping


def s1000_whole(torch, idxs, dev, device) -> tuple:
    """The whole trie in one episode, ascending (keeping its largest
    drain's rows and path decode for the kernel checks) and gnu, each
    against the frozen concatenation, pulling its history to the host at
    least once under the default cap (2^28 entries for ~463M nodes), then
    ascending once more under torch.profiler; -> (records, the kept
    inputs)."""
    from dsm_tpu_torch.mining import engine_device as ed
    from dsm_tpu_torch.mining.engine import MiningConfig, mine_torch

    cfg = MiningConfig(fmin=FMIN, emax=EMAX)
    kept = {"leftchar": {}, "decode": {}}
    lc_orig, lc_keep = s1000_keeper(torch, kept["leftchar"], "leftchar_rows",
                                    lambda tables, orows: orows.shape[0])
    dec_orig, dec_keep = s1000_keeper(
        torch, kept["decode"], "decode",
        lambda hist, lvl_off, rows, jrel, maxj: rows.shape[0] * maxj)

    def whole(order):
        return lambda prof: mine_torch(idxs, cfg, dev=dev, device=device,
                                       reader_order=order, profile=prof)

    recs, outs = {}, {}
    ed.leftchar_rows, ed.decode = lc_keep, dec_keep
    try:
        outs["ascending"], recs["ascending"] = s1000_run(
            torch, "whole trie ascending (the drains' inputs kept)",
            whole("ascending"))
    finally:
        ed.leftchar_rows, ed.decode = lc_orig, dec_orig
    outs["gnu"], recs["gnu"] = s1000_run(torch, "whole trie gnu",
                                         whole("gnu"))
    prof = {}
    ms, acts, top = device_profile(torch, lambda: mine_torch(
        idxs, cfg, dev=dev, device=device, profile=prof))
    recs["ascending"].update(device_ms=ms, device_activities=acts,
                             device_top=top)
    log(f"scale 1000 whole trie ascending under torch.profiler: device time "
        f"{fmt_ms(ms)} in {acts:,} device activities over {prof['levels']} "
        f"levels ({prof['levels'] + prof['drains']} rank launches); the "
        f"largest: {json.dumps(top)}")
    for order, out in outs.items():
        s1000_check(out, S1000, "whole trie", order)
        if out.total_occs != S1000["occs"] or abs(
                out.smallest_entropy - S1000["entropy"][0]) > ENT_TOL \
                or abs(out.largest_entropy - S1000["entropy"][1]) > ENT_TOL:
            raise SystemExit(
                f"scale 1000 whole trie ({order}): occs {out.total_occs}, "
                f"entropy range ({out.smallest_entropy}, "
                f"{out.largest_entropy}), want {S1000['occs']}, "
                f"{S1000['entropy']}")
    exits = recs["ascending"]["histfull"] + recs["gnu"]["histfull"]
    if exits < 1:
        raise SystemExit("scale 1000: the whole-trie runs took no HISTFULL "
                         "exit under the default history cap")
    log(f"scale 1000: the whole trie in one episode equals the frozen "
        f"concatenation, ascending and gnu, with {exits} HISTFULL exit(s) "
        f"in the two runs")
    return recs, kept


def s1000_sharded(torch, idxs, device) -> tuple:
    """`mine --engine sharded-episode` at 2 shards on the one card, gnu,
    against the frozen concatenation; -> (its record, its largest drain's
    block)."""
    from dsm_tpu_torch.mining.engine import MiningConfig
    from dsm_tpu_torch.parallel import engine_episode as tee
    from dsm_tpu_torch.parallel.engine_episode import mine_device_sharded
    from dsm_tpu_torch.parallel.engine_sharded import ShardedIndexes
    from dsm_tpu_torch.parallel.multihost import global_samples_mesh

    cfg = MiningConfig(fmin=FMIN, emax=EMAX)
    mesh = global_samples_mesh(2, device)
    tables = ShardedIndexes.build(idxs, mesh)
    drain, blocks = tee._drain_sharded, {}

    def keeping(*a, **k):
        st = a[3]
        if st.ocount > blocks.get("rows", 0):
            blocks.update(rows=st.ocount, blocks=[
                (st.out[:st.ocount].clone(), a[6].base(0))])
        return drain(*a, **k)

    tee._drain_sharded = keeping
    try:
        out, rec = s1000_run(
            torch, "2 shards gnu", lambda prof: mine_device_sharded(
                idxs, cfg, mesh=mesh, dev=tables, reader_order="gnu",
                profile=prof), "mine_sharded")
    finally:
        tee._drain_sharded = drain
    s1000_check(out, S1000, "2 shards", "gnu")
    return rec, blocks["blocks"]


def s1000_level(torch, dev, device) -> list[dict]:
    """K1 (occ_cum8 and expand), K2, K3, P1 with its stage_rows entry, and
    K9a/K9b/K9c on the widest real level of the scale-1000 mine (made by
    the port's own level loop), each against its plain version; the table
    rows the level's pairs touch against the 50 MB L2; -> the entries."""
    from dsm_tpu_torch.mining.config import MiningConfig

    entries = [occ_cum8_case(torch, dev, device, np.random.default_rng(2031),
                             device_time=True)]
    pairs, nb, depth = widest_state(dev)
    p, u = pairs.shape[0], nb.shape[0] - 1
    blo = (pairs[:, 0] >> 7) + pairs[:, 4]
    bhi = (pairs[:, 1] >> 7) + pairs[:, 4]
    rows = int(torch.unique(torch.cat([blo, bhi])).numel())
    log(f"scale 1000: the widest level, depth {depth}: {u:,} nodes, {p:,} "
        f"pairs; its pairs touch {rows:,} forward-table rows = "
        f"{128 * rows / 1e6:.1f} MB of the {dev.frows.numel() * 4 / 1e6:.1f} "
        f"MB table (the L2 holds 50 MB): each touched row is read once from "
        f"HBM at best, and the bound charges 128 B a touched row")
    # the sharded level's kernels on the level cut into the 2-shard mesh's
    # sample shards ([0, 3) and [3, 5))
    return entries + level_kernels(
        torch, dev, device, MiningConfig(fmin=FMIN, emax=EMAX),
        (pairs, nb, depth), "scale 1000", (0, 3, dev.S))


def level_kernels(torch, dev, device, cfg, level, tag: str,
                  bounds) -> list[dict]:
    """K1's expand, K2, K3, P1 with its stage_rows entry, and K1's
    expand_tables and K9a/K9b/K9c on a real level (pair rows, node starts,
    depth) of a mine over `dev` at `cfg`, each against its plain version,
    timed by events and by the profiler's device time; the sharded level's
    kernels on the level as the one pair list of the sample shards
    [bounds[k], bounds[k + 1]) of one process (K9c with K9b's ids and the
    level's own rank outputs); -> the entries."""
    from dsm_tpu_torch.mining.engine_device import _Scalars
    from dsm_tpu_torch.ops.children import (children, children_ids,
                                            children_ids_plain,
                                            children_plain)
    from dsm_tpu_torch.ops.compact import (compact_rows, compact_rows_plain,
                                           stage_rows, stage_rows_plain)
    from dsm_tpu_torch.ops.rank import expand
    from dsm_tpu_torch.ops.segstats import (S_CHILDREN, S_ENT_MIN, S_GATED,
                                            S_KEPT, segstats, segstats_plain)
    from dsm_tpu_torch.ops.shardstats import (PART_COLS, shard_partials,
                                              shard_partials_plain)

    pairs, nb, depth = level
    p, u = pairs.shape[0], nb.shape[0] - 1
    entries, timed = [], []   # (entry, a call of its kernel) for device times
    entries.append(expand_case(torch, dev, pairs,
                               f"{tag} (depth {depth})")[0])
    timed.append((entries[-1], lambda: expand(dev.frows, pairs, FMIN,
                                              0b1111)))

    g = _Scalars.build(cfg).gates(depth, dev.S)
    olo, ohi, freq, keepc, cbits = expand(dev.frows, pairs, cfg.fmin,
                                          g.sym_mask)
    fk, ek, pk, sk = segstats(nb, freq, cbits, g)
    fp, ep, pp, sp = segstats_plain(nb, freq, cbits, g)
    torch.cuda.synchronize()
    got, want = sk.tolist(), sp.tolist()
    eerr = float((ek - ep).abs().max())
    rerr = max(abs(a - b) for a, b in zip(got[S_ENT_MIN:], want[S_ENT_MIN:]))
    if not (torch.equal(fk, fp) and torch.equal(pk, pp)) \
            or got[:S_ENT_MIN] != want[:S_ENT_MIN] \
            or max(eerr, rerr) > ENT_TOL:
        raise SystemExit(f"{tag}: segstats disagrees with its plain version "
                         f"({got} vs {want})")
    entries.append(dict(
        name="segstats", route="cuda",
        source="dsm_tpu_torch/csrc/segstats.cu",
        replaces="dsm_tpu/mining/engine_device.py:726",
        max_abs_err=max(eerr, rerr),
        ms=cuda_ms(torch, lambda: segstats(nb, freq, cbits, g)),
        plain_ms=cuda_ms(torch, lambda: segstats_plain(nb, freq, cbits, g)),
        **bound(4 * (u + 1) + 5 * p + 12 * u + p + 48, 6 * p + 6 * u,
                F64_TOPS), library_ms=None))
    timed.append((entries[-1], lambda: segstats(nb, freq, cbits, g)))
    log(f"kernel segstats: {tag}: equal (sums {json.dumps(got)}); "
        f"{entries[-1]['ms']:.4f} ms vs plain {entries[-1]['plain_ms']:.4f} "
        f"ms (bound {entries[-1]['bound_ms']:.4f} ms)")

    pair_count, child_total = int(got[S_KEPT]), int(got[S_CHILDREN])
    hk = torch.full((child_total,), -1, dtype=torch.int32, device=device)
    hp = hk.clone()
    kargs = (nb, pairs, olo, ohi, keepc, pair_count, child_total)
    (kr, kn), (pr_, pn) = children(*kargs, hk), children_plain(*kargs, hp)
    torch.cuda.synchronize()
    if not (torch.equal(kr, pr_) and torch.equal(kn, pn)
            and torch.equal(hk, hp)):
        raise SystemExit(f"{tag}: children disagrees with its plain version")
    del kr, kn, pr_, pn
    entries.append(dict(
        name="children", route="cuda",
        source="dsm_tpu_torch/csrc/children.cu",
        replaces="dsm_tpu/mining/engine_device.py:789", max_abs_err=0,
        ms=cuda_ms(torch, lambda: children(*kargs, hk)),
        plain_ms=cuda_ms(torch, lambda: children_plain(*kargs, hp), 3),
        **bound(4 * (u + 1) + lane_bytes(keepc) + 8 * child_total + 4,
                16 * p), library_ms=None))
    timed.append((entries[-1], lambda: children(*kargs, hk)))
    log(f"kernel children: {tag}: {pair_count:,} lanes kept into "
        f"{child_total:,} children, equal; {entries[-1]['ms']:.4f} ms vs "
        f"plain {entries[-1]['plain_ms']:.4f} ms (bound "
        f"{entries[-1]['bound_ms']:.4f} ms)")

    n_gated = int(got[S_GATED])
    for width in (n_gated, n_gated // 2):
        (a, ac), (b, bc) = (stage_rows(pk, pairs, depth, width),
                            stage_rows_plain(pk, pairs, depth, width))
        if not torch.equal(a, b) or int(ac) != int(bc):
            raise SystemExit(f"{tag}: stage_rows disagrees with its plain "
                             "version")
    entries.append(dict(
        name="stage_rows", route="cuda",
        source="dsm_tpu_torch/csrc/compact.cu",
        replaces="dsm_tpu/mining/engine_device.py:858", max_abs_err=0,
        ms=cuda_ms(torch, lambda: stage_rows(pk, pairs, depth, n_gated)),
        plain_ms=cuda_ms(torch, lambda: stage_rows_plain(pk, pairs, depth,
                                                         n_gated)),
        **bound(p + n_gated * (24 + 20) + 8, 2 * p), library_ms=None))
    live = keepc.any(0)
    k = int(live.sum())
    got_c, want_c = compact_rows(live, pairs, k), compact_rows_plain(
        live, pairs, k)
    torch.cuda.synchronize()
    if not torch.equal(got_c[0], want_c[0]) \
            or int(got_c[1]) != int(want_c[1]):
        raise SystemExit(f"{tag}: compact_rows disagrees with its plain "
                         "version")
    timed.append((entries[-1],
                  lambda: stage_rows(pk, pairs, depth, n_gated)))
    entries.append(dict(
        name="compact_rows", route="cuda",
        source="dsm_tpu_torch/csrc/compact.cu",
        replaces="dsm_tpu/ops/pallas_compact.py:162", max_abs_err=0,
        ms=cuda_ms(torch, lambda: compact_rows(live, pairs, k)),
        plain_ms=cuda_ms(torch, lambda: compact_rows_plain(live, pairs, k)),
        **bound(p + 2 * k * 24 + 8, 2 * p),
        library_ms=cuda_ms(torch, lambda: pairs[live])))
    timed.append((entries[-1], lambda: compact_rows(live, pairs, k)))
    log(f"kernel stage_rows / compact_rows: {tag}: {n_gated:,} gated pairs "
        f"staged, {k:,} of {p:,} pair rows that keep a lane compacted: "
        f"equal; {entries[-2]['ms']:.4f} / {entries[-1]['ms']:.4f} ms vs "
        f"plain {entries[-2]['plain_ms']:.4f} / "
        f"{entries[-1]['plain_ms']:.4f} ms (pairs[mask] "
        f"{entries[-1]['library_ms']:.4f} ms)")

    # the sharded level's form: the level as one process's pair list over
    # the shard tables [bounds[k], bounds[k + 1]) (K1's expand_tables, timed
    # by itself), K9a over the list, K9b on its rows, K9c on the list with
    # K9b's ids and the level's own rank outputs
    entries.append(expand_tables_case(torch, dev, pairs, bounds,
                                      f"{tag} (depth {depth})"))
    level4 = (pairs[:, 5].to(torch.int64), pairs[:, 3].to(torch.int64), freq,
              cbits)
    shards = split_level(torch, level4, bounds, nodes=u)
    part = torch.empty((u, PART_COLS), dtype=torch.int64, device=device)
    kept = torch.empty(1, dtype=torch.float64, device=device)
    shard_partials(nb, freq, cbits, g.sym_mask, part, kept)
    # the fixed-point column, in units (k9b_case holds every column)
    off = int((part[:, 1] - shard_partials_plain(
        nb, freq, cbits, g.sym_mask)[0][:, 1]).abs().max())
    entries.append(dict(
        name="shard_partials", route="cuda",
        source="dsm_tpu_torch/csrc/shardstats.cu",
        replaces="dsm_tpu/mining/engine_device.py:421", max_abs_err=off,
        ms=cuda_ms(torch, lambda: shard_partials(nb, freq, cbits,
                                                 g.sym_mask, part, kept)),
        plain_ms=cuda_ms(torch, lambda: shard_partials_plain(
            nb, freq, cbits, g.sym_mask)),
        **bound(4 * (u + 1) + 5 * p + 24 * u + 8, 6 * p, F64_TOPS),
        library_ms=None))
    timed.append((entries[-1], lambda: shard_partials(
        nb, freq, cbits, g.sym_mask, part, kept)))
    entry, _whole, fk9, kk9, child_total9 = k9b_case(torch, shards, g,
                                                     device)
    entries.append(entry)
    cargs = (nb, pairs, olo, ohi, keepc, fk9, kk9, pair_count, child_total9)
    (kr, kn), (pr_, pn) = children_ids(*cargs), children_ids_plain(*cargs)
    torch.cuda.synchronize()
    if not (torch.equal(kr, pr_) and torch.equal(kn, pn)):
        raise SystemExit(f"{tag}: children_ids disagrees with its plain "
                         f"version")
    del kr, kn, pr_, pn
    entries.append(dict(
        name="children_ids", route="cuda",
        source="dsm_tpu_torch/csrc/children.cu",
        replaces="dsm_tpu/mining/engine_device.py:490", max_abs_err=0,
        ms=cuda_ms(torch, lambda: children_ids(*cargs)),
        plain_ms=cuda_ms(torch, lambda: children_ids_plain(*cargs), 3),
        **bound(12 * u + 4 + lane_bytes(keepc) + 4 * (child_total9 + 1),
                16 * p), library_ms=None))
    timed.append((entries[-1], lambda: children_ids(*cargs)))
    log(f"kernel children_ids: {tag}: the one list of {len(shards)} "
        f"shards, {pair_count:,} kept lanes into {child_total9:,} children, "
        f"equal to the plain version; {entries[-1]['ms']:.4f} ms")
    for e, fn in timed:
        e["device_ms"] = device_ms(torch, fn)
    return entries


def s1000_drain_kernels(torch, kept: dict, blocks) -> list[dict]:
    """K5 (leftChar) on the whole-trie run's largest drain, K6 (decode) on
    its largest path decode and K10 on the 2-shard run's largest drain's
    blocks, each against its plain version; -> their entries."""
    from dsm_tpu_torch.ops.decode import decode

    entries = []
    tables, orows = kept["leftchar"]["args"]
    entries.append(leftchar_case(torch, tables, orows,
                                 "scale 1000, the largest drain")[0])
    args = kept["decode"]["args"]
    entries.append(decode_case(torch, "scale 1000, the largest path decode",
                               args))
    entries[-1]["device_ms"] = device_ms(torch, lambda: decode(*args))
    if blocks:
        entries.append(gather_case(torch, blocks,
                                   "scale 1000, the 2-shard run's largest "
                                   "drain"))
    return entries


def s1000_plan(torch, idxs, recs: dict) -> dict:
    """The capacity plan's bytes (tables + episode, fmin FMIN) against the
    whole-trie and 2-shard runs' peaks."""
    from dsm_tpu_torch.mining import bigindex as big

    tb, eb = big.table_bytes(idxs), big.episode_bytes(idxs, FMIN)
    plan = {"table_bytes": tb, "episode_bytes": eb,
            "level_pairs_bound": big.level_pairs(idxs, FMIN)}
    for label in ("ascending", "gnu", "2 shards"):
        if label in recs:
            peak = recs[label]["peak_bytes"]
            plan[f"planned/peak {label}"] = (tb + eb) / peak
            if tb + eb < peak:
                raise SystemExit(f"scale 1000: the plan's {tb + eb:,} bytes "
                                 f"are below the {label} run's peak {peak:,}")
    log(f"scale 1000 capacity: {json.dumps(plan)}")
    return plan


def phase_scale1000(torch, toy, td: str, device) -> tuple:
    """Phase 15: the main path at scale 1000 (see the module's docstring);
    -> (the build's launches, the single-device mine's launches, the
    kernels at this size)."""
    from dsm_tpu_torch.mining.engine import DeviceIndexes

    t_phase = time.perf_counter()
    idxs, toy0, build_launches, build_s = s1000_build(torch, toy, td, device)
    kernels = s1000_sa(torch, toy0, device)
    del toy0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dev = DeviceIndexes.build(idxs, device)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    table = 2 * dev.frows.numel() * 4
    log(f"scale 1000: one upload of the tables, {table:,} bytes (both "
        f"directions), in {upload_s:.4f} s")
    recs = s1000_prefixes(torch, idxs, dev, device)
    whole, kept = s1000_whole(torch, idxs, dev, device)
    recs.update(whole)
    mine_launches = whole["gnu"]["launches"]
    kernels += s1000_level(torch, dev, device)
    del dev
    sharded, blocks = s1000_sharded(torch, idxs, device)
    recs["2 shards"] = sharded
    kernels += s1000_drain_kernels(torch, kept, blocks)
    del kept, blocks
    plan = s1000_plan(torch, idxs, recs)
    # each kernel's launches in the scale-1000 run of its path: the build,
    # the whole-trie gnu mine, the 2-shard mine
    counts = {**sharded["launches"], **mine_launches, **build_launches}
    for k in kernels:
        k["launches"] = counts[LAUNCH_KEY[k["name"]]]
    log("scale 1000 kernels: " + json.dumps(kernels))
    log("scale 1000 summary: " + json.dumps(dict(
        build_s=sum(build_s), build_s_per_sample=build_s, upload_s=upload_s,
        table_bytes=table, phase_s=time.perf_counter() - t_phase,
        runs={k: {f: r[f] for f in ("wall_s", "levels", "level_s",
                                    "drain_s", "tail_s", "tail_depth",
                                    "drains", "histfull", "pulled_levels",
                                    "pull_s", "walk_s", "peak_bytes")}
              for k, r in recs.items()}, plan=plan)))
    return build_launches, mine_launches, kernels


# ------------------------------------------------ phase 16: the sample axis,
# d = 64, 273 and 512 samples, against references frozen from the JAX package

def samples_build(torch, fz, ref: dict, td: str, device) -> tuple:
    """make_samples' data of `ref` built on the card a sample at a time (2d
    suffix arrays through K8); -> (indexes, the build's launches, seconds a
    sample)."""
    from dsm_tpu_torch.index import indexes_from_fasta
    from dsm_tpu_torch.ops import _build

    d, asked, seed = ref["make"]
    t0 = time.perf_counter()
    fastas = fz.make_samples(os.path.join(td, f"d{d}"), d, asked, seed)
    made = time.perf_counter() - t0
    idxs, secs = [], []
    torch.cuda.synchronize()
    _build.reset_launches()
    for path in fastas:
        t0 = time.perf_counter()
        idxs += indexes_from_fasta([path], device)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    launches = path_launches("build", f"the D{d} build")
    n = sum(i.n for i in idxs)
    sizes = [i.n for i in idxs]
    log(f"D{d}: data made on the host in {made:.2f} s; {n:,} indexed symbols "
        f"in {d} samples ({min(sizes):,}-{max(sizes):,} a sample), built on "
        f"the card in {sum(secs):.4f} s ({sum(secs) / d:.4f} s a sample, "
        f"{min(secs):.4f}-{max(secs):.4f})")
    if n != ref["symbols"]:
        raise SystemExit(f"D{d}: {n} indexed symbols, the reference has "
                         f"{ref['symbols']}")
    return idxs, launches, secs


def samples_check(out, ref: dict, label: str, order: str) -> None:
    """An output against the frozen `ref`: paths, lines, occurrences, the
    frequency histogram's sha256 (its d int64 words) and the sha256 of its
    bytes in `order` equal, the
    entropy range within SAMPLES_ENT_TOL (dsm_tpu's float32 diagnostics)."""
    d = ref["make"][0]
    sha = hashlib.sha256(out.format_lines()).hexdigest()
    hist = hashlib.sha256(np.asarray(out.freq_histogram, dtype="<i8")
                          .tobytes()).hexdigest()
    got = (out.total_paths, out.total_output, out.total_occs, hist, sha)
    exp = (ref["paths"], ref["lines"], ref["occs"], ref["hist"], ref[order])
    ent = (out.smallest_entropy, out.largest_entropy)
    if got != exp or max(abs(a - b) for a, b in zip(ent, ref["entropy"])) \
            > SAMPLES_ENT_TOL:
        raise SystemExit(f"D{d} {label} ({order}) FAILED: got paths, lines, "
                         f"occs, histogram, sha256 {got}, entropy range "
                         f"{ent}; want {exp}, {ref['entropy']}")
    log(f"D{d} {label} ({order}): {out.total_paths:,} paths, "
        f"{out.total_output:,} lines, sha256 {sha}: the frozen reference's")


def samples_config(ref: dict):
    from dsm_tpu_torch.mining.engine import MiningConfig

    kw = {} if ref["maxdepth"] is None else dict(maxdepth=ref["maxdepth"])
    return MiningConfig(fmin=FMIN, pmin=2, emax=ref["emax"], **kw)


def pair_histogram(torch, nb) -> dict:
    """Nodes by their pairs, in bins 1, 2, 3-4, 5-8, ... 257-512."""
    sizes = (nb[1:] - nb[:-1]).to(torch.float64)
    b = torch.ceil(torch.log2(sizes.clamp(min=1))).to(torch.int64)
    counts = torch.bincount(b, minlength=10).tolist()
    return {("1" if k == 0 else "2" if k == 1 else
             f"{(1 << (k - 1)) + 1}-{1 << k}"): c
            for k, c in enumerate(counts) if c}


def level_widths(torch, dev, cfg) -> tuple:
    """Every device level of a mine over `dev` at `cfg` (the port's own
    level loop; staged rows dropped): per depth [nodes, pairs, widest node,
    nodes past 64 pairs]; -> (those rows, {"widest": the level with the
    most pairs, "past64": the one with the most nodes past 64 pairs,
    "nodes": the one with the most nodes}, each as (pairs, nb, depth))."""
    from dsm_tpu_torch.mining.engine_device import (FLAG_DONE, FLAG_HISTFULL,
                                                    FLAG_TAIL, _hist_cap,
                                                    _level, _Scalars,
                                                    _seed_episode)

    sc = _Scalars.build(cfg)
    st = _seed_episode(dev, _hist_cap(dev))
    rows, best = [], {}

    def record():
        sizes = st.nb[1:] - st.nb[:-1]
        row = [st.depth, sizes.shape[0], st.npairs,
               int(sizes.max()) if sizes.numel() else 0,
               int((sizes > 64).sum())]
        rows.append(row)
        for key, v in (("widest", row[2]), ("past64", row[4]),
                       ("nodes", row[1])):
            if v > best.get(key, (-1,))[0]:
                best[key] = (v, (st.pairs, st.nb, st.depth))

    record()
    while True:
        flag = _level(dev, sc, st)
        if flag == FLAG_HISTFULL:
            st.hist_len, st.lvl_off = 0, []
            continue
        st.out, st.ocount = [], 0
        record()
        if flag in (FLAG_DONE, FLAG_TAIL):
            return rows, {k: v[1] for k, v in best.items()}


def samples_sharded(torch, idxs, ref: dict, n: int, device,
                    keep: dict | None = None) -> dict:
    """The sharded episode at n shards on the one card, ascending and gnu,
    each against `ref`: the expand, K9a, K9b and K9c launched once a level
    (`s1000_run`); at SAMPLES_SHARDS' most shards one more ascending run
    under torch.profiler, whose device time and activities a level go into
    that order's record; `keep` gets the gnu run's largest drain's block
    and the shard tables; -> the runs' records."""
    from dsm_tpu_torch.parallel import engine_episode as tee
    from dsm_tpu_torch.parallel.engine_episode import mine_device_sharded
    from dsm_tpu_torch.parallel.engine_sharded import ShardedIndexes
    from dsm_tpu_torch.parallel.multihost import global_samples_mesh

    d, cfg = ref["make"][0], samples_config(ref)
    mesh = global_samples_mesh(n, device)
    tables = ShardedIndexes.build(idxs, mesh)
    drain, recs = tee._drain_sharded, {}

    def keeping(*a, **k):
        st = a[3]
        if st.ocount > keep.get("rows", 0):
            keep.update(rows=st.ocount, tables=tables, blocks=[
                (st.out[:st.ocount].clone(), a[6].base(0))])
        return drain(*a, **k)

    for order in ("ascending", "gnu"):
        if keep is not None and order == "gnu":
            tee._drain_sharded = keeping
        try:
            out, rec = s1000_run(
                torch, f"{n} shards {order}",
                lambda prof: mine_device_sharded(
                    idxs, cfg, mesh=mesh, dev=tables, reader_order=order,
                    profile=prof), "mine_sharded", tag=f"D{d}")
        finally:
            tee._drain_sharded = drain
        samples_check(out, ref, f"{n} shards", order)
        recs[f"{n} shards {order}"] = rec
    if n == max(SAMPLES_SHARDS):
        prof = {}
        ms, acts, top = device_profile(torch, lambda: mine_device_sharded(
            idxs, cfg, mesh=mesh, dev=tables, profile=prof))
        rec = recs[f"{n} shards ascending"]
        rec.update(device_ms=ms, activities=acts,
                   activities_per_level=acts / prof["levels"])
        log(f"D{d} {n} shards ascending: level_s {rec['level_s']} over "
            f"{rec['levels']} levels, peak {rec['peak_bytes']:,} bytes; "
            f"under torch.profiler device time {fmt_ms(ms)} in {acts:,} "
            f"device activities, {acts / prof['levels']:.1f} a level; the "
            f"largest: " + json.dumps(top))
    return recs


def samples_resume(torch, idxs, dev, ref: dict, td: str, device) -> dict:
    """The gnu mine with a snapshot file (out_reserve SAMPLES_RESERVE),
    killed at its second save and resumed from it, against `ref`; -> the
    resumed run's record."""
    from dsm_tpu_torch.mining import checkpoint as ckpt
    from dsm_tpu_torch.mining.engine import mine_torch

    d, cfg = ref["make"][0], samples_config(ref)
    path = os.path.join(td, f"d{d}.ckpt")
    save, saves = ckpt.save_checkpoint, []

    def killing(p, state, *a, **k):
        t0 = time.perf_counter()
        save(p, state, *a, **k)
        saves.append((int(state["depth"]), int(state["nvalid"]),
                      round(time.perf_counter() - t0, 4),
                      os.path.getsize(p)))
        if len(saves) == 2:
            raise Killed()

    ckpt.save_checkpoint = killing
    t0 = time.perf_counter()
    try:
        mine_torch(idxs, cfg, dev=dev, device=device, reader_order="gnu",
                   out_reserve=SAMPLES_RESERVE, checkpoint=path)
        raise SystemExit(f"D{d} resume: the run was not killed")
    except Killed:
        killed = time.perf_counter() - t0
    finally:
        ckpt.save_checkpoint = save
    if not os.path.exists(path):
        raise SystemExit(f"D{d} resume: the killed run left no snapshot")
    prof = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    out = mine_torch(idxs, cfg, dev=dev, device=device, reader_order="gnu",
                     out_reserve=SAMPLES_RESERVE, checkpoint=path,
                     profile=prof)
    torch.cuda.synchronize()
    rec = dict(prof, wall_s=time.perf_counter() - t0, killed_s=killed,
               peak_bytes=torch.cuda.max_memory_allocated(device),
               saves_before=saves)
    if os.path.exists(path):
        raise SystemExit(f"D{d} resume: the snapshot file outlived the run")
    samples_check(out, ref, "killed at its second save and resumed", "gnu")
    log(f"D{d} resume: killed after save 2 at {killed:.4f} s; saves (depth, "
        f"frontier nodes, write s, bytes) {json.dumps(saves)}; the resumed "
        f"run {json.dumps(rec)}")
    return rec


def samples_distance(torch, gnu, d: int, device) -> dict:
    """`distance --fast` on the mined rows: the accumulator exact on the
    host and through K11 on the card (count and noutput equal, the f64
    matrices within DIST_TOL); -> its launches and wall."""
    from dsm_tpu_torch.ops import _build
    from dsm_tpu_torch.post.distance import (DistanceAccumulator,
                                             entropy_steps)

    lines = gnu.format_lines().decode().splitlines()
    kw = dict(smpls=d, maxents=entropy_steps(0.05))
    exact = DistanceAccumulator(**kw)
    exact.add_lines(lines)
    want = exact.matrices()
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    fast = DistanceAccumulator(exact=False, device=device, **kw)
    fast.add_lines(lines)
    got = fast.matrices()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = path_launches("distance", f"the D{d} distance path")
    if not np.array_equal(got["noutput"], want["noutput"]):
        raise SystemExit(f"D{d} distance: noutput differs")
    err = distance_err(got, want, f"D{d} distance path")
    if not all(np.isfinite(got[k]).all() and got[k].shape == (21, d, d)
               for k in ("log", "sqrt", "lgamma")):
        raise SystemExit(f"D{d} distance: matrices of the wrong shape")
    log(f"D{d} distance --fast: {fast.rows_read} lines -> "
        f"{int(got['noutput'][-1])} rows in {wall:.4f} s; count and noutput "
        f"equal the exact host path, f64 matrices within {DIST_TOL} (max "
        f"abs err {err:.3g})")
    return dict(wall_s=wall, launches=launches, max_abs_err=err)


def samples_plan(torch, idxs, ref: dict, recs: dict, device) -> dict:
    """`mine --engine auto`'s capacity plan on the card: device mode, and
    table_bytes + episode_bytes at or above every run's peak."""
    from dsm_tpu_torch.mining import bigindex as big

    d = ref["make"][0]
    p = big.plan(idxs, fmin=FMIN, device=device)
    if p.mode != "device":
        raise SystemExit(f"D{d} capacity: the card's budget plans {p.mode}, "
                         f"not device mode ({p.reason})")
    tb, eb = big.table_bytes(idxs), big.episode_bytes(idxs, FMIN)
    plan = {"mode": p.mode, "table_bytes": tb, "episode_bytes": eb}
    for label, rec in recs.items():
        plan[f"planned/peak {label}"] = (tb + eb) / rec["peak_bytes"]
        if tb + eb < rec["peak_bytes"]:
            raise SystemExit(f"D{d} capacity: the plan's {tb + eb:,} bytes "
                             f"are below the {label} run's peak "
                             f"{rec['peak_bytes']:,}")
    log(f"D{d} capacity: {json.dumps(plan)}")
    return plan


def samples_drain_kernels(torch, keep: dict, tag: str) -> list[dict]:
    """K10 on the largest drain's block of a many-shard gnu run, and K5 on
    the rows it packs over that run's shard tables, each against its plain
    version; -> their entries."""
    from dsm_tpu_torch.mining.engine import OC_SID
    from dsm_tpu_torch.ops.gatherpack import gather_pack

    blocks, sh = keep["blocks"], keep["tables"]
    entries = [gather_case(torch, blocks, f"{tag}, one block")]
    rows = gather_pack([c for c, _b in blocks], [b for _c, b in blocks],
                       OC_SID)[0]
    tables = sh.leftchar_tables()
    entries.append(leftchar_case(torch, tables, rows,
                                 f"{tag} over {len(tables)} shard tables")[0])
    return entries


def samples_set(torch, fz, ref: dict, td: str, device, kernels: list,
                resume: bool = False, measure: bool = False,
                shard_counts=SAMPLES_SHARDS, held: dict | None = None
                ) -> dict:
    """One sample set of phase 16 (see the module's docstring): with
    `measure`, the kernels at its widest level, at its level with the most
    nodes past 64 pairs and at the largest drain of its run with the most
    shards, their entries appended to `kernels`; `held` (a dict) keeps its
    indexes under d; -> its summary."""
    from dsm_tpu_torch.mining.engine import DeviceIndexes, mine_torch

    d, cfg = ref["make"][0], samples_config(ref)
    tag = f"D{d}"
    t_set = time.perf_counter()
    idxs, build_launches, build_s = samples_build(torch, fz, ref, td, device)
    if held is not None:
        held[d] = idxs
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dev = DeviceIndexes.build(idxs, device)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    log(f"{tag}: one upload of the tables, {2 * dev.frows.numel() * 4:,} "
        f"bytes, in {upload_s:.4f} s")
    recs, outs = {}, {}
    for order in ("ascending", "gnu"):
        outs[order], recs[order] = s1000_run(
            torch, f"one device {order}", lambda prof: mine_torch(
                idxs, cfg, dev=dev, device=device, reader_order=order,
                profile=prof), tag=tag)
        samples_check(outs[order], ref, "one device", order)
    if resume:
        recs["gnu resumed"] = samples_resume(torch, idxs, dev, ref, td,
                                             device)
    rows, chosen = level_widths(torch, dev, cfg)
    log(f"{tag} levels (depth, nodes, pairs, widest node, nodes past 64 "
        f"pairs): {json.dumps(rows)}")
    levels = {}
    for key, (pairs, nb, depth) in chosen.items():
        levels[key] = dict(depth=depth, nodes=nb.shape[0] - 1,
                           pairs=pairs.shape[0],
                           histogram=pair_histogram(torch, nb))
        log(f"{tag}: the level of the most {key} (depth {depth}): "
            f"{json.dumps(levels[key])}")
    if d == 512 and max(r[3] for r in rows) != 512:
        raise SystemExit(f"{tag}: no level holds a node of 512 pairs")
    measured = []
    if measure:
        n = max(shard_counts)
        bounds = tuple(k * d // n for k in range(n + 1))
        # the widest level, and the one with the most nodes past 64 pairs,
        # or where that is the widest, the one with the most nodes
        second = "past64" if chosen["past64"][2] != chosen["widest"][2] \
            else "nodes"
        for key in ("widest", second):
            level = chosen[key]
            for e in level_kernels(torch, dev, device, cfg, level,
                                   f"{tag} {key} level", bounds):
                e["case"] = f"{tag}, the level of the most {key} (depth " \
                    f"{level[2]})"
                measured.append(e)
    del chosen, dev
    launches = {"build": build_launches, "mine": recs["gnu"]["launches"]}
    keep = {}
    for n in shard_counts:
        recs.update(samples_sharded(torch, idxs, ref, n, device,
                                    keep if n == max(shard_counts) else None))
    # the sharded kernels' entries are at the most shards: that run's counts
    launches["mine_sharded"] = recs[f"{max(shard_counts)} shards gnu"][
        "launches"]
    if measure:
        for e in samples_drain_kernels(
                torch, keep, f"{tag}, the {max(shard_counts)}-shard gnu "
                f"run's largest drain"):
            e["case"] = f"{tag}, a {max(shard_counts)}-shard drain"
            measured.append(e)
    del keep
    dist = samples_distance(torch, outs["gnu"], d, device)
    plan = samples_plan(torch, idxs, ref, recs, device)
    counts = {}
    for path in launches.values():
        for k, v in path.items():
            counts.setdefault(k, v)
    for e in measured:
        e["launches"] = counts[LAUNCH_KEY[e["name"]]]
    kernels += measured
    summary = dict(
        symbols=ref["symbols"], build_s=sum(build_s),
        build_s_per_sample=sum(build_s) / d, upload_s=upload_s,
        set_s=time.perf_counter() - t_set, levels=rows,
        chosen_levels=levels, distance=dist, plan=plan,
        runs={k: {f: r.get(f) for f in (
            "wall_s", "paths_per_s", "levels", "level_s", "drain_s",
            "tail_s", "tail_depth", "drains", "histfull", "pull_s",
            "save_s", "saves", "peak_bytes", "device_ms",
            "activities_per_level") if f in r} for k, r in recs.items()})
    log(f"{tag} summary: {json.dumps(summary)}")
    return summary


def phase_samples(torch, device, held: dict | None = None) -> list[dict]:
    """Phase 16: D64, D273 (also killed and resumed; the kernels at its
    widest level, its level with the most nodes past 64 pairs and a
    128-shard drain) and D512 (its indexes kept in `held`, a dict, for
    phase 17); -> the kernels' entries."""
    fz = load_tests_module("freeze_samples_reference")
    kernels = []
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="dsm_smoke_samples_") as td:
        for ref in (D64, D273, D512):
            samples_set(torch, fz, ref, td, device, kernels,
                        resume=ref is D273, measure=ref is D273,
                        shard_counts=(128,) if ref is D512
                        else SAMPLES_SHARDS,
                        held=held if ref is D512 else None)
    log(f"samples kernels: {json.dumps(kernels)}")
    log(f"samples: phase 16 in {time.perf_counter() - t0:.1f} s")
    return kernels


def samples_alone(torch, device) -> None:
    """Phase 16 by itself, after the environment and the build (for a
    quicker run while developing; no result line)."""
    phase_env(torch)
    phase_build()
    phase_samples(torch, device)


# ------------------------------------------------ phase 17: the per-level
# engines, mine_torch(reader_order="level-gnu") and mine_sharded

def level_run(torch, label: str, run, tag: str) -> tuple:
    """One run of a per-level engine (`s1000_run`, path "mine_level"): K12
    and K13 each launched once a level, redone levels included; the widest
    real level (the most valid nodes x samples) recorded; -> (output, its
    record, that level as (tables, state, fmin, sym_mask)).

    The recorder adds no sync to the timed step: a state's valid nodes are
    the last kept level's child counts (R of them, copied without blocking
    into pinned memory, which the loop's own read of the counts completes),
    or R at the root."""
    from dsm_tpu_torch.mining import engine as eng

    step, widest = eng._level_step, {}
    seen = dict(nodes=None, counts=None, cap=0)

    def recording(tables, state, fmin, sym_mask, group=None):
        if seen["nodes"] is None:
            seen["nodes"] = state[0].shape[0]
        elif max(seen["counts"].tolist()) <= seen["cap"]:
            # the last level was kept (not redone at a larger capacity)
            seen["nodes"] = int(seen["counts"].sum())
        cells = seen["nodes"] * state[0].shape[2]
        if cells > widest.get("cells", -1):
            widest.update(cells=cells, level=(tables, state, fmin, sym_mask))
        res = step(tables, state, fmin, sym_mask, group)
        cc = res["child_count"]
        if seen["counts"] is None:
            seen["counts"] = torch.empty(cc.shape, dtype=cc.dtype,
                                         pin_memory=True)
        seen["counts"].copy_(cc, non_blocking=True)
        seen["cap"] = state[0].shape[1]
        return res

    eng._level_step = recording
    try:
        out, rec = s1000_run(torch, label, run, "mine_level", tag=tag)
    finally:
        eng._level_step = step
    got = (rec["launches"]["level_expand"], rec["launches"]["level_compact"])
    if got != (rec["levels"], rec["levels"]):
        raise SystemExit(f"{tag} {label}: K12 / K13 launched {got} times in "
                         f"{rec['levels']} levels")
    return out, rec, widest["level"]


def concat_check(outs, ref: dict, label: str, order: str) -> None:
    """The four prefix runs' bytes concatenated against the whole run's
    frozen sha256 in `order`, their lines and occurrences summed."""
    blob = b"".join(o.format_lines() for o in outs)
    sha = hashlib.sha256(blob).hexdigest()
    got = (sum(o.total_output for o in outs), sum(o.total_occs for o in outs),
           sum(o.total_paths for o in outs), sha)
    want = (ref["lines"], ref["occs"], ref["paths"], ref[order])
    if got != want:
        raise SystemExit(f"{label} ({order}) FAILED: lines, occs, paths, "
                         f"sha256 {got}, want {want}")
    log(f"{label} ({order}): A, C, G, T concatenated: {got[0]:,} lines, "
        f"sha256 {sha}: the whole run's frozen reference")


def table_rows(torch, tables, pos_a, pos_b, mask, S: int) -> int:
    """The distinct table rows that cells under `mask` read at positions
    pos_a and pos_b (R, CAP, S), each column in its own table."""
    soff = torch.cat([t[2].to(torch.int64) for t in tables])
    table = torch.cat([torch.full((t[2].shape[0],), k, dtype=torch.int64,
                                  device=soff.device)
                       for k, t in enumerate(tables)])
    ids = []
    for pos in (pos_a, pos_b):
        row = (pos.to(torch.int64) >> 7) + soff
        ids.append((table[None, None, :] * (1 << 40) + row)[mask])
    return int(torch.unique(torch.cat(ids)).numel())


def level_kernel_cases(torch, level, label: str) -> list[dict]:
    """K12 and K13 on a recorded level against their plain versions (every
    output equal), timed by events, by the profiler's device time and by
    events around calls queued behind a spin kernel (`queued_ms`); -> their
    entries."""
    from dsm_tpu_torch.ops import level as L

    tables, state, fmin, sym_mask = level
    lo, hi, rlo, valid = state
    R, CAP, S = lo.shape
    core = L.expand_level(tables, *state, fmin)
    want = L.expand_level_plain(tables, *state, fmin)
    bad = [k for k in ("clo", "chi", "crlo", "cactive", "freq", "lc", "sums")
           if not torch.equal(core[k], want[k])]
    res = L.compact_level(core, core["sums"], sym_mask)
    exp = L.compact_level_plain(want, want["sums"], sym_mask)
    bad += [k for k in exp if not torch.equal(res[k], exp[k])]
    torch.cuda.synchronize()
    if bad:
        raise SystemExit(f"K12/K13 disagree with their plain versions at "
                         f"{label}: {bad}")
    sizes, b12, b13 = level_bounds(torch, level, res["child_count"])
    entries = []
    for name, fn, plain, b, src, rep in (
            ("level_expand",
             lambda: L.expand_level(tables, *state, fmin),
             lambda: L.expand_level_plain(tables, *state, fmin), b12,
             "dsm_tpu_torch/csrc/rank.cu", "dsm_tpu/mining/engine.py:286"),
            ("level_compact",
             lambda: L.compact_level(core, core["sums"], sym_mask),
             lambda: L.compact_level_plain(core, core["sums"], sym_mask),
             b13, "dsm_tpu_torch/csrc/level.cu",
             "dsm_tpu/mining/engine.py:351")):
        e = dict(name=name, route="cuda", source=src, replaces=rep,
                 max_abs_err=0, ms=cuda_ms(torch, fn),
                 device_ms=device_ms(torch, fn),
                 queued_ms=queued_ms(torch, fn),
                 plain_ms=cuda_ms(torch, plain, reps=3),
                 **b, library_ms=None, case=label)
        entries.append(e)
        log(f"kernel {name}: {label}: R={R}, CAP={CAP:,}, S={S}, "
            f"{sizes['active']:,} active cells, {sizes['kept']:,} children "
            f"kept, table rows {sizes['frows']:,} + {sizes['rrows']:,}; "
            f"equal; {e['ms']:.4f} ms (device {fmt_ms(e['device_ms'])}, "
            f"queued {e['queued_ms']:.4f}) vs "
            f"plain {e['plain_ms']:.4f} ms; bound {e['bound_ms']:.4f} ms by "
            f"{e['bound_by']}")
    return entries


def level_bounds(torch, level, child_count) -> tuple:
    """The least times of K12 and K13 on a recorded level whose K13 gave
    `child_count`: -> (its sizes, K12's bound, K13's bound)."""
    tables, state, _fmin, _sm = level
    tables = getattr(tables, "tables", tables)
    lo, hi, rlo, valid = state
    R, CAP, S = lo.shape
    cells, nodes = R * CAP * S, R * CAP
    active = (hi > lo) & valid[..., None]
    sizes = dict(R=R, CAP=CAP, S=S, tables=len(tables),
                 active=int(active.sum()), lc=int((hi > lo).sum()),
                 kept=int(child_count.clamp(max=CAP).sum()),
                 frows=table_rows(torch, tables, lo, hi, active, S),
                 rrows=table_rows(torch, tables, rlo, rlo + (hi - lo),
                                  hi > lo, S))
    # K12: the state once, the table rows its cells touch, every output
    # once (57 B a cell: clo, chi, crlo, cactive of 4 children, freq, lc;
    # and the 20-byte node sums); ~50 integer operations an end
    b12 = 12 * cells + nodes + 128 * (sizes["frows"] + sizes["rrows"]) \
        + 57 * cells + 20 * nodes
    # K13: the sums, the kept children's S-wide rows and activity, the next
    # state and the row outputs written once
    b13 = 20 * nodes + 4 * R + 13 * S * sizes["kept"] + 12 * cells \
        + 10 * nodes + 4 * R
    return (sizes, bound(b12, 100 * (2 * sizes["active"] + 2 * sizes["lc"])),
            bound(b13, 20 * nodes))


def dense_level_times(torch, device) -> None:
    """Times, without checks but equality, K12 and K13 of the package
    beside this file and prints one JSON line.  It records the widest level
    (`level_run`) of four per-level runs in ascending order, which walk the
    gnu runs' frontiers: scale 100 under LEVEL_PREFIX on one row and one
    table (`mine_levels` as level-gnu drives it) and `mine_sharded` at
    (4, 2) (four rows, 2 tables); D512 on one row and at (4, 128) (128
    tables).  At each it times `expand_level` and `compact_level` with the
    tables as a list (events: five times 20 calls; device time by the
    profiler and by events around calls queued behind a spin kernel,
    `queued_ms`; host time a call) and, where the package has it, `expand_level` with the tables
    prepared once (`LevelTables`); and each run's wall, levels and
    `level_s`.  It calls only the level functions' contract, so a copy of
    this file in the root of another tree times that tree, and two commits
    are compared in turns (parent, change, change, parent)."""
    from dsm_tpu_torch.ops import level as L

    phase_build()
    res = {"tree": HERE, "smi": smi_line(), "runs": {}, "levels": {}}
    for label, (rec, level) in dense_levels(torch, device).items():
        res["runs"][label] = {k: rec.get(k) for k in (
            "wall_s", "levels", "regrows", "level_s", "host_s")}
        tables, state, fmin, sym_mask = level
        listed = getattr(tables, "tables", tables)
        core = L.expand_level(listed, *state, fmin)
        out = L.compact_level(core, core["sums"], sym_mask)
        sizes, b12, b13 = level_bounds(torch, level, out["child_count"])
        fns = {"expand": lambda: L.expand_level(listed, *state, fmin),
               "compact": lambda: L.compact_level(core, core["sums"],
                                                  sym_mask)}
        if hasattr(L, "LevelTables"):
            prepared = L.LevelTables(listed)
            fns["expand_prepared"] = lambda: L.expand_level(
                prepared, *state, fmin)
        t = dict(sizes, expand_bound_ms=b12["bound_ms"],
                 compact_bound_ms=b13["bound_ms"])
        for name, f in fns.items():
            t[f"{name}_ms"] = [cuda_ms(torch, f, 20) for _ in range(5)]
            t[f"{name}_device_ms"] = device_ms(torch, f)
            t[f"{name}_queued_ms"] = [queued_ms(torch, f) for _ in range(3)]
            t[f"{name}_host_ms"] = host_ms(torch, f)
        res["levels"][label] = t
        log(f"level times {label}: {json.dumps(t)}")
    print(json.dumps(res), flush=True)


# the build variants of K12 and K13 that `level_variant_times` times:
# (source, constant, value), or (source, "cut", n): the source built with a
# `return` (a `continue` inside K12's chunk loop) before the anchors of cut
# n, so that the kernel stops after its first stages (its outputs then
# wrong, its time that of those stages)
LEVEL_VARIANTS = (("rank.cu", "cut", 1), ("rank.cu", "cut", 2),
                  ("rank.cu", "cut", 3), ("rank.cu", "cut", 4),
                  ("rank.cu", "kExpandBlocks", 3),
                  ("rank.cu", "kExpandBlocks", 5),
                  ("rank.cu", "kWideBlocks", 2), ("rank.cu", "kWideBlocks", 3),
                  ("level.cu", "cut", 1), ("level.cu", "cut", 2),
                  ("level.cu", "cut", 3), ("level.cu", "kBlocksPerSm", 2),
                  ("level.cu", "kBlocksPerSm", 8))
LEVEL_CUTS = {
    "rank.cu": {  # node tiles: cells loaded, staged, ranked, summed;
        #           chunks: cells loaded, ranked
        1: ("  // ---- stage the cells and list the rank jobs",
            "    // jobs: the forward ones (cells of mf)"),
        2: ("  // ---- the rank jobs: a group of 8 lanes a job",),
        3: ("  // ---- the nodes' sums: a warp's segments",
            "    // this lane's cell out"),
        4: ("  // ---- the staged spans out, 16 bytes a store",)},
    "level.cu": {  # launched; the flags' phase; the grid barrier
        1: ("  // ---- phase 1: the flags",),
        2: ("  cg::this_grid().sync();",),
        3: ("  // ---- phase 2: the rows",)}}


def level_variant_times(torch, device) -> None:
    """K12 and K13 on `dense_levels`' four recorded levels, as built and
    with each of LEVEL_VARIANTS (its source changed, built with the other
    sources into its own library under build/variants/): device time by
    `queued_ms`, three times each; the variants that change a constant are
    held against the plain versions.  K13's running state is made anew for
    each variant (a cut one leaves it unzeroed).  Prints one JSON line."""
    import re
    import shutil

    from dsm_tpu_torch.ops import _build
    from dsm_tpu_torch.ops import level as L

    phase_build()
    levels = dense_levels(torch, device)
    want = {}
    for label, (_rec, (tables, state, fmin, sm)) in levels.items():
        core = L.expand_level_plain(tables, *state, fmin)
        want[label] = core, L.compact_level_plain(core, core["sums"], sm)
    res = {"smi": smi_line()}

    def time_build(tag: str, check: bool) -> None:
        L._COMPACT_STATES.clear()
        for label, (_rec, (tables, state, fmin, sm)) in levels.items():
            core = L.expand_level(tables, *state, fmin)
            out = L.compact_level(core, core["sums"], sm)
            if check and not (
                    all(torch.equal(core[k], want[label][0][k])
                        for k in want[label][0])
                    and all(torch.equal(out[k], want[label][1][k])
                            for k in out)):
                raise SystemExit(f"level_variant_times: {tag} disagrees with "
                                 f"the plain versions on {label}")
            res[f"{tag}, {label}"] = {
                "K12": [queued_ms(torch, lambda: L.expand_level(
                    tables, *state, fmin)) for _ in range(3)],
                "K13": [queued_ms(torch, lambda: L.compact_level(
                    core, core["sums"], sm)) for _ in range(3)]}

    time_build("as built", True)
    csrc, build_dir = _build.CSRC, _build.BUILD_DIR
    try:
        for src, name, value in LEVEL_VARIANTS:
            work = os.path.join(HERE, "build", "variants",
                                f"{src[:-3]}_{name}{value}")
            shutil.rmtree(work, ignore_errors=True)
            shutil.copytree(csrc, os.path.join(work, "csrc"))
            path = os.path.join(work, "csrc", src)
            with open(path) as fh:
                text = fh.read()
            if name == "cut":
                n = 0
                for anchor in LEVEL_CUTS[src][value]:
                    stop = "    continue;\n" if anchor.startswith("    ") \
                        else "  return;\n"
                    n += text.count(anchor)
                    text = text.replace(anchor, stop + anchor, 1)
            else:
                text, n = re.subn(rf"constexpr int {name} = \d+;",
                                  f"constexpr int {name} = {value};", text)
            if n != (len(LEVEL_CUTS[src][value]) if name == "cut" else 1):
                raise SystemExit(f"level_variant_times: {src} has no "
                                 f"{name} {value}")
            with open(path, "w") as fh:
                fh.write(text)
            _build.CSRC = Path(work) / "csrc"
            _build.BUILD_DIR, _build._lib = Path(work), None
            _build.lib()
            time_build(f"{src} {name} {value}", name != "cut")
    finally:
        _build.CSRC, _build.BUILD_DIR, _build._lib = csrc, build_dir, None
        L._COMPACT_STATES.clear()
    print(json.dumps(res), flush=True)


def dense_levels(torch, device) -> dict:
    """`dense_level_times`' four runs: -> {label: (the run's record, its
    widest level as (tables, state, fmin, sym_mask))}."""
    from dsm_tpu_torch.mining import engine as eng
    from dsm_tpu_torch.mining.config import MiningConfig
    from dsm_tpu_torch.parallel.engine_sharded import (ShardedIndexes,
                                                       mine_sharded)
    from dsm_tpu_torch.parallel.mesh import make_mesh

    fz = load_tests_module("freeze_samples_reference")
    with tempfile.TemporaryDirectory(prefix="dsm_times_levels_") as td:
        s100 = phase_data(torch, load_make_toydata(), td, device)[0]
        d512 = samples_build(torch, fz, D512, td, device)[0]
    found = {}
    sets = (("scale 100 under " + LEVEL_PREFIX.decode(), s100, LEVEL_PREFIX,
             MiningConfig(fmin=FMIN, emax=EMAX), (4, 2)),
            ("D512", d512, b"", samples_config(D512), (4, 128)))
    for where, idxs, prefix, cfg, shape in sets:
        dev = eng.DeviceIndexes.build(idxs, device)
        mesh = make_mesh(*shape, device=device)
        sharded = ShardedIndexes.build(idxs, mesh.samples)
        runs = (("one row", lambda prof: eng.mine_levels(
            cfg, dev.S, [(dev.frows, dev.rrows, dev.soff, 0)], dev.ns,
            np.ones((1, 0, 4), dtype=bool), prefix, None, eng.MIN_CAP,
            device, profile=prof)),
            (f"{shape}", lambda prof: mine_sharded(
                idxs, cfg, mesh=mesh, dev=sharded, prefix=prefix,
                reader_order="ascending", profile=prof)))
        for run, fn in runs:
            label = f"{where}, {run}"
            _out, rec, level = level_run(torch, label, fn, "level times")
            found[label] = rec, level
    return found


def occ_table_big(torch, device):
    """K15's table past the 50 MB L2: OCC_BIG_CODES random codes in 1..5
    made on the card from a seeded generator, as (nb, 128) int8 blocks, and
    its (nb + 1, SIGMA) int32 occ table by cumulative counts (~0.17 GB)."""
    from dsm_tpu_torch.ops.rank import SIGMA

    gen = torch.Generator(device=device).manual_seed(27)
    blocks = torch.randint(1, 6, (OCC_BIG_CODES // 128, 128), device=device,
                           dtype=torch.int8, generator=gen)
    occ = torch.zeros((blocks.shape[0] + 1, SIGMA), dtype=torch.int32,
                      device=device)
    occ[1:] = torch.stack([(blocks == c).sum(1, dtype=torch.int32)
                           for c in range(SIGMA)], 1).cumsum(
                               0, dtype=torch.int32)
    return blocks, occ


def occ_cases(torch, toy0, device, gen) -> dict:
    """K15's three cases, {label: (blocks, occ, syms, pos)}: (a)
    LEVEL_OCC_Q random positions (and symbols 0..7, PAD included) on toy0's
    blocks at scale 100, drawn from `gen`; (b) the same positions sorted,
    the order in which a level's interval ends arrive; (c) LEVEL_OCC_Q
    random positions on `occ_table_big`, past the L2."""
    t = toy0.table
    blocks = torch.as_tensor(t.blocks, device=device)
    occ = torch.as_tensor(t.occ, device=device)
    pos = (torch.rand(LEVEL_OCC_Q, device=device, generator=gen)
           * (t.n + 1)).to(torch.int32).clamp(max=t.n)
    syms = torch.randint(0, 8, (LEVEL_OCC_Q,), device=device,
                         dtype=torch.int32, generator=gen)
    big_blocks, big_occ = occ_table_big(torch, device)
    big_pos = torch.randint(0, OCC_BIG_CODES + 1, (LEVEL_OCC_Q,),
                            device=device, dtype=torch.int32, generator=gen)
    q, nb = f"Q={LEVEL_OCC_Q:,}", f"{blocks.shape[0]:,}"
    return {
        f"(a) {q} random on toy0's {nb} blocks": (blocks, occ, syms, pos),
        f"(b) {q} sorted on toy0's {nb} blocks": (
            blocks, occ, syms, torch.sort(pos).values),
        f"(c) {q} random on {big_blocks.shape[0]:,} blocks past the L2": (
            big_blocks, big_occ, syms, big_pos)}


def occ_bounds(torch, blocks, occ, pos) -> dict:
    """K15's bounds at these inputs: `bound` by DRAM bytes (12 B a query,
    each distinct block's row and occ row once) and the L2 floor, the mean
    32-byte sectors a query reads (its occ sector and the row's sectors it
    counts in), counted from the row's start and from its nearer end."""
    p = pos.to(torch.int64)
    b, r = p >> 7, p & 127
    nblk = int(torch.unique(b).numel())
    fwd = (r + 31) // 32
    back = (r > 64) & (b + 1 < blocks.shape[0])
    nearer = torch.where(back, 4 - r // 32, fwd)
    return dict(**bound(12 * p.numel() + nblk * (128 + 4 * occ.shape[1]),
                        40 * p.numel()),
                distinct_blocks=nblk,
                sectors_forward=1 + float(fwd.double().mean()),
                sectors_nearer=1 + float(nearer.double().mean()))


def ops_cases(torch, toy0, device) -> list[dict]:
    """K14 (compact_kidx) at N = LEVEL_KIDX_N, 30% set, and K15
    (occ_batch) at `occ_cases`' three cases, each first called once
    through its API (the "ops" path, counts from 0), then against its plain
    version and timed (also `queued_ms`, device time without the wrapper's
    host time; K14's also its scratch's zero fill alone); -> their
    entries."""
    from dsm_tpu_torch.ops import _build
    from dsm_tpu_torch.ops.compact import (TILE_ROWS, compact_kidx,
                                           compact_kidx_plain,
                                           compact_kidx_sort)
    from dsm_tpu_torch.ops.rank import occ_batch, occ_batch_plain

    gen = torch.Generator(device=device).manual_seed(17)
    mask = torch.rand(LEVEL_KIDX_N, device=device, generator=gen) < 0.3
    cases = occ_cases(torch, toy0, device, gen)
    count = int(mask.sum())
    torch.cuda.synchronize()
    _build.reset_launches()
    kidx, c1 = compact_kidx(mask, count)
    kidx_s, c2 = compact_kidx_sort(mask, count)
    ranks = [occ_batch(*args) for args in cases.values()]
    torch.cuda.synchronize()
    launches = path_launches("ops", "the API ops' path (one call each)")
    want, wc = compact_kidx_plain(mask, count)
    if not (torch.equal(kidx, want) and torch.equal(kidx_s, want)
            and int(c1) == int(c2) == int(wc) == count):
        raise SystemExit("compact_kidx disagrees with its plain version")
    below, bc = compact_kidx(mask, count // 2)
    if not torch.equal(below, want[:count // 2]) or int(bc) != count:
        raise SystemExit("compact_kidx disagrees below the count")
    for (label, args), got in zip(cases.items(), ranks):
        if not torch.equal(got, occ_batch_plain(*args)):
            raise SystemExit(f"occ_batch disagrees with its plain version at "
                             f"{label}")
    n = LEVEL_KIDX_N
    entries = [
        dict(name="compact_kidx", route="cuda",
             source="dsm_tpu_torch/csrc/compact.cu",
             replaces="dsm_tpu/ops/compact.py:33", launches=launches[
                 "compact_kidx"], max_abs_err=0,
             ms=cuda_ms(torch, lambda: compact_kidx(mask, count)),
             device_ms=device_ms(torch, lambda: compact_kidx(mask, count)),
             queued_ms=queued_ms(torch, lambda: compact_kidx(mask, count)),
             # its scratch's zero fill alone (the C entry clears the status
             # words and tile counter with cudaMemsetAsync before the kernel)
             scratch_queued_ms=queued_ms(torch, torch.empty(
                 -(-n // TILE_ROWS) + 1, dtype=torch.int64,
                 device=device).zero_),
             plain_ms=cuda_ms(torch, lambda: compact_kidx_plain(mask, count)),
             **bound(n + 4 * count, 2 * n),
             library_ms=cuda_ms(torch, lambda: torch.nonzero(mask)[:count]),
             case=f"N={n:,}, {count:,} set")]
    for label, args in cases.items():
        entries.append(dict(
            name="occ_batch", route="cuda",
            source="dsm_tpu_torch/csrc/occbatch.cu",
            replaces="dsm_tpu/ops/rank.py:270",
            launches=launches["occ_batch"], max_abs_err=0,
            ms=cuda_ms(torch, lambda: occ_batch(*args)),
            device_ms=device_ms(torch, lambda: occ_batch(*args)),
            queued_ms=queued_ms(torch, lambda: occ_batch(*args)),
            plain_ms=cuda_ms(torch, lambda: occ_batch_plain(*args), reps=3),
            **occ_bounds(torch, args[0], args[1], args[3]),
            library_ms=None, case=label))
    for e in entries:
        log(f"kernel {e['name']}: {e['case']}: equal; {e['ms']:.4f} ms "
            f"(device {fmt_ms(e['device_ms'])}, queued "
            f"{e['queued_ms']:.4f} ms) vs plain {e['plain_ms']:.4f} ms, "
            f"library {fmt_ms(e['library_ms'])}; bound "
            f"{e['bound_ms']:.4f} ms by {e['bound_by']}")
    return entries


# K15's build variants that `occ_batch_times` times beside the source as
# built, {label: ((old, new), ...)}: csrc/occbatch.cu with each `old`
# (found once) replaced by `new`.  Two other forms, checked against the
# plain version (the count from the row's start; `__vcmpeq4` under a mask a
# word for the zero-byte test), then cuts that skip stages (their outputs
# wrong, their time that of the stages left)
_OCC_NO_OCC = ("mine ? __ldg(occ", "false ? __ldg(occ")
_OCC_NO_ROWS = ("const bool need = vi < 8",
                "const bool need = false && vi < 8")
_OCC_W = "  const uint32_t w[4] = {v.x, v.y, v.z, v.w};\n"
_OCC_NO_COMPARES = (_OCC_W,
                    "  return (v.x ^ v.y ^ v.z ^ v.w) & 1u;\n" + _OCC_W)
OCC_PATCHES = {
    "from the start": (("return (p & 127u) > 64u",
                        "return false && (p & 127u) > 64u"),),
    "vcmpeq4": ((_OCC_W, _OCC_W + """\
  uint32_t bits = 0;
  for (int k = 0; k < 4; ++k) {
    const uint32_t m = __funnelshift_lc(kFull, 0u, max(8 * below - 32 * k, 0));
    bits += __popc(__vcmpeq4(w[k], sym4) & (back ? ~m : m));
  }
  return bits >> 3;
"""),),
    "cut: no occ load": (_OCC_NO_OCC,),
    "cut: no row loads": (_OCC_NO_ROWS,),
    "cut: no compares": (_OCC_NO_COMPARES,),
    "cut: positions and symbols only": (
        _OCC_NO_OCC, _OCC_NO_ROWS, _OCC_NO_COMPARES,
        ("out[base + lane] = from_end(p, nb) ? o - n : o + n;",
         "out[base + lane] = (int32_t)p + s;"))}


def occ_batch_times(torch, device, parent: str | None = None) -> None:
    """Times K15 at `occ_cases`' three cases and prints one JSON line:
    device time by `queued_ms` (three readings a turn) of the package's
    `occ_batch` as built and, where `parent` names another tree's root
    (e.g. `git archive` of the parent commit unpacked into build/parent),
    that tree's kernel, built and bound by that tree's own ops/_build.py,
    in turns (parent, change, OCC_PATCHES' builds, change, parent); each
    patched copy of csrc/ is built through _build into its own directory
    under build/occ_times/.  Every build but the cut ones is first held bit
    for bit against `occ_batch_plain`; beside the times each case's bounds
    (`occ_bounds`)."""
    import importlib.util
    import shutil

    from dsm_tpu_torch.ops import _build
    from dsm_tpu_torch.ops.rank import occ_batch, occ_batch_plain

    phase_build()
    with tempfile.TemporaryDirectory(prefix="dsm_times_occ_") as td:
        toy0 = phase_data(torch, load_make_toydata(), td, device)[0][0]
    gen = torch.Generator(device=device).manual_seed(17)
    torch.rand(LEVEL_KIDX_N, device=device, generator=gen)  # ops_cases' mask
    cases = occ_cases(torch, toy0, device, gen)
    calls = {"change": occ_batch}
    if parent:
        spec = importlib.util.spec_from_file_location(
            "parent_build", os.path.join(parent, "dsm_tpu_torch", "ops",
                                         "_build.py"))
        pb = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(pb)
        with_nb = len(pb._SIGNATURES["dsm_occ_batch"]) == 9

        def parent_call(blocks, occ, syms, pos):
            out = torch.empty(pos.shape[0], dtype=torch.int32, device=device)
            nb = (blocks.shape[0],) if with_nb else ()
            pb.launch("dsm_occ_batch", "occ_batch", device, blocks.data_ptr(),
                      *nb, occ.data_ptr(), occ.shape[1], syms.data_ptr(),
                      pos.data_ptr(), out.data_ptr(), pos.shape[0])
            return out
        calls["parent"] = parent_call
    res = {"tree": HERE, "smi": smi_line(), "cases": {
        label: {**occ_bounds(torch, args[0], args[1], args[3]),
                "queued_ms": {}} for label, args in cases.items()}}

    def time_build(tag: str, call) -> None:
        for label, args in cases.items():
            if "cut:" not in tag and not torch.equal(
                    call(*args), occ_batch_plain(*args)):
                raise SystemExit(f"occ_batch_times: {tag} disagrees with the "
                                 f"plain version at {label}")
            res["cases"][label]["queued_ms"].setdefault(tag, []).extend(
                queued_ms(torch, lambda: call(*args)) for _ in range(3))

    turns = ["parent"] if parent else []
    for tag in turns + ["change"]:
        time_build(tag, calls[tag])
    csrc, build_dir = _build.CSRC, _build.BUILD_DIR
    try:
        for i, (label, patches) in enumerate(OCC_PATCHES.items()):
            work = os.path.join(HERE, "build", "occ_times", f"v{i}")
            shutil.rmtree(work, ignore_errors=True)
            shutil.copytree(csrc, os.path.join(work, "csrc"))
            path = os.path.join(work, "csrc", "occbatch.cu")
            with open(path) as fh:
                text = fh.read()
            for old, new in patches:
                if text.count(old) != 1:
                    raise SystemExit(f"occ_batch_times: {label}: {old!r} is "
                                     f"not in occbatch.cu once")
                text = text.replace(old, new)
            with open(path, "w") as fh:
                fh.write(text)
            _build.CSRC = Path(work) / "csrc"
            _build.BUILD_DIR, _build._lib = Path(work), None
            _build.lib()
            time_build(label, occ_batch)
    finally:
        _build.CSRC, _build.BUILD_DIR, _build._lib = csrc, build_dir, None
    for tag in ["change"] + turns:
        time_build(tag, calls[tag])
    for label, t in res["cases"].items():
        log(f"occ_batch times {label}: {json.dumps(t)}")
    print(json.dumps(res), flush=True)


def levels_d512(torch, idxs, device) -> tuple:
    """D512's per-level runs against the frozen D512 (see the module's
    docstring); -> (records, {label: the widest level of the level-gnu run
    and of the (4, 128) ascending run})."""
    from dsm_tpu_torch.mining.engine import DeviceIndexes, mine_torch
    from dsm_tpu_torch.parallel.engine_sharded import (ShardedIndexes,
                                                       mine_sharded)
    from dsm_tpu_torch.parallel.mesh import make_mesh

    ref, tag = D512, "D512 levels"
    cfg = samples_config(ref)
    dev = DeviceIndexes.build(idxs, device)
    recs, widest = {}, {}
    out, recs["level-gnu"], widest["level-gnu"] = level_run(
        torch, "mine_torch level-gnu", lambda prof: mine_torch(
            idxs, cfg, dev=dev, reader_order="level-gnu", profile=prof), tag)
    samples_check(out, ref, "level-gnu", "gnu")
    for shape, orders in (((1, 1), ("ascending",)),
                          ((4, 2), ("ascending", "gnu")),
                          ((4, 128), ("ascending", "gnu"))):
        mesh = make_mesh(*shape, device=device)
        tables = ShardedIndexes.build(idxs, mesh.samples)
        for order in orders:
            label = f"mine_sharded {shape} {order}"
            out, recs[label], w = level_run(
                torch, label, lambda prof: mine_sharded(
                    idxs, cfg, mesh=mesh, dev=tables, reader_order=order,
                    profile=prof), tag)
            if shape == (4, 128) and order == "ascending":
                widest[label] = w
            samples_check(out, ref, f"mine_sharded {shape}", order)
        del tables
    # the level's all-reduce and the emission's gathers on the card: the
    # (4, 2) gnu run once more in a process group of this one process
    import torch.distributed as dist

    from dsm_tpu_torch.parallel.multihost import initialize

    with tempfile.TemporaryDirectory(prefix="dsm_smoke_nccl_") as td:
        initialize(f"file://{os.path.join(td, 'rendezvous')}", 1, 0,
                   backend="nccl")
        try:
            mesh = make_mesh(4, 2, device=device)
            if mesh.samples.group is None:
                raise SystemExit("no process group after initialize()")
            label = "mine_sharded (4, 2) gnu in a one-rank NCCL group"
            out, recs[label], _w = level_run(
                torch, label, lambda prof: mine_sharded(
                    idxs, cfg, mesh=mesh, reader_order="gnu", profile=prof),
                tag)
            samples_check(out, ref, "mine_sharded (4, 2), NCCL group", "gnu")
        finally:
            dist.destroy_process_group()
    # the four one-symbol prefix runs, concatenated, in each order
    for how, order in (("episode", "ascending"), ("episode", "gnu"),
                       ("level-gnu", "gnu")):
        outs = []
        for p in b"ACGT":
            ro = "level-gnu" if how == "level-gnu" else order
            outs.append(mine_torch(idxs, cfg, dev=dev, prefix=bytes([p]),
                                   reader_order=ro))
        concat_check(outs, ref, f"D512 prefix runs by {how}", order)
    return recs, widest


def levels_s100(torch, idxs, device) -> tuple:
    """Scale 100 under LEVEL_PREFIX: the episode's bytes in each order, and
    level-gnu and mine_sharded at (4, 2) in both orders equal to them;
    -> (records, {label: the widest level of the level-gnu run and of the
    (4, 2) ascending run})."""
    from dsm_tpu_torch.mining.engine import (DeviceIndexes, MiningConfig,
                                             mine_torch)
    from dsm_tpu_torch.parallel.engine_sharded import (ShardedIndexes,
                                                       mine_sharded)
    from dsm_tpu_torch.parallel.mesh import make_mesh

    tag, p = "scale 100 levels", LEVEL_PREFIX
    cfg = MiningConfig(fmin=FMIN, emax=EMAX)
    dev = DeviceIndexes.build(idxs, device)
    want, recs = {}, {}
    for order in ("ascending", "gnu"):
        want[order], recs[f"episode {order}"] = s1000_run(
            torch, f"episode {order} under {p.decode()}",
            lambda prof: mine_torch(idxs, cfg, dev=dev, prefix=p,
                                    reader_order=order, profile=prof),
            tag=tag)
    log(f"{tag}: under {p.decode()} the episode finds "
        f"{want['gnu'].total_paths:,} paths, {want['gnu'].total_output:,} "
        f"lines")
    mesh = make_mesh(4, 2, device=device)
    tables = ShardedIndexes.build(idxs, mesh.samples)
    runs = [("level-gnu", "gnu", lambda prof: mine_torch(
        idxs, cfg, dev=dev, prefix=p, reader_order="level-gnu",
        profile=prof))]
    for order in ("ascending", "gnu"):
        runs.append((f"mine_sharded (4, 2) {order}", order,
                     lambda prof, order=order: mine_sharded(
                         idxs, cfg, mesh=mesh, dev=tables, prefix=p,
                         reader_order=order, profile=prof)))
    widest = {}
    for label, order, run in runs:
        out, recs[label], w = level_run(torch, f"{label} under "
                                        f"{p.decode()}", run, tag)
        if label == "level-gnu" or order == "ascending":
            widest[label] = w
        got = (out.format_lines(), out.total_paths, out.total_occs)
        if got != (want[order].format_lines(), want[order].total_paths,
                   want[order].total_occs):
            raise SystemExit(f"{tag} {label}: not the episode's bytes")
        log(f"{tag} {label}: {out.total_output:,} lines, the episode's "
            f"{order} bytes")
    return recs, widest


def phase_levels(torch, idxs, d512, device) -> list[dict]:
    """Phase 17: the per-level engines on D512 (its indexes from phase 16)
    and on scale 100 under LEVEL_PREFIX; K12 and K13 at the widest level of
    each one's level-gnu run (one row, one table) and of its sharded run
    with four prefix rows ((4, 2): 2 tables; (4, 128): 128), each entry
    with the launches of its own run; K14 and K15 through their API; -> the
    kernels' entries."""
    t0 = time.perf_counter()
    recs512, w512 = levels_d512(torch, d512, device)
    recs100, w100 = levels_s100(torch, idxs, device)
    kernels = []
    cases = [(f"scale 100 under {LEVEL_PREFIX.decode()}", recs100, w100),
             ("D512", recs512, w512)]
    for where, recs, widest in cases:
        for run, level in widest.items():
            label = f"{where}, the {run} run's widest level"
            for e in level_kernel_cases(torch, level, label):
                e["launches"] = recs[run]["launches"][e["name"]]
                kernels.append(e)
        widest.clear()
    kernels += ops_cases(torch, idxs[0], device)
    summary = {"D512": {k: {f: r.get(f) for f in (
        "wall_s", "levels", "regrows", "level_s", "host_s", "peak_bytes")}
        for k, r in recs512.items()},
        "scale 100": {k: {f: r.get(f) for f in (
            "wall_s", "paths", "levels", "regrows", "level_s", "host_s",
            "peak_bytes")} for k, r in recs100.items()},
        "phase_s": time.perf_counter() - t0, "card": smi_line()}
    log(f"levels summary: {json.dumps(summary)}")
    log(f"levels kernels: {json.dumps(kernels)}")
    return kernels


def levels_alone(torch, device) -> None:
    """Phase 17 by itself, after the environment, the build, the scale-100
    data and D512's build (for a quicker run while developing; no result
    line)."""
    phase_env(torch)
    phase_build()
    fz = load_tests_module("freeze_samples_reference")
    with tempfile.TemporaryDirectory(prefix="dsm_smoke_levels_") as td:
        idxs, _toy0, _l = phase_data(torch, load_make_toydata(), td, device)
        d512 = samples_build(torch, fz, D512, td, device)[0]
    phase_levels(torch, idxs, d512, device)


def main() -> int:
    import torch


    smi = phase_env(torch)
    from dsm_tpu_torch.mining.engine import DeviceIndexes
    toy = load_make_toydata()

    phase_build()
    device = torch.device("cuda", 0)
    launches = {}
    with tempfile.TemporaryDirectory(prefix="dsm_smoke_") as td:
        idxs, toy0, launches["build"] = phase_data(torch, toy, td, device)
        dev = DeviceIndexes.build(idxs, device)
        kernels = (phase_kernels(torch, dev, device)
                   + [phase_leftchar(torch, idxs, dev, device)]
                   + phase_sharded_kernels(torch, device)
                   + phase_sa_kernels(torch, toy0, device)
                   + phase_repro_kernels(torch, device))
        launches["mine"], warm, gnu = phase_main(torch, idxs, dev, device)
        phase_resume(torch, idxs, dev, device, td)
        phase_halt(torch, idxs, dev, device, warm)
        launches["mine_sharded"], k10 = phase_sharded(torch, idxs, dev,
                                                      device, warm, td)
        kernels.append(k10)
        launches["owned"] = phase_owned(torch, idxs, device, warm)
        phase_cli(idxs, td, warm)
        # the capacity phase reads the peak memory of runs that hold their
        # own tables alone
        del dev
        launches["capacity"] = phase_capacity(torch, idxs, device)
        phase_fleet(td, device)
    # after the mine's peak memory is read: the plain version's f64 einsums
    # leave the matrix library's 32 MiB workspace allocated for the process
    kernels += phase_distance_kernel(torch, device)
    log(f"device memory allocated after the K11 phase: "
        f"{torch.cuda.memory_allocated(device):,} bytes")
    launches["distance"] = phase_distance(torch, device, gnu)
    launches["repro"] = phase_repro(torch, device)
    with tempfile.TemporaryDirectory(prefix="dsm_smoke1000_") as td:
        launches["s1000_build"], launches["s1000_mine"], _k = \
            phase_scale1000(torch, toy, td, device)
    held = {}
    samples = phase_samples(torch, device, held)
    levels = phase_levels(torch, idxs, held[512], device)
    # a kernel of two paths (rank, compact, decode) keeps the count of the
    # first, the single-device mine
    counts = {}
    for path in launches.values():
        for k, v in path.items():
            counts.setdefault(k, v)
    for k in kernels:
        k["launches"] = counts[LAUNCH_KEY[k["name"]]]
    # phase 16's entries (each with its "case") keep the launches of their
    # D273 run's path, phase 17's those of the run each case was taken from
    # and of the API ops' path
    kernels += samples + levels
    if any(m == "jax" or m.split(".")[0] == "dsm_tpu" for m in sys.modules):
        raise SystemExit("chip_smoke: jax or the JAX package was imported")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
