"""The benchmark's input data: FASTA sample sets made from a seed.

Frozen copies of the repository's two generators, so that a change to the
program or to its tests cannot change what the benchmark mines:

  * `make_toydata(outdir, scale, seed)`: the reference README's 5-sample
    example set (6 species genomes carried by 2-4 samples each with 1%
    per-sample mutations, three 120-base repeat elements planted 40-79
    times into sample pairs, a de Bruijn(4, 6) spike-in in every sample,
    lowercase letters and `N`s), 100 x scale reads of 80 bases a sample;
  * `make_samples(outdir, d, symbols, seed)`: d samples shaped as a
    metagenome collection (a core species in every sample, accessory
    species, private sequence, planted repeats; see its docstring).

Both write the same bytes as the originals for the same arguments (a CPU
test holds them to it).  A configuration may also state the layout of its
set (which samples carry what, at what abundance, the samples' sizes,
the repeats' copies), as the generator recorded it at a seed of the
configuration's choosing: the run's seed then draws only the sequences,
so every seed mines a trie of nearly the same size and shape.
`generate(config, seed, outdir)` dispatches on a configuration's
`generator` key.
"""

from __future__ import annotations

import os

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def _genome(rng: np.random.Generator, length: int) -> np.ndarray:
    return BASES[rng.integers(0, 4, size=length)]


def _mutate(rng: np.random.Generator, g: np.ndarray, rate: float) -> np.ndarray:
    g = g.copy()
    k = rng.binomial(len(g), rate)
    pos = rng.choice(len(g), size=k, replace=False)
    g[pos] = BASES[rng.integers(0, 4, size=k)]
    return g


def _write_fasta(path: str, reads) -> None:
    """`reads`: (header, sequence bytes) in order; 70 bases a line."""
    lines = []
    for header, seq in reads:
        lines.append(header)
        lines.extend(seq[i:i + 70] for i in range(0, len(seq), 70))
    with open(path, "wb") as f:
        f.write(b"\n".join(lines) + b"\n")


# ------------------------------------------------------------- toydata

TOY_SAMPLES = 5


def de_bruijn(k: int, order: int) -> np.ndarray:
    """de Bruijn sequence B(k, order) over ACGT[:k], wrapped by order-1
    symbols so every k**order substring of length `order` occurs linearly."""
    a = [0] * k * order
    seq: list[int] = []

    def db(t: int, p: int) -> None:
        if t > order:
            if order % p == 0:
                seq.extend(a[1:p + 1])
        else:
            a[t] = a[t - p]
            db(t + 1, p)
            for j in range(a[t - p] + 1, k):
                a[t] = j
                db(t + 1, t)

    db(1, 1)
    arr = np.array(seq + seq[:order - 1], dtype=np.int64)
    return BASES[arr]


def make_toydata(outdir: str, scale: int, seed: int,
                 layout: dict | None = None,
                 record: dict | None = None) -> list[str]:
    """toy0.fasta .. toy4.fasta in `outdir`; -> their paths.  The set's
    layout (which samples carry each species and at what abundance, each
    repeat's sample pair and copies) is drawn from `seed` with the
    sequences, and written into `record` when one is given; or it is
    `layout`, such a record, and `seed` draws only the sequences."""
    rng = np.random.default_rng(seed)
    nspecies = 6
    glen = 800 * scale
    species = [_genome(rng, glen) for _ in range(nspecies)]
    if layout is None:
        carriers = [
            sorted(rng.choice(TOY_SAMPLES, size=int(rng.integers(2, 5)),
                              replace=False))
            for _ in range(nspecies)
        ]
    else:
        carriers = layout["carriers"]
    repeats = []
    for r in range(3):
        elem = _genome(rng, 120)
        if layout is None:
            pair = sorted(rng.choice(TOY_SAMPLES, size=2, replace=False))
            copies = {int(s): int(rng.integers(40, 80)) for s in pair}
        else:
            copies = {int(s): c for s, c in layout["repeat_copies"][r].items()}
        repeats.append((elem, copies))
    if record is not None:
        record.update(carriers=[[int(c) for c in cs] for cs in carriers],
                      repeat_copies=[{str(k): v for k, v in c.items()}
                                     for _e, c in repeats], weights=[])
    reads_per_sample = 100 * scale
    read_len = 80
    spikein = de_bruijn(4, 6)
    paths = []
    os.makedirs(outdir, exist_ok=True)
    for s in range(TOY_SAMPLES):
        pool = [sp for sp in range(nspecies) if s in carriers[sp]]
        weights = (rng.dirichlet(np.ones(len(pool)) * 0.8) if layout is None
                   else np.asarray(layout["weights"][s]))
        local = {sp: _mutate(rng, species[sp], 0.01) for sp in pool}
        reads = []
        for r in range(reads_per_sample):
            sp = pool[rng.choice(len(pool), p=weights)]
            start = int(rng.integers(0, glen - read_len))
            read = local[sp][start:start + read_len].copy()
            if r % 17 == 0:
                read[:read_len // 4] += 32  # lowercase
            if r % 23 == 0:
                read[read_len // 2] = ord("N")
            reads.append((read, f"species={sp}"))
        for rid, (elem, copies) in enumerate(repeats):
            for _ in range(copies.get(s, 0)):
                off = int(rng.integers(0, 8))
                reads.append((elem[off:], f"repeat={rid}"))
        reads.append((spikein, "control"))
        if record is not None:
            record.setdefault("weights", []).append(weights.tolist())
        path = os.path.join(outdir, f"toy{s}.fasta")
        _write_fasta(path, [(f">read_{s}_{i} {tag}".encode(), read.tobytes())
                            for i, (read, tag) in enumerate(reads)])
        paths.append(path)
    return paths


# ------------------------------------------------------ many samples

READ_LEN = 80
CORE_LEN = 600          # the species every sample carries
REPEAT_LEN = 120        # a high-copy repeat element
REPEAT_SHARE = 0.15     # of the symbols, in the planted repeats


def _reads(rng, genome: np.ndarray, n: int) -> list[np.ndarray]:
    starts = rng.integers(0, len(genome) - READ_LEN + 1, size=n)
    return [genome[s:s + READ_LEN] for s in starts]


def make_samples(outdir: str, d: int, symbols: int, seed: int,
                 layout: dict | None = None,
                 record: dict | None = None) -> list[str]:
    """d FASTA files sample0000.fasta .. with about `symbols` indexed
    symbols in all (a read of n bases indexes 2n + 2), shaped as a
    metagenome collection:

      * sample sizes log-uniform over 0.5-2x their mean;
      * a core species (CORE_LEN bases, no variation) in every sample at
        30% of its reads;
      * accessory species (about one a 4 samples, each of 1.5x a mean
        sample's bases), each carried by 2..d/4 samples at uneven
        (Dirichlet) abundance, with 1% per-sample mutations: 55% of reads;
      * sample-private sequence: 15% of reads;
      * high-copy repeat elements (REPEAT_LEN bases, one a 8 samples),
        each planted into 2-3 samples so that they hold REPEAT_SHARE of
        the symbols, each copy with 1% mutations and a start jitter of up
        to 8;
      * lowercase letters (one read in 17) and `N`s (one read in 23).

    The collection's layout (read counts a sample, carriers, repeat
    groups and copies, each sample's reads a species) is drawn from `seed`
    with the sequences, and written into `record` when one is given; or it
    is `layout`, such a record, and `seed` draws only the sequences.
    """
    rng = np.random.default_rng(seed)
    if layout is None:
        sizes = np.exp(rng.uniform(np.log(0.5), np.log(2.0), size=d))
        sizes /= sizes.mean()
        per_read = 2 * READ_LEN + 2
        nreads = np.maximum((sizes * (1 - REPEAT_SHARE) * symbols / d
                             / per_read).astype(np.int64), 8)
    else:
        nreads = np.asarray(layout["nreads"], dtype=np.int64)
    mean_reads = float(nreads.mean())
    core = _genome(rng, CORE_LEN)
    nacc = max(2, d // 4)
    acc = [_genome(rng, max(int(1.5 * mean_reads * READ_LEN), 4 * READ_LEN))
           for _ in range(nacc)]
    if layout is None:
        carriers = [set(rng.choice(
            d, size=int(rng.integers(2, max(3, d // 4 + 1))),
            replace=False).tolist()) for _ in range(nacc)]
    else:
        carriers = [set(c) for c in layout["carriers"]]
    nrep = max(2, d // 8)
    copies = REPEAT_SHARE * symbols / (nrep * 2.5 * (2 * REPEAT_LEN + 2))
    repeats = []
    for r in range(nrep):
        if layout is None:
            group = rng.choice(d, size=int(rng.integers(2, 4)), replace=False)
            repeats.append((_genome(rng, REPEAT_LEN), {
                int(s): int(rng.integers(max(2, int(0.4 * copies)),
                                         max(3, int(1.6 * copies))))
                for s in group}))
        else:
            repeats.append((_genome(rng, REPEAT_LEN), {
                int(s): c for s, c in layout["repeat_copies"][r].items()}))
    if record is not None:
        record.update(nreads=nreads.tolist(),
                      carriers=[sorted(c) for c in carriers],
                      repeat_copies=[{str(k): v for k, v in g.items()}
                                     for _e, g in repeats], species_reads=[])
    os.makedirs(outdir, exist_ok=True)
    paths = []
    for s in range(d):
        n = int(nreads[s])
        pool = [a for a in range(nacc) if s in carriers[a]]
        reads = [(r, "core") for r in _reads(rng, core, int(0.30 * n))]
        counts = []
        if pool:
            if layout is None:
                w = rng.dirichlet(np.full(len(pool), 0.8))
                counts = rng.multinomial(int(0.55 * n), w)
            else:
                counts = layout["species_reads"][s]
            for a, c in zip(pool, counts):
                local = _mutate(rng, acc[a], 0.01)
                reads += [(r, f"species={a}") for r in _reads(rng, local, c)]
        if record is not None:
            record["species_reads"].append([int(c) for c in counts])
        private = _genome(rng, max(4 * READ_LEN, int(0.15 * n) * READ_LEN // 3))
        reads += [(r, "private") for r in _reads(rng, private, int(0.15 * n))]
        for rid, (elem, group) in enumerate(repeats):
            for _ in range(group.get(s, 0)):
                off = int(rng.integers(0, 8))
                reads.append((_mutate(rng, elem, 0.01)[off:], f"repeat={rid}"))
        out = []
        for i, (read, tag) in enumerate(reads):
            read = read.copy()
            if i % 17 == 0:
                read[:len(read) // 4] += 32   # lowercase
            if i % 23 == 0:
                read[len(read) // 2] = ord("N")
            out.append((f">read_{s}_{i} {tag}".encode(), read.tobytes()))
        path = os.path.join(outdir, f"sample{s:04d}.fasta")
        _write_fasta(path, out)
        paths.append(path)
    return paths


GENERATORS = {
    "toydata": lambda cfg, seed, outdir: make_toydata(
        outdir, cfg["scale"], seed, cfg.get("layout")),
    "samples": lambda cfg, seed, outdir: make_samples(
        outdir, cfg["samples"], cfg["symbols_asked"], seed,
        cfg.get("layout")),
}


def generate(config: dict, seed: int, outdir: str) -> list[str]:
    """The FASTA files of `config` (a configuration file's dict) for
    `seed`, written into `outdir`; -> their paths in sample order."""
    return GENERATORS[config["generator"]](config, seed, outdir)
