"""Cluster/localhost orchestration — the wrapper-SLURM / wrapper-simple
equivalent (SURVEY.md §2.4).

The reference topology: one metaserver per DNA-prefix "hash" on
consecutive ports (4 / 16 / 64 processes: example-server.sh), each
writing a `hostname\\tport\\thash` discovery file; clients concatenate the
files and stream one trie per (sample, prefix) pair
(example-client.sh + client-wrapper.sh, --fmin 2, entropy cutoff 1.2).

`python -m dsm_tpu_torch launch` reproduces that wiring (the port's copy
of dsm_tpu/cli/launch.py; its processes are the port's own CLI):

  * `--mode local`  — spawn every server and client as a subprocess on
    this machine and wait (the README toydata walkthrough, automated);
  * `--mode slurm`  — emit sbatch scripts per server/client with the
    same discovery-file contract, for a real cluster;
  * `--mode config` — only write the hostinfo/discovery files so
    externally-managed processes can join.

The integrated device pipeline (`mine`) is the GPU path; this launcher
exists for reference-compatible process fleets (ours or mixed — every
component speaks the reference wire protocol).
"""

from __future__ import annotations

import itertools
import os
import subprocess
import sys
import time


def prefix_hashes(depth: int) -> list[str]:
    """A, C, G, T -> 4**depth prefixes (example-server.sh hash arrays)."""
    return ["".join(p) for p in itertools.product("ACGT", repeat=depth)]


def write_discovery(tmpdir: str, host: str, port: int, hash_: str) -> str:
    """server-wrapper.sh's `hostname\\tport\\thash` config file."""
    path = os.path.join(tmpdir, f"metaserver_config_{hash_}.txt")
    with open(path, "w") as f:
        f.write(f"{host}\t{port}\t{hash_}\n")
    return path


def read_discovery(tmpdir: str) -> list[tuple[str, int, str]]:
    """Concatenate metaserver_config_*.txt (example-client.sh)."""
    out = []
    for name in sorted(os.listdir(tmpdir)):
        if name.startswith("metaserver_config_") and name.endswith(".txt"):
            with open(os.path.join(tmpdir, name)) as f:
                for line in f:
                    if line.strip():
                        host, port, hash_ = line.rstrip("\n").split("\t")
                        out.append((host, int(port), hash_))
    return out


def launch_local(samples: list[str], indexes: list[str], tmpdir: str,
                 outdir: str, base_port: int = 52000, hash_depth: int = 1,
                 emax: float = 1.2, fmin: int = 2,
                 server_cmd: list[str] | None = None,
                 client_cmd: list[str] | None = None,
                 extra_server_args: list[str] | None = None,
                 extra_client_args: list[str] | None = None,
                 err=sys.stderr) -> list[str]:
    """Run the full fleet on localhost; -> per-prefix output files.

    server_cmd/client_cmd default to the port's CLI (`python -m
    dsm_tpu_torch serve` / `enumerate`); point them at the reference
    binaries (["/path/metaserver"], ["/path/metaenumerate"])
    for mixed-fleet runs.
    """
    os.makedirs(tmpdir, exist_ok=True)
    os.makedirs(outdir, exist_ok=True)
    hashes = prefix_hashes(hash_depth)
    names = ("\n".join(samples) + "\n").encode()
    if server_cmd is None:
        server_cmd = [sys.executable, "-m", "dsm_tpu_torch", "serve"]
    if client_cmd is None:
        client_cmd = [sys.executable, "-m", "dsm_tpu_torch", "enumerate"]

    servers, outputs = [], []
    for i, h in enumerate(hashes):
        port = base_port + i
        write_discovery(tmpdir, "localhost", port, h)
        outfile = os.path.join(outdir, f"server-output.{h}.txt")
        outputs.append(outfile)
        with open(outfile, "wb") as out, \
                open(os.path.join(tmpdir, f"server.{h}.log"), "wb") as log:
            p = subprocess.Popen(
                [*server_cmd, "-p", str(port), "--emax", str(emax),
                 *(extra_server_args or [])],
                stdin=subprocess.PIPE, stdout=out, stderr=log)
        p.stdin.write(names)
        p.stdin.close()
        servers.append(p)

    time.sleep(1.0)
    hostinfo = "".join(f"{host} {port} {h}\n"
                       for host, port, h in read_discovery(tmpdir)).encode()
    clients = []
    for sample, index in zip(samples, indexes):
        with open(os.path.join(tmpdir, f"client.{sample}.log"), "wb") as log:
            p = subprocess.Popen(
                [*client_cmd, "--fmin", str(fmin),
                 *(extra_client_args or []), index],
                stdin=subprocess.PIPE, stdout=subprocess.DEVNULL, stderr=log)
        p.stdin.write(hostinfo)
        p.stdin.close()
        clients.append(p)

    failed = []
    for p, sample in zip(clients, samples):
        if p.wait() != 0:
            failed.append(f"client {sample}")
    if failed:
        # a server waits for every sample's connection: one that will
        # never come leaves it waiting for good
        for p in servers:
            p.kill()
    for p, h in zip(servers, hashes):
        if p.wait() != 0:
            failed.append(f"server {h}")
    if failed:
        raise RuntimeError(f"launch: failed processes: {', '.join(failed)}")
    return outputs


SBATCH_SERVER = """#!/bin/bash
#SBATCH -J dsm_server_{hash}
#SBATCH -e {tmpdir}/server_{hash}.ER
#SBATCH -o {tmpdir}/server_{hash}.OU
#SBATCH --mem-per-cpu={mem_mb}
#SBATCH -t {walltime}
echo -e "$HOSTNAME\\t{port}\\t{hash}" > {tmpdir}/metaserver_config_{hash}.txt
cat {samplelist} | {server_cmd} -p {port} --emax {emax} -v \\
    > {outdir}/server-output.{hash}.txt 2> {tmpdir}/server.{hash}.log
"""

SBATCH_CLIENT = """#!/bin/bash
#SBATCH -J dsm_client
#SBATCH -e {tmpdir}/client_%j.ER
#SBATCH -o {tmpdir}/client_%j.OU
#SBATCH --mem-per-cpu={mem_mb}
#SBATCH -t {walltime}
cat {tmpdir}/metaserver_config_*.txt \\
    | awk '{{print $1" "$2" "$3}}' \\
    | {client_cmd} --fmin {fmin} {index}
"""


def emit_slurm(samples: list[str], indexes: list[str], tmpdir: str,
               outdir: str, samplelist: str, base_port: int = 52000,
               hash_depth: int = 1, emax: float = 1.2, fmin: int = 2,
               mem_mb: int = 1000, walltime: str = "24:00:00",
               server_cmd: str = "python -m dsm_tpu_torch serve",
               client_cmd: str = "python -m dsm_tpu_torch enumerate"
               ) -> list[str]:
    """Write sbatch scripts mirroring wrapper-SLURM; -> script paths.
    Submit servers first, clients once every discovery file exists
    (README.md:114-120 job-dependency discipline)."""
    os.makedirs(tmpdir, exist_ok=True)
    scripts = []
    for i, h in enumerate(prefix_hashes(hash_depth)):
        path = os.path.join(tmpdir, f"server_{h}.sbatch")
        with open(path, "w") as f:
            f.write(SBATCH_SERVER.format(
                hash=h, port=base_port + i, tmpdir=tmpdir, outdir=outdir,
                samplelist=samplelist, emax=emax, mem_mb=mem_mb,
                walltime=walltime, server_cmd=server_cmd))
        scripts.append(path)
    for sample, index in zip(samples, indexes):
        path = os.path.join(tmpdir, f"client_{sample}.sbatch")
        with open(path, "w") as f:
            f.write(SBATCH_CLIENT.format(
                tmpdir=tmpdir, index=index, fmin=fmin, mem_mb=mem_mb,
                walltime=walltime, client_cmd=client_cmd))
        scripts.append(path)
    return scripts
