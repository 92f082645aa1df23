"""Multi-process entry points: the process group, arrays on each rank, a
local launcher (port of goblin_tpu/parallel/multihost.py).

goblin_tpu spans hosts with jax.distributed and a global device mesh; the
port runs one process a device, joined by a torch.distributed process
group (NCCL between cards, gloo when the caller asks for the CPU, as the
tests do). Nothing in the render code changes; parallel/mesh.py shards the
pixel batches over the group's ranks:

- init_from_env(): init_process_group from the GOBLIN_* variables (no-op
  when none is set, so one process runs as before)
- global_put(): an array onto this rank's device (every rank passes the
  same value, as goblin_tpu's host-side pixel ids and masks)
- launch_local(): spawn N local processes with that environment, the
  stand-in for one process a host
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time

import torch

ENV_KEYS = ("GOBLIN_COORDINATOR", "GOBLIN_NUM_PROCS", "GOBLIN_PROC_ID")


def init_from_env(device="cuda") -> bool:
    """Join the process group the environment describes -> True, or False
    when it describes none.

    GOBLIN_COORDINATOR=host:port, GOBLIN_NUM_PROCS and GOBLIN_PROC_ID give
    the rendezvous (tcp://host:port), the world size and this rank; with
    GOBLIN_DIST=auto the group reads torchrun's variables (env://). The
    backend is NCCL for a CUDA device, with rank r on cuda:{r % cards}, and
    gloo for the CPU. A partial set of the three variables raises."""
    import torch.distributed as dist

    cuda = torch.device(device).type == "cuda"
    backend = "nccl" if cuda else "gloo"
    if os.environ.get("GOBLIN_DIST") == "auto":
        dist.init_process_group(backend, init_method="env://")
    else:
        found = {k: os.environ.get(k) for k in ENV_KEYS}
        if not any(found.values()):
            return False
        missing = [k for k, v in found.items() if not v]
        if missing:
            given = [k for k, v in found.items() if v]
            raise ValueError(f"init_from_env: {', '.join(missing)} not set "
                             f"beside {', '.join(given)}")
        dist.init_process_group(
            backend, init_method=f"tcp://{found['GOBLIN_COORDINATOR']}",
            world_size=int(found["GOBLIN_NUM_PROCS"]),
            rank=int(found["GOBLIN_PROC_ID"]))
    if cuda:
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return True


def global_put(arr, mesh):
    """arr (the same value on every rank) as a tensor on this rank's device
    of the mesh."""
    return torch.as_tensor(arr, device=mesh.device)


def free_port() -> int:
    """A TCP port on localhost that the OS had free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch_local(n_procs: int, argv: list[str], port: int = 7723,
                 env_extra=None, timeout: float = 1200):
    """Run n_procs local processes of `python argv...`, rank i with the
    GOBLIN_* variables of a group on localhost:port -> [(returncode,
    output)] in rank order, stdout and stderr together. If they have not
    all ended timeout seconds after the start, every one still running is
    killed and subprocess.TimeoutExpired is raised."""
    procs = []
    try:
        for rank in range(n_procs):
            env = dict(os.environ)
            env.update(env_extra or {})
            env.update(GOBLIN_COORDINATOR=f"localhost:{port}",
                       GOBLIN_NUM_PROCS=str(n_procs),
                       GOBLIN_PROC_ID=str(rank))
            procs.append(subprocess.Popen(
                [sys.executable] + list(argv), env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        deadline = time.monotonic() + timeout
        results = []
        for p in procs:
            out, _ = p.communicate(
                timeout=max(deadline - time.monotonic(), 0.0))
            results.append((p.returncode, out))
        return results
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
