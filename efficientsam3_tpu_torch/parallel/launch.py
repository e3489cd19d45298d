"""Multi-process launch entry on torch.distributed.

Counterpart of efficientsam3_tpu/parallel/launch.py. The reference
launches one torch process per GPU (mp.spawn / submitit / torchrun) and
wires ranks through env vars; so does the port: one process per card, each
calling ``initialize_distributed`` at the top of its script.

Env contract (the JAX package's names, which SLURM and torchrun set):
  COORDINATOR_ADDRESS / MASTER_ADDR(+PORT)  rendezvous "host:port"
  PROCESS_ID / SLURM_PROCID / RANK          this process's rank
  NUM_PROCESSES / SLURM_NTASKS / WORLD_SIZE process count
  LOCAL_RANK                                this process's card on its host
  SAM3_COLLECTIVE_OP_TIMEOUT_SEC            collective timeout (300 s)

The backend is NCCL when CUDA is present and gloo otherwise (the CPU
tests); each process takes the card ``LOCAL_RANK`` (default: its rank
modulo the host's card count).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist


def _env(*names, default=None):
    for n in names:
        v = os.environ.get(n)
        if v is not None:
            return v
    return default


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> bool:
    """Initialise the default process group from the arguments or the env.
    Returns True if a multi-process group was initialised, False (touching
    nothing) for a world of one. Safe to call unconditionally."""
    coord = coordinator_address or _env("COORDINATOR_ADDRESS")
    if coord is None:
        addr = _env("MASTER_ADDR")
        port = _env("MASTER_PORT", default="1234")
        if addr is not None:
            coord = f"{addr}:{port}"
    n = num_processes if num_processes is not None else _env(
        "NUM_PROCESSES", "SLURM_NTASKS", "WORLD_SIZE")
    pid = process_id if process_id is not None else _env("PROCESS_ID", "SLURM_PROCID", "RANK")
    if coord is None or n is None or int(n) <= 1:
        return False
    rank = int(pid or 0)
    # a dead peer fails the collective after this long instead of hanging
    # the job (the reference's SAM3_COLLECTIVE_OP_TIMEOUT_SEC)
    timeout_s = int(_env("SAM3_COLLECTIVE_OP_TIMEOUT_SEC", default="300"))
    backend = "gloo"
    if torch.cuda.is_available():
        backend = "nccl"
        local = _env("LOCAL_RANK")
        torch.cuda.set_device(int(local) if local is not None
                              else rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{coord}", world_size=int(n),
                            rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    return True


def global_mesh(axis_sizes: dict):
    """Mesh over all ranks of the default group (after
    ``initialize_distributed``). Put the inter-host axis first so that the
    data-parallel gradient reduction crosses hosts and the model axes stay
    within one."""
    from efficientsam3_tpu_torch.parallel.sharding import make_mesh

    return make_mesh(axis_sizes)
