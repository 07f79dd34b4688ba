"""Process-group start-up for runs over several processes or hosts.

Port of ``chatterbox_tpu/parallel/multihost.py``: call ``init_multihost()``
in every process before ``parallel/sharding.make_mesh``. One process a card:
``torchrun --nproc_per_node=N`` sets the environment this reads.
"""

import datetime
import logging
import os

import torch
import torch.distributed as dist

from ..device import resolve_device

logger = logging.getLogger(__name__)


def init_multihost(coordinator_address=None, num_processes=None, process_id=None, *,
                   device=None, backend=None, timeout_s: float = 600.0) -> bool:
    """``torch.distributed.init_process_group`` from the arguments, else from
    the environment ``torchrun`` sets (``MASTER_ADDR``/``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``; ``LOCAL_RANK`` picks the card). The backend is
    ``nccl`` on the card and ``gloo`` on the CPU (``device``), unless
    ``backend`` names one. Returns False, and starts nothing, for a single
    process, as the JAX function does; True once the group is up."""
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if coordinator_address is None and num_processes is None:
        logger.info("single-process run (no coordinator configured)")
        return False
    if process_id is None:
        process_id = int(env.get("RANK", 0))
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", process_id)) % torch.cuda.device_count())
    dist.init_process_group(backend or ("nccl" if dev.type == "cuda" else "gloo"),
                            init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes or 1), rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s))
    logger.info("process group up: rank %d of %d (%s)", dist.get_rank(), dist.get_world_size(),
                dist.get_backend())
    return True


def local_batch_slice(global_batch: int):
    """(start, size) of this process's share of a data-parallel batch."""
    if not dist.is_initialized():
        return 0, global_batch
    per = global_batch // dist.get_world_size()
    return dist.get_rank() * per, per
