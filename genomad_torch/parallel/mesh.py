"""Process groups and the (data, db) device mesh.

Port of ``genomad_tpu/parallel/mesh.py``. The pipeline uses a 2-D logical
mesh:

  * ``data`` — batch parallelism: contig windows and query-pair batches are
    split across this axis (the reference's multiprocessing pools,
    genomad/prodigal.py:23-29);
  * ``db`` — database-shard parallelism: the marker-profile database is
    partitioned across this axis (MMseqs2's ``--splits`` serial chunking,
    genomad/mmseqs2.py:83-95).

JAX compiles one sharded program over the mesh; here each mesh cell is a
``torch.device`` and the callers launch each cell's work on it. With a
``torch.distributed`` process group the cells are split among the ranks in
contiguous blocks, each rank runs its own, and the results are gathered so
that every rank holds all of them.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def balanced_factorization(n_devices: int) -> tuple[int, int]:
    """(n_data, n_db) for a production mesh: the largest power-of-two db
    axis not exceeding sqrt(2 * n_devices), remainder on data.
    8 devices -> (2, 4); 4 -> (2, 2); 2 -> (1, 2); 1 -> (1, 1)."""
    n_db = 1
    while n_db * 2 <= n_devices and (n_db * 2) ** 2 <= 2 * n_devices:
        n_db *= 2
    while n_devices % n_db:
        n_db //= 2
    return n_devices // n_db, n_db


def pad_to_multiple(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def initialize_distributed() -> bool:
    """Join the ``torch.distributed`` process group that the environment
    names (torchrun's ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and
    ``MASTER_PORT``, in place of the JAX package's GENOMAD_TPU_COORDINATOR,
    _NUM_PROCESSES and _PROCESS_ID). NCCL when a card is present, each rank
    on ``cuda:LOCAL_RANK``; gloo on the CPU. A no-op returning False when
    the environment names no group; True once the group is joined."""
    if "WORLD_SIZE" not in os.environ:
        return False
    import torch.distributed as dist

    if not dist.is_initialized():
        for name in ("RANK", "MASTER_ADDR", "MASTER_PORT"):
            if name not in os.environ:
                raise RuntimeError(f"WORLD_SIZE is set but {name} is not: cannot join the process group")
        if torch.cuda.is_available():
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
            backend = "nccl"
        else:
            backend = "gloo"
        dist.init_process_group(
            backend, init_method="env://", rank=int(os.environ["RANK"]), world_size=int(os.environ["WORLD_SIZE"])
        )
    return True


def group_device(group=None) -> torch.device:
    """The device a collective of ``group`` takes its tensors on: this
    rank's card under NCCL, the CPU under gloo."""
    import torch.distributed as dist

    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def canonical_device(device) -> torch.device:
    """``torch.device`` with its index: a bare ``cuda`` is the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class Mesh:
    """An (n_data, n_db) grid of ``torch.device``s, one per mesh cell.

    Cells may repeat a device (every cell ``cpu`` in the tests, or
    ``cuda:0`` on a one-card machine). With a process group (``group``
    not None) the cells are split among its ranks in contiguous blocks in
    row-major order, as JAX orders the devices of its processes; a rank
    runs only its ``rank_cells`` and :meth:`gather` gives every rank the
    whole result. ``cell_launches`` counts the K1 launches each cell made
    in the searches over this mesh (on the card; the CPU makes none)."""

    def __init__(self, devices, group=None):
        self.devices = np.array(devices, dtype=object)
        if self.devices.ndim != 2 or self.devices.size == 0:
            raise ValueError(f"a mesh is a non-empty (n_data, n_db) grid of devices, got shape {self.devices.shape}")
        for cell in np.ndindex(self.devices.shape):
            self.devices[cell] = canonical_device(self.devices[cell])
        self.group = group
        world, rank = 1, 0
        if group is not None:
            import torch.distributed as dist

            world, rank = dist.get_world_size(group), dist.get_rank(group)
        if self.devices.size % world:
            raise ValueError(f"{self.devices.size} mesh cells do not divide among {world} ranks")
        per_rank = self.devices.size // world
        n_db = self.devices.shape[1]
        self.rank_cells = [divmod(c, n_db) for c in range(rank * per_rank, (rank + 1) * per_rank)]
        self.cell_launches: dict = {}

    @property
    def shape(self) -> dict:
        return {"data": self.devices.shape[0], "db": self.devices.shape[1]}

    @property
    def size(self) -> int:
        return self.devices.size

    def gather(self, arr: np.ndarray) -> np.ndarray:
        """Every rank's part of a result into the whole, on every rank: each
        rank fills the rows of its own cells and leaves the rest 0, so the
        sum over the ranks (one ``all_reduce``) is exact. Single-process
        meshes return ``arr`` as it is."""
        if self.group is None:
            return arr
        import torch.distributed as dist

        t = torch.from_numpy(np.ascontiguousarray(arr)).to(group_device(self.group))
        dist.all_reduce(t, group=self.group)
        return t.cpu().numpy()


def make_mesh(n_data: int | None = None, n_db: int = 1, devices=None) -> Mesh:
    """A (data, db) mesh over ``devices`` (default: every visible card; in
    a process group, one cell per rank, each on the rank's own device).
    With a process group joined (``initialize_distributed``) the mesh
    spans its ranks."""
    import torch.distributed as dist

    group = dist.group.WORLD if dist.is_available() and dist.is_initialized() else None
    if devices is None:
        if group is not None:
            local = torch.device("cuda", torch.cuda.current_device()) if dist.get_backend(group) == "nccl" else torch.device("cpu")
            devices = [local] * dist.get_world_size(group)
        else:
            if not torch.cuda.is_available():
                raise RuntimeError("CUDA is not available: pass the mesh's devices (e.g. ['cpu'] * n) explicitly.")
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if n_data is None:
        n_data = len(devices) // n_db
    if n_data < 1 or n_data * n_db > len(devices):
        raise ValueError(f"a ({n_data}, {n_db}) mesh needs {n_data * n_db} devices, got {len(devices)}")
    grid = np.empty((n_data, n_db), dtype=object)
    for i, device in enumerate(devices[: n_data * n_db]):
        grid[divmod(i, n_db)] = device
    return Mesh(grid, group)
