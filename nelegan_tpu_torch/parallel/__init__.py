"""Data and tensor parallelism over `torch.distributed` (counterpart of
`nelegan_tpu/parallel/`): the mesh, its collectives and the parameters'
placement on its model axis (`mesh.py`), the column-parallel exchanges
(`tensor.py`) and a launcher of local worlds (`launch.py`)."""
from nelegan_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    all_gather_rows,
    all_reduce_sum,
    assert_replicated,
    gather_params,
    make_mesh,
    replica_digest,
    replicate,
    shard_batch,
    shard_params,
)
