from vitax_torch.parallel.distributed import (  # noqa: F401
    all_reduce,
    init_distributed,
    local_device,
    process_info,
    world_size,
)
from vitax_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    batch_rows,
    cli_mesh,
    gather_params,
    local_rows,
    make_mesh,
    resvit_param_spec,
    shard_params,
    tp_size,
    vit_param_spec,
)
